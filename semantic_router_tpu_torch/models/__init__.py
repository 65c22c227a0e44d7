from .convert import (
    deberta_params_from_flax,
    hf_state_for,
    load_safetensors,
    params_from_flax,
    read_safetensors,
    state_dict_from_hf,
)
from .deberta import (
    DebertaV3Config,
    DebertaV3ForSequenceClassification,
    DebertaV3ForTokenClassification,
    DebertaV3Model,
)
from .embeddings import MmBertEmbeddingModel
from .generate import (
    GenerationResult,
    GreedyGenerator,
    GuardVerdict,
    Qwen3Decoder,
    build_guard_prompt,
    parse_guard_output,
    with_lora_leaves,
)
from .lora import (
    LoRAConfig,
    LoRADense,
    ModernBertLoRAHeadClassifier,
    apply_head_bank,
    apply_head_bank_bgmv,
    head_bank_entry,
    stack_head_bank,
)
from .modernbert import (
    ModernBertConfig,
    ModernBertForSequenceClassification,
    ModernBertForTokenClassification,
    ModernBertModel,
)
from .quant import QuantDense, build_quant_trunk, quantize_trunk_params
from .qwen3 import Qwen3Config, Qwen3ForCausalLM, Qwen3Model

__all__ = [
    "DebertaV3Config",
    "DebertaV3ForSequenceClassification",
    "DebertaV3ForTokenClassification",
    "DebertaV3Model",
    "GenerationResult",
    "GreedyGenerator",
    "GuardVerdict",
    "LoRAConfig",
    "LoRADense",
    "MmBertEmbeddingModel",
    "ModernBertConfig",
    "ModernBertForSequenceClassification",
    "ModernBertForTokenClassification",
    "ModernBertLoRAHeadClassifier",
    "ModernBertModel",
    "QuantDense",
    "Qwen3Config",
    "Qwen3Decoder",
    "Qwen3ForCausalLM",
    "Qwen3Model",
    "apply_head_bank",
    "apply_head_bank_bgmv",
    "build_guard_prompt",
    "build_quant_trunk",
    "deberta_params_from_flax",
    "head_bank_entry",
    "hf_state_for",
    "load_safetensors",
    "params_from_flax",
    "parse_guard_output",
    "quantize_trunk_params",
    "read_safetensors",
    "stack_head_bank",
    "state_dict_from_hf",
    "with_lora_leaves",
]
