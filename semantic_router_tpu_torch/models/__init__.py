from .convert import (
    load_safetensors,
    params_from_flax,
    read_safetensors,
    state_dict_from_hf,
)
from .embeddings import MmBertEmbeddingModel
from .lora import (
    LoRAConfig,
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

__all__ = [
    "LoRAConfig",
    "MmBertEmbeddingModel",
    "ModernBertConfig",
    "ModernBertForSequenceClassification",
    "ModernBertForTokenClassification",
    "ModernBertLoRAHeadClassifier",
    "ModernBertModel",
    "QuantDense",
    "apply_head_bank",
    "apply_head_bank_bgmv",
    "build_quant_trunk",
    "head_bank_entry",
    "load_safetensors",
    "params_from_flax",
    "quantize_trunk_params",
    "read_safetensors",
    "stack_head_bank",
    "state_dict_from_hf",
]
