from .convert import (
    load_safetensors,
    params_from_flax,
    read_safetensors,
    state_dict_from_hf,
)
from .lora import apply_head_bank, head_bank_entry, stack_head_bank
from .modernbert import (
    ModernBertConfig,
    ModernBertForSequenceClassification,
    ModernBertForTokenClassification,
    ModernBertModel,
)

__all__ = [
    "ModernBertConfig",
    "ModernBertForSequenceClassification",
    "ModernBertForTokenClassification",
    "ModernBertModel",
    "apply_head_bank",
    "head_bank_entry",
    "load_safetensors",
    "params_from_flax",
    "read_safetensors",
    "stack_head_bank",
    "state_dict_from_hf",
]
