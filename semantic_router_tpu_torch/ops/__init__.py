from .attention import (
    NEG_INF,
    chunked_sdpa,
    cls_pool,
    mean_pool,
    padding_bias,
    sdpa,
    sliding_window_bias,
)
from .bgmv import bgmv, bgmv_reference
from .epilogue import head_epilogue, head_epilogue_reference
from .flash_attention import flash_attention, flash_attention_reference
from .matryoshka import matryoshka_views, truncate_normalize
from .quant import dequant_matmul, dequantize, quantize_per_channel
from .rope import RopeSpec, apply_rotary, default_inv_freq, rope_tables, \
    yarn_inv_freq

__all__ = [
    "NEG_INF",
    "RopeSpec",
    "apply_rotary",
    "bgmv",
    "bgmv_reference",
    "chunked_sdpa",
    "cls_pool",
    "default_inv_freq",
    "dequant_matmul",
    "dequantize",
    "flash_attention",
    "flash_attention_reference",
    "head_epilogue",
    "head_epilogue_reference",
    "matryoshka_views",
    "mean_pool",
    "padding_bias",
    "quantize_per_channel",
    "rope_tables",
    "sdpa",
    "sliding_window_bias",
    "truncate_normalize",
    "yarn_inv_freq",
]
