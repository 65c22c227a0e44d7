from .batcher import BatchItem, DynamicBatcher, pick_bucket, pow2_batch
from .classify import (
    TRUNK_KEY,
    ClassResult,
    EntitySpan,
    InferenceEngine,
    TokenClassResult,
    TrunkGroup,
)
from .kernels import normalize_kernels

__all__ = [
    "BatchItem",
    "ClassResult",
    "DynamicBatcher",
    "EntitySpan",
    "InferenceEngine",
    "TRUNK_KEY",
    "TokenClassResult",
    "TrunkGroup",
    "normalize_kernels",
    "pick_bucket",
    "pow2_batch",
]
