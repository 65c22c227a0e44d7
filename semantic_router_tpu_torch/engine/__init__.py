from .batcher import BatchItem, DynamicBatcher, pick_bucket, pow2_batch
from .classify import (
    TRUNK_KEY,
    ClassResult,
    EntitySpan,
    InferenceEngine,
    TokenClassResult,
    TrunkGroup,
)
from .pathing import (
    STACKED,
    TRADITIONAL,
    DualPathChooser,
    PathSelection,
    ProcessingRequirements,
)
from .kernels import QUANT_MODES, normalize_kernels, normalize_quant, \
    quant_selects

__all__ = [
    "BatchItem",
    "DualPathChooser",
    "PathSelection",
    "ProcessingRequirements",
    "STACKED",
    "TRADITIONAL",
    "QUANT_MODES",
    "ClassResult",
    "DynamicBatcher",
    "EntitySpan",
    "InferenceEngine",
    "TRUNK_KEY",
    "TokenClassResult",
    "TrunkGroup",
    "normalize_kernels",
    "normalize_quant",
    "pick_bucket",
    "pow2_batch",
    "quant_selects",
]
