"""Model selection: the registry of every algorithm a decision's
``algorithm: {type: ...}`` may name."""

from . import algorithms as _algorithms  # noqa: F401  (registers selectors)
from . import ml as _ml  # noqa: F401
from .algorithms import (
    AutoMixSelector,
    EloSelector,
    HybridSelector,
    LatencyAwareSelector,
    LookupTableSelector,
    MultiFactorSelector,
    RLDrivenSelector,
    SessionAwareSelector,
    StaticSelector,
)
from .base import (
    Feedback,
    PercentileTracker,
    SelectionContext,
    SelectionResult,
    Selector,
    SelectorRegistry,
    registry,
)
from .ml import (
    DeviceWork,
    GMTRouterSelector,
    KMeansSelector,
    KNNSelector,
    MLPSelector,
    RouterDCSelector,
    SVMSelector,
)

__all__ = [
    "AutoMixSelector", "DeviceWork", "EloSelector", "Feedback",
    "GMTRouterSelector", "HybridSelector", "KMeansSelector", "KNNSelector",
    "LatencyAwareSelector", "LookupTableSelector", "MLPSelector",
    "MultiFactorSelector", "PercentileTracker", "RLDrivenSelector",
    "RouterDCSelector", "SVMSelector", "SelectionContext", "SelectionResult",
    "Selector", "SelectorRegistry", "SessionAwareSelector", "StaticSelector",
    "registry",
]
