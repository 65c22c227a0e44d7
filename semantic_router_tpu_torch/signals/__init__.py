from .base import Message, RequestContext, SignalHit, SignalResult
from .dispatch import (
    DispatchReport,
    SignalDispatcher,
    apply_complexity_composers,
    build_dispatcher,
)
from .embedding_signal import (
    ComplexitySignal,
    EmbeddingSignal,
    PreferenceSignal,
    build_embedding_evaluators,
)
from .learned import (
    BinaryTaskSignal,
    DomainSignal,
    JailbreakSignal,
    PIISignal,
    build_learned_evaluators,
)

__all__ = [
    "BinaryTaskSignal",
    "ComplexitySignal",
    "DispatchReport",
    "DomainSignal",
    "EmbeddingSignal",
    "JailbreakSignal",
    "Message",
    "PIISignal",
    "PreferenceSignal",
    "RequestContext",
    "SignalDispatcher",
    "SignalHit",
    "SignalResult",
    "apply_complexity_composers",
    "build_dispatcher",
    "build_embedding_evaluators",
    "build_learned_evaluators",
]
