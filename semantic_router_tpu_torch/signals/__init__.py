from .base import Message, RequestContext, SignalHit, SignalResult
from .dispatch import DispatchReport, SignalDispatcher, build_dispatcher
from .learned import (
    BinaryTaskSignal,
    DomainSignal,
    JailbreakSignal,
    PIISignal,
    build_learned_evaluators,
)

__all__ = [
    "BinaryTaskSignal",
    "DispatchReport",
    "DomainSignal",
    "JailbreakSignal",
    "Message",
    "PIISignal",
    "RequestContext",
    "SignalDispatcher",
    "SignalHit",
    "SignalResult",
    "build_dispatcher",
    "build_learned_evaluators",
]
