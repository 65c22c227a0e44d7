from .base import Message, RequestContext, SignalHit, SignalResult, \
    text_units
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
from .heuristic import (
    AuthzSignal,
    ContextSignal,
    ConversationSignal,
    EventSignal,
    LanguageSignal,
    ReaskSignal,
    StructureSignal,
    detect_language,
)
from .kb import KBSignal
from .keyword import KeywordSignal
from .learned import (
    BinaryTaskSignal,
    DomainSignal,
    JailbreakSignal,
    PIISignal,
    build_learned_evaluators,
)

__all__ = [
    "AuthzSignal",
    "BinaryTaskSignal",
    "ComplexitySignal",
    "ContextSignal",
    "ConversationSignal",
    "DispatchReport",
    "DomainSignal",
    "EmbeddingSignal",
    "EventSignal",
    "JailbreakSignal",
    "KBSignal",
    "KeywordSignal",
    "LanguageSignal",
    "Message",
    "PIISignal",
    "PreferenceSignal",
    "ReaskSignal",
    "RequestContext",
    "SignalDispatcher",
    "SignalHit",
    "SignalResult",
    "StructureSignal",
    "apply_complexity_composers",
    "build_dispatcher",
    "build_embedding_evaluators",
    "build_learned_evaluators",
    "detect_language",
    "text_units",
]
