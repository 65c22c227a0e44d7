from .loader import load_config, substitute_env
from .schema import (
    Decision,
    DomainRule,
    InferenceEngineConfig,
    JailbreakRule,
    ModelCard,
    ModelRef,
    NamedRule,
    PIIRule,
    RouterConfig,
    RuleNode,
    SignalsConfig,
)

__all__ = [
    "Decision",
    "DomainRule",
    "InferenceEngineConfig",
    "JailbreakRule",
    "ModelCard",
    "ModelRef",
    "NamedRule",
    "PIIRule",
    "RouterConfig",
    "RuleNode",
    "SignalsConfig",
    "load_config",
    "substitute_env",
]
