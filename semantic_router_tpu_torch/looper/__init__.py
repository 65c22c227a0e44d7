from .looper import (
    HTTPLLMClient,
    LLMClient,
    LOOPER_MARKER_HEADER,
    Looper,
    LooperResponse,
)

__all__ = ["HTTPLLMClient", "LLMClient", "LOOPER_MARKER_HEADER", "Looper",
           "LooperResponse"]
