from .mock_backend import MockVLLMServer
from .pipeline import RouteResult, Router
from .server import RouterServer

__all__ = ["MockVLLMServer", "RouteResult", "Router", "RouterServer"]
