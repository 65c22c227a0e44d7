"""The config editor's session tokens (``auth.TokenIssuer``); the editor's
routes live in ``router/server.py``."""

from .auth import TokenIssuer

__all__ = ["TokenIssuer"]
