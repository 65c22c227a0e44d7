"""The dashboard's backend: session tokens (``auth.TokenIssuer``), the
durable job runner (``jobs``), the embedding map (``embedmap``), and the
bundled page (``index.html``, ``static/``); its routes live in
``router/server.py``."""

from .auth import TokenIssuer
from .jobs import JobRunner, JobStore

__all__ = ["JobRunner", "JobStore", "TokenIssuer"]
