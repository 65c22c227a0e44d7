"""Dashboard session tokens.

HMAC-SHA256 signed tokens in the JWT compact shape
(``base64url(header).base64url(payload).base64url(sig)``), framed by
hand: the claims are a role list, ``iat`` and ``exp``.  ``POST
/dashboard/api/login`` issues one for a configured management API key,
so a browser never keeps the long-lived key; the signing secret is
random per process, so a restart ends every session.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time
from typing import List, Optional, Set


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64url(text: str) -> bytes:
    pad = "=" * (-len(text) % 4)
    return base64.urlsafe_b64decode(text + pad)


class TokenIssuer:
    def __init__(self, secret: Optional[bytes] = None,
                 ttl_s: float = 8 * 3600.0) -> None:
        self.secret = secret or os.urandom(32)
        self.ttl_s = ttl_s

    def _sign(self, signing_input: bytes) -> str:
        return _b64url(hmac.new(self.secret, signing_input,
                                hashlib.sha256).digest())

    def issue(self, roles: Set[str], ttl_s: Optional[float] = None) -> str:
        now = time.time()
        header = _b64url(json.dumps(
            {"alg": "HS256", "typ": "JWT"},
            separators=(",", ":")).encode())
        payload = _b64url(json.dumps(
            {"roles": sorted(roles), "iat": int(now),
             "exp": int(now + (ttl_s or self.ttl_s))},
            separators=(",", ":")).encode())
        signing_input = f"{header}.{payload}".encode()
        return f"{header}.{payload}.{self._sign(signing_input)}"

    def verify(self, token: str) -> Optional[Set[str]]:
        """Roles for a valid unexpired token; None otherwise."""
        parts = token.split(".")
        if len(parts) != 3:
            return None
        signing_input = f"{parts[0]}.{parts[1]}".encode()
        # compare as BYTES: compare_digest on str demands ASCII, and a
        # presented signature segment from a latin-1-decoded header can
        # carry non-ASCII — that must be a clean None, not a TypeError
        presented = parts[2].encode("utf-8", "surrogateescape")
        if not hmac.compare_digest(self._sign(signing_input).encode(),
                                   presented):
            return None
        try:
            payload = json.loads(_unb64url(parts[1]))
        except (ValueError, UnicodeDecodeError):
            return None
        if float(payload.get("exp", 0)) < time.time():
            return None
        roles = payload.get("roles")
        if not isinstance(roles, list):
            return None
        return set(str(r) for r in roles)
