"""Pooled upstream HTTP client for the router's forward path.

The port's copy of ``semantic_router_tpu.router.httpclient``: per-(scheme,
host, port) stacks of idle keep-alive ``http.client.HTTPConnection``s
shared across handler threads (a fresh TCP connection per forwarded
request adds a round trip and slow start to every answer).  A borrowed
connection is probed for staleness (a readable idle socket means the
peer closed it) and replaced.  Retry discipline is at-most-once: an
exception while sending means the backend cannot have seen a complete
request (Content-Length framing), so one retry on a fresh connection is
safe even for POST; an exception while reading the response is never
retried, since the backend may have processed the request.  The raised
exception carries ``request_delivered``, which the server's endpoint
failover reads.
"""

from __future__ import annotations

import http.client
import select
import socket
import threading
from typing import Dict, Optional, Tuple
from urllib.parse import urlsplit

__all__ = ["UpstreamPool"]


class _Conn(http.client.HTTPConnection):
    def connect(self) -> None:  # pragma: no cover - trivial
        super().connect()
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass


class _ConnS(http.client.HTTPSConnection):
    def connect(self) -> None:  # pragma: no cover - needs TLS backend
        super().connect()
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass


def _stale(sock: Optional[socket.socket]) -> bool:
    """True when the peer half-closed the idle connection (readable with
    a pending EOF / unsolicited bytes) — reuse would send into a dead
    pipe and surface as a spurious backend error."""
    if sock is None:
        return True
    try:
        readable, _, _ = select.select([sock], [], [], 0)
        return bool(readable)
    except (OSError, ValueError):
        return True


class UpstreamPool:
    """Keep-alive connection pool, shared across handler threads."""

    def __init__(self, max_idle_per_host: int = 16) -> None:
        self._idle: Dict[Tuple[str, str, int], list] = {}
        self._lock = threading.Lock()
        self._max_idle = max_idle_per_host
        self._closed = False

    # -- lifecycle ------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conns = [c for stack in self._idle.values() for c in stack]
            self._idle.clear()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    # -- internals ------------------------------------------------------

    def _borrow(self, scheme: str, host: str, port: int,
                timeout: float, fresh: bool = False):
        """``fresh=True`` bypasses the idle stack entirely — the retry
        path uses it so a request that just died on one stale pooled
        socket can't be handed ANOTHER stale pooled socket (the _stale
        probe only sees an EOF that has already arrived; a server
        closing idle connections as it receives bytes defeats it)."""
        if not fresh:
            key = (scheme, host, port)
            with self._lock:
                stack = self._idle.get(key)
                while stack:
                    conn = stack.pop()
                    if not _stale(conn.sock):
                        conn.timeout = timeout
                        if conn.sock is not None:
                            conn.sock.settimeout(timeout)
                        return conn, True
                    try:
                        conn.close()
                    except OSError:
                        pass
        cls = _ConnS if scheme == "https" else _Conn
        return cls(host, port, timeout=timeout), False

    def _give_back(self, scheme: str, host: str, port: int, conn) -> None:
        with self._lock:
            if not self._closed:
                stack = self._idle.setdefault((scheme, host, port), [])
                if len(stack) < self._max_idle:
                    stack.append(conn)
                    return
        try:
            conn.close()
        except OSError:
            pass

    # -- request --------------------------------------------------------

    def request(self, method: str, url: str, body: Optional[bytes],
                headers: Dict[str, str], timeout: float
                ) -> Tuple[int, Dict[str, str], bytes]:
        """One fully-buffered HTTP exchange. Returns
        ``(status, response_headers, response_body)``; raises OSError /
        http.client.HTTPException when the backend is unreachable (the
        caller maps that to its fail-open 502). Non-2xx statuses are
        returned, not raised."""
        parts = urlsplit(url)
        scheme = parts.scheme or "http"
        host = parts.hostname or "127.0.0.1"
        port = parts.port or (443 if scheme == "https" else 80)
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        last_exc: Optional[Exception] = None
        for attempt in (0, 1):
            # the retry always runs on a FRESH connection: the failure
            # that got us here was very likely a stale keep-alive
            # socket, and the rest of the idle stack aged exactly the
            # same way
            conn, reused = self._borrow(scheme, host, port, timeout,
                                        fresh=attempt > 0)
            sent = False
            got_response = False
            try:
                conn.request(method, path, body=body, headers=headers)
                sent = True
                resp = conn.getresponse()
                got_response = True
                data = resp.read()
                keep = (resp.version >= 11 and
                        resp.headers.get("connection", "").lower()
                        != "close")
                if keep:
                    self._give_back(scheme, host, port, conn)
                else:
                    conn.close()
                return resp.status, dict(resp.headers), data
            except (http.client.HTTPException, OSError) as exc:
                try:
                    conn.close()
                except OSError:
                    pass
                last_exc = exc
                # the keep-alive close race, REUSED connections only: a
                # server tearing down an idle connection as our bytes
                # arrive surfaces as a clean RemoteDisconnected (FIN
                # before any response byte) or — when our request bytes
                # were still pending in its buffer at close — a hard
                # ECONNRESET/EPIPE.  Either way the socket was dead
                # before this request: retry once on a FRESH connection
                # instead of surfacing a spurious backend failure.
                # ``not got_response`` keeps this narrow: once a status
                # line was parsed the server provably processed the
                # request, and a reset mid-body must surface, never
                # replay.  (A crash-after-execute that RSTs before any
                # response byte is indistinguishable from the idle
                # close — the same call Go's http.Transport makes for
                # reused connections with nothing received.)
                stale_reuse_race = (
                    reused and attempt == 0 and not got_response
                    and isinstance(exc, (http.client.RemoteDisconnected,
                                         ConnectionResetError,
                                         BrokenPipeError)))
                if sent and not stale_reuse_race:
                    # response-phase failure: the server may have
                    # executed the request — never retry.
                    # Callers doing endpoint failover need the same
                    # at-most-once distinction, so it rides the exception.
                    exc.request_delivered = True  # type: ignore[attr-defined]
                    raise
        # both attempts failed in the send phase: the backend never saw a
        # complete frame — safe for the caller to replay elsewhere
        last_exc.request_delivered = False  # type: ignore[attr-defined]
        raise last_exc
