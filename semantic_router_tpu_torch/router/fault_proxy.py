"""Fault-injecting OpenAI proxy for resilience tests and the card's smoke
run.

The port's copy of ``semantic_router_tpu.router.fault_proxy``: a proxy
between the router and its backend that injects the failures a
production backend shows, so failover is measured, not assumed.  Faults
(per-request probabilities or fixed plans, adjustable while traffic
runs):

- ``error_rate``: fraction answered with a 5xx JSON error body;
- ``disconnect_rate``: fraction where the socket closes after reading the
  request (the at-most-once hard case: the backend may have executed it);
- ``refuse``: stop accepting entirely (connect refused: a dead replica);
- ``plan``: an explicit per-request script, e.g. ["ok", "error",
  "disconnect"], cycled;
- ``reset`` (plan action): a hard RST after reading the request;
- ``set_flap(down_s, up_s, mode)``: alternate a faulty window (``mode``:
  error / reset / disconnect) with a healthy one.

(The reference's added latency and ``slow`` action are left out: no test
or smoke phase of the port injects them.)

Everything else proxies verbatim to the target backend.  ``stats``
counts the actions taken.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
import urllib.error
import urllib.request
from typing import List, Optional


class FaultProxy:
    """HTTP proxy in front of ``target_url`` with scriptable faults."""

    def __init__(self, target_url: str, error_rate: float = 0.0,
                 disconnect_rate: float = 0.0,
                 plan: Optional[List[str]] = None, seed: int = 0) -> None:
        import numpy as np

        self.target_url = target_url.rstrip("/")
        self.error_rate = error_rate
        self.disconnect_rate = disconnect_rate
        self.plan = list(plan) if plan else None
        self._plan_i = 0
        # timed flap: (down_s, up_s, mode, t0) — None = no flapping
        self._flap: Optional[tuple] = None
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self.stats = {"ok": 0, "error": 0, "disconnect": 0}
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(64)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def set_flap(self, down_s: float, up_s: float,
                 mode: str = "error") -> None:
        """Timed flapping: ``down_s`` of ``mode`` faults, then ``up_s``
        healthy, repeating — the intermittent-backend shape that
        exercises breaker open → half-open probe → reopen cycles.
        Overrides plan/rates while set; runtime-adjustable."""
        with self._lock:
            self._flap = (max(0.0, float(down_s)), max(0.0, float(up_s)),
                          mode, time.monotonic())

    def clear_flap(self) -> None:
        with self._lock:
            self._flap = None

    def _next_action(self) -> str:
        with self._lock:
            if self._flap is not None:
                down_s, up_s, mode, t0 = self._flap
                period = down_s + up_s
                if period <= 0:
                    return mode
                phase = (time.monotonic() - t0) % period
                return mode if phase < down_s else "ok"
            if self.plan:
                action = self.plan[self._plan_i % len(self.plan)]
                self._plan_i += 1
                return action
            r = float(self._rng.random())
            if r < self.disconnect_rate:
                return "disconnect"
            if r < self.disconnect_rate + self.error_rate:
                return "error"
            return "ok"

    def _note(self, action: str) -> None:
        with self._lock:
            self.stats[action] = self.stats.get(action, 0) + 1

    # -- connection handling ------------------------------------------------

    def _read_request(self, conn: socket.socket):
        """(method, path, headers, body) or None on EOF/garbage."""
        conn.settimeout(30)
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = conn.recv(65536)
            if not chunk:
                return None
            buf += chunk
        head, _, rest = buf.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        method, path, _ = lines[0].split(" ", 2)
        headers = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, v = ln.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", 0))
        body = rest
        while len(body) < length:
            chunk = conn.recv(65536)
            if not chunk:
                break
            body += chunk
        return method, path, headers, body

    def _handle(self, conn: socket.socket) -> None:
        try:
            req = self._read_request(conn)
            if req is None:
                return
            method, path, headers, body = req
            action = self._next_action()
            self._note(action)
            if action == "disconnect":
                return  # close-after-read: the at-most-once hard case
            if action == "reset":
                # hard RST, not a polite FIN: SO_LINGER 0 makes close()
                # abort the connection — "connection reset by peer" on
                # the client, the mid-exchange network-failure shape
                try:
                    conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                    struct.pack("ii", 1, 0))
                except OSError:
                    pass
                return
            if action == "error":
                payload = json.dumps({"error": {
                    "message": "injected backend failure",
                    "type": "fault_proxy"}}).encode()
                conn.sendall(
                    b"HTTP/1.1 503 Service Unavailable\r\n"
                    b"content-type: application/json\r\n"
                    + f"content-length: {len(payload)}\r\n\r\n"
                    .encode() + payload)
                return
            # forward verbatim
            fwd = urllib.request.Request(
                self.target_url + path, data=body or None, method=method)
            for k, v in headers.items():
                if k not in ("host", "content-length", "connection",
                             "transfer-encoding"):
                    fwd.add_header(k, v)
            try:
                with urllib.request.urlopen(fwd, timeout=60) as resp:
                    data = resp.read()
                    status, reason = resp.status, resp.reason
                    ctype = resp.headers.get("content-type",
                                             "application/json")
            except urllib.error.HTTPError as e:
                data = e.read()
                status, reason = e.code, e.reason
                ctype = e.headers.get("content-type", "application/json")
            conn.sendall(
                f"HTTP/1.1 {status} {reason}\r\n"
                f"content-type: {ctype}\r\n"
                f"content-length: {len(data)}\r\n"
                f"connection: close\r\n\r\n".encode() + data)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                self._srv.settimeout(0.5)
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def start(self) -> "FaultProxy":
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="fault-proxy")
        self._thread.start()
        return self

    def refuse(self) -> None:
        """Stop accepting — connect-refused, the dead-replica mode."""
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass

    def stop(self) -> None:
        self.refuse()
