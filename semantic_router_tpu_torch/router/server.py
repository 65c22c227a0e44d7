"""HTTP front end: ``POST /v1/chat/completions`` routes the request, forwards
the rewritten body to the backend, and answers with the backend's response
stamped with the router's x-vsr-* headers; a semantic-cache hit is
answered by the router without the backend, and a routed 200 goes through
the router's response path (the cache write).  ``GET /health`` reports
liveness.  Standard library only (``ThreadingHTTPServer`` + ``http.client``).
"""

from __future__ import annotations

import http.client
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .pipeline import Router


class _Handler(BaseHTTPRequestHandler):
    server_version = "semantic-router-torch/0.1"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # silence
        pass

    def do_GET(self):
        if self.path in ("/health", "/healthz"):
            self._reply(200, {"status": "ok"})
        else:
            self._reply(404, {"error": "not found"})

    def do_POST(self):
        if self.path != "/v1/chat/completions":
            self._reply(404, {"error": "not found"})
            return
        length = int(self.headers.get("content-length", 0))
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            self._reply(400, {"error": {"message": "request body is not JSON"}})
            return
        srv: RouterServer = self.server.owner
        result = srv.router.route(body, dict(self.headers.items()))
        if result.kind in ("cache_hit", "blocked"):
            self._reply(result.status, result.response_body, result.headers)
            return
        try:
            status, data = srv.forward(result.body)
        except OSError as exc:
            self._reply(502, {"error": {"message": f"backend unreachable: "
                                                   f"{exc}"}},
                        result.headers)
            return
        if status == 200:
            try:
                reply = json.loads(data)
            except ValueError:
                reply = None
            if isinstance(reply, dict):
                srv.router.process_response(result, reply)
        self._reply_raw(status, data, result.headers)

    def _reply(self, status: int, payload: dict,
               headers: Optional[dict] = None) -> None:
        self._reply_raw(status, json.dumps(payload).encode(), headers)

    def _reply_raw(self, status: int, data: bytes,
                   headers: Optional[dict] = None) -> None:
        self.send_response(status)
        self.send_header("content-type", "application/json")
        self.send_header("content-length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)


class RouterServer:
    """Serves one Router in front of one OpenAI-compatible backend."""

    def __init__(self, router: Router, backend_url: str,
                 host: str = "127.0.0.1", port: int = 0,
                 timeout_s: float = 60.0) -> None:
        self.router = router
        u = urllib.parse.urlsplit(backend_url)
        if u.scheme != "http" or not u.hostname:
            raise ValueError(f"backend must be an http:// URL, got "
                             f"{backend_url!r}")
        self._backend = (u.hostname, u.port or 80, u.path.rstrip("/"))
        self.timeout_s = timeout_s
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.owner = self  # type: ignore[attr-defined]
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host = self.httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def forward(self, body: dict) -> "tuple[int, bytes]":
        """POST the routed body to the backend; (status, response bytes)."""
        host, port, prefix = self._backend
        conn = http.client.HTTPConnection(host, port, timeout=self.timeout_s)
        try:
            conn.request("POST", f"{prefix}/v1/chat/completions",
                         body=json.dumps(body).encode(),
                         headers={"content-type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def start(self) -> "RouterServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="router-http")
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
