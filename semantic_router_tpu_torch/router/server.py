"""HTTP front end: ``POST /v1/chat/completions`` routes the request, forwards
the rewritten body to the backend, and answers with the backend's response
stamped with the router's x-vsr-* headers; a semantic-cache hit is
answered by the router without the backend.  Each backend call is counted
in the in-flight tracker (the ``multi_factor`` selector's load) and timed;
a 200 goes through the router's response path (its headers and annotated
body are what the client gets), and every answer, 200 or not, is fed
back to the decision's selector (``record_feedback``).  ``GET /health`` reports
liveness.  Standard library only (``ThreadingHTTPServer`` + ``http.client``).

The Classification API answers as the reference server's handlers do
with no API keys configured:

  POST /api/v1/classify/intent|pii|security|fact-check|user-feedback
       (``windowed`` / ``stride`` classify a long text over stride windows)
  POST /api/v1/classify/combined   every loaded task on one text
  POST /api/v1/classify/batch      one task over ``texts``
  POST /api/v1/embeddings          ``input``, ``dimensions`` → output_dim
  POST /api/v1/similarity[/batch]  cosine of embedded text pairs
  GET  /api/v1                     the routes this server answers
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..observability.inflight import default_tracker
from .pipeline import EMBEDDING_TASK, Router

# the routes this server answers (the reference's discovery document,
# trimmed to what the port serves)
API_CATALOG = {"endpoints": [
    {"path": p, "method": m} for p, m in (
        ("/health", "GET"),
        ("/api/v1", "GET"),
        ("/v1/chat/completions", "POST"),
        ("/api/v1/classify/intent", "POST"),
        ("/api/v1/classify/pii", "POST"),
        ("/api/v1/classify/security", "POST"),
        ("/api/v1/classify/fact-check", "POST"),
        ("/api/v1/classify/user-feedback", "POST"),
        ("/api/v1/classify/combined", "POST"),
        ("/api/v1/classify/batch", "POST"),
        ("/api/v1/embeddings", "POST"),
        ("/api/v1/similarity", "POST"),
        ("/api/v1/similarity/batch", "POST"),
    )]}

# Classification API route name → engine task
CLASSIFY_TASKS = {"intent": "intent", "security": "jailbreak", "pii": "pii",
                  "fact-check": "fact_check",
                  "user-feedback": "user_feedback"}


class _Handler(BaseHTTPRequestHandler):
    server_version = "semantic-router-torch/0.1"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # silence
        pass

    def do_GET(self):
        if self.path in ("/health", "/healthz"):
            self._reply(200, {"status": "ok"})
        elif self.path.split("?", 1)[0] == "/api/v1":
            self._reply(200, API_CATALOG)
        else:
            self._reply(404, {"error": "not found"})

    def do_POST(self):
        path = self.path.split("?", 1)[0]
        length = int(self.headers.get("content-length", 0))
        data = self.rfile.read(length)
        known = path == "/v1/chat/completions" or path in (
            "/api/v1/embeddings", "/api/v1/similarity",
            "/api/v1/similarity/batch") \
            or path.startswith("/api/v1/classify/")
        if not known:
            self._reply(404, {"error": "not found"})
            return
        try:
            body = json.loads(data or b"{}")
        except json.JSONDecodeError:
            self._reply(400, {"error": {"message": "request body is not JSON"}})
            return
        if path == "/v1/chat/completions":
            self._chat(body)
            return
        try:
            if path.startswith("/api/v1/classify/"):
                self._classify(path.rsplit("/", 1)[1], body)
            elif path == "/api/v1/embeddings":
                self._embeddings(body)
            else:
                self._similarity(body)
        except Exception as exc:
            self._reply(500, {"error": {
                "message": f"{type(exc).__name__}: {exc}"}})

    # -- the Classification API --------------------------------------------

    def _classify(self, task: str, body: dict) -> None:
        eng = self.server.owner.router.engine
        if eng is None:
            self._reply(503, {"error": "no inference engine"})
            return
        if task == "batch":
            results = eng.classify_batch(body.get("task", "intent"),
                                         body.get("texts", []))
            self._reply(200, {"results": [
                dict({"label": r.label, "confidence": r.confidence},
                     **({"truncated": True} if r.truncated else {}))
                for r in results]})
            return
        if task == "combined":
            text = body.get("text", "")
            out = {}
            for api_name, engine_task in CLASSIFY_TASKS.items():
                if not eng.has_task(engine_task):
                    continue
                if engine_task == "pii":
                    r = eng.token_classify(engine_task, text)
                    out[api_name] = {"entities": [e.__dict__
                                                  for e in r.entities]}
                else:
                    r = eng.classify(engine_task, text)
                    out[api_name] = {"label": r.label, "class_idx": r.index,
                                     "confidence": r.confidence}
            self._reply(200, out)
            return
        engine_task = CLASSIFY_TASKS.get(task, task)
        if not eng.has_task(engine_task):
            self._reply(404, {"error": f"task {engine_task!r} not loaded"})
            return
        text = body.get("text", "")
        if engine_task == "pii":
            r = eng.token_classify(engine_task, text)
            resp = {"entities": [e.__dict__ for e in r.entities]}
        else:
            if body.get("windowed"):
                r = eng.classify_windowed(engine_task, text,
                                          stride=int(body.get("stride", 64)))
            else:
                r = eng.classify(engine_task, text)
            resp = {"label": r.label, "class_idx": r.index,
                    "confidence": r.confidence, "probs": r.probs}
        if r.truncated:
            # the model never saw the input's tail: a consumer reading
            # "no entities" or a label as covering all of it must see this
            resp["truncated"] = True
        self._reply(200, resp)

    def _embeddings(self, body: dict) -> None:
        router = self.server.owner.router
        eng = router.engine
        task = body.get("model", EMBEDDING_TASK)
        if eng is None or not eng.has_task(task):
            self._reply(503, {"error": "embedding task not loaded"})
            return
        texts = body.get("input")
        if isinstance(texts, str):
            texts = [texts]
        embs = eng.embed(task, texts, output_dim=body.get("dimensions"))
        self._reply(200, {"object": "list", "data": [
            {"object": "embedding", "index": i, "embedding": e.tolist()}
            for i, e in enumerate(embs)]})

    def _similarity(self, body: dict) -> None:
        router = self.server.owner.router
        eng = router.engine
        task = EMBEDDING_TASK
        if eng is None or not eng.has_task(task):
            self._reply(503, {"error": "embedding task not loaded"})
            return
        pairs = body.get("pairs")
        if pairs:
            out = []
            for p in pairs:
                e = eng.embed(task, [p.get("text_a", ""),
                                     p.get("text_b", "")])
                out.append(float(e[0] @ e[1]))
            self._reply(200, {"similarities": out})
            return
        a = body.get("text_a") or body.get("text1", "")
        b = body.get("text_b") or body.get("text2", "")
        e = eng.embed(task, [a, b])
        self._reply(200, {"similarity": float(e[0] @ e[1])})

    # -- chat ----------------------------------------------------------------

    def _chat(self, body: dict) -> None:
        srv: RouterServer = self.server.owner
        router = srv.router
        result = router.route(body, dict(self.headers.items()))
        if result.kind in ("cache_hit", "blocked"):
            self._reply(result.status, result.response_body, result.headers)
            return
        t0 = time.perf_counter()
        token = default_tracker.begin(result.model)
        try:
            status, data = srv.forward(result.body)
        except OSError as exc:
            status, data = 502, json.dumps({"error": {
                "message": f"backend unreachable: {exc}"}}).encode()
        finally:
            default_tracker.end(result.model, token)
        latency_ms = (time.perf_counter() - t0) * 1e3
        if status != 200:
            router.record_feedback(result, success=False,
                                   latency_ms=latency_ms)
            self._reply_raw(status, data, result.headers)
            return
        try:
            reply = json.loads(data)
        except ValueError:
            reply = None
        processed = router.process_response(result, reply) \
            if isinstance(reply, dict) else None
        router.record_feedback(result, success=True, latency_ms=latency_ms)
        if processed is None:
            self._reply_raw(status, data, result.headers)
            return
        self._reply(200, processed.body,
                    {**result.headers, **processed.headers})

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
