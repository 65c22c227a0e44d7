"""Mock vLLM backend: a deterministic OpenAI-compatible server that echoes
request facts as the completion content, so routing assertions read the
echoed model and messages instead of needing a real model.  A
``content_fn`` replaces the echo with its own answer to each request body
(a response path's input: long answers, facts to check).  The W3C
``traceparent`` of every completion request is kept (``traceparents``),
so a test can see the router's trace reach the backend."""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional


def _echo_payload(body: dict) -> dict:
    messages = body.get("messages", [])
    return {
        "model": body.get("model", ""),
        "n_messages": len(messages),
        "last_user": next((m.get("content", "") for m in reversed(messages)
                           if m.get("role") == "user"), ""),
        "reasoning_effort": body.get("reasoning_effort"),
    }


class _Handler(BaseHTTPRequestHandler):
    server_version = "mock-vllm/0.1"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # silence
        pass

    def do_GET(self):
        if self.path == "/v1/models":
            self._json(200, {"object": "list", "data": [
                {"id": self.server.model_name, "object": "model"}]})
        elif self.path in ("/health", "/healthz"):
            self._json(200, {"status": "ok"})
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self):
        length = int(self.headers.get("content-length", 0))
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            self._json(400, {"error": "bad json"})
            return
        if self.path != "/v1/chat/completions":
            self._json(404, {"error": "not found"})
            return
        with self.server.hits_lock:
            self.server.hits += 1
            self.server.traceparents.append(
                self.headers.get("traceparent", ""))
        self._json(200, {
            "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": body.get("model", self.server.model_name),
            "choices": [{"index": 0,
                         "message": {"role": "assistant",
                                     "content": self.server.content_fn(body)},
                         "finish_reason": "stop"}],
            "usage": {"prompt_tokens": 17, "completion_tokens": 23,
                      "total_tokens": 40},
        })

    def _json(self, status: int, payload: dict) -> None:
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("content-type", "application/json")
        self.send_header("content-length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


class MockVLLMServer:
    def __init__(self, port: int = 0, model_name: str = "mock-model",
                 content_fn: Optional[Callable[[dict], str]] = None) -> None:
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.model_name = model_name  # type: ignore[attr-defined]
        self.httpd.content_fn = content_fn or (  # type: ignore[attr-defined]
            lambda body: json.dumps(_echo_payload(body)))
        self.httpd.hits = 0  # type: ignore[attr-defined]
        self.httpd.traceparents = []  # type: ignore[attr-defined]
        self.httpd.hits_lock = threading.Lock()  # type: ignore[attr-defined]
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    @property
    def hits(self) -> int:
        """Completion requests served."""
        with self.httpd.hits_lock:  # type: ignore[attr-defined]
            return self.httpd.hits  # type: ignore[attr-defined]

    @property
    def traceparents(self) -> list:
        """The ``traceparent`` header of each completion request, in
        arrival order ("" when absent)."""
        with self.httpd.hits_lock:  # type: ignore[attr-defined]
            return list(self.httpd.traceparents)  # type: ignore

    def start(self) -> "MockVLLMServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="mock-vllm")
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
