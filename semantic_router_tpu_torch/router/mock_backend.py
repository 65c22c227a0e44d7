"""Mock vLLM backend: a deterministic OpenAI-compatible server that echoes
request facts as the completion content, so routing assertions read the
echoed model and messages instead of needing a real model.  A
``content_fn`` replaces the echo with its own answer to each request body
(a response path's input: long answers, facts to check); an answer that
is a dict is the whole assistant message (tool calls).  ``stream: true``
is answered as the reference's mock answers it: SSE chunks of 40
characters, a final chunk with ``finish_reason`` and the usage, then
``data: [DONE]``; a ``cut_fn`` that returns n for a request body drops
that stream after its first n chunks, with no finish and no ``[DONE]``
(an upstream that dies mid-answer).  The W3C ``traceparent`` and every
header of each completion request are kept (``traceparents``,
``headers_seen``), so a test can see what the router sent.  Serves on
the pooled front end (``httpserver.PooledHTTPServer``), as the
reference's mock does."""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler
from typing import Callable, Optional, Union

from .httpserver import PooledHTTPServer

STREAM_PIECE = 40  # characters per streamed chunk
USAGE = {"prompt_tokens": 17, "completion_tokens": 23, "total_tokens": 40}


def _echo_payload(body: dict) -> dict:
    messages = body.get("messages", [])
    return {
        "model": body.get("model", ""),
        "n_messages": len(messages),
        "last_user": next((m.get("content", "") for m in reversed(messages)
                           if m.get("role") == "user"), ""),
        "reasoning_effort": body.get("reasoning_effort"),
    }


def stream_pieces(content: str) -> list:
    """The content pieces a streamed answer carries, in order."""
    return [content[i:i + STREAM_PIECE]
            for i in range(0, len(content), STREAM_PIECE)]


class _Handler(BaseHTTPRequestHandler):
    server_version = "mock-vllm/0.1"
    protocol_version = "HTTP/1.1"
    timeout = 65

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
            self.server.headers_seen.append(
                {k.lower(): v for k, v in self.headers.items()})
        answer = self.server.content_fn(body)
        message = dict(answer) if isinstance(answer, dict) else {
            "role": "assistant", "content": answer}
        message.setdefault("role", "assistant")
        if body.get("stream"):
            self._stream(body, message.get("content") or "")
            return
        self._json(200, {
            "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": body.get("model", self.server.model_name),
            "choices": [{"index": 0, "message": message,
                         "finish_reason": "tool_calls"
                         if message.get("tool_calls") else "stop"}],
            "usage": dict(USAGE),
        })

    def _stream(self, body: dict, content: str) -> None:
        self.send_response(200)
        self.send_header("content-type", "text/event-stream")
        # no content-length on SSE: the connection closes after the stream
        self.send_header("connection", "close")
        self.close_connection = True
        self.end_headers()
        cid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        model = body.get("model", self.server.model_name)
        cut = self.server.cut_fn(body)
        for i, piece in enumerate(stream_pieces(content)):
            if cut is not None and i >= cut:
                return  # dies mid-answer: no finish, no [DONE]
            chunk = {"id": cid, "object": "chat.completion.chunk",
                     "created": int(time.time()), "model": model,
                     "choices": [{"index": 0, "delta": {"content": piece},
                                  "finish_reason": None}]}
            self.wfile.write(f"data: {json.dumps(chunk)}\n\n".encode())
            self.wfile.flush()
        final = {"id": cid, "object": "chat.completion.chunk",
                 "created": int(time.time()), "model": model,
                 "choices": [{"index": 0, "delta": {},
                              "finish_reason": "stop"}],
                 "usage": dict(USAGE)}
        self.wfile.write(f"data: {json.dumps(final)}\n\n".encode())
        self.wfile.write(b"data: [DONE]\n\n")

    def _json(self, status: int, payload: dict) -> None:
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("content-type", "application/json")
        self.send_header("content-length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


class MockVLLMServer:
    def __init__(self, port: int = 0, model_name: str = "mock-model",
                 content_fn: Optional[Callable[[dict],
                                               Union[str, dict]]] = None,
                 cut_fn: Optional[Callable[[dict], Optional[int]]] = None
                 ) -> None:
        self.httpd = PooledHTTPServer(("127.0.0.1", port), _Handler,
                                      max_workers=64)
        self.httpd.model_name = model_name  # type: ignore[attr-defined]
        self.httpd.content_fn = content_fn or (  # type: ignore[attr-defined]
            lambda body: json.dumps(_echo_payload(body)))
        self.httpd.cut_fn = cut_fn or (  # type: ignore[attr-defined]
            lambda body: None)
        self.httpd.hits = 0  # type: ignore[attr-defined]
        self.httpd.traceparents = []  # type: ignore[attr-defined]
        self.httpd.headers_seen = []  # type: ignore[attr-defined]
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

    @property
    def headers_seen(self) -> list:
        """Every completion request's headers (lower-cased names), in
        arrival order."""
        with self.httpd.hits_lock:  # type: ignore[attr-defined]
            return list(self.httpd.headers_seen)  # type: ignore

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
