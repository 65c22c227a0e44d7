"""OpenAI Responses API ⇄ ChatCompletions translation + response store.

Capability parity with pkg/responseapi (1.9k LoC; wired at
extproc/req_filter_response_api.go:527) and pkg/responsestore (2.3k):
inbound `/v1/responses` requests translate to the internal ChatCompletions
shape for the signal/decision pipeline; completions translate back to
Response objects; `previous_response_id` threads stored conversation
history into the new request; responses persist in a store (in memory,
or on Redis / Valkey / a Redis Cluster over the port's RESP clients, with
the reference's keys and JSON, so a turn stored through any replica of
either package continues through any other).  The port's copy of
``semantic_router_tpu.router.responseapi``.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class StoredResponse:
    id: str
    model: str
    messages: List[dict]  # full conversation incl. the assistant turn
    created_t: float = field(default_factory=time.time)
    metadata: Dict[str, Any] = field(default_factory=dict)


class ResponseStore:
    """In-memory response/conversation persistence (pkg/responsestore)."""

    def __init__(self, max_entries: int = 10_000,
                 ttl_seconds: float = 86_400.0) -> None:
        self.max_entries = max_entries
        self.ttl_seconds = ttl_seconds
        self._items: Dict[str, StoredResponse] = {}
        self._lock = threading.Lock()

    def put(self, resp: StoredResponse) -> None:
        with self._lock:
            # insertion order == age (created_t monotonic): O(1) eviction
            while len(self._items) >= self.max_entries:
                self._items.pop(next(iter(self._items)))
            self._items[resp.id] = resp

    def get(self, response_id: str) -> Optional[StoredResponse]:
        with self._lock:
            resp = self._items.get(response_id)
            if resp and time.time() - resp.created_t > self.ttl_seconds:
                del self._items[response_id]
                return None
            return resp

    def delete(self, response_id: str) -> bool:
        with self._lock:
            return self._items.pop(response_id, None) is not None


class RedisResponseStore:
    """Redis/Valkey-backed response store (pkg/responsestore redis backend):
    conversation threads survive restarts and are shared across replicas.
    Same surface as ResponseStore; entries carry a server-side TTL."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 db: int = 0, password: str = "",
                 key_prefix: str = "vsr:resp",
                 ttl_seconds: float = 86_400.0, client=None) -> None:
        from ..state.resp import RedisClient

        self.prefix = key_prefix
        self.ttl_seconds = ttl_seconds
        self.client = client or RedisClient(host, port, db, password)

    def _key(self, response_id: str) -> str:
        return f"{self.prefix}:{response_id}"

    def put(self, resp: StoredResponse) -> None:
        payload = json.dumps({
            "id": resp.id, "model": resp.model, "messages": resp.messages,
            "created_t": resp.created_t, "metadata": resp.metadata})
        # sub-second TTLs round up to 1s rather than silently never expiring
        ex = max(1, int(round(self.ttl_seconds))) \
            if self.ttl_seconds > 0 else None
        try:
            self.client.set(self._key(resp.id), payload, ex=ex)
        except Exception:
            pass  # fail open: thread continuity degrades, requests succeed

    def get(self, response_id: str) -> Optional[StoredResponse]:
        try:
            raw = self.client.get(self._key(response_id))
            if not raw:
                return None
            d = json.loads(raw)
            return StoredResponse(id=d["id"], model=d.get("model", ""),
                                  messages=d.get("messages", []),
                                  created_t=d.get("created_t", time.time()),
                                  metadata=d.get("metadata", {}))
        except Exception:
            # unreachable store, WRONGTYPE collision, corrupt payload,
            # foreign schema — all degrade to "no stored thread", never 500
            return None

    def delete(self, response_id: str) -> bool:
        try:
            return bool(self.client.delete(self._key(response_id)))
        except Exception:
            return False


def build_response_store(cfg: Dict[str, Any]):
    """Factory from the ``response_store`` config block: the in-memory
    store (``backend: memory``, the default), a ``RedisResponseStore`` on
    one server (``redis`` / ``valkey``: host, port, db, password) or on a
    cluster (``redis-cluster`` / ``valkey-cluster``: ``nodes``, the slot
    map read at build).  Any other backend gets the in-memory store, as
    the reference's does."""
    cfg = cfg or {}
    backend = str(cfg.get("backend", "memory") or "memory")
    if backend in ("redis-cluster", "valkey-cluster"):
        from ..state.rediscluster import RedisClusterClient

        nodes = [(str(n.get("host", "127.0.0.1")), int(n.get("port")))
                 for n in cfg.get("nodes", []) or []]
        client = RedisClusterClient(nodes,
                                    password=str(cfg.get("password", "")))
        client.refresh_slots()
        return RedisResponseStore(
            key_prefix=cfg.get("key_prefix", "vsr:resp"),
            ttl_seconds=float(cfg.get("ttl_seconds", 86_400.0)),
            client=client)
    if backend in ("redis", "valkey"):
        return RedisResponseStore(
            host=cfg.get("host", "127.0.0.1"),
            port=int(cfg.get("port", 6379)),
            db=int(cfg.get("db", 0)),
            password=str(cfg.get("password", "")),
            key_prefix=cfg.get("key_prefix", "vsr:resp"),
            ttl_seconds=float(cfg.get("ttl_seconds", 86_400.0)))
    return ResponseStore(
        max_entries=int(cfg.get("max_entries", 10_000)),
        ttl_seconds=float(cfg.get("ttl_seconds", 86_400.0)))


def _input_to_messages(inp: Any) -> List[dict]:
    """Responses API `input` (string | item list) → chat messages."""
    if isinstance(inp, str):
        return [{"role": "user", "content": inp}]
    messages: List[dict] = []
    for item in inp or []:
        itype = item.get("type", "message")
        if itype == "message":
            content = item.get("content", "")
            if isinstance(content, list):
                texts = [c.get("text", "") for c in content
                         if c.get("type") in ("input_text", "output_text",
                                              "text")]
                content = "\n".join(texts)
            messages.append({"role": item.get("role", "user"),
                             "content": content})
        elif itype == "function_call":
            messages.append({"role": "assistant", "content": None,
                             "tool_calls": [{
                                 "id": item.get("call_id", ""),
                                 "type": "function",
                                 "function": {
                                     "name": item.get("name", ""),
                                     "arguments": item.get("arguments",
                                                           "{}")}}]})
        elif itype == "function_call_output":
            messages.append({"role": "tool",
                             "tool_call_id": item.get("call_id", ""),
                             "content": item.get("output", "")})
    return messages


def responses_to_chat(body: Dict[str, Any],
                      store: Optional[ResponseStore] = None
                      ) -> Dict[str, Any]:
    """Responses API request → ChatCompletions request. When
    ``previous_response_id`` is set and found in the store, its conversation
    prefixes the new input (the store interplay,
    req_filter_response_api.go)."""
    messages: List[dict] = []
    if body.get("instructions"):
        messages.append({"role": "system", "content": body["instructions"]})
    prev_id = body.get("previous_response_id")
    if prev_id and store is not None:
        prev = store.get(prev_id)
        if prev is not None:
            messages.extend(m for m in prev.messages
                            if m.get("role") != "system")
    messages.extend(_input_to_messages(body.get("input")))

    out: Dict[str, Any] = {"model": body.get("model", ""),
                           "messages": messages}
    if body.get("max_output_tokens"):
        out["max_tokens"] = body["max_output_tokens"]
    # NOTE: `stream` is intentionally NOT forwarded — the Responses
    # endpoint serves complete Response objects; streaming events are a
    # round-2 item (the chat endpoint streams).
    for k in ("temperature", "top_p", "user", "metadata"):
        if k in body:
            out[k] = body[k]
    if body.get("tools"):
        out["tools"] = [
            {"type": "function",
             "function": {"name": t.get("name", ""),
                          "description": t.get("description", ""),
                          "parameters": t.get("parameters", {})}}
            if t.get("type") == "function" else t
            for t in body["tools"]]
    return out


def chat_sse_to_response_events(chunks, request_body: Dict[str, Any],
                                chat_request: Optional[Dict[str, Any]]
                                = None,
                                store: Optional[ResponseStore] = None):
    """OpenAI chat-completions SSE chunks → Responses API streaming
    events (the reference's missing responseapi streaming surface).

    Yields ``(event_name, payload)`` in the public event order:
    response.created → response.output_item.added →
    response.content_part.added → response.output_text.delta* →
    response.output_text.done → response.content_part.done →
    response.output_item.done → response.completed.  The final completed
    payload is a full response object and the conversation persists via
    ``store`` exactly like the non-streaming path.
    """
    response_id = f"resp_{uuid.uuid4().hex[:24]}"
    item_id = f"msg_{uuid.uuid4().hex[:16]}"
    base = {"id": response_id, "object": "response",
            "created_at": int(time.time()),
            "model": request_body.get("model", ""),
            "status": "in_progress", "output": [],
            "previous_response_id":
                request_body.get("previous_response_id"),
            "metadata": request_body.get("metadata") or {}}
    yield "response.created", {"type": "response.created",
                               "response": dict(base)}
    yield "response.output_item.added", {
        "type": "response.output_item.added", "output_index": 0,
        "item": {"type": "message", "id": item_id, "role": "assistant",
                 "status": "in_progress", "content": []}}
    yield "response.content_part.added", {
        "type": "response.content_part.added", "item_id": item_id,
        "output_index": 0, "content_index": 0,
        "part": {"type": "output_text", "text": "", "annotations": []}}

    text_parts: List[str] = []
    usage: Dict[str, Any] = {}
    model = base["model"]
    for chunk in chunks:
        model = chunk.get("model", model)
        if chunk.get("usage"):
            usage = chunk["usage"]
        for choice in chunk.get("choices", ()):
            delta = (choice.get("delta") or {}).get("content")
            if delta:
                text_parts.append(delta)
                yield "response.output_text.delta", {
                    "type": "response.output_text.delta",
                    "item_id": item_id, "output_index": 0,
                    "content_index": 0, "delta": delta}

    text = "".join(text_parts)
    yield "response.output_text.done", {
        "type": "response.output_text.done", "item_id": item_id,
        "output_index": 0, "content_index": 0, "text": text}
    yield "response.content_part.done", {
        "type": "response.content_part.done", "item_id": item_id,
        "output_index": 0, "content_index": 0,
        "part": {"type": "output_text", "text": text, "annotations": []}}
    yield "response.output_item.done", {
        "type": "response.output_item.done", "output_index": 0,
        "item": {"type": "message", "id": item_id, "role": "assistant",
                 "status": "completed",
                 "content": [{"type": "output_text", "text": text,
                              "annotations": []}]}}
    final_chat = {"choices": [{"message": {"role": "assistant",
                                           "content": text},
                               "finish_reason": "stop"}],
                  "model": model, "usage": usage}
    final = chat_to_response(final_chat, request_body,
                             chat_request=chat_request, store=store,
                             response_id=response_id)
    yield "response.completed", {"type": "response.completed",
                                 "response": final}


def build_incomplete_response(created: Dict[str, Any], item_id: str,
                              partial_text: str) -> Dict[str, Any]:
    """The terminal ``response`` object for a stream whose upstream died
    mid-generation: the created base marked incomplete, carrying whatever
    text was already streamed. Lives here so the wire shape stays owned
    by the same module that builds every other response object."""
    failed = dict(created)
    failed["status"] = "incomplete"
    failed["incomplete_details"] = {"reason": "upstream_disconnected"}
    failed["output"] = [{
        "type": "message", "id": item_id, "role": "assistant",
        "status": "incomplete",
        "content": [{"type": "output_text", "text": partial_text,
                     "annotations": []}]}]
    return failed


def chat_to_response(chat_resp: Dict[str, Any], request_body: Dict[str, Any],
                     chat_request: Optional[Dict[str, Any]] = None,
                     store: Optional[ResponseStore] = None,
                     response_id: str = "") -> Dict[str, Any]:
    """ChatCompletions response → Responses API response object; persists
    the conversation when store=True on the request (the API default).
    ``response_id`` lets the streaming path store under the id its events
    already announced (a mismatch would break previous_response_id)."""
    choice = (chat_resp.get("choices") or [{}])[0]
    msg = choice.get("message") or {}
    response_id = response_id or f"resp_{uuid.uuid4().hex[:24]}"
    output: List[dict] = []
    if msg.get("content"):
        output.append({
            "type": "message", "id": f"msg_{uuid.uuid4().hex[:16]}",
            "role": "assistant", "status": "completed",
            "content": [{"type": "output_text", "text": msg["content"],
                         "annotations": []}]})
    for tc in msg.get("tool_calls") or []:
        fn = tc.get("function", {})
        output.append({"type": "function_call",
                       "call_id": tc.get("id", ""),
                       "name": fn.get("name", ""),
                       "arguments": fn.get("arguments", "{}"),
                       "status": "completed"})
    usage = chat_resp.get("usage") or {}
    result = {
        "id": response_id,
        "object": "response",
        "created_at": int(time.time()),
        "model": chat_resp.get("model", request_body.get("model", "")),
        "status": "completed",
        "output": output,
        "output_text": msg.get("content") or "",
        "previous_response_id": request_body.get("previous_response_id"),
        "usage": {"input_tokens": usage.get("prompt_tokens", 0),
                  "output_tokens": usage.get("completion_tokens", 0),
                  "total_tokens": usage.get("total_tokens", 0)},
        "metadata": request_body.get("metadata") or {},
    }
    if store is not None and request_body.get("store", True):
        conversation = list((chat_request or {}).get("messages", []))
        if msg.get("content") or msg.get("tool_calls"):
            conversation.append({"role": "assistant",
                                 "content": msg.get("content") or "",
                                 **({"tool_calls": msg["tool_calls"]}
                                    if msg.get("tool_calls") else {})})
        store.put(StoredResponse(id=response_id,
                                 model=result["model"],
                                 messages=conversation,
                                 metadata=result["metadata"]))
    return result
