"""Anthropic Messages ⇄ OpenAI ChatCompletions translation cell (the
port's copy of ``semantic_router_tpu.router.anthropic``).

Capability parity with pkg/anthropic (7.5k LoC: inbound.go request
translation, outbound.go response re-emit, sse_out.go streaming
re-synthesis, passthrough.go). Inbound Anthropic requests translate to the
internal OpenAI shape for the signal/decision pipeline; responses translate
back; fields with no OpenAI representation ride a sidecar extension dict
keyed by JSON paths (pkg/ir extensions, ir/extensions.go:1-30).
"""

from __future__ import annotations

import json
import uuid
from typing import Any, Dict, Iterator, List, Tuple

EXTENSION_KEY = "_vsr_ext"  # sidecar envelope for untranslatable fields


def _flatten_content(content: Any) -> Tuple[str, List[dict]]:
    """Anthropic content (str | blocks) → (text, extra_parts)."""
    if isinstance(content, str):
        return content, []
    texts, extras = [], []
    for block in content or []:
        btype = block.get("type")
        if btype == "text":
            texts.append(block.get("text", ""))
        elif btype == "image":
            src = block.get("source", {})
            url = src.get("url") or f"data:{src.get('media_type', '')};base64,{src.get('data', '')[:64]}"
            extras.append({"type": "image_url", "image_url": {"url": url}})
        elif btype in ("tool_use", "tool_result"):
            extras.append(block)
    return "\n".join(texts), extras


def anthropic_to_openai(body: Dict[str, Any]) -> Dict[str, Any]:
    """Messages request → ChatCompletions request (inbound.go)."""
    out: Dict[str, Any] = {"model": body.get("model", "")}
    ext: Dict[str, Any] = {}
    messages: List[dict] = []

    system = body.get("system")
    if system:
        if isinstance(system, list):  # system blocks with cache_control
            text = "\n".join(b.get("text", "") for b in system
                             if b.get("type") == "text")
            for i, b in enumerate(system):
                if "cache_control" in b:
                    ext[f"system[{i}].cache_control"] = b["cache_control"]
            messages.append({"role": "system", "content": text})
        else:
            messages.append({"role": "system", "content": system})

    for mi, m in enumerate(body.get("messages", []) or []):
        role = m.get("role", "user")
        text, extras = _flatten_content(m.get("content"))
        tool_calls = []
        tool_results = []
        parts: List[dict] = []
        for e in extras:
            if e.get("type") == "tool_use":
                tool_calls.append({
                    "id": e.get("id", ""),
                    "type": "function",
                    "function": {"name": e.get("name", ""),
                                 "arguments": json.dumps(e.get("input", {}))},
                })
            elif e.get("type") == "tool_result":
                tool_results.append(e)
            else:
                parts.append(e)
        if tool_results:
            for tr in tool_results:
                content = tr.get("content", "")
                if isinstance(content, list):
                    content, _ = _flatten_content(content)
                messages.append({"role": "tool",
                                 "tool_call_id": tr.get("tool_use_id", ""),
                                 "content": content})
            if text:
                messages.append({"role": role, "content": text})
            continue
        msg: Dict[str, Any] = {"role": role}
        if parts:
            content_list = ([{"type": "text", "text": text}] if text else [])
            content_list += parts
            msg["content"] = content_list
        else:
            msg["content"] = text
        if tool_calls:
            msg["tool_calls"] = tool_calls
        thinking = None
        if isinstance(m.get("content"), list):
            for bi, b in enumerate(m["content"]):
                if b.get("type") == "thinking":
                    ext[f"messages[{mi}].content[{bi}].thinking"] = b
        messages.append(msg)

    out["messages"] = messages
    if "max_tokens" in body:
        out["max_tokens"] = body["max_tokens"]
    for k in ("temperature", "top_p", "stream", "stop_sequences", "metadata"):
        if k in body:
            out["stop" if k == "stop_sequences" else k] = body[k]
    if body.get("tools"):
        out["tools"] = [{
            "type": "function",
            "function": {"name": t.get("name", ""),
                         "description": t.get("description", ""),
                         "parameters": t.get("input_schema", {})},
        } for t in body["tools"]]
    if body.get("thinking"):
        ext["thinking"] = body["thinking"]
    if ext:
        out[EXTENSION_KEY] = ext
    return out


_STOP_MAP = {"stop": "end_turn", "length": "max_tokens",
             "tool_calls": "tool_use", "content_filter": "end_turn"}


def openai_to_anthropic_response(body: Dict[str, Any]) -> Dict[str, Any]:
    """ChatCompletions response → Messages response (outbound.go)."""
    choice = (body.get("choices") or [{}])[0]
    msg = choice.get("message") or {}
    content: List[dict] = []
    if msg.get("content"):
        content.append({"type": "text", "text": msg["content"]})
    for tc in msg.get("tool_calls") or []:
        fn = tc.get("function", {})
        try:
            args = json.loads(fn.get("arguments") or "{}")
        except (json.JSONDecodeError, TypeError):
            args = {}
        content.append({"type": "tool_use", "id": tc.get("id", ""),
                        "name": fn.get("name", ""), "input": args})
    usage = body.get("usage") or {}
    return {
        "id": body.get("id", f"msg_{uuid.uuid4().hex[:24]}"),
        "type": "message",
        "role": "assistant",
        "model": body.get("model", ""),
        "content": content,
        "stop_reason": _STOP_MAP.get(choice.get("finish_reason", "stop"),
                                     "end_turn"),
        "stop_sequence": None,
        "usage": {"input_tokens": usage.get("prompt_tokens", 0),
                  "output_tokens": usage.get("completion_tokens", 0)},
    }


def is_anthropic_request(path: str, body: Dict[str, Any]) -> bool:
    return path.endswith("/v1/messages") or (
        "max_tokens" in body and "system" in body
        and "messages" in body and "anthropic_version" in body)


def openai_sse_to_anthropic_events(chunks: Iterator[Dict[str, Any]]
                                   ) -> Iterator[Tuple[str, Dict[str, Any]]]:
    """OpenAI streaming chunks → Anthropic SSE event stream re-synthesis
    (client_stream.go + sse_out.go): message_start → content_block_start →
    content_block_delta* → content_block_stop → message_delta →
    message_stop."""
    started = False
    block_open = False
    model = ""
    for chunk in chunks:
        model = chunk.get("model", model)
        if not started:
            started = True
            yield "message_start", {
                "type": "message_start",
                "message": {"id": chunk.get("id", ""), "type": "message",
                            "role": "assistant", "model": model,
                            "content": [],
                            "usage": {"input_tokens": 0, "output_tokens": 0}}}
        choice = (chunk.get("choices") or [{}])[0]
        delta = choice.get("delta") or {}
        text = delta.get("content")
        if text:
            if not block_open:
                block_open = True
                yield "content_block_start", {
                    "type": "content_block_start", "index": 0,
                    "content_block": {"type": "text", "text": ""}}
            yield "content_block_delta", {
                "type": "content_block_delta", "index": 0,
                "delta": {"type": "text_delta", "text": text}}
        finish = choice.get("finish_reason")
        if finish:
            if block_open:
                yield "content_block_stop", {"type": "content_block_stop",
                                             "index": 0}
                block_open = False
            usage = chunk.get("usage") or {}
            yield "message_delta", {
                "type": "message_delta",
                "delta": {"stop_reason": _STOP_MAP.get(finish, "end_turn"),
                          "stop_sequence": None},
                "usage": {"output_tokens":
                          usage.get("completion_tokens", 0)}}
    if block_open:
        yield "content_block_stop", {"type": "content_block_stop", "index": 0}
    if started:
        yield "message_stop", {"type": "message_stop"}
