"""The port's Anthropic Messages translation (router/anthropic.py) against
the JAX one: requests in (system blocks, images, tool use and results,
thinking, stop sequences), answers out (text, tool calls, each finish
reason), the request sniffer, and the SSE re-synthesis of a chunk stream
(text, empty deltas, a finish with usage, a stream cut before its
finish).  Equal after the random message id is set aside."""

import copy
import json

import pytest

from semantic_router_tpu.router import anthropic as ja
from semantic_router_tpu_torch.router import anthropic as ta

REQUESTS = {
    "plain": {"model": "claude", "max_tokens": 64,
              "messages": [{"role": "user", "content": "hello"}]},
    "system_string": {"model": "claude", "max_tokens": 8,
                      "system": "be brief", "temperature": 0.2,
                      "top_p": 0.9, "stream": True,
                      "messages": [{"role": "user", "content": "hi"}]},
    "system_blocks": {"model": "claude", "system": [
        {"type": "text", "text": "rule one"},
        {"type": "text", "text": "rule two",
         "cache_control": {"type": "ephemeral"}}],
        "messages": [{"role": "user", "content": "hi"}]},
    "image_block": {"model": "claude", "messages": [{"role": "user",
        "content": [{"type": "text", "text": "what is this"},
                    {"type": "image", "source": {
                        "type": "base64", "media_type": "image/png",
                        "data": "iVBORw0KGgo" * 20}}]}]},
    "image_url": {"model": "claude", "messages": [{"role": "user",
        "content": [{"type": "image", "source": {
            "type": "url", "url": "https://example.com/cat.png"}}]}]},
    "tool_use": {"model": "claude", "tools": [
        {"name": "search", "description": "web search",
         "input_schema": {"type": "object",
                          "properties": {"q": {"type": "string"}}}}],
        "messages": [
            {"role": "user", "content": "look it up"},
            {"role": "assistant", "content": [
                {"type": "text", "text": "searching"},
                {"type": "tool_use", "id": "tu_1", "name": "search",
                 "input": {"q": "tpu"}}]},
            {"role": "user", "content": [
                {"type": "tool_result", "tool_use_id": "tu_1",
                 "content": [{"type": "text", "text": "found it"}]},
                {"type": "text", "text": "now answer"}]}]},
    "thinking": {"model": "claude", "thinking": {"type": "enabled",
                                                  "budget_tokens": 512},
                 "stop_sequences": ["END"], "metadata": {"user_id": "u1"},
                 "messages": [{"role": "assistant", "content": [
                     {"type": "thinking", "thinking": "hmm"},
                     {"type": "text", "text": "ok"}]},
                     {"role": "user", "content": "go on"}]},
    "empty": {},
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_request_translates_like_the_reference(name):
    body = REQUESTS[name]
    assert ta.anthropic_to_openai(copy.deepcopy(body)) == \
        ja.anthropic_to_openai(copy.deepcopy(body))


def _completion(finish="stop", content="the answer", tool_calls=None,
                usage=True, with_id=True):
    msg = {"role": "assistant", "content": content}
    if tool_calls is not None:
        msg["tool_calls"] = tool_calls
    out = {"model": "m", "choices": [{"index": 0, "message": msg,
                                      "finish_reason": finish}]}
    if with_id:
        out["id"] = "chatcmpl-1"
    if usage:
        out["usage"] = {"prompt_tokens": 11, "completion_tokens": 7,
                        "total_tokens": 18}
    return out


ANSWERS = {
    "stop": _completion(),
    "length": _completion("length"),
    "tool_calls": _completion("tool_calls", None, [
        {"id": "call_1", "type": "function",
         "function": {"name": "search", "arguments": '{"q": "x"}'}},
        {"id": "call_2", "type": "function",
         "function": {"name": "bad", "arguments": "{not json"}}]),
    "content_filter": _completion("content_filter"),
    "unknown_finish": _completion("weird"),
    "no_usage": _completion(usage=False),
    "no_id": _completion(with_id=False),
    "no_choices": {"model": "m"},
}


def _strip_generated_id(msg: dict, original: dict) -> dict:
    out = dict(msg)
    if "id" not in original:
        assert out.pop("id").startswith("msg_")
    return out


@pytest.mark.parametrize("name", sorted(ANSWERS))
def test_answer_translates_like_the_reference(name):
    body = ANSWERS[name]
    got = ta.openai_to_anthropic_response(copy.deepcopy(body))
    want = ja.openai_to_anthropic_response(copy.deepcopy(body))
    assert _strip_generated_id(got, body) == _strip_generated_id(want, body)


@pytest.mark.parametrize("path, body", [
    ("/v1/messages", {}),
    ("/v1/chat/completions", {"max_tokens": 1, "system": "s",
                              "messages": [], "anthropic_version": "x"}),
    ("/v1/chat/completions", {"max_tokens": 1, "messages": []}),
])
def test_request_sniffer_agrees(path, body):
    assert ta.is_anthropic_request(path, body) == \
        ja.is_anthropic_request(path, body)


def _chunk(content=None, finish=None, usage=None):
    c = {"id": "chatcmpl-s", "model": "m", "object": "chat.completion.chunk",
         "choices": [{"index": 0, "delta": {} if content is None
                      else {"content": content}, "finish_reason": finish}]}
    if usage:
        c["usage"] = usage
    return c


STREAMS = {
    "text": [_chunk("Hel"), _chunk("lo"), _chunk(finish="stop",
                                                 usage={"completion_tokens":
                                                        2})],
    "empty_deltas": [_chunk(""), _chunk("x"), _chunk(None),
                     _chunk(finish="length")],
    "cut_before_finish": [_chunk("partial"), _chunk(" text")],
    "finish_only": [_chunk(finish="tool_calls")],
    "nothing": [],
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_sse_resynthesis_matches_the_reference(name):
    chunks = STREAMS[name]
    got = list(ta.openai_sse_to_anthropic_events(iter(copy.deepcopy(chunks))))
    want = list(ja.openai_sse_to_anthropic_events(
        iter(copy.deepcopy(chunks))))
    assert json.dumps(got) == json.dumps(want)
