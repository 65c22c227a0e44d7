"""The port's Responses API translation and store (router/responseapi.py)
against the JAX ones: requests in (string and item input, function
calls and their outputs, instructions, tools, ``previous_response_id``
threading through the store), answers out (text, tool calls, usage,
``store: false``), the streamed event sequence, the incomplete
response, and the in-memory store's eviction and TTL.  Equal after the
random and time-based fields are renumbered (``resp_…`` / ``msg_…`` ids
by first appearance, ``created_at``)."""

import copy
import json
import re

import pytest

from semantic_router_tpu.router import responseapi as jr
from semantic_router_tpu_torch.router import responseapi as tr

_ID = re.compile(r"^(resp|msg)_[0-9a-f]+$")


def normalize(obj, ids=None):
    """``obj`` with every ``resp_…`` / ``msg_…`` id replaced by its order
    of first appearance and ``created_at`` by 0."""
    ids = {} if ids is None else ids
    if isinstance(obj, dict):
        return {k: 0 if k == "created_at" else normalize(v, ids)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [normalize(v, ids) for v in obj]
    if isinstance(obj, str) and _ID.match(obj):
        kind = obj.split("_", 1)[0]
        return ids.setdefault(obj, f"{kind}_#{len(ids)}")
    return obj


INPUTS = {
    "string": {"model": "auto", "input": "hello"},
    "items": {"model": "auto", "instructions": "be brief",
              "max_output_tokens": 32, "temperature": 0.1, "top_p": 0.5,
              "user": "u1", "metadata": {"k": "v"},
              "input": [
                  {"type": "message", "role": "user", "content": [
                      {"type": "input_text", "text": "part one"},
                      {"type": "input_text", "text": "part two"},
                      {"type": "input_image", "image_url": "x"}]},
                  {"type": "function_call", "call_id": "c1",
                   "name": "search", "arguments": '{"q": 1}'},
                  {"type": "function_call_output", "call_id": "c1",
                   "output": "42"}]},
    "tools": {"model": "auto", "input": "use a tool", "stream": True,
              "tools": [{"type": "function", "name": "search",
                         "description": "d", "parameters": {"type":
                                                            "object"}},
                        {"type": "web_search"}]},
    "unknown_previous": {"model": "auto", "input": "again",
                         "previous_response_id": "resp_missing"},
}


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_request_translates_like_the_reference(name):
    body = INPUTS[name]
    assert tr.responses_to_chat(copy.deepcopy(body), tr.ResponseStore()) \
        == jr.responses_to_chat(copy.deepcopy(body), jr.ResponseStore())


def _chat_answer(content="the answer", tool_calls=None):
    msg = {"role": "assistant", "content": content}
    if tool_calls:
        msg["tool_calls"] = tool_calls
    return {"model": "m1", "choices": [{"message": msg,
                                        "finish_reason": "stop"}],
            "usage": {"prompt_tokens": 5, "completion_tokens": 3,
                      "total_tokens": 8}}


ANSWERS = {
    "text": (_chat_answer(), {"model": "auto", "input": "q"}),
    "tool_calls": (_chat_answer(None, [{"id": "c9", "type": "function",
                                        "function": {"name": "f",
                                                     "arguments": "{}"}}]),
                   {"model": "auto", "input": "q", "metadata": {"a": 1}}),
    "not_stored": (_chat_answer(), {"model": "auto", "input": "q",
                                    "store": False}),
    "empty": ({}, {"model": "auto", "input": "q"}),
}


@pytest.mark.parametrize("name", sorted(ANSWERS))
def test_answer_translates_and_stores_like_the_reference(name):
    answer, request = ANSWERS[name]
    chat_req = tr.responses_to_chat(copy.deepcopy(request))
    stores = (tr.ResponseStore(), jr.ResponseStore())
    got = tr.chat_to_response(copy.deepcopy(answer), request,
                              chat_request=chat_req, store=stores[0])
    want = jr.chat_to_response(copy.deepcopy(answer), request,
                               chat_request=chat_req, store=stores[1])
    assert normalize(got) == normalize(want)
    kept = [s.get(r["id"]) for s, r in zip(stores, (got, want))]
    assert (kept[0] is None) == (kept[1] is None)
    if kept[0] is not None:
        assert (kept[0].model, kept[0].messages, kept[0].metadata) == \
            (kept[1].model, kept[1].messages, kept[1].metadata)


def test_previous_response_id_threads_a_three_turn_chain():
    """Each turn stores its conversation; the next turn's chat request
    starts with it (instructions of an earlier turn are not carried)."""
    rows = []
    for mod in (tr, jr):
        store = mod.ResponseStore()
        prev, chats = None, []
        for i, text in enumerate(["first", "second", "third"]):
            req = {"model": "auto", "input": text,
                   "instructions": f"turn {i}"}
            if prev:
                req["previous_response_id"] = prev
            chat = mod.responses_to_chat(req, store)
            chats.append(chat)
            out = mod.chat_to_response(_chat_answer(f"answer {i}"), req,
                                       chat_request=chat, store=store)
            prev = out["id"]
        rows.append(chats)
    assert rows[0] == rows[1]
    assert [m["content"] for m in rows[0][2]["messages"]] == [
        "turn 2", "first", "answer 0", "second", "answer 1", "third"]


def _chunks(texts, finish=True, usage=None):
    out = [{"model": "m1", "choices": [{"delta": {"content": t},
                                        "finish_reason": None}]}
           for t in texts]
    if finish:
        out.append({"model": "m1", "choices": [{"delta": {},
                                                "finish_reason": "stop"}],
                    "usage": usage or {}})
    return out


@pytest.mark.parametrize("texts, finish", [
    (["Hel", "lo ", "world"], True),
    ([], True),
    (["only"], False),
])
def test_streamed_events_match_the_reference(texts, finish):
    request = {"model": "auto", "input": "q", "metadata": {"t": 1}}
    chat_req = {"model": "auto", "messages": [{"role": "user",
                                               "content": "q"}]}
    got = list(tr.chat_sse_to_response_events(
        iter(_chunks(texts, finish, {"prompt_tokens": 2})), request,
        chat_request=chat_req, store=tr.ResponseStore()))
    want = list(jr.chat_sse_to_response_events(
        iter(_chunks(texts, finish, {"prompt_tokens": 2})), request,
        chat_request=chat_req, store=jr.ResponseStore()))
    assert [e for e, _ in got] == [e for e, _ in want]
    assert normalize(got) == normalize(want)
    # the completed response carries the id the created event announced
    assert got[0][1]["response"]["id"] == got[-1][1]["response"]["id"]


def test_incomplete_response_matches_the_reference():
    created = {"id": "resp_0abc", "object": "response", "created_at": 5,
               "status": "in_progress", "output": [], "model": "m"}
    got = tr.build_incomplete_response(dict(created), "msg_1f", "part")
    want = jr.build_incomplete_response(dict(created), "msg_1f", "part")
    assert got == want
    assert got["status"] == "incomplete"


def test_store_evicts_oldest_and_expires(monkeypatch):
    now = [1000.0]
    for mod in (tr, jr):
        monkeypatch.setattr(mod.time, "time", lambda: now[0])
    stores = (tr.ResponseStore(max_entries=2, ttl_seconds=10.0),
              jr.ResponseStore(max_entries=2, ttl_seconds=10.0))
    seen = []
    for s, mod in zip(stores, (tr, jr)):
        now[0] = 1000.0
        for i in range(3):
            s.put(mod.StoredResponse(id=f"r{i}", model="m", messages=[],
                                     created_t=now[0]))
        row = [s.get(f"r{i}") is not None for i in range(3)]
        now[0] = 1011.0
        row.append(s.get("r2") is not None)
        row.append(s.delete("r1"))
        seen.append(row)
    assert seen[0] == seen[1] == [False, True, True, False, True]


@pytest.mark.parametrize("cfg", [{}, {"backend": "memory",
                                      "max_entries": 3,
                                      "ttl_seconds": 7}])
def test_memory_store_builds_like_the_reference(cfg):
    got, want = tr.build_response_store(cfg), jr.build_response_store(cfg)
    assert type(got).__name__ == type(want).__name__ == "ResponseStore"
    assert (got.max_entries, got.ttl_seconds) == \
        (want.max_entries, want.ttl_seconds)


@pytest.mark.parametrize("backend", ["redis", "valkey", "redis-cluster",
                                     "valkey-cluster"])
def test_resp_backed_store_is_refused_by_name(backend):
    # served since the RESP family was ported: the port builds the store
    # the reference builds (a cluster over no reachable node keeps an
    # empty slot map); an unknown backend stays refused by name
    cfg = {"backend": backend, "key_prefix": "p", "ttl_seconds": 9,
           "port": 1, "nodes": [{"host": "127.0.0.1", "port": 1}]}
    got, want = tr.build_response_store(cfg), jr.build_response_store(cfg)
    assert type(got).__name__ == type(want).__name__ == "RedisResponseStore"
    assert (got.prefix, got.ttl_seconds) == (want.prefix,
                                             want.ttl_seconds) == ("p", 9.0)
    assert type(got.client).__name__ == type(want.client).__name__
    with pytest.raises(ValueError, match="response_store.backend"):
        tr.build_response_store({"backend": backend + "-x"})


def test_events_are_json_serializable():
    events = list(tr.chat_sse_to_response_events(
        iter(_chunks(["a"])), {"model": "auto"}))
    json.dumps(events)
