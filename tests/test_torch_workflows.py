"""The port's workflows engine (looper/workflows.py) against the JAX one,
each over a scripted client (as the reference's tests/test_workflows.py
drives it): plan extraction and validation, static and dynamic modes,
access lists, the planner's fallback under ``on_error: skip``, a tool
interrupt (state id in each tool-call id) and its resume through the
in-memory state store, a chained interrupt, an interrupt in the final
synthesis, the output contracts and the fallback final.  Answers, traces,
usage and every call are equal after the random ids (state ids,
completion ids) and ``created`` are renumbered."""

import copy
import json
import re

import pytest

from semantic_router_tpu.config.schema import ModelRef as JModelRef
from semantic_router_tpu.looper import workflows as jw
from semantic_router_tpu_torch.config import ModelRef
from semantic_router_tpu_torch.looper import workflows as tw

_RANDOM = re.compile(r"(vsrwf-|state ')([0-9a-f]{16})"
                     r"|(chatcmpl-)([0-9a-f]{24})")


def normalize(obj):
    """JSON of ``obj`` with state / completion ids renumbered by first
    appearance and ``created`` zeroed."""
    text = json.dumps(obj, sort_keys=True, default=repr)
    ids: dict = {}

    def repl(m):
        prefix = m.group(1) or m.group(3)
        key = m.group(2) or m.group(4)
        return prefix + ids.setdefault(key, f"#{len(ids)}")

    text = re.sub(r'"created": \d+', '"created": 0', text)
    return _RANDOM.sub(repl, text)


def chat(text, **kw):
    return {"model": "auto",
            "messages": [{"role": "user", "content": text}], **kw}


def reply(text, model="m", usage=None, tool_calls=None):
    msg = {"role": "assistant", "content": text}
    if tool_calls:
        msg["tool_calls"] = tool_calls
        msg["content"] = None
    return {"choices": [{"message": msg, "finish_reason":
                         "tool_calls" if tool_calls else "stop"}],
            "model": model, "usage": usage or {"total_tokens": 7}}


class ScriptedClient:
    def __init__(self, script):
        self.script = copy.deepcopy(script)
        self.calls = []

    def complete(self, body, model, headers=None):
        self.calls.append({"model": model, "body": copy.deepcopy(body),
                           "headers": dict(headers or {})})
        responses = self.script.get(model)
        if not responses:
            raise RuntimeError(f"no scripted response for {model}")
        resp = responses.pop(0)
        if isinstance(resp, Exception):
            raise resp
        return copy.deepcopy(resp)


TOOL_CALL = {"id": "call_orig1", "type": "function",
             "function": {"name": "search_web", "arguments": '{"q": "x"}'}}
TOOLS = [{"type": "function", "function": {"name": "search_web"}}]
PLAN = {"steps": [
    {"id": "research", "role": "r", "models": ["worker-a"],
     "prompt": "Find facts."},
    {"id": "write", "role": "w", "models": ["worker-b"],
     "prompt": "Write it.", "access_list": ["research"]}],
    "final": {"model": "worker-b", "prompt": "Polish."}}
STATIC = {"mode": "static", "roles": [
    {"id": "s1", "models": ["worker-a", "worker-b"], "prompt": "Draft."},
    {"id": "s2", "models": ["worker-b"], "prompt": "Review.",
     "access_list": []}],
    "final": {"model": "worker-a", "prompt": "Fuse."},
    "include_intermediate_responses": True}

SCENARIOS = {
    "static": (STATIC, {
        "worker-a": [reply("draft a", "worker-a"),
                     reply("final a", "worker-a")],
        "worker-b": [reply("draft b", "worker-b"),
                     reply("review b", "worker-b")]}, chat("do it")),
    "static_max_parallel_1": (dict(STATIC, max_parallel=1), {
        "worker-a": [reply("draft a", "worker-a"),
                     reply("final a", "worker-a")],
        "worker-b": [reply("draft b", "worker-b"),
                     reply("review b", "worker-b")]}, chat("do it")),
    "dynamic": ({"mode": "dynamic", "planner_model": "worker-a"}, {
        "worker-a": [reply("```json\n" + json.dumps(PLAN) + "\n```"),
                     reply("facts", "worker-a")],
        "worker-b": [reply("text", "worker-b"),
                     reply("polished", "worker-b")]}, chat("write")),
    "dynamic_bad_plan_raises": ({"mode": "dynamic"}, {
        "worker-a": [reply("no plan here")]}, chat("write")),
    "dynamic_bad_plan_skips": ({"mode": "dynamic", "on_error": "skip"}, {
        "worker-a": [reply("no plan here"), reply("a says", "worker-a")],
        "worker-b": [reply("b says", "worker-b"),
                     reply("final", "worker-b")]}, chat("write")),
    "json_action": (dict(STATIC, output_contract={"type": "json_action"}), {
        "worker-a": [reply('prefix {"action": "go"} suffix', "worker-a"),
                     reply("no json in final", "worker-a")],
        "worker-b": [reply("draft b", "worker-b"),
                     reply("review b", "worker-b")]}, chat("act")),
    "reference_selection": (dict(STATIC, output_contract={
        "type": "reference_selection"}), {
        "worker-a": [reply("cand one", "worker-a"),
                     reply("I pick 2", "worker-a")],
        "worker-b": [reply("cand two", "worker-b"),
                     reply("cand three", "worker-b")]}, chat("choose")),
    "fallback_final": (dict(STATIC, on_error="skip"), {
        "worker-a": [reply("short", "worker-a"), RuntimeError("down")],
        "worker-b": [reply("a longer answer", "worker-b"),
                     reply("mid", "worker-b")]}, chat("go")),
    "final_fails": (STATIC, {
        "worker-a": [reply("x", "worker-a"), RuntimeError("down")],
        "worker-b": [reply("y", "worker-b"), reply("z", "worker-b")]},
        chat("go")),
    "step_fails": ({"mode": "static", "roles": [
        {"id": "s1", "models": ["worker-a"], "prompt": "Do."}],
        "min_successful": 1}, {"worker-a": [RuntimeError("401")]},
        chat("go")),
    "unknown_model": ({"mode": "static", "roles": [
        {"id": "s1", "models": ["nobody"], "prompt": "Do."}]}, {},
        chat("go")),
    "interrupt": ({"mode": "static", "roles": [
        {"id": "s1", "models": ["worker-a"], "prompt": "Use tools."}],
        "final": {"model": "worker-a"}}, {
        "worker-a": [reply(None, "worker-a", tool_calls=[TOOL_CALL])]},
        chat("look this up", tools=TOOLS)),
}


def _execute(mod, ref_cls, algorithm, script, body, store=None):
    client = ScriptedClient(script)
    wf = mod.WorkflowsLooper(client, state_store=store)
    refs = [ref_cls(model="worker-a"), ref_cls(model="worker-b")]
    try:
        res = wf.execute({"workflows": copy.deepcopy(algorithm)}, refs,
                         copy.deepcopy(body), headers={"x-t": "1"},
                         headers_for=lambda m: {"authorization": m})
        out = ["ok", res.body, res.model, res.algorithm,
               res.candidates_used, res.usage, res.rounds]
    except (RuntimeError, ValueError) as exc:
        out = ["error", type(exc).__name__, str(exc)]
    finally:
        wf.shutdown()
    return out, sorted(client.calls, key=lambda c: json.dumps(
        c, sort_keys=True))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_workflow_matches_the_reference(name):
    algorithm, script, body = SCENARIOS[name]
    got = _execute(tw, ModelRef, algorithm, script, body)
    want = _execute(jw, JModelRef, algorithm, script, body)
    assert normalize(got) == normalize(want)


def _resume_body(first_body, tc_id, content="tool says 42"):
    body = chat("look this up")
    body["messages"] += [first_body["choices"][0]["message"],
                         {"role": "tool", "tool_call_id": tc_id,
                          "content": content}]
    return body


@pytest.mark.parametrize("resume_script", [
    # the model answers after the tool result, then the final
    {"worker-a": [reply("answer using 42", "worker-a"),
                  reply("final: 42", "worker-a")]},
    # the model chains a second tool call
    {"worker-a": [reply(None, "worker-a", tool_calls=[
        dict(TOOL_CALL, id="call_orig2")])]},
    # the final synthesis itself asks for a tool
    {"worker-a": [reply("step done", "worker-a"),
                  reply(None, "worker-a", tool_calls=[TOOL_CALL])]},
])
def test_interrupt_and_resume_match_the_reference(resume_script):
    algorithm, script, body = SCENARIOS["interrupt"]
    rows = []
    for mod, ref in ((tw, ModelRef), (jw, JModelRef)):
        store = mod.MemoryWorkflowStateStore()
        (status, first, *_), _ = _execute(mod, ref, algorithm, script, body,
                                          store)
        assert status == "ok"
        tc_id = first["choices"][0]["message"]["tool_calls"][0]["id"]
        state_id = mod.parse_tool_call_state_id(tc_id)
        assert tc_id.endswith("::call_orig1") and state_id
        resume = _resume_body(first, tc_id)
        assert mod.find_workflow_state_id(resume) == state_id
        second = _execute(mod, ref, {}, resume_script, resume, store)
        # the state was taken: a second resume of it fails
        again = _execute(mod, ref, {}, resume_script, resume, store)
        rows.append((first, second, again[0]))
    assert normalize(rows[0]) == normalize(rows[1])


@pytest.mark.parametrize("text", [
    "```json\n{\"steps\": []}\n```", "prefix {\"a\": 1} suffix",
    "{\"a\": {\"b\": [1, 2]}}", "no json", "[1, 2]", "{broken",
])
def test_json_extraction_matches_the_reference(text):
    assert tw.extract_json_object(text) == jw.extract_json_object(text)


@pytest.mark.parametrize("plan", [
    {"steps": []},
    {"steps": [{"id": "a", "prompt": "p"}, {"id": "a", "prompt": "q"}]},
    {"steps": [{"id": "a", "models": ["ghost"], "prompt": "p"}]},
    {"steps": [{"id": "a", "models": ["worker-a"]}]},
    {"steps": [{"id": "a", "prompt": "p", "access_list": ["b"]},
               {"id": "b", "prompt": "q"}]},
    {"steps": [{"prompt": "p"}], "final": {"model": "ghost"}},
    {"steps": [{"prompt": "p"}] * 5},
    {"steps": [{"prompt": "p"}, {"prompt": "q", "access_list": []}]},
])
def test_plan_validation_matches_the_reference(plan):
    out = []
    for mod in (tw, jw):
        p = mod.WorkflowPlan.from_dict(copy.deepcopy(plan))
        try:
            mod.validate_plan(p, ["worker-a", "worker-b"],
                              mod.WorkflowConfig())
            out.append(("ok", p.to_dict()))
        except ValueError as exc:
            out.append(("error", str(exc)))
    assert out[0] == out[1]


def test_state_store_expires_like_the_reference(monkeypatch):
    now = [100.0]
    seen = []
    for mod in (tw, jw):
        monkeypatch.setattr(mod.time, "time", lambda: now[0])
        store = mod.MemoryWorkflowStateStore(ttl_s=5.0)
        now[0] = 100.0
        for sid in ("s1", "s2"):
            store.put(mod.PendingToolState(
                state_id=sid, phase="step", step_index=0, model="m",
                messages=[], plan={}, step_results=[],
                sibling_responses=[], original_body={}, config={},
                created_t=now[0]))
        first = store.take("s1") is not None
        now[0] = 106.0
        seen.append((first, store.take("s2") is not None,
                     store.take("s1") is not None))
    assert seen[0] == seen[1] == (True, False, False)


@pytest.mark.parametrize("backend", ["redis", "valkey"])
def test_resp_backed_state_is_refused_by_name(backend):
    # served since the RESP family was ported: the port builds the store
    # the reference builds
    cfg = {"workflow_state": {"backend": backend, "port": 1,
                              "ttl_seconds": 9}}
    got, want = tw.build_workflow_state_store(cfg), \
        jw.build_workflow_state_store(cfg)
    assert type(got).__name__ == type(want).__name__ == \
        "RedisWorkflowStateStore"
    assert (got.prefix, got.ttl_s, got.client.port) == \
        (want.prefix, want.ttl_s, want.client.port)
    assert isinstance(tw.build_workflow_state_store(
        {"workflow_state": {"ttl_seconds": 9}}),
        tw.MemoryWorkflowStateStore)
