"""The chat surface over HTTP: the JAX ``RouterServer`` and the port's,
each in front of a mock backend of its own, over the reference's fixture
config (tests/fixtures/router_config.yaml) plus one decision per looper
algorithm, upstream credentials and skip-processing, on one tiny seeded
engine pair (the fixture's learned tasks, ``nli`` and an embedding task
on one shared trunk).  Each request goes to both servers; status,
content type, every x-vsr-* header but the request and record ids, and
the body (JSON, or each SSE frame) must be equal once the random and
time-based fields are set aside (``id``, ``created``, ``created_at``,
``resp_…`` / ``msg_…`` ids renumbered by first appearance).

Covered: streamed chat (frames relayed as the backend sent them, the
cache written only when the stream completed, a cut stream never cached
and fed back as a failure with its time to first token), Anthropic
``/v1/messages`` streamed and not (and a cache hit translated),
``/v1/responses`` as a three-turn ``previous_response_id`` chain streamed
on its last turn and an upstream death mid-stream
(``response.incomplete``), every looper algorithm (fusion's grounding one
``nli`` forward per panel answer) and a workflows tool interrupt and its
resume, the looper marker's short-circuit, a passthrough through the
response path, the credential header at the backend, a chunked POST, and
``GET /v1/models``."""

import copy
import http.client
import json
import re
import urllib.parse

import numpy as np
import pytest
import torch
import yaml

from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.models.embeddings import \
    MmBertEmbeddingModel as JEmbeddingModel
from semantic_router_tpu.router.pipeline import Router as JRouter
from semantic_router_tpu.router.server import RouterServer as JServer
from semantic_router_tpu.runtime.registry import RuntimeRegistry as \
    JRegistry
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.models import MmBertEmbeddingModel, \
    params_from_flax
from semantic_router_tpu_torch.router import MockVLLMServer, Router, \
    RouterServer
from semantic_router_tpu_torch.router import headers as H
from semantic_router_tpu_torch.runtime import RuntimeRegistry

DOMAINS = ["business", "computer science", "health", "other"]
SEQ_TASKS = [("intent", DOMAINS),
             ("jailbreak", ["benign", "jailbreak"]),
             ("modality", ["AR", "DIFFUSION", "BOTH"]),
             ("fact_check", ["needs_fact_check", "no_fact_check_needed"]),
             ("user_feedback", ["wrong_answer", "need_clarification"]),
             ("nli", ["entailment", "neutral", "contradiction"])]
PII_LABELS = ["O", "B-PERSON", "I-PERSON"]
# heads biased to one class: the modality head says AR and the jailbreak
# head benign (so neither the image nor the block decision shadows the
# chat decisions)
BIASED = {"modality": 0, "jailbreak": 0}
ALGORITHMS = {
    "confidence": {"type": "confidence", "confidence": {"threshold": 0.7}},
    "ratings": {"type": "ratings", "ratings": {"max_concurrent": 2}},
    "remom": {"type": "remom", "remom": {"breadth_schedule": [2, 1]}},
    "fusion": {"type": "fusion", "fusion": {"grounding": {"enabled": True},
                                            "synthesis_model": "panel-b"}},
    "workflows": {"type": "workflows", "workflows": {
        "mode": "static",
        "roles": [{"id": "s1", "models": ["wf-tool"],
                   "prompt": "Use tools."}],
        "final": {"model": "wf-final", "prompt": "Fuse."}}},
}
LOOPER_MODELS = {"confidence": ["qwen3-8b", "qwen3-32b"],
                 "ratings": ["qwen3-8b", "qwen3-32b"],
                 "remom": ["qwen3-8b", "qwen3-32b"],
                 "fusion": ["panel-a", "panel-b", "panel-c"],
                 "workflows": ["wf-tool", "wf-final"]}
TOOL_CALL = {"id": "call_1", "type": "function",
             "function": {"name": "search_web", "arguments": "{}"}}
CUT = "cutoff"  # a streamed answer to a prompt with it dies after 1 chunk


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bias_classifier(params, cls_index):
    p = dict(params)
    inner = dict(p["params"])
    clf = dict(inner["classifier"])
    bias = np.zeros(np.shape(clf["bias"]), np.float32)
    bias[cls_index] = 8.0
    clf["bias"] = bias
    inner["classifier"] = clf
    p["params"] = inner
    return p


@pytest.fixture(scope="module")
def engines():
    import jax
    import jax.numpy as jnp

    jeng = jtesting.make_shared_trunk_engine(
        tasks=SEQ_TASKS, token_tasks=[("pii", PII_LABELS)], seed=11)
    for name, idx in BIASED.items():
        t = jeng._tasks[name]
        jeng.register_task(name, t.kind, t.module,
                           _bias_classifier(t.params, idx), t.tokenizer,
                           t.labels, max_seq_len=512)
    emb = JEmbeddingModel(jtesting.tiny_config(2))
    emb_params = emb.init(jax.random.PRNGKey(5), jnp.ones((1, 8), jnp.int32))
    jeng.register_task("embedding", "embedding", emb, emb_params,
                       jeng._tasks["intent"].tokenizer, [], max_seq_len=512)
    teng = ttesting.make_shared_trunk_engine(
        tasks=SEQ_TASKS, token_tasks=[("pii", PII_LABELS)], device="cpu",
        flax_params={n: jeng._tasks[n].params
                     for n, _ in SEQ_TASKS + [("pii", None)]})
    temb = MmBertEmbeddingModel(ttesting.tiny_config(2))
    temb.load_state_dict(params_from_flax(emb_params))
    teng.register_task("embedding", "embedding", temb,
                       teng.trunk_group("intent").tokenizer, [],
                       max_seq_len=512)
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


def _config(path) -> dict:
    with open(path) as f:
        d = yaml.safe_load(f)
    routing = d["routing"]
    for algo, spec in ALGORITHMS.items():
        routing["signals"]["keywords"].append(
            {"name": f"lp_{algo}", "operator": "OR", "method": "exact",
             "keywords": [f"zz{algo}"]})
        routing["decisions"].append({
            "name": f"looper_{algo}", "priority": 400,
            "rules": {"operator": "OR", "conditions": [
                {"type": "keyword", "name": f"lp_{algo}"}]},
            "modelRefs": [{"model": m} for m in LOOPER_MODELS[algo]],
            "algorithm": spec})
    d["authz"] = {"credentials": [
        {"models": ["qwen3-32b"], "api_key": "key-32b"},
        {"models": ["panel-a", "panel-c"], "api_key": "key-panel",
         "header": "x-api-key"}]}
    d["skip_processing"] = {"enabled": True}
    return d


def _last_user(body) -> str:
    return next((m.get("content") or "" for m in
                 reversed(body.get("messages", []))
                 if m.get("role") == "user"), "")


def answer(body):
    """The mock's answer: a tool call from ``wf-tool`` until the
    conversation holds a tool result, else an echo of the request."""
    msgs = body.get("messages", [])
    if body.get("model") == "wf-tool" and body.get("tools") \
            and not any(m.get("role") == "tool" for m in msgs):
        return {"content": None, "tool_calls": [dict(TOOL_CALL)]}
    last = _last_user(body)
    return json.dumps({"model": body.get("model", ""),
                       "n_messages": len(msgs),
                       "last_user": last if isinstance(last, str) else "",
                       "tools": len(body.get("tools") or [])})


def cut(body):
    last = _last_user(body)
    return 1 if isinstance(last, str) and CUT in last else None


class _Pair:
    def __init__(self, cfg: dict, engines) -> None:
        jeng, teng = engines
        self.backend = {s: MockVLLMServer(content_fn=answer,
                                          cut_fn=cut).start()
                        for s in ("jax", "port")}
        self.jreg = JRegistry.isolated()
        self.treg = RuntimeRegistry.isolated(runtimestats=None)
        jcfg = JRouterConfig.from_dict(copy.deepcopy(cfg))
        self.router = {
            "jax": JRouter(jcfg, engine=jeng,
                           metrics=self.jreg.metric_series(),
                           explain=self.jreg.get("explain"),
                           resilience=self.jreg.get("resilience")),
            "port": Router(load_config(copy.deepcopy(cfg)), engine=teng,
                           metrics=self.treg.metric_series(),
                           explain=self.treg.explain,
                           resilience=self.treg.resilience)}
        self.feedback = {"jax": [], "port": []}
        self.nli = {"jax": 0, "port": 0}
        for side, eng in (("jax", jeng), ("port", teng)):
            self._spy(side, eng)
        self.server = {
            "jax": JServer(self.router["jax"], jcfg,
                           default_backend=self.backend["jax"].url,
                           registry=self.jreg).start(),
            "port": RouterServer(self.router["port"],
                                 self.backend["port"].url,
                                 registry=self.treg).start()}

    def _spy(self, side, eng):
        router = self.router[side]
        inner = router.record_feedback

        def record_feedback(route, success=True, **kw):
            self.feedback[side].append(
                (success, kw.get("ttft_ms", 0.0) > 0))
            return inner(route, success=success, **kw)

        router.record_feedback = record_feedback
        inner_classify = eng.classify

        def classify(task, text, *a, **kw):
            if task == "nli":
                self.nli[side] += 1
            return inner_classify(task, text, *a, **kw)

        eng.classify = classify

    def request(self, side, method, path, body=None, headers=None,
                chunked=False):
        u = urllib.parse.urlsplit(self.server[side].url)
        conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
        data = None if body is None else json.dumps(body).encode()
        if chunked:
            data = iter([data[:7], data[7:]])
        try:
            conn.request(method, path, body=data,
                         headers={"content-type": "application/json",
                                  **(headers or {})})
            r = conn.getresponse()
            return (r.status, {k.lower(): v for k, v in r.getheaders()},
                    r.read())
        finally:
            conn.close()

    def both(self, method, path, body=None, headers=None, chunked=False):
        """Send to the JAX server, then the port's; assert equal answers;
        the port's (status, headers, parsed body)."""
        out = {}
        for side in ("jax", "port"):
            status, hdrs, raw = self.request(side, method, path,
                                             copy.deepcopy(body), headers,
                                             chunked)
            out[side] = (status, hdrs.get("content-type"),
                         _vsr_headers(hdrs), _parse(hdrs, raw))
        assert normalize(out["port"]) == normalize(out["jax"])
        return out["port"]

    def stop(self) -> None:
        for s in self.server.values():
            s.stop()
        for b in self.backend.values():
            b.stop()
        for r in self.router.values():
            r.shutdown()


@pytest.fixture(scope="module")
def pair(engines, fixture_config_path):
    p = _Pair(_config(fixture_config_path), engines)
    yield p
    p.stop()


_RANDOM_HEADERS = (H.REQUEST_ID, H.DECISION_RECORD)
_ID = re.compile(r"^(resp|msg)_[0-9a-f]+$")


def _vsr_headers(hdrs: dict) -> dict:
    return {k: v for k, v in sorted(hdrs.items())
            if k.startswith("x-vsr-") and k not in _RANDOM_HEADERS}


def _parse(hdrs: dict, raw: bytes):
    if "event-stream" in (hdrs.get("content-type") or ""):
        frames = []
        for frame in raw.decode().split("\n\n"):
            if not frame.strip():
                continue
            event, data = "", ""
            for line in frame.split("\n"):
                if line.startswith("event: "):
                    event = line[7:]
                elif line.startswith("data: "):
                    data = line[6:]
            frames.append((event, data if data == "[DONE]"
                           else json.loads(data)))
        return frames
    return json.loads(raw) if raw else None


def normalize(obj, ids=None):
    """``obj`` without ``id`` / ``created`` / ``created_at`` and with the
    ``resp_…`` / ``msg_…`` ids it still holds renumbered."""
    ids = {} if ids is None else ids
    if isinstance(obj, dict):
        return {k: normalize(v, ids) for k, v in obj.items()
                if k not in ("id", "created", "created_at")}
    if isinstance(obj, (list, tuple)):
        return [normalize(v, ids) for v in obj]
    if isinstance(obj, str) and _ID.match(obj):
        return ids.setdefault(obj, f"{obj.split('_')[0]}_#{len(ids)}")
    return obj


def chat(text, **kw):
    return {"model": "auto",
            "messages": [{"role": "user", "content": text}], **kw}


def _text_of(frames) -> str:
    return "".join((f[1]["choices"] or [{}])[0].get("delta", {})
                   .get("content") or "" for f in frames
                   if isinstance(f[1], dict) and f[1].get("choices"))


# ---------------------------------------------------------------------------


def test_models_list(pair):
    status, _, _, body = pair.both("GET", "/v1/models")
    assert status == 200
    assert [m["id"] for m in body["data"]] == \
        ["qwen3-8b", "qwen3-32b", "sdxl-image"]


STREAM_TEXTS = ["please debug this function", "URGENT: need help asap",
                "hello world, what is the weather like",
                "first solve this step by step"]


@pytest.mark.parametrize("text", STREAM_TEXTS)
def test_stream_relays_the_backends_frames(pair, text):
    plain = pair.both("POST", "/v1/chat/completions",
                      chat(text + " (plain)"))
    status, ctype, hdrs, frames = pair.both(
        "POST", "/v1/chat/completions", chat(text, stream=True))
    assert status == 200 and ctype == "text/event-stream"
    assert frames[-1] == ("", "[DONE]")
    # the relayed text is the backend's answer, chunk by chunk
    assert json.loads(_text_of(frames))["last_user"] == text
    # the same decision and model as the non-streamed twin
    assert (hdrs.get(H.DECISION), hdrs.get(H.MODEL)) == \
        (plain[2].get(H.DECISION), plain[2].get(H.MODEL))


def test_cache_is_written_only_when_a_stream_completes(pair):
    cut_text = f"please debug this function {CUT} now"
    fed = {s: len(pair.feedback[s]) for s in pair.feedback}
    _, _, hdrs, frames = pair.both("POST", "/v1/chat/completions",
                                   chat(cut_text, stream=True))
    assert hdrs[H.DECISION] == "code_route"
    assert len(frames) == 2 and frames[-1] == ("", "[DONE]")
    for side in pair.feedback:
        assert pair.feedback[side][fed[side]:] == [(False, True)]
    # the cut stream was not cached: its twin reaches the backend
    hits = {s: b.hits for s, b in pair.backend.items()}
    _, _, hdrs, _ = pair.both("POST", "/v1/chat/completions",
                              chat(cut_text))
    assert H.CACHE_HIT not in hdrs
    assert all(b.hits == hits[s] + 1 for s, b in pair.backend.items())
    # a completed stream is cached: its twin is a hit
    done_text = "refactor this algorithm code for me"
    _, _, hdrs, _ = pair.both("POST", "/v1/chat/completions",
                              chat(done_text, stream=True))
    assert hdrs[H.DECISION] == "code_route"
    hits = {s: b.hits for s, b in pair.backend.items()}
    _, _, hdrs, body = pair.both("POST", "/v1/chat/completions",
                                 chat(done_text))
    assert hdrs.get(H.CACHE_HIT) == "true"
    assert all(b.hits == hits[s] for s, b in pair.backend.items())
    # and a cache hit on /v1/messages comes back as an Anthropic message
    _, _, hdrs, msg = pair.both("POST", "/v1/messages", {
        "model": "auto", "max_tokens": 32,
        "messages": [{"role": "user", "content": done_text}]})
    assert hdrs.get(H.CACHE_HIT) == "true" and msg["type"] == "message"


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("text", ["URGENT: need help asap",
                                  "what is the capital of portugal"])
def test_anthropic_messages(pair, text, stream):
    body = {"model": "auto", "max_tokens": 64, "system": "be brief",
            "stream": stream,
            "messages": [{"role": "user", "content": [
                {"type": "text", "text": text}]}]}
    status, ctype, _, out = pair.both("POST", "/v1/messages", body)
    assert status == 200
    if stream:
        assert ctype == "text/event-stream"
        assert [e for e, _ in out][0] == "message_start"
        assert [e for e, _ in out][-1] == "message_stop"
    else:
        assert out["type"] == "message" and out["content"]


def test_responses_chain_streams_its_last_turn(pair):
    prev = {}
    for i, text in enumerate(["first question", "second question",
                              "third question"]):
        body = {"model": "auto", "input": text, "instructions": "terse"}
        last = i == 2
        if last:
            body["stream"] = True
            body["stream_options"] = {"include_usage": True}
        outs = {}
        for side in ("jax", "port"):
            b = dict(body, **({"previous_response_id": prev[side]}
                              if side in prev else {}))
            status, hdrs, raw = pair.request(side, "POST", "/v1/responses",
                                             b)
            assert status == 200
            outs[side] = (_vsr_headers(hdrs), _parse(hdrs, raw))
        assert normalize(outs["port"]) == normalize(outs["jax"])
        if not last:
            for side in outs:
                prev[side] = outs[side][1]["id"]
                echo = json.loads(outs[side][1]["output_text"])
                assert echo["n_messages"] == 2 + 2 * i
    events = [e for e, _ in outs["port"][1]]
    assert events[0] == "response.created"
    assert events[-1] == "response.completed"


def test_responses_stream_dies_as_incomplete(pair):
    _, _, _, frames = pair.both("POST", "/v1/responses", {
        "model": "auto", "input": f"tell me a story {CUT}",
        "stream": True})
    events = [e for e, _ in frames]
    assert events[-1] == "response.incomplete"
    assert "response.completed" not in events
    assert frames[-1][1]["response"]["status"] == "incomplete"


@pytest.mark.parametrize("algo", sorted(set(ALGORITHMS) - {"workflows"}))
@pytest.mark.parametrize("path", ["/v1/chat/completions", "/v1/messages",
                                  "/v1/responses"])
def test_looper_algorithms(pair, algo, path):
    text = f"zz{algo} explain tunneling"
    if path == "/v1/responses":
        body = {"model": "auto", "input": text}
    else:
        body = chat(text, max_tokens=64)
    nli = dict(pair.nli)
    seen = {s: len(b.headers_seen) for s, b in pair.backend.items()}
    status, _, hdrs, _ = pair.both("POST", path, body)
    assert status == 200
    assert hdrs["x-vsr-looper-algorithm"] == algo
    assert hdrs["x-vsr-looper-candidates"]
    for side, b in pair.backend.items():
        calls = b.headers_seen[seen[side]:]
        assert calls and all(h.get(H.LOOPER) == "true" for h in calls)
        # each fan-out call carries its own candidate's credential
        for h in calls:
            if "authorization" in h:
                assert h["authorization"] == "Bearer key-32b"
    if algo == "fusion":
        # one nli forward per panel answer, on each side
        assert pair.nli["port"] - nli["port"] == 3
        assert pair.nli["jax"] - nli["jax"] == 3


def test_looper_marked_request_is_served_single_model(pair):
    hits = {s: b.hits for s, b in pair.backend.items()}
    status, _, hdrs, _ = pair.both(
        "POST", "/v1/chat/completions", chat("zzfusion explain"),
        headers={H.LOOPER: "true"})
    assert status == 200 and "x-vsr-looper-algorithm" not in hdrs
    assert all(b.hits == hits[s] + 1 for s, b in pair.backend.items())


def test_workflows_interrupt_and_resume(pair):
    tools = [{"type": "function", "function": {"name": "search_web"}}]
    body = chat("zzworkflows look this up", tools=tools)
    status, _, hdrs, first = pair.both("POST", "/v1/chat/completions", body)
    assert status == 200 and hdrs["x-vsr-looper-algorithm"] == "workflows"
    assert first["choices"][0]["finish_reason"] == "tool_calls"
    # each server's own state id rides in its tool-call id
    outs = {}
    for side in ("jax", "port"):
        st, hd, raw = pair.request(side, "POST", "/v1/chat/completions",
                                   copy.deepcopy(body))
        first = json.loads(raw)
        msg = first["choices"][0]["message"]
        tc_id = msg["tool_calls"][0]["id"]
        assert tc_id.startswith("vsrwf-") and tc_id.endswith("::call_1")
        resume = copy.deepcopy(body)
        resume["messages"] += [msg, {"role": "tool", "tool_call_id": tc_id,
                                     "content": "42"}]
        st, hd, raw = pair.request(side, "POST", "/v1/chat/completions",
                                   resume)
        outs[side] = (st, _vsr_headers(hd), json.loads(raw))
    assert normalize(outs["port"]) == normalize(outs["jax"])
    status, hdrs, out = outs["port"]
    assert status == 200 and hdrs[H.MODEL] == "wf-final"
    trace = out["vsr_annotations"]["workflow_trace"]
    assert trace["tool_trajectory"][0]["model"] == "wf-tool"


@pytest.mark.parametrize("stream", [False, True])
def test_passthrough_goes_through_the_response_path(pair, stream):
    body = chat("please debug this function", stream=stream,
                reasoning_effort="high")
    hits = {s: b.hits for s, b in pair.backend.items()}
    status, _, hdrs, out = pair.both(
        "POST", "/v1/chat/completions", body,
        headers={H.SKIP_PROCESSING: "true"})
    assert status == 200 and H.DECISION not in hdrs
    assert all(b.hits == hits[s] + 1 for s, b in pair.backend.items())
    text = _text_of(out) if stream else \
        out["choices"][0]["message"]["content"]
    assert json.loads(text)["model"] == "auto"


def test_credential_header_reaches_the_backend(pair):
    seen = {s: len(b.headers_seen) for s, b in pair.backend.items()}
    status, _, hdrs, _ = pair.both("POST", "/v1/chat/completions",
                                   chat("zzfusion compare"))
    assert status == 200
    got = {}
    for side, b in pair.backend.items():
        got[side] = sorted((h.get("authorization", ""),
                            h.get("x-api-key", ""))
                           for h in b.headers_seen[seen[side]:])
    assert got["port"] == got["jax"]
    assert ("", "key-panel") in got["port"]


@pytest.mark.parametrize("text", ["URGENT: need help asap",
                                  "please debug this function"])
def test_chunked_post_is_routed_as_its_twin(pair, text):
    plain = pair.both("POST", "/v1/chat/completions", chat(text))
    chunked = pair.both("POST", "/v1/chat/completions", chat(text),
                        chunked=True)
    assert chunked[0] == plain[0] == 200
    assert chunked[2].get(H.DECISION) == plain[2].get(H.DECISION)
