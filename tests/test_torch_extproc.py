"""The port's Envoy ExtProc filter (``semantic_router_tpu_torch.extproc``)
against the JAX one, on the CPU: every message sequence of the JAX
package's ExtProc tests (the request, looper, response, cache and
in-flight paths, the decision-record echo, the STREAMED hardening) goes
through both services, and their ``ProcessingResponse``s must be equal
once trace, request and record ids are set aside: which oneof, status,
header mutations, body mutation bytes, ``clear_route_cache`` and
``mode_override``.  The fixture config routes with ``engine=None`` and,
for the learned families, over one tiny seeded engine pair (the same Flax
weights through ``params_from_flax``), buffered and streamed.  One case
runs over real gRPC on loopback for both packages; the others drive
``Process`` in process.  A weighted static decision draws from a seeded
generator on both sides, so both pick the same model."""

import copy
import json
import os
import time

import numpy as np
import pytest
import torch

from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.config import load_config as jload_config
from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.extproc import external_processor_pb2 as jpb
from semantic_router_tpu.extproc import server as jserver
from semantic_router_tpu.observability.inflight import InflightTracker \
    as JInflightTracker
from semantic_router_tpu.router import Router as JRouter
from semantic_router_tpu.selection import algorithms as jalgorithms
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.extproc import SERVICE_NAME, ExtProcServer, \
    ExtProcService
from semantic_router_tpu_torch.extproc import external_processor_pb2 as pb
from semantic_router_tpu_torch.extproc import server as tserver
from semantic_router_tpu_torch.extproc.server import build_looper_executor
from semantic_router_tpu_torch.observability.inflight import \
    InflightTracker, default_tracker
from semantic_router_tpu_torch.router import MockVLLMServer, Router
from semantic_router_tpu_torch.router import headers as H
from semantic_router_tpu_torch.selection import algorithms as talgorithms
from test_torch_router_fixture import BODIES, _fixture_dict
from test_torch_router_fixture import engines  # noqa: F401  (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "router_config.yaml")
# header values that carry a fresh id a request
VOLATILE_HEADERS = ("traceparent", H.DECISION_RECORD, H.REQUEST_ID)
# JSON keys of answer bodies that carry a fresh id or a clock (a 429's
# retry_after is the bucket's refill time left, read at the route)
VOLATILE_KEYS = ("id", "created", "request_id", "decision_record_id",
                 "retry_after")


@pytest.fixture(autouse=True)
def _seeded_static(monkeypatch):
    """A static selector without a seed draws from seed 0, in both
    packages: the same request order picks the same weighted model."""
    def init(self, seed=None, **_):
        self.rng = np.random.default_rng(0 if seed is None else seed)

    monkeypatch.setattr(jalgorithms.StaticSelector, "__init__", init)
    monkeypatch.setattr(talgorithms.StaticSelector, "__init__", init)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# messages, as Envoy sends them

def _headers_msg(extra=None, eos=False):
    base = {":method": "POST", ":path": "/v1/chat/completions",
            ":authority": "router.local", "content-type": "application/json"}
    base.update(extra or {})
    return pb.ProcessingRequest(request_headers=pb.HttpHeaders(
        headers=pb.HeaderMap(headers=[
            pb.HeaderValue(key=k, raw_value=v.encode())
            for k, v in base.items()]),
        end_of_stream=eos))


def _body_msg(payload, eos=True):
    raw = payload if isinstance(payload, bytes) \
        else json.dumps(payload).encode()
    return pb.ProcessingRequest(request_body=pb.HttpBody(
        body=raw, end_of_stream=eos))


def _resp_headers_msg(status="200", ctype="application/json"):
    return pb.ProcessingRequest(response_headers=pb.HttpHeaders(
        headers=pb.HeaderMap(headers=[
            pb.HeaderValue(key=":status", raw_value=status.encode()),
            pb.HeaderValue(key="content-type", raw_value=ctype.encode())])))


def _resp_body_msg(payload, eos=True):
    raw = payload if isinstance(payload, bytes) \
        else json.dumps(payload).encode()
    return pb.ProcessingRequest(response_body=pb.HttpBody(
        body=raw, end_of_stream=eos))


def chat(text, **kw):
    return {"model": "auto",
            "messages": [{"role": "user", "content": text}], **kw}


ANSWER = {"choices": [{"message": {"role": "assistant", "content": "done"},
                       "finish_reason": "stop"}],
          "usage": {"prompt_tokens": 3, "completion_tokens": 1}}
SSE = (b'data: {"choices":[{"delta":{"content":"hi "}}]}\n\n'
       b'data: {"choices":[{"delta":{"content":"there"}}],'
       b'"usage":{"completion_tokens":2}}\n\n'
       b'data: [DONE]\n\n')


# ---------------------------------------------------------------------------
# normalised responses

def _scrub(obj):
    if isinstance(obj, dict):
        return {k: ("<id>" if k in VOLATILE_KEYS else _scrub(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


def _body(raw):
    if not raw:
        return raw
    try:
        return ("json", _scrub(json.loads(raw)))
    except ValueError:
        return ("raw", raw)


def _header_map(mutation) -> dict:
    out = {}
    for opt in mutation.set_headers:
        val = opt.header.raw_value.decode() if opt.header.raw_value \
            else opt.header.value
        if opt.header.key in VOLATILE_HEADERS:
            val = "<id>" if val else ""
        elif opt.header.key == "content-length":
            val = "<n>"   # the scrubbed body is what is compared
        out[opt.header.key] = (val, opt.append_action)
    return out


def norm(resp) -> dict:
    """What Envoy acts on in a ``ProcessingResponse``, ids set aside."""
    which = resp.WhichOneof("response")
    out = {"which": which,
           "mode_override": resp.mode_override.response_body_mode
           if resp.HasField("mode_override") else None}
    if which == "immediate_response":
        imm = resp.immediate_response
        out.update(status=imm.status.code, headers=_header_map(imm.headers),
                   body=_body(imm.body.encode() if isinstance(imm.body, str)
                              else imm.body))
    elif which in ("request_headers", "request_body", "response_headers",
                   "response_body"):
        common = getattr(resp, which).response
        out.update(status=common.status,
                   headers=_header_map(common.header_mutation),
                   body=_body(common.body_mutation.body)
                   if common.HasField("body_mutation") else None,
                   clear_route_cache=common.clear_route_cache)
    return out


def drive(service, msgs) -> list:
    return [norm(r) for r in service.Process(iter(msgs), None)]


class Pair:
    """The JAX filter and the port's over routers built from one config,
    each with its own engine (or none)."""

    def __init__(self, cfg=FIXTURE, jeng=None, teng=None,
                 looper_execute=None, mutate=None) -> None:
        if isinstance(cfg, str):
            jcfg, tcfg = jload_config(cfg), load_config(cfg)
        else:
            jcfg = JRouterConfig.from_dict(copy.deepcopy(cfg))
            tcfg = load_config(copy.deepcopy(cfg))
        if mutate is not None:
            mutate(jcfg)
            mutate(tcfg)
        self.jrouter = JRouter(jcfg, engine=jeng)
        self.trouter = Router(tcfg, engine=teng)
        self.jsvc = jserver.ExtProcService(self.jrouter,
                                           looper_execute=looper_execute)
        self.tsvc = ExtProcService(self.trouter,
                                   looper_execute=looper_execute)

    def both(self, msgs) -> tuple:
        return drive(self.jsvc, msgs), drive(self.tsvc, msgs)

    def same(self, msgs) -> list:
        want, got = self.both(msgs)
        assert got == want
        return got

    def close(self) -> None:
        for svc in (self.jsvc, self.tsvc):
            svc._prefetch_pool.shutdown(wait=True, cancel_futures=True)
        self.jrouter.shutdown()
        self.trouter.shutdown()


@pytest.fixture()
def pair():
    p = Pair()
    yield p
    p.close()


def test_generated_module_is_the_same_descriptor():
    assert pb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    assert tserver.SERVICE_NAME == jserver.SERVICE_NAME == SERVICE_NAME
    with open(os.path.join(REPO, "semantic_router_tpu", "extproc",
                           "external_processor_pb2.py"), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "semantic_router_tpu_torch", "extproc",
                           "external_processor_pb2.py"), "rb") as f:
        assert f.read() == want


# ---------------------------------------------------------------------------
# the request path (tests/test_extproc.py TestRequestPath)

def test_route_mutates_body_and_sets_headers(pair):
    got = pair.same([_headers_msg(), _body_msg(chat("this is urgent, fix asap")),
                     _resp_headers_msg(), _resp_body_msg(ANSWER)])
    assert [r["which"] for r in got] == ["request_headers", "request_body",
                                         "response_headers", "response_body"]
    body = got[1]
    assert body["clear_route_cache"]
    assert body["body"][1]["model"] == "qwen3-8b"
    assert body["headers"][H.MODEL][0] == "qwen3-8b"
    assert body["headers"][H.DECISION][0] == "urgent_route"


def test_streamed_request_chunks_accumulate(pair):
    raw = json.dumps(chat("this is urgent, fix asap")).encode()
    got = pair.same([_headers_msg(), _body_msg(raw[:20], eos=False),
                     _body_msg(raw[20:], eos=True)])
    assert got[1]["body"] is None
    assert got[2]["body"][1]["model"] == "qwen3-8b"


BLOCK_CONFIG = {
    "default_model": "m-default",
    "routing": {
        "modelCards": [{"name": "m-default"}],
        "signals": {"keywords": [{
            "name": "forbidden", "operator": "OR", "method": "exact",
            "keywords": ["forbidden topic"]}]},
        "decisions": [{
            "name": "block_forbidden", "priority": 100,
            "rules": {"operator": "OR", "conditions": [
                {"type": "keyword", "name": "forbidden"}]},
            "modelRefs": [{"model": "m-default"}],
            "plugins": [{"type": "fast_response", "configuration": {
                "enabled": True,
                "response": "Request blocked by policy."}}]}]},
}


def test_policy_block_immediate_response():
    p = Pair(BLOCK_CONFIG)
    try:
        got = p.same([_headers_msg(),
                      _body_msg(chat("tell me about the forbidden topic"))])
        assert got[1]["which"] == "immediate_response"
        assert got[1]["status"] == 200
        assert got[1]["body"][1]["choices"][0]["message"]["content"] == \
            "Request blocked by policy."
        assert got[1]["headers"][H.JAILBREAK_BLOCKED][0] == "true"
    finally:
        p.close()


def test_invalid_json_immediate_400(pair):
    got = pair.same([_headers_msg(), _body_msg(b"{not json", eos=True)])
    assert got[1]["which"] == "immediate_response"
    assert got[1]["status"] == 400


def test_rate_limited_immediate_429():
    def limit(cfg):
        cfg.ratelimit = {"requests_per_minute": 60, "burst": 1}

    p = Pair(mutate=limit)
    try:
        msgs = [_headers_msg(), _body_msg(chat("hello"))]
        first = p.same(msgs)
        assert first[1]["which"] == "request_body"
        second = p.same(msgs)
        assert second[1]["which"] == "immediate_response"
        assert second[1]["status"] == 429
    finally:
        p.close()


def test_pipeline_error_fails_open():
    p = Pair()

    def dead(*_a, **_k):
        raise RuntimeError("engine dead")

    p.jrouter.route = dead
    p.trouter.route = dead
    try:
        got = p.same([_headers_msg(), _body_msg(chat("anything"))])
        assert got[1] == {"which": "request_body", "mode_override": None,
                          "status": pb.CommonResponse.CONTINUE,
                          "headers": {}, "body": None,
                          "clear_route_cache": False}
    finally:
        p.close()


# ---------------------------------------------------------------------------
# the looper path (TestLooperPath)

WF_CONFIG = {
    "default_model": "worker-a",
    "routing": {
        "modelCards": [{"name": "worker-a"}],
        "signals": {"keywords": [{
            "name": "wf", "operator": "OR", "method": "exact",
            "keywords": ["orchestrate"]}]},
        "decisions": [{
            "name": "wf_route", "priority": 50,
            "rules": {"operator": "OR", "conditions": [
                {"type": "keyword", "name": "wf"}]},
            "modelRefs": [{"model": "worker-a"}],
            "algorithm": {"type": "workflows", "workflows": {
                "mode": "static",
                "roles": [{"id": "s1", "models": ["worker-a"],
                           "prompt": "Work."}]}}}]},
}


def test_workflows_decision_answers_via_immediate_response():
    seen = []

    def looper_execute(route, headers):
        seen.append(route.looper_algorithm)
        return "worker-a", {"choices": [{"message": {
            "role": "assistant", "content": "wf done"},
            "finish_reason": "stop"}]}, {H.LOOPER_ALGORITHM: "workflows"}

    p = Pair(WF_CONFIG, looper_execute=looper_execute)
    try:
        got = p.same([_headers_msg(), _body_msg(chat("orchestrate the task"))])
        assert seen == ["workflows", "workflows"]
        imm = got[1]
        assert imm["which"] == "immediate_response"
        assert imm["body"][1]["choices"][0]["message"]["content"] == "wf done"
        assert imm["headers"][H.LOOPER_ALGORITHM][0] == "workflows"
        assert imm["headers"][H.MODEL][0] == "worker-a"
    finally:
        p.close()


def test_looper_error_falls_back_to_single_model():
    def broken(route, headers):
        raise RuntimeError("backend down")

    p = Pair(WF_CONFIG, looper_execute=broken)
    try:
        got = p.same([_headers_msg(), _body_msg(chat("orchestrate it"))])
        assert got[1]["which"] == "request_body"
        assert got[1]["body"][1]["model"] == "worker-a"
    finally:
        p.close()


def test_build_looper_executor_against_live_backend():
    from semantic_router_tpu.config.schema import ModelRef as JModelRef
    from semantic_router_tpu.extproc.server import \
        build_looper_executor as jbuild
    from semantic_router_tpu_torch.config.schema import ModelRef

    cfg = {"default_model": "m1",
           "routing": {"modelCards": [{"name": "m1"}, {"name": "m2"}],
                       "decisions": []}}
    backend = MockVLLMServer().start()

    def fake_route(ref_cls):
        class FakeDecision:
            class decision:
                algorithm = {"type": "confidence",
                             "confidence": {"threshold": 0.0}}
                model_refs = [ref_cls(model="m1"), ref_cls(model="m2")]

        class FakeRoute:
            looper_algorithm = "confidence"
            decision = FakeDecision
            body = chat("hello")
        return FakeRoute

    try:
        want = jbuild(JRouterConfig.from_dict(cfg),
                      default_backend=backend.url)(fake_route(JModelRef), {})
        got = build_looper_executor(load_config(cfg),
                                    default_backend=backend.url)(
            fake_route(ModelRef), {})
        assert got[0] == want[0] == "m1"  # threshold 0: the first wins
        assert got[2] == want[2]
        assert got[2][H.LOOPER_ALGORITHM] == "confidence"
        assert _scrub(got[1]) == _scrub(want[1])
        assert got[1]["choices"][0]["message"]["content"]
        assert backend.hits == 2
    finally:
        backend.stop()


def test_looper_executor_drops_envoy_pseudo_headers():
    """Behind Envoy the stream's headers carry HTTP/2 pseudo-headers; the
    port's executor leaves them out of its upstream calls and answers.
    The JAX executor forwards them and its calls fail (an HTTP/1.1 header
    name cannot start with ':'), so there a looper decision falls back to
    one model: a known difference, the port's the working one."""
    from semantic_router_tpu.config.schema import ModelRef as JModelRef
    from semantic_router_tpu.extproc.server import \
        build_looper_executor as jbuild
    from semantic_router_tpu_torch.config.schema import ModelRef

    cfg = {"default_model": "m1",
           "routing": {"modelCards": [{"name": "m1"}, {"name": "m2"}],
                       "decisions": []}}
    envoy = {":method": "POST", ":path": "/v1/chat/completions",
             ":authority": "router.local", "x-user": "u1"}
    backend = MockVLLMServer().start()

    def fake_route(ref_cls):
        class FakeDecision:
            class decision:
                algorithm = {"type": "confidence",
                             "confidence": {"threshold": 0.0}}
                model_refs = [ref_cls(model="m1"), ref_cls(model="m2")]

        class FakeRoute:
            looper_algorithm = "confidence"
            decision = FakeDecision
            body = chat("hello")
        return FakeRoute

    try:
        model, body, extra = build_looper_executor(
            load_config(cfg), default_backend=backend.url)(
            fake_route(ModelRef), dict(envoy))
        assert model == "m1" and body["choices"][0]["message"]["content"]
        seen = backend.headers_seen[-1]
        assert seen["x-user"] == "u1"
        assert not any(k.startswith(":") for k in seen)
        with pytest.raises(Exception):
            jbuild(JRouterConfig.from_dict(cfg),
                   default_backend=backend.url)(fake_route(JModelRef),
                                                dict(envoy))
        # without pseudo-headers the two executors agree
        assert build_looper_executor(
            load_config(cfg), default_backend=backend.url)(
            fake_route(ModelRef), {"x-user": "u1"})[2] == jbuild(
            JRouterConfig.from_dict(cfg), default_backend=backend.url)(
            fake_route(JModelRef), {"x-user": "u1"})[2]
    finally:
        backend.stop()


# ---------------------------------------------------------------------------
# the response path (TestResponsePath), the record echo (test_explain.py)

def test_sse_response_mode_override_and_passthrough(pair):
    got = pair.same([_headers_msg(),
                     _body_msg(chat("this is urgent, fix asap", stream=True)),
                     _resp_headers_msg(ctype="text/event-stream"),
                     _resp_body_msg(SSE[:30], eos=False),
                     _resp_body_msg(SSE[30:], eos=True)])
    assert got[2]["mode_override"] == pb.ProcessingMode.STREAMED
    assert got[3]["body"] is None and got[4]["body"] is None


@pytest.mark.parametrize("status", ["200", "503"])
def test_response_body_feedback_and_upstream_feed(status):
    """A JSON answer after a routed request, a success and a 5xx: the
    response path's mutation (or none) and the upstream plane's
    model-level health are the same."""
    from semantic_router_tpu.observability.metrics import MetricsRegistry \
        as JMetricsRegistry
    from semantic_router_tpu.resilience.upstream import UpstreamHealth \
        as JUpstreamHealth
    from semantic_router_tpu_torch.observability.metrics import \
        MetricsRegistry
    from semantic_router_tpu_torch.resilience.upstream import \
        UpstreamHealth

    p = Pair()
    p.jrouter.upstream_health = JUpstreamHealth(JMetricsRegistry())
    p.trouter.upstream_health = UpstreamHealth(MetricsRegistry())
    try:
        got = p.same([_headers_msg(),
                      _body_msg(chat("this is urgent, fix asap")),
                      _resp_headers_msg(status=status),
                      _resp_body_msg(ANSWER)])
        assert got[3]["which"] == "response_body"
        want = p.jrouter.upstream_health.health_score("qwen3-8b")
        assert p.trouter.upstream_health.health_score("qwen3-8b") == want
        assert (want < 1.0) == (status == "503")
    finally:
        p.close()


def test_record_id_echoed_on_response_headers():
    from semantic_router_tpu.observability.explain import \
        DecisionExplainer as JExplainer
    from semantic_router_tpu_torch.observability.explain import \
        DecisionExplainer

    p = Pair()
    p.jrouter.explain = JExplainer()
    p.trouter.explain = DecisionExplainer()
    try:
        body = {"model": "auto", "messages": [{
            "role": "user",
            "content": "urgent: please debug this function asap"}]}
        states = []
        for svc, mod in ((p.jsvc, jserver), (p.tsvc, tserver)):
            state = mod._StreamState()
            hdrs = pb.HttpHeaders(headers=pb.HeaderMap(headers=[
                pb.HeaderValue(key=":path", value="/v1/chat/completions")]))
            svc._on_request_headers(hdrs, state)
            svc._on_request_body(pb.HttpBody(
                body=json.dumps(body).encode(), end_of_stream=True), state)
            resp = svc._on_response_headers(pb.HttpHeaders(
                headers=pb.HeaderMap(headers=[
                    pb.HeaderValue(key=":status", value="200")])), state)
            echoed = {o.header.key: o.header.raw_value.decode()
                      for o in resp.response_headers.response
                      .header_mutation.set_headers}
            assert state.route.decision_record_id
            assert echoed[H.DECISION_RECORD] == state.route.decision_record_id
            states.append(norm(resp))
        assert states[0] == states[1]
    finally:
        p.close()


def test_degradation_level_echoed_on_response_headers():
    p = Pair()
    try:
        outs = []
        for svc, mod in ((p.jsvc, jserver), (p.tsvc, tserver)):
            state = mod._StreamState()
            svc._on_request_headers(pb.HttpHeaders(), state)
            svc._on_request_body(pb.HttpBody(
                body=json.dumps(chat("this is urgent")).encode(),
                end_of_stream=True), state)
            state.route.headers[H.DEGRADATION] = "2"
            outs.append(norm(svc._on_response_headers(
                pb.HttpHeaders(), state)))
        assert outs[0] == outs[1]
        assert outs[1]["headers"][H.DEGRADATION][0] == "2"
    finally:
        p.close()


def test_assemble_sse_matches():
    for raw in (SSE, b"", b"data: [DONE]\n\n", b"data: {bad\n\n" + SSE):
        assert tserver.ExtProcService._assemble_sse(raw) == \
            jserver.ExtProcService._assemble_sse(raw)


# ---------------------------------------------------------------------------
# the cache path (TestCachePath) over one seeded embedding engine pair

def test_cache_round_trip_across_streams():
    jeng = jtesting.make_embedding_engine()
    teng = ttesting.make_embedding_engine(
        device="cpu", flax_params={n: t.params
                                   for n, t in jeng._tasks.items()})
    p = Pair(jeng=jeng, teng=teng)
    try:
        q = chat("please debug the cache function in this code")
        answer = {"choices": [{"message": {
            "role": "assistant", "content": "use a debugger"},
            "finish_reason": "stop"}],
            "usage": {"prompt_tokens": 5, "completion_tokens": 3}}
        first = p.same([_headers_msg(), _body_msg(q), _resp_headers_msg(),
                        _resp_body_msg(answer)])
        assert first[1]["which"] == "request_body"
        second = p.same([_headers_msg(), _body_msg(q)])
        assert second[1]["which"] == "immediate_response"
        assert second[1]["body"][1]["choices"][0]["message"]["content"] == \
            "use a debugger"
        assert second[1]["headers"][H.CACHE_HIT][0] == "true"
    finally:
        p.close()
        jeng.shutdown()
        teng.shutdown()


# ---------------------------------------------------------------------------
# in-flight accounting (TestInflight), the stream's finally

def test_inflight_tracker_matches():
    for cls in (JInflightTracker, InflightTracker):
        t = cls(max_age_s=60)
        tok1, tok2 = t.begin("m1"), t.begin("m1")
        assert t.count("m1") == 2
        t.end("m1", tok1)
        assert t.count("m1") == 1
        t.end("m1", tok2)
        assert t.count("m1") == 0 and t.total() == 0
        t = cls(max_age_s=0.01)
        t.begin("m1")
        time.sleep(0.03)
        assert t.count("m1") == 0  # an abandoned entry drops


def test_dropped_stream_ends_its_inflight_entry(pair):
    """A client that drops the stream after the route (no response phase)
    still ends the model's in-flight entry: the generator's finally."""
    model = "qwen3-8b"
    before = default_tracker.count(model)
    gen = pair.tsvc.Process(iter([_headers_msg(),
                                  _body_msg(chat("this is urgent, fix asap"))
                                  ]), None)
    next(gen)
    resp = next(gen)
    assert json.loads(resp.request_body.response.body_mutation.body)[
        "model"] == model
    assert default_tracker.count(model) == before + 1
    gen.close()   # what gRPC does to a cancelled call's generator
    assert default_tracker.count(model) == before


def test_concurrent_streams_stress(pair):
    """More client threads than cores, a short switch interval, buffered
    and streamed bodies through one filter (its prefetch pool shared):
    every stream gets its own route, no in-flight entry is left behind
    and the message counter loses no update."""
    import sys
    import threading

    texts = ["this is urgent, fix asap", "please debug this function",
             "hello world", "urgent: the build is down"]
    want = {t: drive(pair.jsvc, [_headers_msg(), _body_msg(chat(t))])[1]
            for t in texts}
    n_threads, per = len(os.sched_getaffinity(0)) + 4, 4
    before = {m: default_tracker.count(m) for m in ("qwen3-8b",
                                                   "qwen3-32b")}
    m0 = tserver.extproc_messages.total()
    errors, lock = [], threading.Lock()

    def client(c):
        for k in range(per):
            text = texts[(c + k) % len(texts)]
            if (c + k) % 2:
                msgs = [_headers_msg()] + _chunks(chat(text))
                want_body = dict(chat(text), metadata={"pad": "p" * 600})
            else:
                msgs, want_body = [_headers_msg(), _body_msg(chat(text))], \
                    chat(text)
            got = drive(pair.tsvc, msgs)
            w = dict(want[text])
            w["body"] = ("json", {**w["body"][1], **{
                k: v for k, v in want_body.items() if k == "metadata"}})
            if got[-1] != w:
                with lock:
                    errors.append((text, got[-1], w))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:2]
    n_streamed = sum((c + k) % 2 for c in range(n_threads)
                     for k in range(per))
    n_msgs = n_threads * per * 2 + n_streamed * 2
    assert tserver.extproc_messages.total() - m0 == n_msgs
    # no response phase ran: the routed streams' entries stay open until
    # the generator's finally, which closed every one
    assert {m: default_tracker.count(m) for m in before} == before


# ---------------------------------------------------------------------------
# the STREAMED hardening (tests/test_milvus_streamed.py:100)

def test_skip_processing_streams_pass_through_unbuffered():
    cfg = {"default_model": "m1", "skip_processing": {"enabled": True},
           "routing": {"modelCards": [{"name": "m1"}], "decisions": []}}
    p = Pair(cfg)
    try:
        msgs = [_headers_msg({"x-vsr-skip-processing": "true"})]
        msgs += [pb.ProcessingRequest(request_body=pb.HttpBody(
            body=b"x" * 1000, end_of_stream=False)) for _ in range(5)]
        got = p.same(msgs)
        assert len(got) == 6
        assert all(r["body"] is None and r["status"] ==
                   pb.CommonResponse.CONTINUE for r in got[1:])
        assert p.tsvc._prefetch_pool._work_queue.empty()
    finally:
        p.close()


def test_oversized_body_answers_413(monkeypatch):
    cfg = {"default_model": "m1",
           "routing": {"modelCards": [{"name": "m1"}], "decisions": []}}
    monkeypatch.setattr(jserver.ExtProcService, "MAX_BODY_BYTES", 4096)
    monkeypatch.setattr(ExtProcService, "MAX_BODY_BYTES", 4096)
    p = Pair(cfg)
    try:
        msgs = [_headers_msg()] + [pb.ProcessingRequest(
            request_body=pb.HttpBody(body=b"y" * 2048, end_of_stream=False))
            for _ in range(3)]
        got = p.same(msgs)
        imm = [r for r in got if r["which"] == "immediate_response"]
        assert imm and imm[0]["status"] == 413
    finally:
        p.close()


def test_streamed_deadline_answers_408(monkeypatch):
    monkeypatch.setattr(jserver.ExtProcService, "STREAMED_DEADLINE_S", 0.01)
    monkeypatch.setattr(ExtProcService, "STREAMED_DEADLINE_S", 0.01)
    p = Pair()

    def msgs():
        yield _headers_msg()
        yield _body_msg(b'{"model"', eos=False)
        time.sleep(0.03)
        yield _body_msg(b': "auto"', eos=False)

    try:
        want, got = drive(p.jsvc, msgs()), drive(p.tsvc, msgs())
        assert got == want
        assert got[-1]["which"] == "immediate_response"
        assert got[-1]["status"] == 408
    finally:
        p.close()


def test_trailers_and_unknown_phases():
    p = Pair()
    try:
        got = p.same([
            pb.ProcessingRequest(request_trailers=pb.HttpTrailers()),
            pb.ProcessingRequest(response_trailers=pb.HttpTrailers()),
            pb.ProcessingRequest()])
        assert [r["which"] for r in got] == [
            "request_trailers", "response_trailers", "request_headers"]
    finally:
        p.close()


# ---------------------------------------------------------------------------
# the fixture's learned families over one tiny engine pair, buffered and
# streamed (the prefetch on the filter's workers)

def _chunks(body: dict) -> list:
    """The body in three STREAMED chunks: the first ends after the
    top-level ``messages`` (the prefetch starts there), then an inert
    trailing field arrives in two."""
    b = dict(body, model=body.get("model", "auto"))
    b["metadata"] = {"pad": "p" * 600}
    raw = json.dumps(b).encode()
    cut = raw.index(b'"metadata"')
    mid = (cut + len(raw)) // 2
    return [_body_msg(raw[:cut], eos=False), _body_msg(raw[cut:mid], False),
            _body_msg(raw[mid:], eos=True)]


@pytest.fixture(scope="module")
def learned_pairs(engines):  # noqa: F811
    jeng, teng = engines
    d = _fixture_dict(FIXTURE)
    p = Pair(d, jeng=jeng, teng=teng)
    yield p
    p.close()


@pytest.mark.parametrize("mode", ["buffered", "streamed"])
@pytest.mark.parametrize("i", range(len(BODIES)))
def test_learned_fixture_bodies_match(learned_pairs, engines, mode,  # noqa
                                      i):
    body, headers = BODIES[i]
    body = dict(copy.deepcopy(body), model="auto")
    if mode == "buffered":
        msgs = [_headers_msg(headers), _body_msg(body)]
    else:
        msgs = [_headers_msg(headers)] + _chunks(body)
    # one route a side: reset the seeded static draws before each
    for router in (learned_pairs.jrouter, learned_pairs.trouter):
        router._selectors.clear()
    want, got = learned_pairs.both(msgs)
    assert got == want
    assert got[-1]["which"] in ("request_body", "immediate_response")


# ---------------------------------------------------------------------------
# over real gRPC on loopback, both packages

def test_over_grpc_loopback_both_packages():
    import grpc

    routers = (JRouter(jload_config(FIXTURE)), Router(load_config(FIXTURE)))
    servers = (jserver.ExtProcServer(routers[0], port=0).start(),
               ExtProcServer(routers[1], port=0).start())
    raw = json.dumps(chat("this is urgent, fix asap")).encode()
    msgs = [_headers_msg(), _body_msg(raw[:20], eos=False),
            _body_msg(raw[20:], eos=True), _resp_headers_msg(),
            _resp_body_msg(ANSWER)]
    outs = []
    try:
        for server in servers:
            channel = grpc.insecure_channel(server.address)
            call = channel.stream_stream(
                f"/{SERVICE_NAME}/Process",
                request_serializer=pb.ProcessingRequest.SerializeToString,
                response_deserializer=pb.ProcessingResponse.FromString)
            try:
                outs.append([norm(r) for r in call(iter(msgs))])
            finally:
                channel.close()
    finally:
        for server in servers:
            server.stop()
        for router in routers:
            router.shutdown()
    assert outs[1] == outs[0]
    assert outs[1][2]["body"][1]["model"] == "qwen3-8b"


def test_cancelled_grpc_call_ends_the_inflight_entry():
    """A client that cancels its call after the routed body: the
    servicer's generator is closed and its finally ends the entry."""
    import grpc

    router = Router(load_config(FIXTURE))
    server = ExtProcServer(router, port=0).start()
    channel = grpc.insecure_channel(server.address)
    call = channel.stream_stream(
        f"/{SERVICE_NAME}/Process",
        request_serializer=pb.ProcessingRequest.SerializeToString,
        response_deserializer=pb.ProcessingResponse.FromString)
    model = "qwen3-8b"
    before = default_tracker.count(model)
    gate = []

    def msgs():
        yield _headers_msg()
        yield _body_msg(chat("this is urgent, fix asap"))
        while not gate:        # hold the stream open until cancelled
            time.sleep(0.01)

    try:
        it = call(msgs())
        next(it)
        resp = next(it)
        assert resp.request_body.response.HasField("body_mutation")
        assert default_tracker.count(model) == before + 1
        it.cancel()
        gate.append(True)
        deadline = time.time() + 10
        while default_tracker.count(model) != before and \
                time.time() < deadline:
            time.sleep(0.02)
        assert default_tracker.count(model) == before
    finally:
        channel.close()
        server.stop()
        router.shutdown()


def test_messages_counter_counts_by_phase(pair):
    before = tserver.extproc_messages.total()
    pair.tsvc.Process(iter([]), None)
    drive(pair.tsvc, [_headers_msg(), _body_msg(chat("hi"))])
    assert tserver.extproc_messages.total() == before + 2
