"""The port Router's streamed-prefetch seams (``begin_pending_trace``,
``evaluate_signals``, ``route(precomputed_signals=, pending_trace=)``)
against the JAX Router, on the CPU: on the fixture config (no engine, and
its learned families over one tiny seeded engine pair), with the cascade
off and on, and under the degradation ladder at every level for every
priority class, ``evaluate_signals`` gives the same signals and report
(families, confidences within 1e-4, ``compressed_view``) and a route that
reuses them the same kind, decision, model and headers as the JAX
Router's; the prefetch's ``signals.evaluate`` span is a child of the
request's ``router.route`` span, directly and through the streamed
handler."""

import copy
import json
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.observability.metrics import MetricSeries as \
    JSeries
from semantic_router_tpu.observability.metrics import MetricsRegistry as \
    JMetricsRegistry
from semantic_router_tpu.observability.tracing import Tracer as JTracer
from semantic_router_tpu.router.pipeline import Router as JRouter
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.extproc.streamed import StreamedBodyHandler
from semantic_router_tpu_torch.observability.metrics import MetricSeries, \
    MetricsRegistry
from semantic_router_tpu_torch.observability.tracing import PendingTrace, \
    Tracer
from semantic_router_tpu_torch.router import Router
from semantic_router_tpu_torch.router import headers as H
from test_torch_resilience import CLASSES, _ladder_routers, _raise_to, _row
from test_torch_resilience import PII_LABELS as LADDER_PII
from test_torch_resilience import PROMPTS as LADDER_PROMPTS
from test_torch_resilience import TASKS as LADDER_TASKS
from test_torch_resilience import clock  # noqa: F401  (a fixture)
from test_torch_router_fixture import BODIES, _same_route
from test_torch_router_fixture import engines  # noqa: F401  (a fixture)
from test_torch_router_fixture import routers  # noqa: F401  (a fixture)

PROB_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_report(got, want):
    assert sorted(got.results) == sorted(want.results)
    for fam, res in want.results.items():
        assert (got.results[fam].error is None) == (res.error is None), fam
    assert got.compressed_view == want.compressed_view


def _same_signals(got, want):
    assert {t: sorted(n) for t, n in got.matches.items()} == \
        {t: sorted(n) for t, n in want.matches.items()}
    assert got.confidences.keys() == want.confidences.keys()
    for k, v in want.confidences.items():
        assert abs(got.confidences[k] - v) <= PROB_TOL, k


# ---------------------------------------------------------------------------
# the fixture config, no engine

@pytest.mark.parametrize("i", range(len(BODIES)))
def test_fixture_without_engine(fixture_config_path, i):
    jr = JRouter(JRouterConfig.from_dict(_fixture(fixture_config_path)))
    tr = Router(load_config(_fixture(fixture_config_path)))
    body, headers = BODIES[i]
    body = dict(copy.deepcopy(body), model="auto")
    try:
        jsig = jr.evaluate_signals(copy.deepcopy(body), dict(headers))
        tsig = tr.evaluate_signals(copy.deepcopy(body), dict(headers))
        _same_signals(tsig[0], jsig[0])
        _same_report(tsig[1], jsig[1])
        assert tsig[1].compressed_view is True
        want = jr.route(copy.deepcopy(body), dict(headers),
                        precomputed_signals=jsig)
        got = tr.route(copy.deepcopy(body), dict(headers),
                       precomputed_signals=tsig)
        _same_route(got, want)
        assert got.report is tsig[1] and got.signals is tsig[0]
    finally:
        jr.shutdown()
        tr.shutdown()


def _fixture(path):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


# ---------------------------------------------------------------------------
# the fixture's learned families over the tiny engine pair

@pytest.mark.parametrize("which", ["fixture", "probes"])
@pytest.mark.parametrize("i", range(len(BODIES)))
def test_learned_prefetch_matches_jax_and_inline(routers, which,  # noqa
                                                 i):
    jr, tr = routers[which]
    body, headers = BODIES[i]
    jsig = jr.evaluate_signals(copy.deepcopy(body), dict(headers))
    tsig = tr.evaluate_signals(copy.deepcopy(body), dict(headers))
    _same_signals(tsig[0], jsig[0])
    _same_report(tsig[1], jsig[1])
    want = jr.route(copy.deepcopy(body), dict(headers),
                    precomputed_signals=jsig)
    got = tr.route(copy.deepcopy(body), dict(headers),
                   precomputed_signals=tsig)
    _same_route(got, want)
    # and the prefetch is what the inline path would have evaluated
    inline = tr.route(copy.deepcopy(body), dict(headers))
    _same_signals(got.signals, inline.signals)
    assert (got.decision is None) == (inline.decision is None)
    if inline.decision is not None:
        assert got.decision.decision.name == inline.decision.decision.name


def test_prefetch_reuse_runs_no_classifier_forward(routers,  # noqa: F811
                                                    engines):  # noqa: F811
    """A route that reuses a prefetch runs no classifier step; what it
    still embeds is the semantic cache's lookup."""
    _jr, tr = routers["fixture"]
    _jeng, teng = engines
    body, headers = BODIES[2]
    sig = tr.evaluate_signals(copy.deepcopy(body), dict(headers))
    steps = len(teng.steps())
    res = tr.route(copy.deepcopy(body), dict(headers),
                   precomputed_signals=sig)
    assert res.kind == "route"
    assert {s["flavor"] for s in teng.steps()[steps:]} <= {"embed"}


# ---------------------------------------------------------------------------
# the ladder at every level and class, the cascade off and on

@pytest.fixture(scope="module")
def ladder_engines():
    jeng = jtesting.make_shared_trunk_engine(
        tasks=LADDER_TASKS, token_tasks=[("pii", LADDER_PII)], seed=13)
    teng = ttesting.make_shared_trunk_engine(
        tasks=LADDER_TASKS, token_tasks=[("pii", LADDER_PII)],
        device="cpu", flax_params={n: t.params
                                   for n, t in jeng._tasks.items()})
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


@pytest.mark.parametrize("cascade", [False, True], ids=["fanout",
                                                       "cascade"])
@pytest.mark.parametrize("level", [0, 1, 2, 3, 4])
def test_prefetch_under_the_ladder_matches_jax(ladder_engines, level,
                                               cascade, clock):  # noqa
    (jr, jctl, jbus), (tr, tctl, tbus) = _ladder_routers(ladder_engines,
                                                         cascade)
    try:
        _raise_to(jctl, jbus, level)
        _raise_to(tctl, tbus, level)
        assert jctl.level() == tctl.level() == level
        for c in CLASSES:
            for i, text in enumerate(LADDER_PROMPTS):
                body = {"model": "auto", "messages": [
                    {"role": "user", "content": text}]}
                hdrs = {H.REQUEST_ID: f"r-{c}-{i}", H.PRIORITY: c}
                jsig = jr.evaluate_signals(copy.deepcopy(body), dict(hdrs))
                tsig = tr.evaluate_signals(copy.deepcopy(body), dict(hdrs))
                _same_signals(tsig[0], jsig[0])
                _same_report(tsig[1], jsig[1])
                # L1 and up shed compression; a browned-out class's
                # prefetch runs the safety floor alone (L2 and up brown
                # out the normal and low classes, L4 every class)
                assert tsig[1].compressed_view is (level == 0)
                browned = tctl.browned_out(c)
                assert browned == jctl.browned_out(c)
                assert browned == (level == 4 or (
                    level >= 2 and c in ("normal", "low"))), (level, c)
                learned = set(tr._learned_families(tr.dispatcher))
                ran = set(tsig[1].results) & learned
                assert ran == ({"jailbreak"} if browned else learned), \
                    (level, c)
                want = jr.route(copy.deepcopy(body), dict(hdrs),
                                precomputed_signals=jsig)
                got = tr.route(copy.deepcopy(body), dict(hdrs),
                               precomputed_signals=tsig)
                assert _row(got) == _row(want), (level, c, text)
                if level == 3 and c == "low":
                    assert got.kind == "shed"
                elif got.kind == "route" and level < 4:
                    # a prefetched view is kept, never browned out after
                    # the fact, and the cascade does not run again
                    assert got.report is tsig[1]
    finally:
        jr.shutdown()
        tr.shutdown()


# ---------------------------------------------------------------------------
# the span tree (tests/test_trace_followons.py)

def _routers_traced():
    cfg = {"default_model": "m"}
    jt, tt = JTracer(capacity=4096, sample_rate=1.0), \
        Tracer(capacity=4096, sample_rate=1.0)
    return (JRouter(JRouterConfig.from_dict(cfg), tracer=jt,
                    metrics=JSeries(JMetricsRegistry())), jt), \
        (Router(load_config(cfg), tracer=tt,
                metrics=MetricSeries(MetricsRegistry())), tt)


def _tree(spans, root_id) -> list:
    """(name, parent's name, prefetch) of every span of one trace."""
    by_id = {s.span_id: s for s in spans}
    return sorted((s.name, by_id[s.parent_id].name
                   if s.parent_id in by_id else
                   ("<root>" if s.span_id == root_id else s.parent_id),
                   bool(s.attributes.get("prefetch"))) for s in spans)


@pytest.mark.parametrize("traceparent", [False, True])
def test_pending_trace_adopted_by_route(traceparent):
    body = {"model": "auto",
            "messages": [{"role": "user", "content": "early text"}]}
    tid, parent = "ab" * 16, "12" * 8
    headers = {"traceparent": f"00-{tid}-{parent}-01"} if traceparent \
        else {}
    trees = []
    for router, tracer in _routers_traced():
        pending = router.begin_pending_trace(dict(headers))
        if traceparent:
            assert (pending.trace_id, pending.parent_id) == (tid, parent)
        router.evaluate_signals(dict(body), dict(headers), pending)
        result = router.route(dict(body), dict(headers),
                              pending_trace=pending)
        assert result.trace_id == pending.trace_id
        assert result.root_span_id == pending.root_span_id
        spans = tracer.trace(pending.trace_id)
        root = [s for s in spans if s.name == "router.route"]
        assert root and root[0].span_id == pending.root_span_id
        assert root[0].parent_id == (parent if traceparent else "")
        pre = [s for s in spans if s.name == "signals.evaluate"
               and s.attributes.get("prefetch")]
        assert pre and pre[0].parent_id == pending.root_span_id
        trees.append(_tree(spans, pending.root_span_id))
        router.shutdown()
    assert isinstance(pending, PendingTrace)
    assert trees[1] == trees[0]


def test_streamed_handler_mints_and_reuses():
    """Through the port's StreamedBodyHandler: the prefetch kicked off
    mid-stream lands its spans under the root span route() opens."""
    (_, _), (router, tracer) = _routers_traced()
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        handler = StreamedBodyHandler(router, {}, prefetch_pool=pool)
        full = json.dumps({
            "model": "auto",
            "messages": [{"role": "user",
                          "content": "streamed request text"}],
            "temperature": 0.7}).encode()
        cut = full.index(b'"temperature"')
        assert handler.handle_chunk(full[:cut], eos=False)[0] == "continue"
        assert handler.pending_trace is not None
        deadline = time.time() + 5.0
        while time.time() < deadline and not handler._prefetch.done():
            time.sleep(0.01)
        action, (body, signals) = handler.handle_chunk(full[cut:], eos=True)
        assert action == "route" and signals is not None
        result = router.route(body, {}, precomputed_signals=signals,
                              pending_trace=handler.pending_trace)
        spans = tracer.trace(result.trace_id)
        pre = [s for s in spans if s.name == "signals.evaluate"
               and s.attributes.get("prefetch")]
        assert pre and pre[0].parent_id == result.root_span_id
        # the inline path opened no second evaluation
        assert [s.name for s in spans].count("signals.evaluate") == 1
    finally:
        pool.shutdown(wait=False)
        router.shutdown()


def test_inline_route_keeps_one_root_and_its_evaluation():
    trees = []
    for router, tracer in _routers_traced():
        res = router.route({"model": "auto", "messages": [
            {"role": "user", "content": "x"}]}, {})
        trees.append(_tree(tracer.trace(res.trace_id), res.root_span_id))
        router.shutdown()
    assert trees[1] == trees[0]
    assert ("signals.evaluate", "router.route", False) in trees[1]
