"""The port's decision-aware signal cascade (``engine/cascade``) against the
JAX one, on the CPU: the three-valued fold on random rule trees and
partial signal sets, the planner and its cost order on the reference's
fixture config, the interval proofs (``certain_winner``, ``assess``) on
random states, and the port's Router against the JAX Router over one
seeded shared-trunk engine (the same Flax weights through
``params_from_flax``) with the cascade on: the same decisions, models,
signal confidences within 1e-4 and, at ``wave_size: 1``, the same skip
certificate; a keyword-decided request never reaches the engine with a
skippable task; brownout truncation; attach and detach through
``apply_cascade_knobs``; the ``/debug/runtime`` block and the decision
record's fields.  Cost order: no runtime stats on either side, so both
order by ``cost_default_ms``."""

import copy
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.config.schema import InferenceEngineConfig as \
    JEngineConfig
from semantic_router_tpu.config.schema import RuleNode as JRuleNode
from semantic_router_tpu.decision.engine import DecisionEngine as JEngine
from semantic_router_tpu.decision.engine import SignalMatches as JMatches
from semantic_router_tpu.engine import cascade as jcascade
from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.observability.explain import DecisionExplainer \
    as JExplainer
from semantic_router_tpu.observability.metrics import MetricSeries as \
    JSeries
from semantic_router_tpu.observability.metrics import MetricsRegistry as \
    JMetricsRegistry
from semantic_router_tpu.observability.tracing import Tracer as JTracer
from semantic_router_tpu.router.pipeline import Router as JRouter
from semantic_router_tpu.router.server import runtime_debug_report as \
    jruntime_debug_report
from semantic_router_tpu.runtime.bootstrap import apply_cascade_knobs as \
    japply_cascade_knobs
from semantic_router_tpu.runtime.registry import RuntimeRegistry as \
    JRegistry
from semantic_router_tpu.signals.base import RequestContext as JContext
from semantic_router_tpu.signals.dispatch import build_heuristic_dispatcher
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.config.schema import RuleNode
from semantic_router_tpu_torch.decision.engine import DecisionEngine, \
    SignalMatches
from semantic_router_tpu_torch.engine import cascade as tcascade
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.observability.explain import \
    DecisionExplainer
from semantic_router_tpu_torch.observability.metrics import MetricSeries, \
    MetricsRegistry
from semantic_router_tpu_torch.observability.tracing import Tracer
from semantic_router_tpu_torch.router import Router
from semantic_router_tpu_torch.router.server import runtime_debug_report
from semantic_router_tpu_torch.runtime import RuntimeRegistry, \
    apply_cascade_knobs
from semantic_router_tpu_torch.signals.base import RequestContext
from semantic_router_tpu_torch.signals.dispatch import build_dispatcher

PROB_TOL = 1e-4
FIXTURE = "tests/fixtures/router_config.yaml"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# random rule trees and signal sets, as plain dicts both packages parse

FAMS = ["keyword", "domain", "fact_check", "user_feedback", "modality",
        "complexity"]
RULES = ["r0", "r1", "r2"]


def _rand_tree(rng, depth=0) -> dict:
    if depth >= 3 or rng.random() < 0.4:
        return {"type": rng.choice(FAMS), "name": rng.choice(RULES)}
    return {"operator": rng.choice(["AND", "OR", "NOT"]),
            "conditions": [_rand_tree(rng, depth + 1)
                           for _ in range(rng.randint(0, 3))]}


def _rand_hits(rng) -> list:
    hits = []
    for f in FAMS:
        for r in RULES:
            if rng.random() < 0.45:
                name = r if f != "complexity" else \
                    f"{r}:{rng.choice(['easy', 'hard'])}"
                hits.append((f, name, round(rng.random(), 3)))
    return hits


def _matches(hits, cls, drop=()):
    sm = cls()
    for f, n, c in hits:
        if f not in drop:
            sm.add(f, n, c)
    return sm


def _tri(t) -> tuple:
    return (t.status, t.conf_lo, t.conf_hi, t.pinned, t.matched_rules)


@pytest.mark.parametrize("seed", range(4))
def test_tri_eval_node_matches_jax(seed):
    """60 trees a seed (240 in all), each under the final signal set and
    10 random partial resolutions."""
    rng = random.Random(0xCA5 + seed)
    for _ in range(60):
        tree, hits = _rand_tree(rng), _rand_hits(rng)
        jt, tt = JRuleNode.from_dict(tree), RuleNode.from_dict(tree)
        for k in range(11):
            unresolved = frozenset() if k == 0 else frozenset(
                f for f in FAMS if rng.random() < 0.4)
            want = jcascade.tri_eval_node(
                jt, _matches(hits, JMatches, unresolved), unresolved)
            got = tcascade.tri_eval_node(
                tt, _matches(hits, SignalMatches, unresolved), unresolved)
            assert _tri(got) == _tri(want), (tree, sorted(unresolved))


# ---------------------------------------------------------------------------
# the planner on the fixture config


class _FakeLearned:
    """An engine-backed family the planner reads and never evaluates."""

    def __init__(self, styp: str) -> None:
        self.signal_type = styp
        self.engine = object()
        self.prefetch_task = styp

    def evaluate(self, ctx):  # pragma: no cover - never called
        raise AssertionError("the planner evaluates nothing")


LEARNED = ["domain", "jailbreak", "pii", "fact_check", "user_feedback",
           "modality", "embedding", "preference", "complexity", "kb"]


def _fixture_dict() -> dict:
    with open(FIXTURE) as f:
        return yaml.safe_load(f)


def _fixture_pair(d=None):
    """(JAX dispatcher, engine, config), (port ...) over the fixture, each
    learned family a stub."""
    d = d or _fixture_dict()
    jcfg = JRouterConfig.from_dict(copy.deepcopy(d))
    tcfg = load_config(copy.deepcopy(d))
    jd = build_heuristic_dispatcher(
        jcfg, extra=[_FakeLearned(f) for f in LEARNED])
    td = build_dispatcher(tcfg)
    td.evaluators.update({f: _FakeLearned(f) for f in LEARNED})
    return ((jd, JEngine(jcfg.decisions, jcfg.strategy), jcfg),
            (td, DecisionEngine(tcfg.decisions, tcfg.strategy), tcfg))


def _plan_fields(p) -> tuple:
    return (p.version, dict(p.relevance), p.pinned, p.skippable,
            p.complexity_feeders, p.projection_feeders)


@pytest.mark.parametrize("with_signals", [True, False])
def test_build_plan_on_the_fixture_matches_jax(with_signals):
    (jd, je, jcfg), (td, te, tcfg) = _fixture_pair()
    try:
        want = jcascade.build_plan(je, jd, jcfg.signals if with_signals
                                   else None)
        got = tcascade.build_plan(te, td, tcfg.signals if with_signals
                                  else None)
        assert _plan_fields(got) == _plan_fields(want)
        assert got.skippable  # the fixture leaves families to skip
        assert "jailbreak" in got.pinned
        rng = random.Random(7)
        fams = sorted(got.skippable)
        for _ in range(20):
            cost = {f: rng.uniform(0.5, 20.0) for f in fams
                    if rng.random() < 0.7}
            values = {n: rng.uniform(0, 50) for n in got.relevance
                      if rng.random() < 0.3}
            blend = rng.choice([0.0, 0.25, 1.0])
            assert tcascade.plan_order(got, cost, values, 5.0, blend) == \
                jcascade.plan_order(want, cost, values, 5.0, blend)
    finally:
        jd.shutdown()
        td.shutdown()


def test_automix_pins_complexity_like_jax():
    d = _fixture_dict()
    d["routing"]["decisions"][0]["algorithm"] = {"type": "automix"}
    (jd, je, jcfg), (td, te, tcfg) = _fixture_pair(d)
    try:
        want = jcascade.build_plan(je, jd, jcfg.signals)
        got = tcascade.build_plan(te, td, tcfg.signals)
        assert _plan_fields(got) == _plan_fields(want)
        assert "complexity" in got.pinned
    finally:
        jd.shutdown()
        td.shutdown()


def test_safety_floor_refuses_like_jax():
    for mod in (jcascade.planner, tcascade.planner):
        with pytest.raises(mod.CascadePlanError):
            mod._check_safety_floor(frozenset(), frozenset({"jailbreak"}))
        mod._check_safety_floor(frozenset({"jailbreak"}), frozenset())


def test_normalize_cascade_matches_jax():
    for d in ({}, {"enabled": 1, "wave_size": 0, "brownout_max_waves": -3,
                   "value_blend": -1.0},
              {"enabled": True, "wave_size": "x", "max_waves": 2,
               "cost_default_ms": "y"}):
        assert tcascade.normalize_cascade(d) == \
            jcascade.normalize_cascade(d)


# ---------------------------------------------------------------------------
# certain_winner and assess on random states


def _rand_decisions(rng, n=5) -> list:
    return [{"name": f"d{i}", "priority": rng.choice([0, 10, 10, 50, 100]),
             "rules": _rand_tree(rng),
             "modelRefs": [{"model": f"m{i}"}],
             "algorithm": {"type": "automix"} if rng.random() < 0.1
             else {}}
            for i in range(n)]


def _contending(c) -> list:
    return [(d.name, _tri(t)) for d, t in c]


@pytest.mark.parametrize("strategy", ["priority", "confidence"])
def test_certain_winner_and_assess_match_jax(strategy):
    rng = random.Random(0xDEC + len(strategy))
    for _ in range(60):
        decs = _rand_decisions(rng)
        d = {"routing": {"strategy": strategy, "decisions": decs,
                         "signals": {"complexity": [
                             {"name": "r0", "composer": _rand_tree(rng)}]}}}
        jcfg = JRouterConfig.from_dict(copy.deepcopy(d))
        tcfg = load_config(copy.deepcopy(d))
        hits = _rand_hits(rng)
        learned = ["domain", "fact_check", "user_feedback", "modality",
                   "complexity"]
        jd = build_heuristic_dispatcher(
            jcfg, extra=[_FakeLearned(f) for f in learned])
        td = build_dispatcher(tcfg)
        td.evaluators.update({f: _FakeLearned(f) for f in learned})
        try:
            je = JEngine(jcfg.decisions, strategy)
            te = DecisionEngine(tcfg.decisions, strategy)
            jplan = jcascade.build_plan(je, jd, jcfg.signals)
            tplan = tcascade.build_plan(te, td, tcfg.signals)
            assert _plan_fields(tplan) == _plan_fields(jplan)
            for _ in range(5):
                unknown = {f for f in FAMS if rng.random() < 0.4}
                want = jcascade.certain_winner(
                    je.decisions, strategy,
                    _matches(hits, JMatches, unknown), unknown)
                got = tcascade.certain_winner(
                    te.decisions, strategy,
                    _matches(hits, SignalMatches, unknown), unknown)
                assert got[:2] == want[:2]
                assert _contending(got[2]) == _contending(want[2])
                pending = {f for f in learned if rng.random() < 0.5}
                wa = jcascade.assess(je, _matches(hits, JMatches, pending),
                                     pending, jplan)
                ga = tcascade.assess(te, _matches(hits, SignalMatches,
                                                  pending), pending, tplan)
                assert (ga.decided, ga.winner, ga.needed) == \
                    (wa.decided, wa.winner, wa.needed)
        finally:
            jd.shutdown()
            td.shutdown()


# ---------------------------------------------------------------------------
# the routers over one seeded shared-trunk engine

DOMAINS = ["business", "law", "health", "computer science", "other"]
TASKS = [("intent", DOMAINS),
         ("user_feedback", ["none", "positive", "negative"]),
         ("modality", ["ar", "diffusion", "both"])]
LORA = ("modality",)


def _leaf(t, n):
    return {"type": t, "name": n}


CONFIG = {
    "default_model": "backend-model",
    "engine": {"max_batch_size": 8, "max_wait_ms": 1.0,
               "seq_len_buckets": [32, 128, 512]},
    "routing": {
        "strategy": "priority",
        "signals": {
            "keywords": [{"name": "escalate",
                          "keywords": ["urgent", "outage"]}],
            "domains": [{"name": d} for d in DOMAINS],
            "user_feedbacks": [{"name": "positive"}, {"name": "negative"}],
            "modality": [{"name": "diffusion"}, {"name": "both"}]},
        "decisions": [
            {"name": "escalation", "priority": 100,
             "rules": {"operator": "OR",
                       "conditions": [_leaf("keyword", "escalate")]},
             "modelRefs": [{"model": "escalation-model"}]},
            {"name": "image_first", "priority": 80,
             "rules": {"operator": "OR",
                       "conditions": [_leaf("modality", "diffusion")]},
             "modelRefs": [{"model": "image-model"}]},
            {"name": "law_route", "priority": 60,
             "rules": {"operator": "OR",
                       "conditions": [_leaf("domain", "law")]},
             "modelRefs": [{"model": "law-model"}]},
            # user_feedback matters only for the "other" domain: on any
            # other domain the family is irrelevant after wave 0
            {"name": "retry_churn", "priority": 50,
             "rules": {"operator": "AND", "conditions": [
                 _leaf("domain", "other"),
                 {"operator": "OR", "conditions": [
                     _leaf("user_feedback", "negative"),
                     _leaf("user_feedback", "positive")]}]},
             "modelRefs": [{"model": "retry-model"}]},
            {"name": "imagegen", "priority": 40,
             "rules": {"operator": "OR",
                       "conditions": [_leaf("modality", "both")]},
             "modelRefs": [{"model": "image-model"}]},
        ]},
}

CORPUS = [
    "urgent outage in the payment cluster right now",
    "please summarize this contract clause for me",
    "urgent outage in the payment cluster right now",
    "draw me a watercolor painting of a lighthouse",
    "what are the symptoms of the common flu",
    "my last answer was wrong, try that request again",
    "refactor this python function to be iterative " * 8,
    "book review of a mystery novel",
    "the outage report for the storage tier",
    "generate an image of a red bicycle in the rain",
    "thanks, that answer was perfect",
    "what does clause 7 of the lease say about pets",
    "urgent: the database is down",
    "compose a short poem about the sea",
    "explain gradient descent to a beginner",
    "that is not what I asked for at all",
]


def _body(text: str) -> dict:
    return {"model": "auto",
            "messages": [{"role": "user", "content": text}]}


# logit offsets on the seeded heads, so the corpus spreads over the
# domains and feedback labels (and so over every cascade outcome)
HEAD_BIAS = {"intent": [2.8, 0.0, 0.9, 1.35, 0.85],
             "user_feedback": [0.0, -0.4, 0.6]}


def _with_bias(params, bias):
    p = dict(params)
    inner = dict(p["params"])
    clf = dict(inner["classifier"])
    clf["bias"] = np.asarray(clf["bias"], np.float32) + \
        np.asarray(bias, np.float32)
    inner["classifier"] = clf
    p["params"] = inner
    return p


@pytest.fixture(scope="module")
def engines():
    jeng = jtesting.make_shared_trunk_engine(
        tasks=TASKS, lora_tasks=LORA, seed=3,
        engine_cfg=JEngineConfig(max_batch_size=8, max_wait_ms=1.0,
                                 seq_len_buckets=[32, 128, 512]))
    for name, bias in HEAD_BIAS.items():
        t = jeng._tasks[name]
        jeng.register_task(name, t.kind, t.module,
                           _with_bias(t.params, bias), t.tokenizer,
                           t.labels, max_seq_len=512)
    teng = ttesting.make_shared_trunk_engine(
        tasks=TASKS, lora_tasks=LORA, device="cpu",
        engine_cfg=load_config(CONFIG).engine,
        flax_params={n: jeng._tasks[n].params for n, _ in TASKS})
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


def _explainers():
    j = JExplainer(ring_size=64)
    j.enabled, j.sample_rate = True, 1.0
    t = DecisionExplainer(ring_size=64)
    t.configure({"enabled": True, "sample_rate": 1.0, "ring_size": 64})
    return j, t


def _routers(engines, cfg=CONFIG, knobs=None):
    """(JAX router, port router) over the shared engines, each with its
    own cascade evaluator (no runtime stats) and decision ring."""
    jeng, teng = engines
    jx, tx = _explainers()
    jr = JRouter(JRouterConfig.from_dict(copy.deepcopy(cfg)), engine=jeng,
                 metrics=JSeries(JMetricsRegistry()),
                 tracer=JTracer(sample_rate=0.0), explain=jx)
    tr = Router(load_config(copy.deepcopy(cfg)), engine=teng,
                metrics=MetricSeries(MetricsRegistry()),
                tracer=Tracer(sample_rate=0.0), explain=tx)
    knobs = {"enabled": True, "wave_size": 1, **(knobs or {})}
    jr.cascade = jcascade.CascadeEvaluator(
        metrics=JSeries(JMetricsRegistry()))
    jr.cascade.configure(jcascade.normalize_cascade(knobs))
    tr.cascade = tcascade.CascadeEvaluator(
        metrics=MetricSeries(MetricsRegistry()))
    tr.cascade.configure(tcascade.normalize_cascade(knobs))
    return jr, tr


def _name(res):
    return res.decision.decision.name if res.decision else None


def _close(a: dict, b: dict, tol=PROB_TOL) -> bool:
    return a.keys() == b.keys() and all(abs(a[k] - b[k]) <= tol for k in a)


@pytest.fixture(scope="module")
def routed(engines):
    """Every corpus request through both routers with the cascade on
    (wave_size 1), and through the port's with it off."""
    jr, tr = _routers(engines)
    rows = []
    try:
        for text in CORPUS:
            j = jr.route(_body(text))
            t = tr.route(_body(text))
            casc = tr.cascade
            tr.cascade = None
            try:
                full = tr.route(_body(text))
            finally:
                tr.cascade = casc
            rows.append((j, t, full))
        yield jr, tr, rows
    finally:
        jr.cascade = tr.cascade = None
        jr.shutdown()
        tr.shutdown()


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_cascade_route_matches_jax(routed, i):
    _, _, rows = routed
    j, t, full = rows[i]
    assert (_name(t), t.model) == (_name(j), j.model)
    assert (_name(t), t.model) == (_name(full), full.model)
    assert t.signals.matches == j.signals.matches
    assert _close(t.signals.confidences, j.signals.confidences)
    assert t.report.cascade == j.report.cascade
    assert sorted(t.report.results) == sorted(j.report.results)
    assert full.report.cascade is None


def test_the_corpus_skips_and_runs_waves(routed):
    """The parity set takes every branch: decided before any wave and
    after the first, a family proven irrelevant, every wave run, and the
    fallback."""
    jr, tr, rows = routed
    certs = [t.report.cascade for _, t, _ in rows]
    assert {r for c in certs for r in c["skipped"].values()} == \
        {"decided", "irrelevant"}
    assert {c["decided_after_wave"] for c in certs} == {None, 0, 1}
    assert any(len(c["waves"]) == 2 for c in certs)
    assert None in {_name(t) for _, t, _ in rows}
    rep, jrep = tr.cascade.report(), jr.cascade.report()
    assert rep == jrep
    assert tr.cascade.metrics.cascade_skipped.total() == \
        sum(len(c["skipped"]) for c in certs)


def test_wider_waves_keep_decisions(engines):
    """wave_size 2: mid-wave cancellation depends on timing, so decisions
    and models compare exactly and the skip reasons as one neutral
    class; no queued wave member is left in the batcher."""
    jr, tr = _routers(engines, knobs={"wave_size": 2})
    try:
        for text in CORPUS:
            j, t = jr.route(_body(text)), tr.route(_body(text))
            assert (_name(t), t.model) == (_name(j), j.model), text
            assert set(t.report.cascade["skipped"].values()) <= \
                set(tcascade.NEUTRAL_SKIP_REASONS)
        assert engines[1].batcher.queue_depths()["pending_items"] == 0
    finally:
        jr.cascade = tr.cascade = None
        jr.shutdown()
        tr.shutdown()


def test_keyword_decided_request_never_reaches_the_engine_skippable(
        engines):
    """A keyword-decided request classifies no skippable task: not in the
    fused prefetch, not in a direct forward."""
    _, teng = engines
    _, tr = _routers(engines)
    calls = []
    orig_multi, orig_single = teng.classify_multi, teng.classify

    def spy_multi(tasks, texts, **kw):
        calls.extend(tasks)
        return orig_multi(tasks, texts, **kw)

    def spy_single(task, text, **kw):
        calls.append(task)
        return orig_single(task, text, **kw)

    teng.classify_multi, teng.classify = spy_multi, spy_single
    try:
        res = tr.route(_body("urgent outage in the billing stack"))
    finally:
        del teng.classify_multi, teng.classify
        tr.shutdown()
    assert _name(res) == "escalation"
    assert "user_feedback" not in calls and "modality" not in calls
    assert "intent" in calls  # the pinned family still ran
    assert res.report.cascade["skipped"] == {"modality": "decided",
                                             "user_feedback": "decided"}


BROWNOUT = {
    "default_model": "backend-model",
    "routing": {
        "signals": {"user_feedbacks": [{"name": "positive"},
                                       {"name": "negative"}],
                    "modality": [{"name": "diffusion"}, {"name": "both"}]},
        "decisions": [
            {"name": "d1", "priority": 50,
             "rules": {"operator": "OR", "conditions": [
                 _leaf("user_feedback", "negative"),
                 _leaf("modality", "both")]},
             "modelRefs": [{"model": "m1"}]},
            {"name": "d2", "priority": 40,
             "rules": {"operator": "OR",
                       "conditions": [_leaf("modality", "diffusion")]},
             "modelRefs": [{"model": "m2"}]}]},
}


@pytest.mark.parametrize("brownout", [True, False])
def test_brownout_truncation_matches_jax(engines, brownout):
    jr, tr = _routers(engines, BROWNOUT, {"brownout_max_waves": 1})
    try:
        text = "please summarize the quarterly report"
        _, jrep = jr.cascade.evaluate(
            JContext.from_openai_body(_body(text)), jr.dispatcher,
            jr.decision_engine, signals_cfg=jr.cfg.signals,
            brownout=brownout)
        sig, trep = tr.cascade.evaluate(
            RequestContext.from_openai_body(_body(text)), tr.dispatcher,
            tr.decision_engine, signals_cfg=tr.cfg.signals,
            brownout=brownout)
        assert trep.cascade == jrep.cascade
        truncated = "truncated" in trep.cascade["skipped"].values()
        assert truncated == brownout
        if brownout:
            assert len(trep.cascade["waves"]) == 1
    finally:
        jr.cascade = tr.cascade = None
        jr.shutdown()
        tr.shutdown()


def test_decision_record_fields_match_jax(engines):
    jr, tr = _routers(engines)
    try:
        for text in ("urgent outage in the auth service",
                     "draw me a watercolor painting of a lighthouse"):
            j, t = jr.route(_body(text)), tr.route(_body(text))
            jrec = jr.explain.get(j.decision_record_id)
            trec = tr.explain.get(t.decision_record_id)
            assert trec["cascade"] == jrec["cascade"]
            assert trec["skipped_families"] == jrec["skipped_families"]
        assert trec["cascade"]["mode"] == "cascade"
        jr.cascade = tr.cascade = None
        j, t = jr.route(_body(CORPUS[1])), tr.route(_body(CORPUS[1]))
        trec = tr.explain.get(t.decision_record_id)
        assert trec["cascade"] is None and trec["skipped_families"] == []
        assert jr.explain.get(j.decision_record_id)["cascade"] is None
    finally:
        jr.cascade = tr.cascade = None
        jr.shutdown()
        tr.shutdown()


# ---------------------------------------------------------------------------
# attach / detach and the /debug/runtime block


def test_apply_cascade_knobs_attaches_reconfigures_detaches():
    reg = RuntimeRegistry.isolated()
    router = SimpleNamespace(cascade=None)
    on = load_config({"engine": {"cascade": {"enabled": True,
                                             "wave_size": 3}}})
    apply_cascade_knobs(on, reg, router)
    casc = reg.get("cascade")
    assert casc is not None and router.cascade is casc
    assert casc.knobs["wave_size"] == 3
    # a reload keeps the evaluator (and its counters), reconfigured
    router2 = SimpleNamespace(cascade=None)
    apply_cascade_knobs(load_config({"engine": {"cascade": {
        "enabled": True, "wave_size": 1}}}), reg, router2)
    assert reg.get("cascade") is casc and router2.cascade is casc
    assert casc.knobs["wave_size"] == 1
    apply_cascade_knobs(load_config({}), reg, router2)
    assert reg.get("cascade") is None and router2.cascade is None


def test_malformed_cascade_block_never_raises():
    reg = RuntimeRegistry.isolated()
    router = SimpleNamespace(cascade=None)
    cfg = load_config({"engine": {"cascade": {"enabled": True}}})
    cfg.engine.cascade = {"enabled": True, "wave_size": object()}
    apply_cascade_knobs(cfg, reg, router)  # logged, not raised


def test_debug_runtime_cascade_block_matches_jax():
    on = {"engine": {"cascade": {"enabled": True}}}
    jreg, treg = JRegistry.isolated(), RuntimeRegistry.isolated()
    jrouter, trouter = SimpleNamespace(flywheel=None), \
        SimpleNamespace(cascade=None)
    japply_cascade_knobs(JRouterConfig.from_dict(copy.deepcopy(on)), jreg,
                         jrouter)
    apply_cascade_knobs(load_config(copy.deepcopy(on)), treg, trouter)
    try:
        want = jruntime_debug_report(jreg, None)["cascade"]
        got = runtime_debug_report(treg, None)["cascade"]
        assert set(got) == set(want)
        assert got == want
        off = {"engine": {"cascade": {"enabled": False}}}
        japply_cascade_knobs(JRouterConfig.from_dict(off), jreg, jrouter)
        apply_cascade_knobs(load_config(off), treg, trouter)
        assert "cascade" not in runtime_debug_report(treg, None)
        assert "cascade" not in jruntime_debug_report(jreg, None)
    finally:
        jreg.runtimestats.stop()
        treg.runtimestats.stop()


def test_build_router_attaches_the_configured_cascade(engines):
    from semantic_router_tpu_torch.runtime import build_router

    _, teng = engines
    cfg = copy.deepcopy(CONFIG)
    reg = RuntimeRegistry.isolated(runtimestats=None)
    cfg["engine"]["cascade"] = {"enabled": True, "wave_size": 1}
    router = build_router(load_config(cfg), teng, registry=reg)
    try:
        assert router.cascade is reg.get("cascade") is not None
        res = router.route(_body(CORPUS[0]))
        assert res.report.cascade["decided_after_wave"] == 0
    finally:
        router.shutdown()
    off = build_router(load_config(CONFIG), teng,
                       registry=RuntimeRegistry.isolated(runtimestats=None))
    try:
        assert off.cascade is None
        assert off.route(_body(CORPUS[0])).report.cascade is None
    finally:
        off.shutdown()


def test_learned_types_match_jax(engines):
    jr, tr = _routers(engines)
    try:
        assert tr.dispatcher.learned_types() == \
            jr.dispatcher.learned_types()
        assert tr.dispatcher.learned_types(keep=("domain",)) == \
            jr.dispatcher.learned_types(keep=("domain",))
    finally:
        jr.cascade = tr.cascade = None
        jr.shutdown()
        tr.shutdown()
