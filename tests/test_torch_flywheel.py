"""The port's routing flywheel (``semantic_router_tpu_torch.flywheel``)
against the JAX package's, module by module, on the CPU, following the
reference's tests/test_flywheel.py class by class: the golden corpus row
byte for byte and ``validate_row``'s problems on the same drifts; the
signal-hash features exactly, from rows and live; the cost-aware bandit's
``fit_offline`` / ``to_json`` blobs byte for byte, its choices and
``score_breakdown``, the untrained and cost-penalty cases; the
counterfactual evaluator's reports and ``bootstrap_ci`` per seed, the
``min_rows`` floor; the promotion state machine event for event; the
admission value weights and the L3 charge through both resilience
controllers; ``apply_flywheel_knobs`` and the normaliser on boot and on
reload (a promoted candidate re-installed on the rebuilt router, through
``attach_config_watcher`` and ``PATCH /config/router``); the scheduled
cycle runner; the cascade's order with decision values and its canary
passthrough; and ``/debug/flywheel`` / ``/debug/flywheel/cycle`` on both
servers, 503 without a flywheel and 401 / 403 through the access gate.
The trainer's ``mlp`` fits on the device it is given (the CPU here)."""

import copy
import json
import os
import time
import urllib.parse
import http.client
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from semantic_router_tpu import flywheel as jfw
from semantic_router_tpu.config.schema import ModelRef as JModelRef
from semantic_router_tpu.config.schema import RouterConfig as JRouterConfig
from semantic_router_tpu.decision.engine import SignalMatches as JMatches
from semantic_router_tpu.engine import cascade as jcascade
from semantic_router_tpu.flywheel.evaluator import \
    _policy_choice as j_policy_choice
from semantic_router_tpu.observability.metrics import \
    MetricsRegistry as JMetricsRegistry
from semantic_router_tpu.resilience import controller as jctl
from semantic_router_tpu.resilience.costmodel import CostModel as JCostModel
from semantic_router_tpu.router.server import RouterServer as JServer
from semantic_router_tpu.runtime import bootstrap as jboot
from semantic_router_tpu.runtime.events import EventBus as JEventBus
from semantic_router_tpu.runtime.registry import \
    RuntimeRegistry as JRuntimeRegistry
from semantic_router_tpu.selection.base import \
    SelectionContext as JContext
from semantic_router_tpu_torch import flywheel as tfw
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.config.schema import ModelRef, RouterConfig
from semantic_router_tpu_torch.config.validator import validate_config
from semantic_router_tpu_torch.decision.engine import SignalMatches
from semantic_router_tpu_torch.engine import cascade as tcascade
from semantic_router_tpu_torch.flywheel.evaluator import _policy_choice
from semantic_router_tpu_torch.observability.metrics import MetricsRegistry
from semantic_router_tpu_torch.resilience import controller as tctl
from semantic_router_tpu_torch.resilience.costmodel import CostModel
from semantic_router_tpu_torch.router import MockVLLMServer, RouterServer
from semantic_router_tpu_torch.runtime import RuntimeRegistry, \
    apply_flywheel_knobs, attach_config_watcher, build_router
from semantic_router_tpu_torch.runtime.events import \
    FLYWHEEL_STATE_CHANGED, SLO_ALERT_FIRING, EventBus
from semantic_router_tpu_torch.selection.base import Feedback, \
    SelectionContext, registry as selector_registry
from test_flywheel import GOLDEN, _AlwaysBestPolicy, _fixture_router, \
    _normalize_row, synth_rows
from test_flywheel_smoke import SMOKE_CFG, _requests
from test_torch_cascade import CORPUS, _body, _fixture_pair, _routers
from test_torch_cascade import engines  # noqa: F401  (a fixture)
from test_torch_flywheel_smoke import same_route

FIXTURE = "tests/fixtures/router_config.yaml"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_fixture_router():
    from semantic_router_tpu_torch.observability.explain import \
        DecisionExplainer
    from semantic_router_tpu_torch.observability.flightrec import \
        FlightRecorder
    from semantic_router_tpu_torch.observability.metrics import \
        MetricSeries
    from semantic_router_tpu_torch.observability.tracing import Tracer
    from semantic_router_tpu_torch.router import Router

    return Router(load_config(FIXTURE), explain=DecisionExplainer(),
                  metrics=MetricSeries(MetricsRegistry()),
                  tracer=Tracer(sample_rate=0.0),
                  flightrec=FlightRecorder())


def _matches(row, cls):
    sm = cls()
    for family, hits in row["signals"].items():
        for rule, conf in hits:
            sm.add(family, rule, conf)
    return sm


# -- TestCorpusSchema ---------------------------------------------------------


def test_golden_row_is_byte_identical():
    router = _port_fixture_router()
    try:
        res = router.route({"model": "auto", "messages": [
            {"role": "user",
             "content": "urgent: please debug this function asap"}]})
        rec = router.explain.get(res.decision_record_id)
        row = tfw.record_to_row(rec, cost_model=CostModel())
        assert not tfw.validate_row(row)
        got = tfw.row_to_json(_normalize_row(row))
        with open(GOLDEN) as f:
            assert got == f.read().strip()
        assert jfw.row_to_json(row) == tfw.row_to_json(row)
    finally:
        router.shutdown()


DRIFTS = [
    ("pop", "reward"), ("set", "extra_key", 1), ("set", "reward", 2.0),
    ("set", "outcome", {"verdict": "nope", "quality": 0.0,
                        "latency_ms": 0.0, "source": "observed"}),
    ("set", "outcome", {"verdict": "good_fit"}),
    ("set", "signals", {"keyword": [["k"]]}),
    ("set", "row_version", 2), ("set", "chosen", 3),
    ("set", "projections", []), ("set", "ts_unix", "now"),
]


@pytest.mark.parametrize("drift", DRIFTS, ids=lambda d: f"{d[0]}-{d[1]}")
def test_validate_row_catches_the_same_drift(drift):
    row = synth_rows(1)[0]
    assert tfw.validate_row(row) == jfw.validate_row(row) == []
    bad = dict(row)
    if drift[0] == "pop":
        bad.pop(drift[1])
    else:
        bad[drift[1]] = drift[2]
    assert tfw.validate_row(bad) == jfw.validate_row(bad) != []
    assert tfw.validate_row([row]) == jfw.validate_row([row])


def test_schema_reward_and_outcome_book_match_jax():
    row = synth_rows(1)[0]
    assert tfw.ROW_SCHEMA == jfw.ROW_SCHEMA and set(row) == set(tfw.ROW_SCHEMA)
    assert tfw.ROW_VERSION == jfw.ROW_VERSION
    for rec in ({"kind": "blocked", "model": "m"},
                {"kind": "cache_hit", "model": "m"},
                {"kind": "route", "model": ""}):
        assert tfw.record_to_row(rec) is jfw.record_to_row(rec) is None
    for verdict in ("good_fit", "failed", "underpowered",
                    "overprovisioned", "bogus", ""):
        for q in (0.0, 0.5, 1.7, -1.0):
            assert tfw.reward_for(verdict, q) == jfw.reward_for(verdict, q)
    books = (tfw.OutcomeBook(capacity=4), jfw.OutcomeBook(capacity=4))
    for book in books:
        for i in range(8):
            book.note(f"r{i}", "good_fit", latency_ms=float(i))
        book.note("r7", "bogus_verdict")
        book.note("", "failed")
    assert len(books[0]) == len(books[1]) == 4
    for i in range(8):
        assert books[0].get(f"r{i}") == books[1].get(f"r{i}")


def test_exporter_jsonl_reads_across_packages(tmp_path):
    jrouter, trouter = _fixture_router(), _port_fixture_router()
    try:
        for text in ("debug my function", "hello world", "urgent asap fix"):
            for r in (jrouter, trouter):
                r.route({"model": "auto", "messages": [
                    {"role": "user", "content": text}]})
        ex = tfw.CorpusExporter(explain=trouter.explain,
                                cost_model=CostModel())
        rows = ex.export_rows()
        jrows = jfw.CorpusExporter(explain=jrouter.explain,
                                   cost_model=JCostModel()).export_rows()
        assert [_normalize_row(r) for r in rows] == \
            [_normalize_row(r) for r in jrows]
        assert ex.stats() == {"max_rows": 10_000, "exported": 3,
                              "skipped": 0, "outcomes_held": 0}
        path = str(tmp_path / "port.jsonl")
        manifest = ex.export_jsonl(path, rows=rows)
        assert manifest["rows"] == len(rows) == 3
        assert jfw.CorpusExporter.load_jsonl(path) == rows
        jpath = str(tmp_path / "jax.jsonl")
        jfw.CorpusExporter(explain=jrouter.explain).export_jsonl(
            jpath, rows=jrows)
        assert tfw.CorpusExporter.load_jsonl(jpath) == jrows
        # a row_version the reader does not know is refused by both
        with open(path) as f:
            lines = f.read().splitlines()
        lines[0] = lines[0].replace('"row_version": 1', '"row_version": 9')
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        for mod in (tfw, jfw):
            with pytest.raises(ValueError, match="row_version"):
                mod.CorpusExporter.load_jsonl(path)
        # routing records for the selection trainers
        assert [tuple(vars(r).values()) for r in
                tfw.rows_to_routing_records(synth_rows(20))] == \
            [tuple(vars(r).values()) for r in
             jfw.rows_to_routing_records(synth_rows(20))]
    finally:
        jrouter.shutdown()
        trouter.shutdown()


# -- TestFeatures ---------------------------------------------------------------


@pytest.mark.parametrize("dim", [16, 32, 64])
def test_features_equal_jax_from_rows_and_live(dim):
    rows = synth_rows(40, seed=dim)
    rows[3]["signals"]["domain"] = [["computer science", 0.71],
                                    ["business", 0.2]]
    rows[5]["signals"]["projection"] = [["band:fast", 0.5]]
    for row in rows:
        got = tfw.row_features(row, dim=dim)
        assert np.array_equal(got, jfw.row_features(row, dim=dim))
        assert got.dtype == np.float32
        assert np.array_equal(
            tfw.signals_obj_features(_matches(row, SignalMatches), dim=dim),
            got)
        assert np.array_equal(
            jfw.signals_obj_features(_matches(row, JMatches), dim=dim), got)
    assert tfw.feature_dim(dim) == jfw.feature_dim(dim)
    assert (tfw.FEATURE_KIND, tfw.DEFAULT_DIM) == \
        (jfw.FEATURE_KIND, jfw.DEFAULT_DIM)
    assert not np.allclose(tfw.row_features(rows[0]),
                           tfw.row_features(rows[1]))


# -- TestLiveVsCorpusFeatureParity --------------------------------------------------


def test_shadow_choice_equals_the_counterfactual_choice():
    router = _port_fixture_router()
    try:
        fw = tfw.FlywheelController(MetricsRegistry(), device="cpu")
        fw.bind(explain=router.explain, events=EventBus(),
                cost_model=CostModel(), router=router)
        fw.configure({"enabled": True})
        router.flywheel = fw
        sel = tfw.CostAwareBanditSelector(dim=64)
        sel.fit_offline(synth_rows(100))
        fw.candidate = sel
        fw.candidate_meta = {"algorithm": "cost_bandit"}
        fw.enter_shadow(reason="test")
        res = router.route({"model": "auto", "messages": [
            {"role": "user", "content": "convene a panel of experts please"}]})
        rec = router.explain.get(res.decision_record_id)
        fly = [p for p in rec["plugins"] if p["plugin"] == "flywheel"]
        assert fly and fly[0]["verdict"] == "shadow"
        row = tfw.record_to_row(rec, cost_model=CostModel())
        assert "projection" in row["signals"]
        assert _policy_choice(sel, row) == fly[0]["detail"]["chosen"] == \
            j_policy_choice(sel, row)
        fw.close()
    finally:
        router.shutdown()


# -- TestHotReloadReinstall -------------------------------------------------------


def test_rebinding_a_new_router_keeps_the_promotion():
    old_router, new_router = _port_fixture_router(), _port_fixture_router()
    try:
        fw = tfw.FlywheelController(MetricsRegistry())
        fw.bind(events=EventBus(), cost_model=CostModel(), router=old_router)
        fw.configure({"enabled": True})
        fw.candidate = _AlwaysBestPolicy()
        fw.last_eval = {"cost_by_decision": {"fusion_route": {}}}
        assert fw.promote(reason="test") == ["fusion_route"]
        assert old_router._selectors["fusion_route"] is fw.candidate
        fresh = object()
        new_router._selectors["fusion_route"] = fresh
        fw.bind(router=new_router)
        assert new_router._selectors["fusion_route"] is fw.candidate
        assert fw.state == "promoted"
        fw.rollback("test")
        assert new_router._selectors["fusion_route"] is fresh
    finally:
        old_router.shutdown()
        new_router.shutdown()


# -- TestCostAwareBandit ---------------------------------------------------------


def _score(sel, row, ctx_cls, matches_cls, ref_cls):
    refs = [ref_cls(model=m, weight=0.3 + 0.2 * i)
            for i, m in enumerate(row["candidates"])]
    ctx = ctx_cls(signals=_matches(row, matches_cls),
                  decision_name=row["decision"])
    res = sel.select(refs, ctx)
    return (res.ref.model, res.score, res.reason,
            sel.score_breakdown(refs, ctx))


@pytest.mark.parametrize("dim,alpha,cost_weight,ridge", [
    (64, 0.0, 0.1, 1.0), (32, 0.5, 0.0, 1.0), (16, 0.0, 0.5, 3.0)])
def test_bandit_blobs_and_choices_equal_jax(dim, alpha, cost_weight, ridge):
    rows = synth_rows(200, seed=dim)
    t = tfw.CostAwareBanditSelector(dim=dim, alpha=alpha,
                                    cost_weight=cost_weight, ridge=ridge)
    j = jfw.CostAwareBanditSelector(dim=dim, alpha=alpha,
                                    cost_weight=cost_weight, ridge=ridge)
    assert t.fit_offline(rows) == j.fit_offline(rows)
    assert t.to_json() == j.to_json()
    back = tfw.CostAwareBanditSelector.from_json(j.to_json())
    assert back.to_json() == t.to_json()
    for row in rows[:30]:
        assert _score(t, row, SelectionContext, SignalMatches, ModelRef) \
            == _score(j, row, JContext, JMatches, JModelRef) \
            == _score(back, row, SelectionContext, SignalMatches, ModelRef)
    assert _score(t, rows[0], SelectionContext, SignalMatches,
                  ModelRef)[0] == "code-7b"
    assert _score(t, rows[1], SelectionContext, SignalMatches,
                  ModelRef)[0] == "general-7b"
    # trained-width feedback updates both alike; a foreign width is ignored
    x = tfw.row_features(rows[2], dim=dim).astype(np.float64)
    for sel, fb_cls in ((t, Feedback), (j, None)):
        from semantic_router_tpu.selection.base import Feedback as JFeedback

        cls = fb_cls or JFeedback
        sel.update(cls(model="code-7b", success=True, query_embedding=x))
        sel.update(cls(model="code-7b", success=True,
                       query_embedding=np.ones(7, np.float32)))
    assert t.to_json() == j.to_json()


def test_bandit_registered_untrained_and_refuses_foreign_kinds(tmp_path):
    sel = selector_registry.create("cost_bandit", dim=16)
    assert isinstance(sel, tfw.CostAwareBanditSelector)
    refs = [ModelRef(model="a", weight=0.2), ModelRef(model="b", weight=0.8)]
    res = sel.select(refs, SelectionContext())
    jres = jfw.CostAwareBanditSelector(dim=16).select(
        [JModelRef(model="a", weight=0.2), JModelRef(model="b", weight=0.8)],
        JContext())
    assert (res.ref.model, res.score, res.reason) == \
        (jres.ref.model, jres.score, jres.reason) == \
        ("b", 0.8, "cost_bandit untrained → weight argmax")
    with pytest.raises(ValueError):
        sel.select([], SelectionContext())
    blob = json.loads(sel.to_json())
    blob["features"]["kind"] = "other-v0"
    for mod in (tfw, jfw):
        with pytest.raises(ValueError, match="feature kind"):
            mod.CostAwareBanditSelector.from_json(json.dumps(blob))
    from semantic_router_tpu_torch.training.selection_train import \
        load_selector

    fitted = tfw.CostAwareBanditSelector(dim=16)
    fitted.fit_offline(synth_rows(40))
    path = str(tmp_path / "cost_bandit.json")
    with open(path, "w") as f:
        f.write(fitted.to_json())
    loaded = load_selector(path, device="cpu")
    assert isinstance(loaded, tfw.CostAwareBanditSelector)
    assert loaded.to_json() == fitted.to_json()
    assert tfw.load_policy(path).to_json() == fitted.to_json()
    assert tfw.load_policy(fitted.to_json()).to_json() == fitted.to_json()


def test_cost_penalty_flips_near_ties_like_jax():
    base = synth_rows(2)[0]
    rows = []
    for i in range(40):
        chosen = ("slow-model", "fast-model")[i % 2]
        rows.append(dict(
            base, record_id=f"{i:016x}", decision="tie_route",
            candidates=["slow-model", "fast-model"], chosen=chosen,
            reward=0.8,
            outcome={"verdict": "good_fit", "quality": 0.0,
                     "latency_ms": 4000.0 if chosen == "slow-model"
                     else 100.0, "source": "observed"}))
    for weight, want in ((0.5, "fast-model"), (0.0, None)):
        t = tfw.CostAwareBanditSelector(dim=16, cost_weight=weight)
        j = jfw.CostAwareBanditSelector(dim=16, cost_weight=weight)
        t.fit_offline(rows)
        j.fit_offline(rows)
        assert t.to_json() == j.to_json()
        assert t.model_costs["slow-model"] == 1.0
        got = _score(t, rows[0], SelectionContext, SignalMatches, ModelRef)
        assert got == _score(j, rows[0], JContext, JMatches, JModelRef)
        if want:
            assert got[0] == want


# -- TestCounterfactualEvaluator ------------------------------------------------


class _Echo:
    def select(self, candidates, ctx):
        from semantic_router_tpu_torch.selection.base import SelectionResult

        return SelectionResult(candidates[0], 1.0, "echo")


class _Raises:
    def select(self, candidates, ctx):
        raise RuntimeError("boom")


@pytest.mark.parametrize("policy", ["best", "echo", "raises", "bandit"])
@pytest.mark.parametrize("seed", [0, 7])
def test_counterfactual_reports_equal_jax(policy, seed):
    rows = synth_rows(300, seed=seed)
    pol = {"best": _AlwaysBestPolicy(), "echo": _Echo(),
           "raises": _Raises()}.get(policy)
    if pol is None:
        pol = tfw.CostAwareBanditSelector(dim=64)
        pol.fit_offline(rows[:150])
    got = tfw.counterfactual_eval(rows, pol, n_boot=200, seed=seed)
    want = jfw.counterfactual_eval(rows, pol, n_boot=200, seed=seed)
    assert got == want and json.dumps(got) == json.dumps(want)
    if policy == "best":
        assert got["win"] and got["reward_delta_ci"][0] > 0
        assert got["policy"]["regret_mean"] < got["incumbent"]["regret_mean"]
        assert set(got["decision_values"]) == {"code_route", "chat_route"}
    deltas = np.random.default_rng(seed).normal(0.1, 0.3, 50)
    for n_boot in (1, 50):
        assert tfw.bootstrap_ci(deltas, n_boot=n_boot, seed=seed) == \
            jfw.bootstrap_ci(deltas, n_boot=n_boot, seed=seed)
    assert tfw.bootstrap_ci(np.asarray([]), seed=seed) == (0.0, 0.0)


def test_min_rows_floor_and_reward_model_match_jax():
    rows = synth_rows(4)
    for min_rows in (0, 4, 5, 50):
        assert tfw.counterfactual_eval(rows, _AlwaysBestPolicy(),
                                       min_rows=min_rows) == \
            jfw.counterfactual_eval(rows, _AlwaysBestPolicy(),
                                    min_rows=min_rows)
    assert not tfw.counterfactual_eval(rows, _AlwaysBestPolicy(),
                                       min_rows=50)["evaluated"]
    t, j = tfw.RewardModel(synth_rows(50)), jfw.RewardModel(synth_rows(50))
    for d in ("code_route", "chat_route", "nope"):
        for m in ("code-7b", "general-7b", "premium-70b", "ghost"):
            assert t.reward(d, m) == j.reward(d, m)
        assert t.best(d, ["code-7b", "ghost"]) == \
            j.best(d, ["code-7b", "ghost"])
    assert tfw.RewardModel([]).global_mean == 0.5


# -- TestPromotionMachine ---------------------------------------------------------


def _controllers(router_pair=None, **cfg):
    out = []
    for mod, reg, bus, cm, r in (
            (jfw, JMetricsRegistry, JEventBus, JCostModel,
             router_pair[0] if router_pair else None),
            (tfw, MetricsRegistry, EventBus, CostModel,
             router_pair[1] if router_pair else None)):
        b = bus()
        fw = mod.FlywheelController(reg())
        fw.bind(events=b, cost_model=cm(), router=r,
                explain=r.explain if r is not None else None)
        fw.configure({"enabled": True,
                      "evaluator": {"min_rows": 10, "bootstrap": 50},
                      "promotion": {"mode": "shadow"}, **cfg})
        events = []
        b.subscribe(lambda ev, events=events: events.append(
            (ev.stage, {k: v for k, v in ev.detail.items()}))
            if ev.stage in (FLYWHEEL_STATE_CHANGED, SLO_ALERT_FIRING)
            else None)
        out.append((fw, b, events))
    return out


def _script(fw, bus, steps):
    out = []
    for step in steps:
        op = step[0]
        try:
            if op == "candidate":
                fw.candidate = _AlwaysBestPolicy()
            elif op == "shadow":
                fw.enter_shadow()
            elif op == "canary":
                fw.enter_canary(**step[1])
            elif op == "emit":
                bus.emit(SLO_ALERT_FIRING, **step[1])
            elif op == "configure":
                fw.configure(step[1])
            elif op == "rollback":
                fw.rollback("test")
            out.append((op, fw.state, fw.rollback_reason))
        except RuntimeError as exc:
            out.append((op, "raised", str(exc)))
    return out


SCRIPTS = {
    "shadow_needs_a_candidate": [("shadow",), ("canary", {}),
                                 ("candidate",), ("shadow",)],
    "slo_burn_rolls_back_a_canary": [
        ("candidate",), ("canary", {"fraction": 0.5}),
        ("emit", {"objective": "routing_latency", "severity": "fast"})],
    "fast_ignores_a_slow_burn": [
        ("configure", {"promotion": {"rollback_on": "fast"}}),
        ("candidate",), ("canary", {}),
        ("emit", {"objective": "x", "severity": "slow"}),
        ("emit", {"objective": "x", "severity": "fast"})],
    "burn_outside_canary_is_ignored": [
        ("emit", {"objective": "x", "severity": "fast"}), ("candidate",),
        ("shadow",), ("emit", {"objective": "x"})],
    "state_changes_emit_events": [("candidate",), ("shadow",),
                                  ("canary", {}), ("rollback",),
                                  ("shadow",)],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_state_machine_matches_jax_event_for_event(name):
    (jf, jb, jev), (tf, tb, tev) = _controllers()
    try:
        assert _script(tf, tb, SCRIPTS[name]) == _script(jf, jb, SCRIPTS[name])
        assert tev == jev
        assert [(t["from"], t["to"], t["reason"]) for t in tf.transitions] \
            == [(t["from"], t["to"], t["reason"]) for t in jf.transitions]
        assert tf.state_gauge.values() == jf.state_gauge.values()
        assert tf.transitions_total.values() == \
            jf.transitions_total.values()
    finally:
        jf.close()
        tf.close()


def _fixture_pair_routers():
    return _fixture_router(), _port_fixture_router()


def test_run_cycle_never_replaces_a_serving_candidate():
    routers = _fixture_pair_routers()
    ctls = _controllers(routers)
    try:
        for text in ("debug a", "debug b", "hello world") * 8:
            for r in routers:
                r.route({"model": "auto", "messages": [
                    {"role": "user", "content": text}]})
        reports = []
        for fw, bus, _ in ctls:
            serving = _AlwaysBestPolicy()
            fw.candidate = serving
            fw.enter_canary(reason="test")
            rep = fw.run_cycle()
            assert rep.get("skipped_promotion") and fw.state == "canary"
            assert fw.candidate is serving
            bus.emit(SLO_ALERT_FIRING, objective="x", severity="fast")
            assert fw.state == "rolled_back"
            reports.append(rep)
        assert reports[1] == reports[0]
    finally:
        for fw, _, _ in ctls:
            fw.close()
        for r in routers:
            r.shutdown()


def test_promote_installs_and_rollback_restores():
    routers = _fixture_pair_routers()
    ctls = _controllers(routers)
    try:
        took = []
        for (fw, _, _), r in zip(ctls, routers):
            fw.candidate = _AlwaysBestPolicy()
            fw.last_eval = {"cost_by_decision": {
                "cs_reasoning_route": {}, "fusion_route": {}}}
            sentinel = object()
            r._selectors["fusion_route"] = sentinel
            took.append(fw.promote())
            assert r._selectors["fusion_route"] is fw.candidate
            fw.rollback("test")
            assert r._selectors["fusion_route"] is sentinel
            assert "cs_reasoning_route" not in r._selectors
            assert fw.state == "rolled_back"
        assert took[1] == took[0] and set(took[1]) == {
            "cs_reasoning_route", "fusion_route"}
    finally:
        for fw, _, _ in ctls:
            fw.close()
        for r in routers:
            r.shutdown()


# -- TestAdmissionValueWeights ---------------------------------------------------


ADMISSION = [
    ({"high": {"chat_route": 10}, "low": {"code_route": 10}},
     {"chat_route": 200.0, "code_route": 50.0}, {}),
    ({"high": {"a": 1}, "low": {"b": 1}}, {"a": 1e6, "b": 1e-6},
     {"floor": 0.5, "ceiling": 2.0}),
    ({"high": {"a": 3, "b": 1}, "normal": {"b": 5}, "low": {"c": 2}},
     {"a": 0.3, "b": 0.9, "c": 0.0}, {}),
    ({"high": {"a": 1}}, {}, {}),
    ({"high": {"a": 1}}, {"a": 1.0}, {"enabled": False}),
    ({"low": {"z": 4}}, {"a": 2.0}, {}),
]


@pytest.mark.parametrize("case", range(len(ADMISSION)))
def test_admission_weights_and_the_l3_charge_match_jax(case):
    traffic, values, adm = ADMISSION[case]
    rows = []
    for mod, reg, cm_cls, ctl in ((jfw, JMetricsRegistry, JCostModel, jctl),
                                  (tfw, MetricsRegistry, CostModel, tctl)):
        cm = cm_cls()
        fw = mod.FlywheelController(reg())
        fw.bind(cost_model=cm)
        fw.configure({"enabled": True, "admission": adm})
        fw._class_traffic = copy.deepcopy(traffic)
        weights = fw.update_admission_weights({"decision_values": values})
        base = cm.request_cost_s(2)
        charges = {c: cm.admission_cost_s(2, c)
                   for c in ("high", "normal", "low", "")}
        # the ladder at L3: each class's bucket is charged the weighted
        # cost (the controller's own admit)
        dc = ctl.DegradationController(reg(), cost_model=cm)
        dc.configure({"enabled": True, "max_level": 3,
                      "admission": {"reject_class": "low",
                                    "burst_s": 1.0,
                                    "target_utilization": 0.5}})
        dc._level = 3
        disp = [dc.admit(c, n_signals=2) for c in ("high", "low")]
        rows.append((weights, charges, base, cm.report()["value_weights"],
                     [(d.level, d.reason) for d in disp]))
        if weights:
            for c, w in weights.items():
                assert charges.get(c, cm.admission_cost_s(2, c)) == \
                    base / max(w, 0.05)
        fw.close()
        dc.stop()
    assert rows[1] == rows[0]


def test_l3_bucket_is_charged_request_cost_over_the_weight():
    """The port's controller at L3 takes ``request_cost_s / weight`` from
    a class's bucket, as the reference's does."""
    takes = []
    for ctl, cm_cls, reg in ((jctl, JCostModel, JMetricsRegistry),
                             (tctl, CostModel, MetricsRegistry)):
        cm = cm_cls()
        cm.set_value_weights({"high": 2.0, "normal": 0.5})
        dc = ctl.DegradationController(reg(), cost_model=cm)
        dc.configure({"enabled": True, "max_level": 3,
                      "admission": {"reject_class": "low",
                                    "burst_s": 1.0,
                                    "target_utilization": 0.5}})
        dc._level = 3
        dc._refresh_buckets()
        got = {}
        for cls in ("high", "normal"):
            bucket = dc._buckets[cls]
            bucket._tokens = bucket.capacity
            bucket._last = time.monotonic() + 1e6  # no refill in between
            dc.admit(cls, n_signals=1)
            got[cls] = bucket.capacity - bucket._tokens
        takes.append(got)
        assert got["high"] == pytest.approx(cm.request_cost_s(1) / 2.0)
        assert got["normal"] == pytest.approx(cm.request_cost_s(1) / 0.5)
        # the reject class is shed outright, whatever its weight
        assert dc.admit("low").reason == "lowest_class_rejected"
        dc.stop()
    assert takes[1] == takes[0]


# -- TestBootstrapWiring -----------------------------------------------------------


FLYWHEEL_BLOCKS = [
    {}, {"enabled": True}, {"enabled": 1, "evaluator": {"min_rows": "nope"},
                            "promotion": {"canary_fraction": "bad"}},
    {"enabled": True, "cycle_interval_s": 30,
     "trainer": {"algorithms": "cost_bandit", "alpha": "x",
                 "unknown": 1}},
    {"enabled": True, "cycle_interval_s": "soon",
     "corpus": {"max_rows": 50, "path": 7}, "features": {"dim": "64"},
     "admission": {"enabled": 0, "floor": "0.5"}},
    {"enabled": False, "trainer": {"algorithms": ["cost_bandit", "mlp"]},
     "promotion": {"mode": "auto", "canary_min_requests": 12.7}},
]


@pytest.mark.parametrize("block", FLYWHEEL_BLOCKS,
                         ids=[str(i) for i in range(len(FLYWHEEL_BLOCKS))])
def test_normaliser_and_validator_match_jax(block):
    d = {"flywheel": copy.deepcopy(block)}
    got = load_config(copy.deepcopy(d)).flywheel_config()
    want = JRouterConfig.from_dict(copy.deepcopy(d)).flywheel_config()
    assert got == want
    assert RouterConfig().flywheel_config() == \
        JRouterConfig().flywheel_config()
    assert validate_config(load_config(copy.deepcopy(d))) == []


def test_apply_flywheel_knobs_attaches_and_detaches_like_jax():
    jrouter, trouter = _fixture_pair_routers()
    try:
        jreg, treg = JRuntimeRegistry.isolated(), RuntimeRegistry.isolated()
        on = {"flywheel": {"enabled": True, "cycle_interval_s": 0,
                           "promotion": {"mode": "auto"}}}
        jboot.apply_flywheel_knobs(JRouterConfig.from_dict(on), jreg, jrouter)
        apply_flywheel_knobs(load_config(on), treg, trouter)
        jf, tf = jreg.get("flywheel"), treg.get("flywheel")
        assert tf is not None and trouter.flywheel is tf
        assert tf.explain is treg.get("explain")
        assert tf.event_bus is treg.get("events")
        assert tf.cost_model is treg.get("resilience").cost_model
        assert tf.cfg == jf.cfg and tf.enabled == jf.enabled
        # a re-apply keeps the controller
        apply_flywheel_knobs(load_config(on), treg, trouter)
        assert treg.get("flywheel") is tf
        off = {}
        jboot.apply_flywheel_knobs(JRouterConfig.from_dict(off), jreg,
                                   jrouter)
        apply_flywheel_knobs(load_config(off), treg, trouter)
        assert treg.get("flywheel") is None and trouter.flywheel is None
        assert jreg.get("flywheel") is None and jrouter.flywheel is None
        # a malformed block never raises
        bad = load_config({"flywheel": {"enabled": True}})
        bad.flywheel = {"enabled": True, "corpus": "not a dict"}
        apply_flywheel_knobs(bad, treg, trouter)
    finally:
        for reg in (jreg, treg):
            if reg.get("flywheel") is not None:
                reg.flywheel.close()
        jrouter.shutdown()
        trouter.shutdown()


def _keyed_cfg(flywheel=True, keys=None):
    d = copy.deepcopy(SMOKE_CFG)
    if flywheel:
        d["flywheel"] = {"enabled": True,
                         "evaluator": {"min_rows": 20, "bootstrap": 50},
                         "trainer": {"algorithms": ["cost_bandit", "mlp"]}}
    if keys:
        d["api_server"] = {"api_keys": [{"key": k, "roles": r}
                                        for k, r in keys.items()]}
    return d


def _write(path, d):
    with open(path, "w") as f:
        f.write(yaml.safe_dump(d, sort_keys=False))
    st = os.stat(path)
    os.utime(path, (st.st_atime, st.st_mtime + 5.0))


def test_hot_reload_reinstalls_the_promotion_and_patch_attaches(tmp_path):
    path = str(tmp_path / "router.yaml")
    d = _keyed_cfg()
    _write(path, d)
    reg = RuntimeRegistry.isolated()
    backend = MockVLLMServer().start()
    server = RouterServer(build_router(load_config(path), None,
                                       registry=reg),
                          backend.url, registry=reg, config_path=path)
    server.start()
    watcher = attach_config_watcher(server, path, None, reg, start=False)
    try:
        fw = reg.get("flywheel")
        assert server.router.flywheel is fw
        fw.device = "cpu"
        fw.candidate = _AlwaysBestPolicy()
        fw.last_eval = {"cost_by_decision": {"code_route": {},
                                             "chat_route": {}}}
        assert sorted(fw.promote(reason="test")) == ["chat_route",
                                                     "code_route"]
        old = server.router
        d2 = copy.deepcopy(d)
        d2["default_model"] = "premium-70b"
        _write(path, d2)
        assert watcher.poll_once()
        new = server.router
        assert new is not old and reg.get("flywheel") is fw
        assert new.flywheel is fw and fw.state == "promoted"
        assert new._selectors["code_route"] is fw.candidate
        res = new.route(_requests(1)[0])
        assert res.model == "code-7b" and res.selection_reason == "oracle"
        fw.rollback("test")
        assert "code_route" not in new._selectors
        # off through a reload, on again through PATCH /config/router
        _write(path, _keyed_cfg(flywheel=False))
        assert watcher.poll_once()
        assert reg.get("flywheel") is None and server.router.flywheel is None
        st, body = _http(server.url, "PATCH", "/config/router",
                         {"flywheel": {"enabled": True}})
        assert st == 200, body
        _write(path, yaml.safe_load(open(path)))
        assert watcher.poll_once()
        assert reg.get("flywheel") is not None
        assert server.router.flywheel is reg.get("flywheel")
    finally:
        server.stop()
        server.router.shutdown()
        backend.stop()
        if reg.get("flywheel") is not None:
            reg.flywheel.close()
        for slot in ("runtimestats", "slo", "resilience"):
            reg.get(slot).stop()


# -- TestScheduledCycleRunner ------------------------------------------------------


def _wait(cond, timeout=3.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


@pytest.mark.parametrize("mode", ["drives", "zero_stops", "errors_contained"])
def test_scheduled_cycle_runner(mode):
    fw = tfw.FlywheelController(MetricsRegistry())
    calls = []

    def cycle(*a, **k):
        calls.append(1)
        if mode == "errors_contained":
            raise RuntimeError("cycle exploded")

    fw.run_cycle = cycle
    try:
        fw.configure({"enabled": True, "cycle_interval_s": 0.01})
        assert _wait(lambda: len(calls) >= 2)
        # the runner floors its period at 50 ms, as the reference's
        assert fw.stats()["cycle_interval_s"] == 0.05
        if mode == "drives":
            assert fw.cycles_run >= 1
        if mode == "errors_contained":
            assert fw.cycles_run == 0  # failures are not counted as runs
        if mode == "zero_stops":
            fw.configure({"enabled": True, "cycle_interval_s": 0})
            assert fw._cycle_thread is None
            n = len(calls)
            time.sleep(0.15)
            assert len(calls) == n
        # disabled: the runner does not start at all
        fw.configure({"enabled": False, "cycle_interval_s": 0.04})
        assert fw._cycle_thread is None
    finally:
        fw.close()
    assert load_config({"flywheel": {"cycle_interval_s": 30}}) \
        .flywheel_config()["cycle_interval_s"] == 30.0


# -- the cascade ---------------------------------------------------------------------


def test_cascade_order_reads_the_decision_values_like_jax():
    (jd, je, jcfg), (td, te, tcfg) = _fixture_pair()
    try:
        jplan = jcascade.build_plan(je, jd, jcfg.signals)
        tplan = tcascade.build_plan(te, td, tcfg.signals)
        rng = np.random.default_rng(4)
        moved = 0
        for _ in range(12):
            values = {n: float(rng.uniform(0, 50)) for n in tplan.relevance
                      if rng.random() < 0.5}
            fake = SimpleNamespace(state="shadow",
                                   last_eval={"decision_values": values})
            j = jcascade.CascadeEvaluator(flywheel_provider=lambda: fake)
            t = tcascade.CascadeEvaluator(flywheel_provider=lambda: fake)
            plain = tcascade.CascadeEvaluator()
            for ev in (j, t, plain):
                ev.configure({"value_blend": 1.0, "cost_default_ms": 5.0})
            got = t._order(tplan)
            assert got == j._order(jplan)
            moved += got != plain._order(tplan)
        assert moved > 0
        broken = SimpleNamespace(state="idle",
                                 last_eval={"decision_values": {"x": "?"}})
        t = tcascade.CascadeEvaluator(flywheel_provider=lambda: broken)
        assert t._order(tplan) == tcascade.CascadeEvaluator()._order(tplan)
    finally:
        jd.shutdown()
        td.shutdown()


@pytest.mark.parametrize("state", ["canary", "promoted", "shadow"])
def test_cascade_passthrough_in_canary_like_jax(engines, state):  # noqa: F811
    jr, tr = _routers(engines)
    fake = SimpleNamespace(state=state, last_eval=None)
    jr.cascade.flywheel_provider = tr.cascade.flywheel_provider = \
        lambda: fake
    try:
        for text in CORPUS[:6]:
            j, t = jr.route(_body(text)), tr.route(_body(text))
            assert (t.model, t.decision is None) == \
                (j.model, j.decision is None)
            assert t.report.cascade.get("mode") == \
                j.report.cascade.get("mode")
            if state == "shadow":
                assert t.report.cascade.get("mode") != "passthrough"
            else:
                assert t.report.cascade == j.report.cascade == {
                    "mode": "passthrough", "reason": f"flywheel_{state}",
                    "planner_version": t.report.cascade["planner_version"]}
    finally:
        jr.cascade = tr.cascade = None
        jr.shutdown()
        tr.shutdown()


# -- /debug/flywheel over HTTP ---------------------------------------------------------


KEYS = {"view-key": ["view"], "edit-key": ["edit"]}


def _http(url, method, path, body=None, key=""):
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    try:
        data = None if body is None else json.dumps(body).encode()
        headers = {"content-type": "application/json"} if data else {}
        if key:
            headers["x-api-key"] = key
        conn.request(method, path, body=data, headers=headers)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


class _Servers:
    """The JAX and the port server over one config (with its flywheel
    when enabled), each on its own isolated registry."""

    def __init__(self, d, backend):
        self.jreg, self.treg = JRuntimeRegistry.isolated(), \
            RuntimeRegistry.isolated()
        jcfg = JRouterConfig.from_dict(copy.deepcopy(d))
        self.jrouter = jboot.build_router(jcfg, registry=self.jreg)
        jboot.apply_flywheel_knobs(jcfg, self.jreg, self.jrouter)
        self.trouter = build_router(load_config(copy.deepcopy(d)),
                                    registry=self.treg)
        if self.treg.get("flywheel") is not None:
            self.treg.flywheel.device = "cpu"
        self.j = JServer(self.jrouter, jcfg, default_backend=backend.url,
                         registry=self.jreg).start()
        self.t = RouterServer(self.trouter, backend.url,
                              registry=self.treg).start()
        self.urls = {"jax": self.j.url, "port": self.t.url}

    def both(self, method, path, body=None, key=""):
        return {n: _http(u, method, path, body, key)
                for n, u in self.urls.items()}

    def close(self):
        self.j.stop()
        self.t.stop()
        for reg in (self.jreg, self.treg):
            if reg.get("flywheel") is not None:
                reg.flywheel.close()
        self.jrouter.shutdown()
        self.trouter.shutdown()


def _sans_volatile(stats):
    stats = copy.deepcopy(stats)
    stats.pop("last_cycle_at", None)
    for t in stats.get("transitions", []):
        t.pop("at_unix", None)
    for entry in (stats.get("last_train") or {}).values():
        if isinstance(entry, dict):
            entry.pop("accuracy", None)  # each package's own MLP init
    return stats


def test_debug_routes_match_jax_with_and_without_a_flywheel():
    backend = MockVLLMServer().start()
    off = _Servers(_keyed_cfg(flywheel=False), backend)
    on = _Servers(_keyed_cfg(), backend)
    try:
        got = off.both("GET", "/debug/flywheel")
        assert got["port"] == got["jax"] and got["port"][0] == 503
        got = off.both("POST", "/debug/flywheel/cycle", {})
        assert got["port"] == got["jax"] and got["port"][0] == 503
        got = on.both("GET", "/debug/flywheel")
        assert got["port"][0] == got["jax"][0] == 200
        assert _sans_volatile(got["port"][1]) == \
            _sans_volatile(got["jax"][1])
        for i, body in enumerate(_requests(40)):
            h = {"traceparent": f"00-{i + 7:032x}-{i + 1:016x}-01"}
            routes = []
            for r in (on.jrouter, on.trouter):
                res = r.route(copy.deepcopy(body), dict(h))
                good = res.model == {"code_route": "code-7b",
                                     "chat_route": "general-7b"}[
                    res.decision.decision.name]
                r.record_feedback(res, verdict="good_fit" if good
                                  else "underpowered")
                routes.append(res)
            assert same_route(*routes)
        got = on.both("POST", "/debug/flywheel/cycle", {})
        (js, jrep), (ts, trep) = got["jax"], got["port"]
        assert ts == js == 200
        assert trep["eval"] == jrep["eval"] and trep["state"] == "shadow"
        assert trep["trained"] == jrep["trained"] == ["corpus",
                                                      "cost_bandit", "mlp"]
        got = on.both("GET", "/debug/flywheel")
        assert _sans_volatile(got["port"][1]) == \
            _sans_volatile(got["jax"][1])
        assert got["port"][1]["admission_weights"] == {"normal": 1.0}
    finally:
        on.close()
        off.close()
        backend.stop()


def test_debug_routes_through_the_access_gate_like_jax():
    backend = MockVLLMServer().start()
    srv = _Servers(_keyed_cfg(keys=KEYS), backend)
    try:
        rows = {}
        for key in ("", "nope", "view-key", "edit-key"):
            for method, path in (("GET", "/debug/flywheel"),
                                 ("POST", "/debug/flywheel/cycle")):
                got = srv.both(method, path, {} if method == "POST"
                               else None, key)
                assert got["port"][0] == got["jax"][0], (key, path, got)
                rows[(key, path)] = got["port"][0]
        assert rows == {("", "/debug/flywheel"): 401,
                        ("", "/debug/flywheel/cycle"): 401,
                        ("nope", "/debug/flywheel"): 401,
                        ("nope", "/debug/flywheel/cycle"): 401,
                        ("view-key", "/debug/flywheel"): 200,
                        ("view-key", "/debug/flywheel/cycle"): 403,
                        ("edit-key", "/debug/flywheel"): 403,
                        ("edit-key", "/debug/flywheel/cycle"): 200}
    finally:
        srv.close()
        backend.stop()


# -- the trainer ------------------------------------------------------------------------


def test_train_policies_matches_jax_and_fits_on_the_given_device(tmp_path):
    rows = synth_rows(120)
    algos = ["cost_bandit", "mlp", "knn", "nope"]
    got = tfw.train_policies(rows, algorithms=algos,
                             out_dir=str(tmp_path / "port"), dim=32,
                             device="cpu")
    want = jfw.train_policies(rows, algorithms=algos,
                              out_dir=str(tmp_path / "jax"), dim=32)
    assert got["corpus"] == want["corpus"]
    assert got["cost_bandit"]["blob"] == want["cost_bandit"]["blob"]
    assert got["cost_bandit"]["arms"] == want["cost_bandit"]["arms"]
    assert got["knn"]["blob"] == want["knn"]["blob"]
    assert got["knn"]["accuracy"] == want["knn"]["accuracy"]
    assert got["nope"] == {"artifact": None, "error": got["nope"]["error"]}
    assert "error" in want["nope"]
    mlp = json.loads(got["mlp"]["blob"])
    assert mlp["algorithm"] == "mlp" and "error" not in got["mlp"]
    assert abs(got["mlp"]["accuracy"] - want["mlp"]["accuracy"]) <= 0.1
    sel = tfw.load_policy(got["mlp"]["artifact"], device="cpu")
    assert type(sel).__name__ == "CategoryFeatureSelector"
    assert str(sel.inner.work.device) == "cpu"
