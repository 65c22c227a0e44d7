"""The reference's flywheel smoke loop (tests/test_flywheel_smoke.py) on
the port's ``Router`` and the JAX ``Router`` side by side, from one config,
on the CPU: labelled traffic → corpus rows → the cost-aware bandit →
counterfactual evaluation → shadow → canary → promote → SLO-burn rollback.
Each request carries the same W3C trace id into both routers, so the
canary's per-trace-id draw is the same; rows are compared once the
record ids and times (fresh per process) are set aside, and bandit blobs
and evaluation reports byte for byte.  Shadow on and off route alike on
the port; export → train → evaluate reruns are deterministic.  One case
routes through a seeded tiny learned ``domain`` bank (the plain K1 / K2
versions on the CPU): its rows' confidences agree within ``TOL`` (f32),
every other field is exact."""

import copy
import json

import numpy as np
import pytest
import torch

from semantic_router_tpu import flywheel as jfw
from semantic_router_tpu.config.schema import RouterConfig as JRouterConfig
from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.observability.explain import \
    DecisionExplainer as JExplainer
from semantic_router_tpu.observability.flightrec import \
    FlightRecorder as JFlightRecorder
from semantic_router_tpu.observability.metrics import \
    MetricSeries as JMetricSeries, MetricsRegistry as JMetricsRegistry
from semantic_router_tpu.observability.tracing import Tracer as JTracer
from semantic_router_tpu.resilience.costmodel import CostModel as JCostModel
from semantic_router_tpu.router.pipeline import Router as JRouter
from semantic_router_tpu.runtime.events import EventBus as JEventBus
from semantic_router_tpu_torch import flywheel as tfw
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.observability.explain import \
    DecisionExplainer
from semantic_router_tpu_torch.observability.flightrec import FlightRecorder
from semantic_router_tpu_torch.observability.metrics import MetricSeries, \
    MetricsRegistry
from semantic_router_tpu_torch.observability.tracing import Tracer
from semantic_router_tpu_torch.resilience.costmodel import CostModel
from semantic_router_tpu_torch.router import Router
from semantic_router_tpu_torch.runtime.events import SLO_ALERT_FIRING, \
    EventBus
from test_flywheel_smoke import BEST, SMOKE_CFG, _requests

TOL = 1e-4
VOLATILE_ROW = ("record_id", "ts_unix")
VOLATILE_HEADERS = ("x-vsr-decision-record", "x-vsr-request-id")
DOMAINS = ["business", "computer science", "health", "other"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trace(i: int) -> dict:
    """A fixed W3C trace id for request ``i``, spread over the id space
    (the canary draws on its rightmost bytes)."""
    tid = f"{(i * 2654435761 + 12345) % (1 << 128):032x}"
    if tid == "0" * 32:
        tid = "1" * 32
    return {"traceparent": f"00-{tid}-{i + 1:016x}-01"}


class Pair:
    """The JAX and the port router over one config (and, optionally, one
    seeded engine pair), each with its flywheel when ``flywheel`` names
    its config, driven in lockstep."""

    def __init__(self, cfg: dict, engines=(None, None), flywheel=None):
        jeng, teng = engines
        self.j = JRouter(JRouterConfig.from_dict(copy.deepcopy(cfg)),
                         engine=jeng,
                         explain=JExplainer(ring_size=2048),
                         metrics=JMetricSeries(JMetricsRegistry()),
                         tracer=JTracer(sample_rate=0.0),
                         flightrec=JFlightRecorder())
        self.t = Router(load_config(copy.deepcopy(cfg)), engine=teng,
                        explain=DecisionExplainer(ring_size=2048),
                        metrics=MetricSeries(MetricsRegistry()),
                        tracer=Tracer(sample_rate=0.0),
                        flightrec=FlightRecorder())
        self.jbus, self.tbus = JEventBus(), EventBus()
        self.jfw = self.tfw = None
        if flywheel is not None:
            self.jfw = jfw.FlywheelController(JMetricsRegistry())
            self.jfw.bind(explain=self.j.explain, events=self.jbus,
                          cost_model=JCostModel(), router=self.j)
            self.tfw = tfw.FlywheelController(MetricsRegistry(),
                                              device="cpu")
            self.tfw.bind(explain=self.t.explain, events=self.tbus,
                          cost_model=CostModel(), router=self.t)
            for fw, r in ((self.jfw, self.j), (self.tfw, self.t)):
                fw.configure(copy.deepcopy(flywheel))
                r.flywheel = fw
        self.n = 0

    def route(self, body: dict, label: bool = False):
        """Route ``body`` on both under one trace id; with ``label`` feed
        back the smoke's ground-truth verdict."""
        h = _trace(self.n)
        self.n += 1
        jres = self.j.route(copy.deepcopy(body), dict(h))
        tres = self.t.route(copy.deepcopy(body), dict(h))
        assert same_route(jres, tres)
        if label:
            for r, res in ((self.j, jres), (self.t, tres)):
                good = res.model == BEST.get(res.decision.decision.name)
                r.record_feedback(
                    res, success=True,
                    verdict="good_fit" if good else "underpowered",
                    latency_ms=120.0 if good else 900.0)
        return jres, tres

    def close(self):
        for fw in (self.jfw, self.tfw):
            if fw is not None:
                fw.close()
        self.j.shutdown()
        self.t.shutdown()


def same_route(a, b) -> bool:
    ha = {k: v for k, v in a.headers.items() if k not in VOLATILE_HEADERS}
    hb = {k: v for k, v in b.headers.items() if k not in VOLATILE_HEADERS}
    return (a.kind, a.model, a.selection_reason, ha) \
        == (b.kind, b.model, b.selection_reason, hb)


def flywheel_capture(router, res):
    rec = router.explain.get(res.decision_record_id)
    return [dict(p) for p in rec["plugins"] if p["plugin"] == "flywheel"]


def stable(rows):
    """(rows without their per-process fields and with each signal hit's
    confidence taken out, the confidences in row order)."""
    out, confs = [], []
    for row in rows:
        r = {k: v for k, v in row.items() if k not in VOLATILE_ROW}
        sig = {}
        for fam, hits in r["signals"].items():
            sig[fam] = [h[0] for h in hits]
            confs += [h[1] for h in hits]
        r["signals"] = sig
        out.append(r)
    return out, np.asarray(confs, np.float64)


def assert_rows_equal(jrows, trows, tol=0.0):
    assert len(jrows) == len(trows)
    js, jc = stable(jrows)
    ts, tc = stable(trows)
    assert ts == js
    if tol:
        assert np.max(np.abs(tc - jc), initial=0.0) <= tol
    else:
        assert tc.tolist() == jc.tolist()
        assert [r["signals"] for r in trows] == [r["signals"]
                                                 for r in jrows]


def _cycle_equal(jrep, trep):
    assert trep["rows"] == jrep["rows"]
    assert trep.get("eval") == jrep.get("eval")
    assert trep.get("state") == jrep.get("state")
    assert trep.get("trained") == jrep.get("trained")


FLYWHEEL = {"enabled": True,
            "evaluator": {"min_rows": 50, "bootstrap": 100, "seed": 0},
            "trainer": {"algorithms": ["cost_bandit"]}}


def test_the_whole_loop_matches_jax(tmp_path):
    """records → rows → train → evaluate → shadow → canary → promote →
    SLO-burn rollback, state for state on both packages."""
    pair = Pair(SMOKE_CFG, flywheel=FLYWHEEL)
    plain = Pair(SMOKE_CFG)
    try:
        for body in _requests(100):
            pair.route(body, label=True)
            plain.route(body)
        jrows = pair.jfw.export_corpus()
        trows = pair.tfw.export_corpus()
        assert len(trows) >= 100 and not any(map(tfw.validate_row, trows))
        assert_rows_equal(jrows, trows)
        jrep = pair.jfw.run_cycle(out_dir=str(tmp_path / "jax"))
        trep = pair.tfw.run_cycle(out_dir=str(tmp_path / "port"))
        _cycle_equal(jrep, trep)
        assert trep["eval"]["win"] and trep["eval"]["reward_delta_ci"][0] > 0
        assert pair.tfw.state == pair.jfw.state == "shadow"
        assert (tmp_path / "port" / "cost_bandit.json").read_bytes() \
            == (tmp_path / "jax" / "cost_bandit.json").read_bytes()
        assert pair.tfw.cost_model.value_weights \
            == pair.jfw.cost_model.value_weights
        # shadow: the routes equal the flywheel-off routers', the records
        # carry the candidate's choice
        for body in _requests(20):
            jres, tres = pair.route(body)
            pj, pt = plain.route(body)
            assert same_route(pt, tres)
            jcap = flywheel_capture(pair.j, jres)
            tcap = flywheel_capture(pair.t, tres)
            assert tcap == jcap and tcap[0]["verdict"] == "shadow"
        assert (pair.tfw.shadow_seen, pair.tfw.shadow_agree) \
            == (pair.jfw.shadow_seen, pair.jfw.shadow_agree)
        assert pair.tfw.shadow_seen == 20
        # canary, then an automatic promotion at its request floor
        for fw in (pair.jfw, pair.tfw):
            fw.configure({"promotion": {"mode": "auto",
                                        "canary_min_requests": 12}})
            fw.enter_canary(fraction=0.5, reason="test")
        states, canaries = [], 0
        for body in _requests(24):
            jres, tres = pair.route(body)
            states.append((pair.jfw.state, pair.tfw.state))
            cap = flywheel_capture(pair.t, tres)
            assert cap == flywheel_capture(pair.j, jres)
            canaries += bool(cap) and cap[0]["verdict"] == "canary"
        assert all(a == b for a, b in states)
        assert states[-1] == ("promoted", "promoted")
        assert pair.tfw.overrides == pair.jfw.overrides > 0
        assert pair.tfw._promoted_decisions == pair.jfw._promoted_decisions \
            == ["code_route", "chat_route"]
        assert pair.tfw.stats() == _sans_times(pair.jfw.stats(),
                                               pair.tfw.stats())
        # SLO burn rolls the promoted candidate back on both
        for bus in (pair.jbus, pair.tbus):
            bus.emit(SLO_ALERT_FIRING, objective="routing_latency p99",
                     severity="fast")
        assert pair.tfw.state == pair.jfw.state == "rolled_back"
        assert pair.tfw.rollback_reason == pair.jfw.rollback_reason
        assert [t["to"] for t in pair.tfw.transitions] \
            == [t["to"] for t in pair.jfw.transitions]
        for body in _requests(10):
            jres, tres = pair.route(body)
            assert "flywheel:canary" not in tres.selection_reason
    finally:
        pair.close()
        plain.close()


def _sans_times(want: dict, got: dict) -> dict:
    """``want`` with the clock-read fields taken from ``got``."""
    want = copy.deepcopy(want)
    want["last_cycle_at"] = got["last_cycle_at"]
    if want["candidate"].get("artifact"):
        want["candidate"]["artifact"] = got["candidate"]["artifact"]
    for a, b in zip(want["transitions"], got["transitions"]):
        a["at_unix"] = b["at_unix"]
    for algo, entry in (want.get("last_train") or {}).items():
        if isinstance(entry, dict) and entry.get("artifact"):
            entry["artifact"] = got["last_train"][algo]["artifact"]
    return want


def test_routing_identical_with_shadow_on_and_off():
    """The reference's shadow guarantee on the port: a shadow-mode
    flywheel changes no model, reason or header (the record id aside),
    and its records carry the candidate's choice."""
    trainer = Pair(SMOKE_CFG, flywheel=FLYWHEEL)
    try:
        for body in _requests(80):
            trainer.route(body, label=True)
        rows = trainer.tfw.export_corpus()
    finally:
        trainer.close()
    candidate = tfw.CostAwareBanditSelector(dim=64)
    candidate.fit_offline(rows)
    jcand = jfw.CostAwareBanditSelector(dim=64)
    jcand.fit_offline(rows)
    assert candidate.to_json() == jcand.to_json()
    plain = Pair(SMOKE_CFG)
    shadowed = Pair(SMOKE_CFG, flywheel=FLYWHEEL)
    try:
        for fw, cand in ((shadowed.tfw, candidate), (shadowed.jfw, jcand)):
            fw.candidate = cand
            fw.candidate_meta = {"algorithm": "cost_bandit"}
            fw.enter_shadow(reason="test")
        for body in _requests(40):
            _, a = plain.route(body)
            jb, b = shadowed.route(body)
            assert same_route(a, b)
            cap = flywheel_capture(shadowed.t, b)
            assert cap and cap == flywheel_capture(shadowed.j, jb)
        assert shadowed.tfw.shadow_seen == shadowed.jfw.shadow_seen == 40
    finally:
        plain.close()
        shadowed.close()


def test_export_train_evaluate_is_deterministic_and_matches_jax():
    pair = Pair(SMOKE_CFG, flywheel=FLYWHEEL)
    try:
        for body in _requests(60):
            pair.route(body, label=True)
        exporter = tfw.CorpusExporter(explain=pair.t.explain,
                                      outcomes=pair.tfw.outcomes,
                                      cost_model=CostModel())
        rows_a = exporter.export_rows()
        rows_b = exporter.export_rows()
        assert rows_a == rows_b
        blobs, reports = [], []
        for rows in (rows_a, rows_b):
            sel = tfw.CostAwareBanditSelector(dim=64)
            sel.fit_offline(rows)
            blobs.append(sel.to_json())
            reports.append(tfw.counterfactual_eval(rows, sel, n_boot=100,
                                                   seed=0))
        assert blobs[0] == blobs[1] and reports[0] == reports[1]
        jsel = jfw.CostAwareBanditSelector(dim=64)
        jsel.fit_offline(rows_a)
        assert jsel.to_json() == blobs[0]
        assert jfw.counterfactual_eval(rows_a, jsel, n_boot=100, seed=0) \
            == reports[0]
        # the JAX package's own export of its records: the same rows
        jrows = jfw.CorpusExporter(explain=pair.j.explain,
                                   outcomes=pair.jfw.outcomes,
                                   cost_model=JCostModel()).export_rows()
        assert_rows_equal(jrows, rows_a)
    finally:
        pair.close()


def test_debug_payload_is_json_and_matches_jax():
    pair = Pair(SMOKE_CFG, flywheel=FLYWHEEL)
    try:
        for body in _requests(60):
            pair.route(body, label=True)
        jrep, trep = pair.jfw.run_cycle(), pair.tfw.run_cycle()
        _cycle_equal(jrep, trep)
        payload = json.loads(json.dumps(pair.tfw.stats()))
        assert payload == json.loads(json.dumps(_sans_times(
            pair.jfw.stats(), pair.tfw.stats())))
        assert payload["state"] in ("shadow", "candidate")
        assert "admission_weights" in payload
    finally:
        pair.close()


# -- a learned domain family on a seeded tiny bank ------------------------------


@pytest.fixture(scope="module")
def engines():
    jeng = jtesting.make_shared_trunk_engine(tasks=[("intent", DOMAINS)],
                                             seed=11)
    teng = ttesting.make_shared_trunk_engine(
        tasks=[("intent", DOMAINS)], device="cpu",
        flax_params={"intent": jeng._tasks["intent"].params})
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


def _learned_cfg() -> dict:
    """The smoke config with a learned ``domain`` family beside the
    keyword one: chat traffic routes on any domain, so every row holds
    the bank's confidence."""
    d = copy.deepcopy(SMOKE_CFG)
    d["signals"]["domains"] = [{"name": n} for n in DOMAINS]
    d["decisions"][1]["rules"] = {"operator": "OR", "conditions": [
        {"type": "domain", "name": n} for n in DOMAINS]}
    return d


def test_learned_domain_rows_agree_and_the_loop_matches(engines, tmp_path):
    pair = Pair(_learned_cfg(), engines=engines, flywheel=FLYWHEEL)
    try:
        for body in _requests(60):
            pair.route(body, label=True)
        jrows = pair.jfw.export_corpus()
        trows = pair.tfw.export_corpus()
        assert all("domain" in r["signals"] for r in trows)
        assert_rows_equal(jrows, trows, tol=TOL)
        # the bandit on the port's rows: the same blob and report in both
        # packages, and the live shadow choice is the counterfactual one
        sel = tfw.CostAwareBanditSelector(dim=64)
        sel.fit_offline(trows)
        jsel = jfw.CostAwareBanditSelector(dim=64)
        jsel.fit_offline(trows)
        assert sel.to_json() == jsel.to_json()
        assert tfw.counterfactual_eval(trows, sel, seed=0) \
            == jfw.counterfactual_eval(trows, jsel, seed=0)
        pair.tfw.candidate = sel
        pair.tfw.candidate_meta = {"algorithm": "cost_bandit"}
        pair.tfw.enter_shadow(reason="test")
        from semantic_router_tpu_torch.flywheel.evaluator import \
            _policy_choice

        for body in _requests(6):
            res = pair.t.route(copy.deepcopy(body))
            cap = flywheel_capture(pair.t, res)
            row = tfw.record_to_row(pair.t.explain.get(
                res.decision_record_id), cost_model=CostModel())
            assert cap and _policy_choice(sel, row) == \
                cap[0]["detail"]["chosen"]
    finally:
        pair.close()
