"""The port's SLO engine against the JAX one, on the CPU: the objective
DSL (expressions, label selectors, explicit dicts, errors), the
histogram's ``le_total`` read, and ``SLOMonitor`` over one numpy-seeded
stream of observations ticked on an explicit clock — burn rates (≤1e-9),
the alert firing / resolved sequence on the event bus, the ``llm_slo_*``
series and ``report()`` bodies.  The SLO-burn capture
(``SLOCaptureController``) takes one trace per firing alert inside its
cooldown, as the JAX one does.  Over HTTP on the port's server,
``/health`` reads ``degraded`` while an alert fires and ``/debug/slo``
names the objective.  A fleet-scoped objective is refused by the loader
and, handed to the monitor directly, recorded as a configuration error."""

import copy
import http.client
import json
import threading
import time
import urllib.parse

import numpy as np
import pytest

from semantic_router_tpu.observability import metrics as jmetrics
from semantic_router_tpu.observability import programstats as jps
from semantic_router_tpu.observability import slo as jslo
from semantic_router_tpu.runtime.events import EventBus as JBus
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.observability import metrics as tmetrics
from semantic_router_tpu_torch.observability import programstats as tps
from semantic_router_tpu_torch.observability import slo as tslo
from semantic_router_tpu_torch.observability.flightrec import FlightRecorder
from semantic_router_tpu_torch.router import MockVLLMServer, RouterServer
from semantic_router_tpu_torch.runtime import RuntimeRegistry, \
    apply_observability_knobs, build_router
from semantic_router_tpu_torch.runtime.events import EventBus

SPECS = [
    "routing_latency p99 < 25ms over 5m",
    "routing_latency{model=qwen3-8b} p95 < 50ms over 1m",
    'routing_latency{model="a", tier=gold} p90 < 0.2s',
    "llm_batcher_queue_wait_seconds p95 < 10ms",
    "signal error-rate < 0.1% over 5m",
    "signal_latency p99.9 < 5ms over 30s",
    {"name": "fast_routing", "objective": "routing_latency p95 < 50ms"},
    {"name": "cache_errors", "kind": "ratio",
     "metric": "llm_cache_lookups_total",
     "total_metric": "llm_cache_lookups_total", "budget": 0.02,
     "window": "1m"},
    {"kind": "latency", "metric": "step", "threshold": "8ms",
     "target": 0.999, "labels": {"group": "g0"}},
    {"objective": "routing_latency p99 < 25ms", "scope": "fleet"},
    {"name": "named_fleet", "objective": "ttft p50 < 1s",
     "scope": "FLEET"},
    # errors
    "routing_latency p100 < 25ms", "nonsense", "foo error-rate < 1%",
    "routing_latency{model} p99 < 1ms", {"objective": "x", "scope": "mesh"},
    {"kind": "latency", "metric": "step"}, "routing_latency p99 < 5ms over x",
]


def _parsed(mod, spec):
    try:
        return ("ok", mod.parse_objective(copy.deepcopy(spec)).describe())
    except (ValueError, KeyError, TypeError) as exc:
        return ("error", type(exc).__name__, str(exc))


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_parse_objective_matches_jax(i):
    assert _parsed(tslo, SPECS[i]) == _parsed(jslo, SPECS[i])


def test_durations_match_jax():
    for raw in (None, 5, 2.5, "250ms", "3s", "5m", "2h", "1d", " 7 "):
        assert tslo.parse_duration_s(raw) == jslo.parse_duration_s(raw)
    for raw in ("x", "5y", "-3s"):
        with pytest.raises(ValueError):
            tslo.parse_duration_s(raw)


def test_le_total_matches_jax():
    rng = np.random.default_rng(3)
    h = {m: m.Histogram("h") for m in (jmetrics, tmetrics)}
    for _ in range(500):
        v = float(rng.exponential(0.05))
        model = str(rng.choice(["a", "b", "c"]))
        for hist in h.values():
            hist.observe(v, model=model, tier="gold" if v < 0.02 else "x")
    for edge in (0.0125, 0.03, 0.0125):
        assert h[tmetrics].add_bucket_edge(edge) == \
            h[jmetrics].add_bucket_edge(edge)
    for thr in (0.0, 0.001, 0.0125, 0.02, 0.03, 0.2, 10.0, 100.0):
        for labels in (None, {}, {"model": "a"}, {"model": "b",
                                                  "tier": "gold"},
                       {"model": "zzz"}):
            assert h[tmetrics].le_total(thr, labels=labels) == \
                h[jmetrics].le_total(thr, labels=labels)


# ---------------------------------------------------------------------------
# the monitor over one seeded stream, on an explicit clock

SLO_CFG = {"evaluation_interval_s": 1.0, "objectives": [
    "routing_latency p99 < 20ms over 1s",
    "routing_latency{model=m1} p90 < 50ms over 2s",
    {"name": "signal_err", "objective": "signal error-rate < 5% over 1s"},
]}


def _monitor(mod, bus_cls):
    reg = mod.MetricsRegistry()
    series = mod.MetricSeries(reg)
    mon = (jslo if mod is jmetrics else tslo).SLOMonitor(reg)
    mon.event_bus = bus_cls()
    mon.configure(copy.deepcopy(SLO_CFG))
    return reg, series, mon


def _report(mon):
    rep = mon.report(tick=False)
    for row in rep["objectives"]:
        row.pop("since_unix")
        row.pop("source")
    return rep


def test_monitor_matches_jax():
    j = _monitor(jmetrics, JBus)
    t = _monitor(tmetrics, EventBus)
    rng = np.random.default_rng(17)
    now = 100.0
    burns = []
    for step in range(120):
        # a calm phase, an overload (slow and erroring), then calm again
        bad = 40 <= step < 75
        for _ in range(int(rng.integers(5, 20))):
            lat = float(rng.exponential(0.05 if bad else 0.004))
            model = str(rng.choice(["m1", "m2"]))
            err = bool(rng.random() < (0.3 if bad else 0.01))
            for _reg, series, _mon in (j, t):
                series.routing_latency.observe(lat, model=model)
                series.signal_latency.observe(lat / 3, family="domain")
                if err:
                    series.signal_errors.inc(family="domain")
        now += float(rng.uniform(0.2, 0.3))
        j[2].tick(now=now)
        t[2].tick(now=now)
        jb = dict(j[2].burn_gauge.values())
        tb = dict(t[2].burn_gauge.values())
        assert jb.keys() == tb.keys()
        for k in jb:
            assert abs(tb[k] - jb[k]) <= 1e-9, (step, k)
        assert t[2].degraded() == j[2].degraded(), step
        assert t[2].alert_gauge.values() == j[2].alert_gauge.values()
        assert t[2].sli_gauge.values() == j[2].sli_gauge.values()
        burns.append(bool(t[2].degraded()))
    jev = [(e.stage, e.detail) for e in reversed(j[2].event_bus.recent(99))]
    tev = [(e.stage, e.detail) for e in reversed(t[2].event_bus.recent(99))]
    assert tev == jev
    stages = [s for s, _ in tev]
    assert "slo_alert_firing" in stages and "slo_alert_resolved" in stages
    # fired during the overload, clear at both ends
    assert not burns[0] and any(burns[40:80]) and not burns[-1]
    assert _report(t[2]) == _report(j[2])
    # the objective-aware edges are the same on both histograms
    assert t[0].find("llm_model_routing_latency_seconds").buckets == \
        j[0].find("llm_model_routing_latency_seconds").buckets


def test_reconfigure_and_disable_match_jax():
    j = _monitor(jmetrics, JBus)
    t = _monitor(tmetrics, EventBus)
    for _, series, mon in (j, t):
        mon.tick(now=10.0)
        for _ in range(50):
            series.routing_latency.observe(0.5, model="m1")
        mon.tick(now=10.5)
        assert mon.degraded()
        mon.configure({"objectives": [
            "routing_latency{model=m2} p99 < 20ms over 1s", "junk"]})
    assert _report(t[2]) == _report(j[2])
    assert t[2].alert_gauge.values() == j[2].alert_gauge.values()
    for _, _, mon in (j, t):
        mon.configure({"enabled": False, "objectives": [
            "routing_latency p99 < 20ms"]})
    assert t[2].degraded() == j[2].degraded() == []
    assert _report(t[2]) == _report(j[2])


def test_fleet_objective_is_a_config_error():
    # served since the fleet observability plane was ported: a fleet
    # objective is no longer a configuration error; both monitors parse
    # it alike and, with no fleet source bound, read local counts stamped
    # "local-fallback" into the llm_fleet_slo_* series
    spec = {"objectives": [
        {"objective": "routing_latency p99 < 20ms", "scope": "fleet"},
        "routing_latency p99 < 20ms"]}
    mons = []
    for metrics, slo in ((jmetrics, jslo), (tmetrics, tslo)):
        reg = metrics.MetricsRegistry()
        mon = slo.SLOMonitor(reg)
        mon.configure(copy.deepcopy(spec))
        reg.histogram("llm_model_routing_latency_seconds",
                      "routing latency").observe(0.5)
        mon.tick(now=1.0)
        mons.append(mon)
    j, t = mons
    assert [o.name for o in t.objectives] == [o.name for o in j.objectives] \
        == ["fleet:routing_latency_p99", "routing_latency_p99"]
    assert t.config_errors == j.config_errors == []
    assert _report(t) == _report(j)
    assert {r["name"]: r["source"] for r in t.report()["objectives"]} == {
        "fleet:routing_latency_p99": "local-fallback",
        "routing_latency_p99": "local"}
    assert t.registry.find("llm_fleet_slo_good_ratio") is not None
    cfg = load_config({"observability": {"slo": {"objectives": [
        {"objective": "routing_latency p99 < 20ms", "scope": "fleet"}]}}})
    assert cfg.slo_config()["objectives"][0]["scope"] == "fleet"


# ---------------------------------------------------------------------------
# the SLO-burn capture


class _FakeProfiler:
    def __init__(self) -> None:
        self.calls = []

    def start(self, log_dir=""):
        self.calls.append("start")
        return {"started": True, "dir": "/trace/x"}

    def stop(self, force=False):
        self.calls.append("stop")
        return {"stopped": True}


class _HandTimer:
    """A ``threading.Timer`` that never runs on its own: ``fire_all``
    runs every pending one in the order they were started, so the
    bounded traces' stops land at fixed points of the event sequence."""

    pending = []

    def __init__(self, interval, function, args=None, kwargs=None):
        self.function, self.args = function, args or ()
        self.kwargs = kwargs or {}
        self.daemon, self.name = False, ""
        self._done = threading.Event()

    def start(self):
        _HandTimer.pending.append(self)

    def cancel(self):
        self._done.set()

    def is_alive(self):
        return not self._done.is_set()

    def join(self, timeout=None):
        self._done.wait(timeout)

    @classmethod
    def fire_all(cls):
        while cls.pending:
            t = cls.pending.pop(0)
            if not t._done.is_set():
                t.function(*t.args, **t.kwargs)
                t._done.set()


def test_slo_capture_matches_jax(monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr("time.monotonic", lambda: clock[0])
    # both controllers start their stop timers through the one threading
    # module: each stop runs by hand right after the event that started
    # its trace, in both runs, so the profilers see the same call order
    monkeypatch.setattr(threading, "Timer", _HandTimer)
    monkeypatch.setattr(_HandTimer, "pending", [])
    rows = []
    for ps, bus_cls, fr in ((jps, JBus, None),
                            (tps, EventBus, FlightRecorder())):
        bus = bus_cls()
        prof = _FakeProfiler()
        ctl = ps.SLOCaptureController(
            catalog=ps.ProgramCatalog(), profiler=prof, flightrec=fr,
            trace_s=0.01, cooldown_s=60.0)
        ctl.attach(bus)
        got = []
        for dt, stage in ((0, "slo_alert_firing"), (1, "slo_alert_resolved"),
                          (30, "slo_alert_firing"), (31, "slo_alert_firing"),
                          (100, "slo_alert_firing")):
            clock[0] += dt
            bus.emit(stage, objective=f"o{dt}")
            _HandTimer.fire_all()
            got.append(len(ctl.links()))
        ctl.join()
        assert prof.calls.count("stop") == prof.calls.count("start")
        links = [{k: v for k, v in link.items() if k != "at_unix"}
                 for link in ctl.links()]
        caps = [e.detail for e in reversed(bus.recent(50, "slo_capture"))]
        rows.append((got, links, caps, prof.calls))
        ctl.detach()
        if fr is not None:
            assert [c["id"] for c in fr.dump()["slo_captures"]] == \
                [link["id"] for link in links]
    assert rows[1] == rows[0]
    # 1031 s is inside the first capture's 60 s cooldown; 1062 s is not
    assert rows[1][0] == [1, 1, 1, 2, 3]
    assert rows[1][3] == ["start", "stop"] * 3


class _SlowFirstStopProfiler(_FakeProfiler):
    """The first trace's stop takes 0.3 s, every later one returns at
    once: a join that waits for the last timer only returns before the
    first stop lands."""

    def stop(self, force=False):
        if "stop" not in self.calls and not getattr(self, "_slow", False):
            self._slow = True
            time.sleep(0.3)
        return super().stop(force)


def test_slo_capture_join_waits_for_every_capture_stop(monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr("time.monotonic", lambda: clock[0])
    bus = EventBus()
    prof = _SlowFirstStopProfiler()
    ctl = tps.SLOCaptureController(
        catalog=tps.ProgramCatalog(), profiler=prof, trace_s=0.01,
        cooldown_s=1.0)
    ctl.attach(bus)
    try:
        for dt in (0, 10, 20):
            clock[0] += dt
            bus.emit("slo_alert_firing", objective=f"o{dt}")
            # the next capture starts while the earlier stops are running
            time.sleep(0.05)
        assert len(ctl.links()) == 3
        ctl.join()
        assert prof.calls.count("start") == 3
        assert prof.calls.count("stop") == 3
    finally:
        ctl.detach()


# ---------------------------------------------------------------------------
# /health and /debug/slo over HTTP


def _get(url, path):
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"{}")
    finally:
        conn.close()


@pytest.fixture
def slo_server():
    # no SLO-burn capture here: a firing alert would start a profiler
    cfg = load_config({"default_model": "m", "observability": {
        "programstats": {"slo_capture": {"enabled": False}},
        "slo": {"evaluation_interval_s": 3600,
                "objectives": ["routing_latency p99 < 20ms over 1s"]}}})
    registry = RuntimeRegistry.isolated(runtimestats=None)
    apply_observability_knobs(cfg, registry)
    router = build_router(cfg, registry=registry)
    backend = MockVLLMServer().start()
    server = RouterServer(router, backend.url, registry=registry).start()
    yield registry, router, server
    server.stop()
    backend.stop()
    router.shutdown()
    registry.slo.stop()
    registry.resilience.stop()


def test_health_degraded_while_an_alert_fires(slo_server):
    registry, router, server = slo_server
    status, body = _get(server.url, "/health")
    assert (status, body) == (200, {"status": "healthy"})
    registry.slo.tick(now=0.0)
    for _ in range(40):
        router.M.routing_latency.observe(0.3, model="m")
    registry.slo.tick(now=1.0)
    status, body = _get(server.url, "/health")
    assert status == 200 and body == {
        "status": "degraded", "slo_breaches": ["routing_latency_p99"]}
    status, rep = _get(server.url, "/debug/slo")
    assert status == 200 and rep["degraded"] == ["routing_latency_p99"]
    assert rep["objectives"][0]["firing"] and \
        rep["objectives"][0]["severity"] == "fast"
    fired = registry.events.recent(10, "slo_alert_firing")
    assert fired and fired[0].detail["objective"] == "routing_latency_p99"
    for _ in range(4000):
        router.M.routing_latency.observe(0.001, model="m")
    registry.slo.tick(now=20.0)
    registry.slo.tick(now=40.0)
    assert _get(server.url, "/health")[1] == {"status": "healthy"}
