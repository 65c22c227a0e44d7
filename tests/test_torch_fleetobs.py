"""The fleet observability plane (``observability/fleetobs.py``), the
exposition linter (``observability/metrics_lint.py``) and the Grafana
dashboards (``observability/grafana.py``) against the reference's, on the
cases of ``tests/test_fleetobs.py``, ``tests/test_metrics_lint.py`` and
``tests/test_grafana_embedmap.py::TestGrafana``:

1. the snapshot wire format byte for byte (the reference's golden), the
   merge's commutativity and counter-sum / gauge-max, on both packages;
2. a 3-replica fleet of each package over one shared backend driven in
   lockstep: every merged view sees every member, ``/metrics/fleet``'s
   text lints clean, errors on one replica fire the fleet-scoped SLO
   alert on all, a dead plane degrades to a stamped local fallback and a
   restart re-converges, with the same scopes, members, alerts and
   sources on both; a mixed fleet (a JAX and a port replica over one
   store) whose merged expositions agree;
3. the server surfaces (``/metrics/fleet``, ``/debug/fleet``,
   ``?source=fleet``, ``/metrics/external`` through the aggregator, 503
   and default off) on both servers;
4. the bootstrap: the knob attaches and detaches, a swapped plane
   re-homes the publisher, ``build_router`` and a config reload attach
   and detach it;
5. malformed and version-skewed snapshots skipped;
6. the linter's verdicts on every case equal to the reference's, and the
   port's live ``/metrics`` clean in both formats;
7. ``render_all`` writing the reference's 14 files, byte for byte."""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from test_fleetobs import GOLDEN, _Killable

from semantic_router_tpu.observability import fleetobs as jfleetobs
from semantic_router_tpu.observability import grafana as jgrafana
from semantic_router_tpu.observability import metrics as jmetrics
from semantic_router_tpu.observability import metrics_lint as jlint
from semantic_router_tpu.observability.runtimestats import \
    RuntimeStats as JRuntimeStats
from semantic_router_tpu.observability.slo import SLOMonitor as JSLOMonitor
from semantic_router_tpu.router.pipeline import Router as JRouter
from semantic_router_tpu.router.server import RouterServer as JRouterServer
from semantic_router_tpu.runtime import bootstrap as jboot
from semantic_router_tpu.runtime.registry import \
    RuntimeRegistry as JRuntimeRegistry
from semantic_router_tpu import stateplane as jsp
from semantic_router_tpu.stateplane import harness as jharness
from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.observability import fleetobs as tfleetobs
from semantic_router_tpu_torch.observability import grafana as tgrafana
from semantic_router_tpu_torch.observability import metrics as tmetrics
from semantic_router_tpu_torch.observability import metrics_lint as tlint
from semantic_router_tpu_torch.observability.runtimestats import \
    RuntimeStats as TRuntimeStats
from semantic_router_tpu_torch.observability.slo import \
    SLOMonitor as TSLOMonitor
from semantic_router_tpu_torch.router import MockVLLMServer, Router, \
    RouterServer
from semantic_router_tpu_torch.runtime import RuntimeRegistry, build_router
from semantic_router_tpu_torch.runtime import bootstrap as tboot
from semantic_router_tpu_torch import stateplane as tsp
from semantic_router_tpu_torch.stateplane import harness as tharness


class _Pkg:
    def __init__(self, **kw):
        self.__dict__.update(kw)


PKGS = {
    "jax": _Pkg(metrics=jmetrics, fleetobs=jfleetobs, lint=jlint,
                sp=jsp, harness=jharness, Registry=JRuntimeRegistry,
                boot=jboot, Config=JRouterConfig.from_dict),
    "port": _Pkg(metrics=tmetrics, fleetobs=tfleetobs, lint=tlint,
                 sp=tsp, harness=tharness, Registry=RuntimeRegistry,
                 boot=tboot, Config=load_config),
}
OBJECTIVE = {"objective": "signal error-rate < 1% over 0.2s",
             "scope": "fleet"}


def _golden_registry(metrics):
    reg = metrics.MetricsRegistry()
    reg.counter("llm_demo_total", "demo counter").inc(
        3, model="m", decision="d")
    reg.gauge("llm_demo_level", "demo gauge").set(2.5)
    h = reg.histogram("llm_demo_seconds", "demo histogram",
                      buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(5.0)
    return reg


# -- 1. the wire format -----------------------------------------------------------


@pytest.mark.parametrize("pkg", sorted(PKGS))
class TestSnapshotWire:
    def test_golden_byte_stability(self, pkg):
        m = PKGS[pkg].metrics
        assert m.encode_snapshot(_golden_registry(m).snapshot()) == GOLDEN

    def test_round_trip(self, pkg):
        m = PKGS[pkg].metrics
        snap = m.decode_snapshot(GOLDEN)
        assert snap["v"] == m.SNAPSHOT_VERSION == 1
        merged = m.MetricsRegistry()
        merged.merge_snapshot(snap)
        assert m.encode_snapshot(merged.snapshot()) == GOLDEN

    def test_version_skew_and_malformed_rejected(self, pkg):
        m = PKGS[pkg].metrics
        for raw in (b'{"v":999,"series":{}}', b'{"series":{}}',
                    b"not json"):
            with pytest.raises(ValueError):
                m.decode_snapshot(raw)

    def test_histogram_merge_commutes_across_divergent_edges(self, pkg):
        m = PKGS[pkg].metrics
        a = m.MetricsRegistry()
        ha = a.histogram("llm_x_seconds", "x", buckets=(0.01, 0.1))
        for v in (0.005, 0.05, 0.5):
            ha.observe(v)
        b = m.MetricsRegistry()
        hb = b.histogram("llm_x_seconds", "x", buckets=(0.025, 0.25, 2.5))
        for v in (0.02, 0.2, 2.0, 20.0):
            hb.observe(v)
        ab, ba = m.MetricsRegistry(), m.MetricsRegistry()
        for reg, order in ((ab, (a, b)), (ba, (b, a))):
            for src in order:
                reg.merge_snapshot(src.snapshot())
        assert m.encode_snapshot(ab.snapshot()) == \
            m.encode_snapshot(ba.snapshot())
        h = ab.find("llm_x_seconds")
        assert h.le_total(0.025) == (2, 7)
        assert h.le_total(0.1) == (3, 7)
        assert h.le_total(2.5) == (5, 7)

    def test_counter_sum_gauge_max(self, pkg):
        m = PKGS[pkg].metrics
        a, b = m.MetricsRegistry(), m.MetricsRegistry()
        a.counter("llm_y_total", "y").inc(5, model="m")
        b.counter("llm_y_total", "y").inc(7, model="m")
        a.gauge("llm_z", "z").set(1.0)
        b.gauge("llm_z", "z").set(3.0)
        merged = m.MetricsRegistry()
        merged.merge_snapshot(a.snapshot())
        merged.merge_snapshot(b.snapshot())
        assert merged.find("llm_y_total").total() == 12.0
        assert "llm_z 3" in merged.expose()


def test_seeded_registries_encode_and_merge_alike():
    """Seeded registries of every series kind: the same snapshot bytes on
    both packages, and a JAX snapshot merged by the port (and the
    reverse) exposes what the reference's merge exposes."""
    regs = {}
    for name, m in (("jax", jmetrics), ("port", tmetrics)):
        r = np.random.default_rng(26)
        reg = m.MetricsRegistry()
        c = reg.counter("llm_seeded_total", "seeded counter")
        g = reg.gauge("llm_seeded_level", "seeded gauge")
        h = reg.histogram("llm_seeded_seconds", "seeded histogram",
                          buckets=(0.001, 0.01, 0.1, 1.0))
        for i in range(200):
            c.inc(float(r.integers(1, 4)), model=f"m{i % 3}")
            g.set(float(r.random()), replica=f"r{i % 2}")
            h.observe(float(r.exponential(0.05)), family=f"f{i % 4}")
        regs[name] = reg
    raw = {k: m.encode_snapshot(regs[k].snapshot())
           for k, m in (("jax", jmetrics), ("port", tmetrics))}
    assert raw["port"] == raw["jax"]
    for m, other in ((tmetrics, "jax"), (jmetrics, "port")):
        merged = m.MetricsRegistry()
        merged.merge_snapshot(m.decode_snapshot(raw[other]))
        merged.merge_snapshot(m.decode_snapshot(raw[other]))
        regs[f"twice-{other}"] = merged
    assert regs["twice-jax"].expose() == regs["twice-port"].expose()


# -- 2. a 3-replica fleet of each package, in lockstep ------------------------------


@pytest.fixture(scope="module")
def fleets():
    """{pkg: (fleet, kill switch)}: three replicas of each package over
    one in-memory store each, the fleet plane on, a fleet-scoped
    error-rate objective on every replica."""
    out = {}
    for name, p in PKGS.items():
        mem = p.sp.InMemoryStateBackend()
        down = {"down": False}
        fl = p.harness.ReplicaFleet(
            backend_factory=lambda p=p, mem=mem, down=down:
            p.sp.GuardedBackend(_Killable(mem, down), cooldown_s=0.1),
            n=3, heartbeat_s=0.2, fleet_obs=True).start()
        for r in fl.replicas:
            mon = r.registry.get("slo")
            mon.event_bus = r.registry.get("events")
            mon.configure({"objectives": [dict(OBJECTIVE)]})
            r.controller.bind(slo=mon)
        fl.heartbeat_all()
        out[name] = (fl, down)
    yield out
    for fl, _ in out.values():
        fl.stop()


def _each(fleets):
    return [(name, *fleets[name]) for name in sorted(fleets)]


class TestFleetConvergence:
    """The reference's ordered phases over both fleets at once."""

    def test_1_merged_view_sees_every_member(self, fleets):
        views = {}
        for name, fl, _down in _each(fleets):
            for r in fl.replicas:
                r.route("what does this contract clause mean")
            fl.heartbeat_all()
            names = {r.name for r in fl.replicas}
            for r in fl.replicas:
                view = r.fleetobs.aggregator.collect(force=True)
                assert view["scope"] == "fleet"
                assert set(view["replicas"]) == names
                assert not view["skipped"]
            views[name] = view
        # the merged counters agree: every replica routed once
        for name, view in views.items():
            reqs = view["registry"].find("llm_model_requests_total")
            assert reqs is not None and reqs.total() == 3.0, name

    def test_2_metrics_fleet_passes_lint(self, fleets):
        texts = {}
        for name, fl, _down in _each(fleets):
            text, _ = fl.replicas[0].fleetobs.aggregator.exposition()
            assert text.startswith("# fleet-scope: fleet replicas=3\n")
            assert "llm_fleet_members 3" in text
            assert "llm_fleet_local_fallback 0" in text
            assert tlint.lint_exposition(text, openmetrics=False) == \
                jlint.lint_exposition(text, openmetrics=False) == []
            texts[name] = {ln.split(" ")[0] for ln in text.splitlines()
                           if ln.startswith("llm_fleet_")
                           or ln.startswith("llm_model_requests_total")}
        assert texts["port"] == texts["jax"]

    def test_3_errors_on_one_replica_fire_fleet_slo_on_all(self, fleets):
        for name, fl, _down in _each(fleets):
            r0 = fl.replicas[0]
            t0 = 1000.0
            for r in fl.replicas:
                r.registry.get("slo").tick(now=t0)
            m = r0.registry.metrics
            m.counter("llm_signal_errors_total",
                      "signal evaluation failures").inc(50)
            lat = m.histogram("llm_signal_latency_seconds", "signal latency")
            for _ in range(50):
                lat.observe(0.001)
            fl.heartbeat_all()
            for r in fl.replicas:
                r.registry.get("slo").tick(now=t0 + 0.3)
            for r in fl.replicas:
                mon = r.registry.get("slo")
                assert mon.firing().get("fleet:signal_error_rate") == \
                    "fast", (name, r.name)
                rows = {row["name"]: row
                        for row in mon.report()["objectives"]}
                assert rows["fleet:signal_error_rate"]["source"] == "fleet"
                assert r.controller.report()["alert_scopes"].get(
                    "fleet:signal_error_rate") == "fleet"
            assert r0.registry.metrics.find(
                "llm_fleet_slo_alert_firing") is not None
            fl.heartbeat_all()  # the siblings publish their alerts
            report = fl.replicas[1].fleetobs.report()
            assert report["slo"]["firing"] == {
                "fleet:signal_error_rate": "fast"}

    def test_4_plane_kill_degrades_to_stamped_local_fallback(self, fleets):
        for name, fl, down in _each(fleets):
            down["down"] = True
            for r in fl.replicas:
                view = r.fleetobs.aggregator.collect(force=True)
                assert view["scope"] == "local-fallback"
                assert set(view["replicas"]) == {r.name}
                text, _ = r.fleetobs.aggregator.exposition()
                assert "llm_fleet_local_fallback 1" in text
                assert tlint.lint_exposition(text, openmetrics=False) == []
                fr = r.fleetobs.aggregator.flightrec_fleet(
                    r.registry.get("flightrec").dump())
                assert fr["scope"] == "local-fallback"
            for r in fl.replicas:
                for i in range(5):
                    res = r.route(f"is this contract {i} enforceable")
                    assert res is not None and res.kind in (
                        "route", "cache_hit")
            for r in fl.replicas:
                mon = r.registry.get("slo")
                mon.tick(now=2000.0)
                rows = {row["name"]: row
                        for row in mon.report()["objectives"]}
                assert rows["fleet:signal_error_rate"]["source"] == \
                    "local-fallback", name

    def test_5_plane_restart_reconverges(self, fleets):
        for _name, _fl, down in _each(fleets):
            down["down"] = False
        time.sleep(0.15)
        for name, fl, _down in _each(fleets):
            names = {r.name for r in fl.replicas}
            deadline = time.time() + 5.0
            converged = False
            while time.time() < deadline and not converged:
                fl.heartbeat_all()
                converged = all(
                    r.fleetobs.aggregator.collect(force=True)["scope"]
                    == "fleet"
                    and set(r.fleetobs.aggregator.collect()["replicas"])
                    == names for r in fl.replicas)
                if not converged:
                    time.sleep(0.05)
            assert converged, name
            for r in fl.replicas:
                mon = r.registry.get("slo")
                mon.tick(now=3000.0)
                rows = {row["name"]: row
                        for row in mon.report()["objectives"]}
                assert rows["fleet:signal_error_rate"]["source"] == "fleet"


def test_mixed_fleet_merges_alike():
    """A JAX replica and a port replica over ONE store: each one's
    aggregator merges both, and the two merged expositions agree but for
    the snapshot ages."""
    mem = tsp.InMemoryStateBackend()
    planes, obs = [], []
    for name, p in (("jax-r", PKGS["jax"]), ("port-r", PKGS["port"])):
        plane = p.sp.StatePlane(p.sp.GuardedBackend(mem), replica_id=name,
                                heartbeat_s=0.2)
        reg = p.metrics.MetricsRegistry()
        reg.counter("llm_model_requests_total", "requests").inc(
            4 if name == "jax-r" else 9, model="m")
        reg.gauge("llm_degradation_level", "ladder level").set(
            1.0 if name == "jax-r" else 2.0)
        fo = p.fleetobs.build_fleet_obs(
            {"publish_interval_s": 0.0, "cache_s": 0.0, "debug_top_n": 8},
            plane, reg)
        plane.add_publisher(fo.publisher.maybe_publish)
        planes.append(plane)
        obs.append(fo)
    for plane in planes * 2:
        plane.heartbeat_once()
    texts = []
    for fo in obs:
        text, view = fo.aggregator.exposition()
        assert set(view["replicas"]) == {"jax-r", "port-r"}
        assert 'llm_model_requests_total{model="m"} 13' in text
        assert "llm_degradation_level 2" in text
        texts.append([ln for ln in text.splitlines()
                      if "snapshot_age" not in ln])
    assert texts[0] == texts[1]
    for fo, plane in zip(obs, planes):
        plane.remove_publisher(fo.publisher.maybe_publish)
        fo.close()
        plane.close()


# -- 3. the server surfaces ---------------------------------------------------------


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=10) as resp:
        raw = resp.read().decode()
        ctype = resp.headers.get("content-type", "")
        return resp.status, (json.loads(raw) if "json" in ctype else raw)


@pytest.fixture(params=sorted(PKGS))
def served(request):
    """A server of each package on a plane with the fleet plane attached
    (the reference's test fixture): (pkg, server, plane, registry)."""
    name = request.param
    p = PKGS[name]
    plane = p.sp.StatePlane(p.sp.build_backend({"backend": "memory"}),
                            replica_id="srv-a", heartbeat_s=0.2)
    plane.heartbeat_once()
    registry = p.Registry.isolated(stateplane=plane)
    controller = registry.get("resilience")
    controller.bind(events=registry.get("events"), fleet=plane)
    cfg = p.harness.fleet_config()
    controller.configure(cfg.resilience_config())
    kw = dict(metrics=registry.metric_series(), tracer=registry.tracer,
              flightrec=registry.get("flightrec"),
              explain=registry.get("explain"), resilience=controller)
    backend = None
    if name == "jax":
        router = JRouter(cfg, **kw)
    else:
        router = Router(cfg, **kw)
    router.stateplane = plane
    fobs = p.fleetobs.build_fleet_obs(
        {"publish_interval_s": 0.0, "cache_s": 0.0, "debug_top_n": 8},
        plane, registry.metrics, flightrec=registry.get("flightrec"),
        explain=registry.get("explain"), slo=registry.get("slo"))
    plane.add_publisher(fobs.publisher.maybe_publish)
    registry.swap(fleetobs=fobs)
    if name == "jax":
        srv = JRouterServer(router, cfg, registry=registry).start()
    else:
        backend = MockVLLMServer().start()
        srv = RouterServer(router, backend.url, registry=registry).start()
    yield name, srv, plane, registry
    srv.stop()
    router.shutdown()
    fobs.close()
    plane.close()
    if backend is not None:
        backend.stop()


def _sibling(p, plane, level: float, pending: float):
    sib = p.sp.StatePlane(plane.backend, replica_id="srv-b",
                          namespace=plane.ns, heartbeat_s=0.2)
    sib.heartbeat_once()
    reg = p.metrics.MetricsRegistry()
    reg.gauge("llm_degradation_level", "ladder level").set(level)
    reg.counter("llm_model_requests_total", "requests").inc(
        9, model="model-large")
    p.fleetobs.build_fleet_obs({"publish_interval_s": 0.0, "cache_s": 0.0,
                                "debug_top_n": 8}, sib,
                               reg).publisher.publish_once()
    sib.publish_pressure({"level": int(level), "pending_items": pending})
    return sib


class TestServerSurface:
    def test_metrics_fleet_and_debug_fleet(self, served):
        name, srv, plane, _registry = served
        sib = _sibling(PKGS[name], plane, 2.0, 9.0)
        plane.heartbeat_once()
        try:
            status, text = _get(srv.url, "/metrics/fleet")
            assert status == 200
            assert text.startswith("# fleet-scope: fleet replicas=2\n")
            assert tlint.lint_exposition(text, openmetrics=False) == []
            assert 'llm_model_requests_total{model="model-large"} 9' in text
            status, rep = _get(srv.url, "/debug/fleet")
            assert status == 200
            assert rep["replica_id"] == "srv-a" and rep["scope"] == "fleet"
            assert set(rep["replicas"]) == {"srv-a", "srv-b"}
            assert rep["wire_version"] == 1
            assert rep["publisher"]["publishes"] >= 1
            assert sorted(rep) == ["aggregator", "publisher", "replica_id",
                                   "replicas", "scope", "skipped", "slo",
                                   "wire_version"]
        finally:
            sib.close()

    def test_external_metrics_unified_and_behavior_identical(self, served):
        name, srv, plane, registry = served
        sib = _sibling(PKGS[name], plane, 2.0, 9.0)
        plane.heartbeat_once()
        try:
            status, doc = _get(srv.url, "/metrics/external")
            assert status == 200
            rows = [(i["metricName"], i["metricLabels"], i["value"])
                    for i in doc["items"]]
            assert rows == [
                ("llm_degradation_level", {"scope": "fleet"}, "2"),
                ("llm_queue_pressure", {"scope": "fleet"}, "9"),
                ("llm_degradation_level", {"replica": "srv-a"}, "0"),
                ("llm_degradation_level", {"replica": "srv-b"}, "2")]
        finally:
            sib.close()

    def test_debug_sources_fleet(self, served):
        name, srv, plane, _registry = served
        sib = _sibling(PKGS[name], plane, 1.0, 0.0)
        plane.heartbeat_once()
        try:
            status, doc = _get(srv.url, "/debug/flightrec?source=fleet")
            assert status == 200 and doc["scope"] == "fleet"
            assert set(doc["replicas"]) == {"srv-a", "srv-b"}
            status, doc = _get(srv.url, "/debug/decisions?source=fleet")
            assert status == 200 and doc["scope"] == "fleet"
            assert "records" in doc and set(doc["replicas"]) == {
                "srv-a", "srv-b"}
        finally:
            sib.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_503_and_default_off_posture(pkg):
    p = PKGS[pkg]
    cfg = p.harness.fleet_config()
    registry = p.Registry.isolated()
    backend = None
    if pkg == "jax":
        router = JRouter(cfg, metrics=registry.metric_series())
        srv = JRouterServer(router, cfg, registry=registry).start()
    else:
        router = Router(cfg, metrics=registry.metric_series())
        backend = MockVLLMServer().start()
        srv = RouterServer(router, backend.url, registry=registry).start()
    try:
        assert registry.get("fleetobs") is None
        for path in ("/metrics/fleet", "/debug/fleet",
                     "/debug/flightrec?source=fleet",
                     "/debug/decisions?source=fleet"):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(srv.url + path, timeout=10)
            assert err.value.code == 503
        status, text = _get(srv.url, "/metrics")
        assert status == 200 and "llm_fleet_" not in text
    finally:
        srv.stop()
        router.shutdown()
        if backend is not None:
            backend.stop()


# -- 4. the bootstrap ---------------------------------------------------------------


def _teardown(registry, *planes):
    for slot in ("resilience", "slo", "runtimestats"):
        comp = registry.get(slot)
        if comp is not None:
            comp.stop()
    explain = registry.get("explain")
    if explain is not None:
        explain.attach_durable(None)
    for plane in planes:
        plane.close()


FLEET_ON = {"observability": {"fleet": {
    "enabled": True, "publish_interval_s": 0.5, "cache_s": 0.25,
    "debug_top_n": 4}}}


@pytest.mark.parametrize("pkg", sorted(PKGS))
class TestBootstrapWiring:
    def test_knob_builds_and_detaches(self, pkg):
        p = PKGS[pkg]
        plane = p.sp.StatePlane(p.sp.build_backend({"backend": "memory"}),
                                replica_id="boot-a", heartbeat_s=0.2)
        registry = p.Registry.isolated(stateplane=plane)
        try:
            p.boot.apply_observability_knobs(p.Config(FLEET_ON), registry)
            fobs = registry.get("fleetobs")
            assert fobs is not None and fobs.plane is plane
            assert fobs.publisher.interval_s == 0.5
            assert fobs.aggregator.cache_s == 0.25
            assert fobs.aggregator.debug_top_n == 16
            slo = registry.get("slo")
            assert slo.fleet_source is not None
            plane.heartbeat_once()
            time.sleep(0.6)
            plane.heartbeat_once()
            assert fobs.publisher.publishes >= 1
            assert plane.backend.get(fobs.publisher.metrics_key())
            off = p.Config({"observability": {"fleet": {"enabled": False}}})
            p.boot.apply_observability_knobs(off, registry)
            assert registry.get("fleetobs") is None
            assert slo.fleet_source is None
            assert plane._publishers == []
            assert plane.backend.get(fobs.publisher.metrics_key()) is None
        finally:
            _teardown(registry, plane)

    def test_default_config_builds_nothing(self, pkg):
        p = PKGS[pkg]
        plane = p.sp.StatePlane(p.sp.build_backend({"backend": "memory"}),
                                replica_id="boot-b")
        registry = p.Registry.isolated(stateplane=plane)
        try:
            p.boot.apply_observability_knobs(p.Config({}), registry)
            assert registry.get("fleetobs") is None
            assert "llm_fleet_" not in registry.metrics.expose()
        finally:
            _teardown(registry, plane)

    def test_swapped_plane_rehomes_the_publisher(self, pkg):
        """A reload that finds another plane in the registry: the
        publisher comes off the old plane's heartbeat onto the new one,
        and the SLO source follows."""
        p = PKGS[pkg]
        planes = [p.sp.StatePlane(p.sp.build_backend({"backend": "memory"}),
                                  replica_id=f"rehome-{i}", heartbeat_s=0.2)
                  for i in range(2)]
        registry = p.Registry.isolated(stateplane=planes[0])
        try:
            cfg = p.Config(FLEET_ON)
            p.boot.apply_observability_knobs(cfg, registry)
            first = registry.get("fleetobs")
            assert planes[0]._publishers == [first.publisher.maybe_publish]
            # same plane: retuned in place
            p.boot.apply_observability_knobs(p.Config({
                "observability": {"fleet": {"enabled": True,
                                            "cache_s": 2.0}}}), registry)
            assert registry.get("fleetobs") is first
            assert first.aggregator.cache_s == 2.0
            registry.swap(stateplane=planes[1])
            p.boot.apply_observability_knobs(cfg, registry)
            second = registry.get("fleetobs")
            assert second is not first and second.plane is planes[1]
            assert planes[0]._publishers == []
            assert planes[1]._publishers == [second.publisher.maybe_publish]
            assert registry.get("slo").fleet_source == \
                second.aggregator.merged_registry
            planes[1].heartbeat_once()
            assert second.publisher.publishes == 1
        finally:
            _teardown(registry, *planes)


def test_build_router_and_a_reload_attach_and_detach(tmp_path):
    """The port's serve path: ``build_router`` attaches the plane and the
    fleet plane over it; a watched reload turning the fleet plane off
    detaches it, one turning it on again re-attaches it, and
    ``close_stateplane`` detaches it with the plane."""
    d = {"default_model": "m",
         "stateplane": {"enabled": True, "backend": "memory",
                        "heartbeat_s": 0.2},
         "observability": {"fleet": {"enabled": True, "cache_s": 0.0},
                           "slo": {"objectives": [dict(OBJECTIVE)]}}}
    path = tmp_path / "router.json"
    path.write_text(json.dumps(d))
    registry = RuntimeRegistry.isolated(runtimestats=None)
    cfg = load_config(str(path))
    tboot.apply_observability_knobs(cfg, registry)
    router = build_router(cfg, registry=registry)
    backend = MockVLLMServer().start()
    server = RouterServer(router, backend.url, registry=registry).start()
    try:
        fobs = registry.get("fleetobs")
        plane = registry.get("stateplane")
        assert fobs is not None and fobs.plane is plane
        assert registry.slo.fleet_source == fobs.aggregator.merged_registry
        status, text = _get(server.url, "/metrics/fleet")
        assert status == 200 and "llm_fleet_members 1" in text
        watcher = tboot.attach_config_watcher(server, str(path), None,
                                              registry, start=False)
        for on in (False, True):
            d["observability"]["fleet"]["enabled"] = on
            path.write_text(json.dumps(d))
            stamp = time.time() + (5 if on else 3)
            os.utime(path, (stamp, stamp))
            assert watcher.poll_once()
            assert (registry.get("fleetobs") is not None) == on
            assert (registry.slo.fleet_source is not None) == on
            assert registry.get("stateplane") is plane
            assert len(plane._publishers) == int(on)
    finally:
        server.stop()
        server.router.shutdown()
        backend.stop()
        registry.slo.stop()
        registry.resilience.stop()
        tboot.close_stateplane(registry)
    assert registry.get("fleetobs") is None and plane._publishers == []


# -- 5. the aggregator's resilience -----------------------------------------------


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_malformed_and_skewed_snapshots_skipped(pkg):
    p = PKGS[pkg]
    mem = p.sp.InMemoryStateBackend()
    plane = p.sp.StatePlane(p.sp.GuardedBackend(mem), replica_id="r1",
                            heartbeat_s=0.2)
    plane.heartbeat_once()
    reg = p.metrics.MetricsRegistry()
    reg.counter("llm_y_total", "y").inc(1)
    agg = p.fleetobs.FleetAggregator(plane, reg, cache_s=0.0)
    for rid, raw in (
            ("bad-json", b"{nope"),
            ("skewed", p.metrics.encode_snapshot(
                {"replica": "skewed", "ts_unix": 1.0,
                 "snap": {"v": 2, "series": {}}}))):
        mem.put(plane.key("replica", rid), b"{}", ttl_s=30)
        mem.put(plane.key("obs", "metrics", rid), raw, ttl_s=30)
    plane.heartbeat_once()
    view = agg.collect(force=True)
    assert view["scope"] == "fleet"
    assert sorted(view["skipped"]) == ["bad-json", "skewed"]
    assert set(view["replicas"]) == {"r1"}
    assert view["registry"].find("llm_y_total").total() == 1.0
    plane.close()


# -- 6. the exposition linter ---------------------------------------------------------


BAD = [
    ('# TYPE h histogram\nh_bucket{le="+Inf"} 1 # {trace_id="x"} 0.1 1.0\n'
     'h_sum 0.1\nh_count 1\n', False),
    ("# TYPE x_total counter\nx_total 1\n# EOF\n", True),
    ('# TYPE h histogram\nh_bucket{le="1"} 5\nh_bucket{le="+Inf"} 3\n'
     'h_sum 1\nh_count 3\n', False),
    ('# TYPE h histogram\nh_bucket{le="+Inf"} 3\nh_sum 1\nh_count 4\n',
     False),
    ("# TYPE g gauge\ng 1\n", True),
    ("mystery_series 1\n", False),
    ("# TYPE g gauge\n# TYPE g gauge\ng 1\n", False),
    ("# HELP g a\n# HELP g b\n# TYPE g gauge\ng 1\n", False),
    ('# TYPE h histogram\nh_bucket{le="1"} 1\nh_sum 1\nh_count 1\n', False),
    ("# TYPE c counter\nc_total 1 # {trace_id=\"ab\"} 1\n# EOF\n", True),
    ("# TYPE c counter\nc_total{a=\"1\"} NaNx\n", False),
]


def _drive(series, registry) -> None:
    series.model_requests.inc(model="m", decision="d")
    series.signal_errors.inc(family="kb")
    series.routing_latency.observe(0.012, exemplar="ab" * 16)
    series.signal_latency.observe(0.004, family="kb", exemplar="cd" * 16)
    series.batcher_queue_wait.observe(0.001, batcher="b")
    series.batcher_fill_ratio.observe(0.5, batcher="b")
    registry.gauge("llm_test_gauge", "A gauge").set(3.5, slot="x")


class TestMetricsLint:
    @pytest.mark.parametrize("i", range(len(BAD)))
    def test_catches_what_the_reference_catches(self, i):
        text, om = BAD[i]
        got = tlint.lint_exposition(text, openmetrics=om)
        assert got == jlint.lint_exposition(text, openmetrics=om)
        if i < 6:
            assert got, text

    @pytest.mark.parametrize("om", [False, True])
    def test_registry_exposition_clean_and_equal(self, om):
        texts = []
        for m in (jmetrics, tmetrics):
            reg = m.MetricsRegistry()
            reg.enable_exemplars(om)
            _drive(m.MetricSeries(reg), reg)
            text = reg.expose() + ("# EOF\n" if om else "")
            assert tlint.lint_exposition(text, openmetrics=om) == []
            texts.append(text)
        strip = (lambda t: "\n".join(ln.split(" # ")[0]
                                     for ln in t.splitlines()))
        assert strip(texts[1]) == strip(texts[0])

    def test_runtime_and_slo_series_clean(self):
        for m, RS, SLO in ((jmetrics, JRuntimeStats, JSLOMonitor),
                           (tmetrics, TRuntimeStats, TSLOMonitor)):
            reg = m.MetricsRegistry()
            series = m.MetricSeries(reg)
            rs = RS(reg)
            rs.record_step("trunk:g0", 128, "fused", 4, 8, 1.0,
                           compiled=True)
            rs.record_step("trunk:g0", 128, "fused", 4, 8, 0.01)
            rs.flush()
            rs.sample_process()
            mon = SLO(reg)
            mon.configure({"objectives": [
                "routing_latency p99 < 25ms over 5m", dict(OBJECTIVE)]})
            mon.tick(now=1.0)
            series.routing_latency.observe(0.012)
            mon.tick(now=2.0)
            assert tlint.lint_exposition(reg.expose(),
                                         openmetrics=False) == []
            assert "# TYPE llm_fleet_slo_alert_firing gauge" in reg.expose()

    @pytest.mark.parametrize("om", [False, True])
    def test_live_scrape_clean(self, om):
        registry = RuntimeRegistry.isolated(runtimestats=None)
        cfg = load_config({"default_model": "m"})
        router = Router(cfg, metrics=registry.metric_series(),
                        tracer=registry.tracer,
                        flightrec=registry.get("flightrec"))
        backend = MockVLLMServer().start()
        srv = RouterServer(router, backend.url, registry=registry).start()
        try:
            registry.metrics.enable_exemplars(om)
            with registry.tracer.span("router.route"):
                pass
            for i in range(3):
                router.route({"model": "auto", "messages": [
                    {"role": "user", "content": f"scrape probe {i}"}]})
            with urllib.request.urlopen(srv.url + "/metrics",
                                        timeout=30) as resp:
                ctype = resp.headers.get("content-type", "")
                text = resp.read().decode()
            assert ctype.startswith("application/openmetrics-text" if om
                                    else "text/plain")
            assert tlint.lint_exposition(text, openmetrics=om) == \
                jlint.lint_exposition(text, openmetrics=om) == []
        finally:
            srv.stop()
            router.shutdown()
            backend.stop()


# -- 7. Grafana -------------------------------------------------------------------------


class TestGrafana:
    def test_render_all_writes_the_references_files(self, tmp_path):
        reg = {}
        for name, m in (("jax", jmetrics), ("port", tmetrics)):
            r = m.MetricsRegistry()
            _drive(m.MetricSeries(r), r)
            reg[name] = r
        paths = {name: tgrafana.render_all(str(tmp_path / name),
                                           registry=reg[name])
                 if name == "port" else
                 jgrafana.render_all(str(tmp_path / name),
                                     registry=reg[name])
                 for name in reg}
        names = {n: sorted(os.path.basename(p) for p in ps)
                 for n, ps in paths.items()}
        assert names["port"] == names["jax"]
        assert len(names["port"]) == 14
        assert {"router_overview.json", "signals_decisions.json",
                "safety.json", "serving.json", "metric_catalog.json",
                "provider.yaml", "flywheel.json", "fleet.json",
                "ann.json"} <= set(names["port"])
        for base in names["port"]:
            with open(tmp_path / "port" / base, "rb") as f:
                got = f.read()
            with open(tmp_path / "jax" / base, "rb") as f:
                want = f.read()
            if base == "provider.yaml":
                assert got.replace(str(tmp_path / "port").encode(), b"") \
                    == want.replace(str(tmp_path / "jax").encode(), b"")
            else:
                assert got == want, base
            if base.endswith(".json"):
                dash = json.loads(got)
                assert dash["uid"].startswith("srt-") and dash["panels"]
                for panel in dash["panels"]:
                    assert all(t["expr"] for t in panel["targets"])

    def test_catalog_tracks_registry(self):
        dashes = []
        for m, g in ((jmetrics, jgrafana), (tmetrics, tgrafana)):
            reg = m.MetricsRegistry()
            reg.counter("my_custom_total", "Custom things")
            reg.histogram("my_latency_seconds", "Custom latency")
            dashes.append(g.catalog(reg))
        assert dashes[1] == dashes[0]
        exprs = [t["expr"] for p in dashes[1]["panels"]
                 for t in p["targets"]]
        assert any("my_custom_total" in e for e in exprs)
        assert any("histogram_quantile" in e and "my_latency_seconds" in e
                   for e in exprs)

    def test_cli_grafana(self, tmp_path, capsys):
        from semantic_router_tpu_torch.__main__ import main

        assert main(["grafana", "--out-dir", str(tmp_path / "g")]) == 0
        out = json.loads(capsys.readouterr().out)
        assert len(out["rendered"]) == 14
        assert any(p.endswith("/ann.json") for p in out["rendered"])
