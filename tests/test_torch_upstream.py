"""The port's upstream plane against the JAX one, on the CPU.

- ``parse_deadline`` / ``attempt_timeout`` on a grid of headers and
  budgets;
- ``UpstreamHealth`` fed one numpy-seeded outcome sequence on an
  injected clock (no sleeps): breaker transitions (the bus events),
  ``allow`` / ``model_open`` / ``health_score``, retry-budget decisions
  at every ladder level, backoffs from the seeded rng, ``report()``;
- the pooled client's ``request_delivered`` marker (refused: False; a
  reset after the request arrived: True) and the fault proxy's actions;
- the per-model backends (``ModelCard.backend_refs``) through both HTTP
  servers: the same requests reach the same backends, a refused first
  endpoint fails over and a reset one does not;
- the budgeted failover over HTTP on both servers with the plane on: a
  5xx endpoint's circuit opens after ``breaker.failures`` failures and
  is then skipped (the proxy's own counters), the same failover paths,
  ``llm_upstream_failovers_total`` and the plane's report agree, and a
  half-open probe closes the circuit once the endpoint heals.

Server threads start in fixtures that stop them with a join timeout."""

import copy
import http.client
import json
import time
import urllib.parse

import numpy as np
import pytest

from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.observability.metrics import MetricsRegistry as \
    JMetricsRegistry
from semantic_router_tpu.resilience import upstream as jup
from semantic_router_tpu.router import fault_proxy as jfp
from semantic_router_tpu.router.httpclient import UpstreamPool as JPool
from semantic_router_tpu.router.pipeline import Router as JRouter
from semantic_router_tpu.router.server import RouterServer as JServer
from semantic_router_tpu.runtime import bootstrap as jboot
from semantic_router_tpu.runtime.events import EventBus as JBus
from semantic_router_tpu.runtime.registry import RuntimeRegistry as \
    JRegistry
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.observability.metrics import MetricsRegistry
from semantic_router_tpu_torch.resilience import upstream as tup
from semantic_router_tpu_torch.router import MockVLLMServer, Router, \
    RouterServer
from semantic_router_tpu_torch.router import fault_proxy as tfp
from semantic_router_tpu_torch.router.httpclient import UpstreamPool
from semantic_router_tpu_torch.router.server import BackendResolver
from semantic_router_tpu_torch.runtime import RuntimeRegistry, \
    apply_upstream_knobs
from semantic_router_tpu_torch.runtime.events import EventBus


class _Clock:
    """time.monotonic, moved by hand."""

    def __init__(self) -> None:
        self.t = 5000.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(time, "monotonic", c)
    return c


# ---------------------------------------------------------------------------
# deadline math

DEADLINE_HEADERS = [{}, {"x-vsr-deadline": "30"}, {"x-vsr-deadline": "0.2"},
                    {"x-vsr-deadline": "9000"}, {"x-vsr-deadline": "soon"},
                    {"x-vsr-deadline": "-5"}, {"x-vsr-deadline": ""},
                    {"x-other": "3"}]


@pytest.mark.parametrize("default_s", [0.0, 0.5, 42.0, 300.0])
def test_parse_deadline_matches_jax(default_s):
    for h in DEADLINE_HEADERS:
        assert tup.parse_deadline(h, default_s) == \
            jup.parse_deadline(h, default_s)
        assert tup.parse_deadline(h, default_s, header="x-other") == \
            jup.parse_deadline(h, default_s, header="x-other")


def test_attempt_timeout_matches_jax():
    rng = np.random.default_rng(7)
    for _ in range(200):
        args = (float(rng.uniform(-1, 60)), int(rng.integers(0, 5)),
                float(rng.uniform(0, 2)), float(rng.uniform(0.1, 300)))
        assert tup.attempt_timeout(*args) == jup.attempt_timeout(*args)


# ---------------------------------------------------------------------------
# the health plane, one seeded sequence on an injected clock

UP_CFG = {"enabled": True,
          "breaker": {"failures": 3, "open_s": 2.0, "error_rate": 0.5},
          "retry": {"budget_per_s": 2.0, "burst": 3, "backoff_ms": 40}}


class _Level:
    def __init__(self) -> None:
        self.value = 0

    def level(self) -> int:
        return self.value


def _planes():
    j = jup.UpstreamHealth(JMetricsRegistry())
    j.configure(JRouterConfig.from_dict({"resilience": {
        "upstream": UP_CFG}}).upstream_config())
    t = tup.UpstreamHealth(MetricsRegistry())
    t.configure(load_config({"resilience": {
        "upstream": UP_CFG}}).upstream_config())
    return j, t


def _report(up):
    rep = up.report()
    rep.pop("fleet_budget", None)
    rep.pop("fleet_open", None)
    for row in rep["endpoints"]:
        row.pop("opened_at_unix")
    rep["config"].pop("fleet_share", None)
    return rep


def test_health_plane_matches_jax(clock):
    j, t = _planes()
    jbus, tbus = JBus(), EventBus()
    jlvl, tlvl = _Level(), _Level()
    j.bind(events=jbus, resilience=jlvl)
    t.bind(events=tbus, resilience=tlvl)
    rng = np.random.default_rng(11)
    eps = [("m1", "http://a"), ("m1", "http://b"), ("m2", "http://c"),
           ("m2", "")]
    trace = []
    for step in range(400):
        clock.t += float(rng.uniform(0.0, 0.4))
        op = int(rng.integers(0, 6))
        model, ep = eps[int(rng.integers(0, len(eps)))]
        if op <= 2:
            ok = bool(rng.random() < (0.2 if ep in ("http://a", "")
                                      else 0.7))
            lat = float(rng.uniform(0, 0.3))
            kind = "" if ok else str(rng.choice(["5xx", "connect"]))
            j.record(model, ep, ok, lat, kind=kind)
            t.record(model, ep, ok, lat, kind=kind)
            row = None
        elif op == 3:
            row = ("allow", j.allow(model, ep), t.allow(model, ep))
        elif op == 4:
            lvl = int(rng.integers(0, 4))
            jlvl.value = tlvl.value = lvl
            row = ("retry", j.try_retry(), t.try_retry())
        else:
            attempt = int(rng.integers(1, 5))
            row = ("backoff", j.backoff_s(attempt), t.backoff_s(attempt))
        if row is not None:
            assert row[1] == row[2], (step, row)
        trace.append((j.model_open("m1"), j.model_open("m2"),
                      j.health_score("m1"), j.health_score("m2")))
        assert trace[-1] == (t.model_open("m1"), t.model_open("m2"),
                             t.health_score("m1"), t.health_score("m2")), step
    # the breaker went both ways, and the bus saw the same transitions
    masked = [o1 or o2 for o1, o2, *_ in trace]
    assert any(masked) and not all(masked)
    jev = [(e.stage, e.detail) for e in reversed(jbus.recent(500))]
    tev = [(e.stage, e.detail) for e in reversed(tbus.recent(500))]
    assert tev == jev and {"upstream_unhealthy", "upstream_recovered"} \
        <= {s for s, _ in tev}
    assert _report(t) == _report(j)
    assert t.retries.values() == j.retries.values()
    assert t.requests.values() == j.requests.values()
    assert t.breaker_transitions.values() == j.breaker_transitions.values()


def test_half_open_admits_one_probe_and_expires(clock):
    j, t = _planes()
    for up in (j, t):
        for _ in range(3):
            up.record("m", "e", False, 0.01, kind="5xx")
    seq = []
    for dt in (0.5, 1.6, 0.0, 1.0, 1.1, 0.0):
        clock.t += dt
        seq.append((j.allow("m", "e"), t.allow("m", "e")))
    assert all(a == b for a, b in seq)
    assert [a for a, _ in seq] == [False, True, False, False, True, False]
    for up in (j, t):
        up.record("m", "e", True, 0.01)
    assert j.allow("m", "e") and t.allow("m", "e")


# ---------------------------------------------------------------------------
# the pooled client's at-most-once marker, and the fault proxy


def test_request_delivered_marker_matches_jax():
    backend = MockVLLMServer().start()
    dead = MockVLLMServer()
    dead_url = dead.url
    dead.httpd.server_close()
    proxy = tfp.FaultProxy(backend.url, plan=["reset"]).start()
    try:
        for pool_cls in (JPool, UpstreamPool):
            pool = pool_cls()
            try:
                with pytest.raises(OSError) as refused:
                    pool.request("POST", dead_url + "/v1/chat/completions",
                                 b"{}", {}, 5.0)
                assert refused.value.request_delivered is False
                with pytest.raises((OSError, http.client.HTTPException)) \
                        as reset:
                    pool.request("POST", proxy.url + "/v1/chat/completions",
                                 b"{}", {}, 5.0)
                assert reset.value.request_delivered is True
                status, _, raw = pool.request(
                    "POST", backend.url + "/v1/chat/completions",
                    json.dumps({"model": "x", "messages": []}).encode(),
                    {"content-type": "application/json"}, 5.0)
                assert status == 200 and json.loads(raw)["model"] == "x"
            finally:
                pool.close()
    finally:
        proxy.stop()
        backend.stop()


@pytest.mark.parametrize("plan", [["ok", "error", "ok"],
                                  ["error", "disconnect"],
                                  None])
def test_fault_proxy_matches_jax(plan):
    backend = MockVLLMServer().start()
    kw = dict(plan=plan) if plan else dict(error_rate=0.3,
                                           disconnect_rate=0.2, seed=5)
    proxies = [m.FaultProxy(backend.url, **kw).start() for m in (jfp, tfp)]
    try:
        outs = []
        for proxy in proxies:
            got = []
            for i in range(8):
                u = urllib.parse.urlsplit(proxy.url)
                conn = http.client.HTTPConnection(u.hostname, u.port,
                                                  timeout=10)
                try:
                    conn.request("POST", "/v1/chat/completions",
                                 body=json.dumps({"model": f"m{i}"}),
                                 headers={"content-type":
                                          "application/json"})
                    got.append(conn.getresponse().status)
                except (OSError, http.client.HTTPException):
                    got.append(0)
                finally:
                    conn.close()
            outs.append((got, dict(proxy.stats)))
        assert outs[1] == outs[0]
    finally:
        for p in proxies:
            p.stop()
        backend.stop()


# ---------------------------------------------------------------------------
# per-model backends through both servers (no upstream plane)


class _Backends:
    """Mock backends that log (name, model, user text) per request."""

    def __init__(self, names) -> None:
        self.log = []
        self.servers = {}
        for name in names:
            self.servers[name] = MockVLLMServer(
                content_fn=self._recorder(name)).start()

    def _recorder(self, name):
        def content(body):
            user = next((m.get("content", "") for m in
                         reversed(body.get("messages", []))
                         if m.get("role") == "user"), "")
            self.log.append((name, body.get("model", ""), user))
            return f"{name}: {user}"
        return content

    def url(self, name, scheme=True):
        u = self.servers[name].url
        return u if scheme else u.split("://", 1)[1]

    def stop(self) -> None:
        for s in self.servers.values():
            s.stop()


def _kw_decision(name, kw, model):
    return {"name": name, "priority": 10,
            "rules": {"operator": "OR", "conditions": [
                {"type": "keyword", "name": kw}]},
            "modelRefs": [{"model": model}]}


def _two_model_config(cards) -> dict:
    return {"default_model": "model-a",
            "routing": {
                "modelCards": cards,
                "signals": {"keywords": [
                    {"name": "alpha", "keywords": ["alpha"]},
                    {"name": "beta", "keywords": ["beta"]}]},
                "decisions": [_kw_decision("to_a", "alpha", "model-a"),
                              _kw_decision("to_b", "beta", "model-b")]}}


def _post(url, body, headers=None):
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
    try:
        conn.request("POST", "/v1/chat/completions",
                     body=json.dumps(body).encode(),
                     headers={"content-type": "application/json",
                              **(headers or {})})
        r = conn.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, \
            json.loads(r.read() or b"{}")
    finally:
        conn.close()


def _get(url, path):
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"{}")
    finally:
        conn.close()


def _user(text):
    return {"model": "auto", "messages": [{"role": "user",
                                            "content": text}]}


class _Pair:
    """A JAX and a port server over one config dict."""

    def __init__(self, cfg: dict, default_url: str,
                 upstream: bool = False) -> None:
        jcfg = JRouterConfig.from_dict(copy.deepcopy(cfg))
        tcfg = load_config(copy.deepcopy(cfg))
        self.jreg = JRegistry.isolated()
        self.treg = RuntimeRegistry.isolated(runtimestats=None)
        self.jrouter = JRouter(jcfg, metrics=self.jreg.metric_series(),
                               explain=self.jreg.get("explain"),
                               resilience=self.jreg.get("resilience"))
        self.trouter = Router(tcfg, metrics=self.treg.metric_series(),
                              explain=self.treg.explain,
                              resilience=self.treg.resilience)
        if upstream:
            jboot.apply_upstream_knobs(jcfg, self.jreg, self.jrouter)
            apply_upstream_knobs(tcfg, self.treg, self.trouter)
        self.jserver = JServer(self.jrouter, jcfg,
                               default_backend=default_url,
                               registry=self.jreg).start()
        self.tserver = RouterServer(self.trouter, default_url,
                                    registry=self.treg).start()

    def stop(self) -> None:
        self.jserver.stop()
        self.tserver.stop()
        self.trouter.shutdown()


@pytest.fixture
def backends():
    b = _Backends(["A1", "A2", "B1", "B2", "D", "LIVE"])
    yield b
    b.stop()


def test_model_card_backend_refs_parse_like_jax(backends):
    cards = [{"name": "model-a", "backend_refs": [
        {"endpoint": backends.url("A1", False), "weight": 70},
        {"endpoint": backends.url("A2"), "weight": 30}]},
        {"name": "model-b"}]
    j = JRouterConfig.from_dict(_two_model_config(cards))
    t = load_config(_two_model_config(cards))
    assert [c.backend_refs for c in t.model_cards] == \
        [c.backend_refs for c in j.model_cards]
    from semantic_router_tpu.router.server import BackendResolver as JRes

    jr, tr = JRes(j, "http://d"), BackendResolver(t, "http://d")
    for model in ["model-a", "model-b", "other"] * 20:
        assert tr.resolve_candidates(model) == jr.resolve_candidates(model)


def test_each_model_reaches_its_own_backends_like_jax(backends):
    """Two models, each with two weighted endpoints: both servers send
    the same requests to the same backends, in the same order."""
    cards = [{"name": "model-a", "backend_refs": [
        {"endpoint": backends.url("A1", False), "weight": 70},
        {"endpoint": backends.url("A2"), "weight": 30}]},
        {"name": "model-b", "backend_refs": [
            {"endpoint": backends.url("B1"), "weight": 50},
            {"endpoint": backends.url("B2"), "weight": 50}]}]
    pair = _Pair(_two_model_config(cards), backends.url("D"))
    texts = [f"{'alpha' if i % 3 else 'beta'} request {i}"
             for i in range(16)] + ["neither keyword"]
    try:
        logs = []
        for server in (pair.jserver, pair.tserver):
            backends.log.clear()
            for text in texts:
                status, headers, _ = _post(server.url, _user(text))
                assert status == 200
            logs.append(list(backends.log))
        assert logs[1] == logs[0]
        hit = {name for name, _, _ in logs[1]}
        # both models spread over their own endpoints; no decision → the
        # default model, whose endpoints are model-a's
        assert hit == {"A1", "A2", "B1", "B2"}
        assert all((name[0] == "A") == (model == "model-a")
                   for name, model, _ in logs[1])
    finally:
        pair.stop()


def test_refused_endpoint_fails_over_reset_does_not(backends):
    dead = MockVLLMServer()
    dead_url = dead.url
    dead.httpd.server_close()  # bound, then closed: connect refused
    proxy = tfp.FaultProxy(backends.url("LIVE"), plan=["reset"]).start()
    cards = [{"name": "model-a", "backend_refs": [
        {"endpoint": dead_url, "weight": 100},
        {"endpoint": backends.url("A1"), "weight": 0}]},
        {"name": "model-b", "backend_refs": [
            {"endpoint": proxy.url, "weight": 100},
            {"endpoint": backends.url("B1"), "weight": 0}]}]
    pair = _Pair(_two_model_config(cards), backends.url("D"))
    try:
        rows = []
        for server, router in ((pair.jserver, pair.jrouter),
                               (pair.tserver, pair.trouter)):
            backends.log.clear()
            a = _post(server.url, _user("alpha please"))
            b = _post(server.url, _user("beta please"))
            rows.append((a[0], b[0], list(backends.log),
                         router.M.backend_failovers.values()))
        assert rows[1] == rows[0]
        status_a, status_b, log, failovers = rows[1]
        # refused: the request never arrived, so it fails over
        assert status_a == 200 and log == [("A1", "model-a",
                                            "alpha please")]
        assert failovers == {(("model", "model-a"),): 1.0}
        # reset after the request arrived: it may have run; no replay
        assert status_b == 502 and proxy.stats["reset"] == 2
    finally:
        pair.stop()
        proxy.stop()


# ---------------------------------------------------------------------------
# the budgeted failover with the plane on, over HTTP on both servers

FAILOVER_UP = {"enabled": True,
               "breaker": {"failures": 3, "open_s": 5.0},
               "retry": {"budget_per_s": 100.0, "burst": 50,
                         "backoff_ms": 1}}


def _strip_path(path, names):
    """A failover path without latencies, endpoints by name."""
    return [{k: names.get(v, v) if k == "endpoint" else v
             for k, v in hop.items() if k != "latency_ms"} for hop in path]


def test_budgeted_failover_matches_jax(backends, clock):
    """model-a's heavy endpoint answers 5xx: its circuit opens after 3
    failures and is skipped while open (the proxy counts no more
    requests); each request still answers 200 from A1.  After the
    endpoint heals and open_s passes, one half-open probe closes it."""
    proxies = [tfp.FaultProxy(backends.url("A2"), plan=["error"]).start()
               for _ in range(2)]
    pairs = []
    try:
        for proxy in proxies:
            cards = [{"name": "model-a", "backend_refs": [
                {"endpoint": proxy.url, "weight": 100},
                {"endpoint": backends.url("A1"), "weight": 0}]},
                {"name": "model-b"}]
            cfg = _two_model_config(cards)
            cfg["resilience"] = {"upstream": FAILOVER_UP}
            pairs.append(_Pair(cfg, backends.url("D"), upstream=True))
        results = []
        for side in ("j", "t"):
            pair = pairs[0] if side == "j" else pairs[1]
            proxy = proxies[0] if side == "j" else proxies[1]
            server = pair.jserver if side == "j" else pair.tserver
            explain = (pair.jreg if side == "j" else pair.treg).get(
                "explain")
            up = (pair.jreg if side == "j" else pair.treg).get("upstreams")
            names = {proxy.url: "P", backends.url("A1"): "A1"}
            rows = []
            for i in range(6):
                status, headers, body = _post(server.url,
                                              _user(f"alpha {i}"))
                rec = explain.get(headers["x-vsr-decision-record"])
                rows.append((status, _strip_path(rec["failover_path"],
                                                 names),
                             dict(proxy.stats)))
            # heal, wait out open_s: the next request is the probe
            proxy.plan = ["ok"]
            clock.t += 6.0
            status, headers, body = _post(server.url, _user("alpha probe"))
            rec = explain.get(headers["x-vsr-decision-record"])
            rows.append((status, _strip_path(rec["failover_path"], names),
                         dict(proxy.stats)))
            rep = up.report()
            results.append((rows, up.failovers.values(),
                            sorted((names[r["endpoint"]], r["state"],
                                    r["requests"], r["failures"], r["opens"])
                                   for r in rep["endpoints"])))
        assert results[1] == results[0]
        rows, failovers, endpoints = results[1]
        assert all(r[0] == 200 for r in rows)
        # 3 failures open the circuit; later requests skip the proxy
        assert [r[2]["error"] for r in rows] == [1, 2, 3, 3, 3, 3, 3]
        assert rows[3][1][0]["outcome"] == "skipped_open"
        assert rows[-1][2]["ok"] == 1 and rows[-1][1] == []
        # the first three each failed over to A1; later ones went there
        # first (the open endpoint skipped), so they are no failover
        assert failovers == {(("model", "model-a"),): 3.0}
        assert endpoints == [("A1", "closed", 6, 0, 0),
                             ("P", "closed", 4, 3, 1)]
        status, dbg = _get(pairs[1].tserver.url, "/debug/resilience")
        assert status == 200 and dbg["upstreams"]["enabled"]
        status, met = _get(pairs[1].tserver.url, "/metrics/external")
        assert status == 200 and met["kind"] == "ExternalMetricValueList"
    finally:
        for pair in pairs:
            pair.stop()
        for proxy in proxies:
            proxy.stop()
