"""The port's shared state plane against the JAX package's.

The backend contract on memory, RESP (either package's ``MiniRedis``) and
SQLite (one file shared across packages); the guarded breaker; ``HashRing``
owners equal to the JAX ring's; membership, TTL expiry and fleet pressure
from the same rows with JAX and port replicas in one namespace; a mixed
fleet (a JAX replica and a port replica) whose cache writes hit on the
other side, exact and similar, both ways; the fleet-wide decision mirror;
the config seam and the bootstrap; the six scenarios of
``tests/test_stateplane_chaos.py::TestFleetConvergence`` run by both
``ReplicaFleet``s with the same outcomes; ``/debug/stateplane`` and the
fleet maximum of ``/metrics/external`` over both HTTP servers.  Every
socket test binds its ``MiniRedis`` to port 0 and stops it; heartbeats
and TTLs use the smallest intervals and poll with a deadline."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from semantic_router_tpu.config.schema import RouterConfig as JRouterConfig
from semantic_router_tpu.state.resp import MiniRedis as JMiniRedis
from semantic_router_tpu import stateplane as jsp
from semantic_router_tpu.stateplane import harness as jharness
from semantic_router_tpu_torch import stateplane as tsp
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.config.schema import RouterConfig
from semantic_router_tpu_torch.state.resp import MiniRedis
from semantic_router_tpu_torch.stateplane import harness as tharness

PKGS = {"port": tsp, "jax": jsp}


@pytest.fixture(scope="module")
def mini():
    srv = MiniRedis().start()
    yield srv
    srv.stop()


def _wait(cond, timeout=5.0, step=0.02):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(step)
    return cond()


def _resp(mod, port, cooldown_s=2.0):
    return mod.GuardedBackend(mod.RespStateBackend(port=port),
                              cooldown_s=cooldown_s)


# -- the backend seam ----------------------------------------------------


def _contract(be, ns):
    """The JAX suite's contract, returning what each step answered."""
    out = [be.ping()]
    be.put(f"{ns}:k1", b"v1")
    out += [be.get(f"{ns}:k1"), be.get(f"{ns}:absent")]
    be.put_hash(f"{ns}:h1", {"a": b"1", "b": b"2"})
    out += [be.get_hash(f"{ns}:h1"), be.get_hash(f"{ns}:absent")]
    be.put(f"{ns}:k2", b"v2")
    out.append([k[len(ns):] for k in be.scan(f"{ns}:k")])
    out += [be.incr(f"{ns}:ctr"), be.incr(f"{ns}:ctr", 5),
            be.delete(f"{ns}:k1"), be.get(f"{ns}:k1")]
    be.put(f"{ns}:ttl", b"x", ttl_s=0.05)
    out.append(be.get(f"{ns}:ttl"))
    _wait(lambda: be.get(f"{ns}:ttl") is None, timeout=3.0)
    out += [be.get(f"{ns}:ttl"), be.scan(f"{ns}:ttl")]
    return out


WANT_CONTRACT = [True, b"v1", None, {"a": b"1", "b": b"2"}, {},
                 [":k1", ":k2"], 1, 6, 1, None, b"x", None, []]


@pytest.mark.parametrize("kind", ["memory", "resp-port-server",
                                  "resp-jax-server", "sqlite"])
def test_backend_contract(kind, mini, tmp_path):
    jmini = None
    if kind == "memory":
        got = tsp.InMemoryStateBackend()
        want = jsp.InMemoryStateBackend()
    elif kind == "sqlite":
        got = tsp.SQLiteStateBackend(str(tmp_path / "t.db"))
        want = jsp.SQLiteStateBackend(str(tmp_path / "j.db"))
    else:
        port = mini.port
        if kind == "resp-jax-server":
            jmini = JMiniRedis().start()
            port = jmini.port
        got = tsp.RespStateBackend(port=port)
        want = jsp.RespStateBackend(port=port)
    try:
        assert _contract(got, "t:port") == _contract(want, "t:jax") \
            == WANT_CONTRACT
    finally:
        got.close()
        want.close()
        if jmini is not None:
            jmini.stop()


def test_sqlite_file_shared_across_packages(tmp_path):
    path = str(tmp_path / "shared.db")
    t, j = tsp.SQLiteStateBackend(path), jsp.SQLiteStateBackend(path)
    t.put("x:k", b"from-port")
    j.put_hash("x:h", {"f": b"from-jax"})
    assert j.get("x:k") == b"from-port"
    assert t.get_hash("x:h") == {"f": b"from-jax"}
    n = 40

    def spin(be):
        for _ in range(n):
            be.incr("x:ctr")

    threads = [threading.Thread(target=spin, args=(be,)) for be in (t, j)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert t.incr("x:ctr") == 2 * n + 1
    t.close(), j.close()


def test_build_backend_factory(tmp_path):
    for mod in (tsp, jsp):
        g = mod.build_backend({"backend": "memory"})
        assert type(g).__name__ == "GuardedBackend"
        assert g.report()["backend"] == "InMemoryStateBackend"
        g = mod.build_backend({"backend": "sqlite", "backend_config":
                               {"path": str(tmp_path / "f.db")}})
        g.put("k", b"v")
        assert g.get("k") == b"v"
        with pytest.raises(ValueError):
            mod.build_backend({"backend": "zookeeper"})
        with pytest.raises(ValueError):
            mod.build_backend({"backend": "sqlite"})


class _Flaky:
    def __init__(self):
        self.down = False
        self.data = {}

    def _check(self):
        if self.down:
            raise OSError("dead")

    def ping(self):
        self._check()
        return True

    def put(self, key, value, ttl_s=None):
        self._check()
        self.data[key] = value

    def get(self, key):
        self._check()
        return self.data.get(key)

    def close(self):
        pass


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_breaker_opens_fast_fails_and_recovers(pkg):
    mod = PKGS[pkg]
    inner = _Flaky()
    g = mod.GuardedBackend(inner, cooldown_s=0.1)
    g.put("k", b"v")
    inner.down = True
    with pytest.raises(mod.StateBackendUnavailable):
        g.get("k")
    assert not g.available
    before = g.roundtrips
    with pytest.raises(mod.StateBackendUnavailable):
        g.get("k")  # open: the inner backend is not touched
    assert g.roundtrips == before and g.errors == 1
    fired = []
    g.on_recover(lambda: fired.append(1))
    inner.down = False
    time.sleep(0.15)
    assert g.get("k") == b"v" and g.available
    assert _wait(lambda: fired == [1], timeout=2.0)
    rep = g.report()
    assert (rep["backend"], rep["available"], rep["errors"],
            rep["cooldown_s"]) == ("_Flaky", True, 1, 0.1)


# -- the ring --------------------------------------------------------------


@pytest.mark.parametrize("members,vnodes", [
    (["replica-0", "replica-1", "replica-2"], 64),
    (["a"], 1), (["x", "y", "z", "w"], 8),
    ([f"host-{i}-{i * 7}" for i in range(9)], 128)])
def test_ring_owners_equal_the_jax_ring(members, vnodes):
    rng = np.random.default_rng(len(members) * vnodes)
    keys = [f"k{i}:{rng.integers(1 << 40)}" for i in range(1000)]
    t = tsp.HashRing(members, vnodes=vnodes)
    j = jsp.HashRing(list(reversed(members)), vnodes=vnodes)
    assert [t.node_for(k) for k in keys] == [j.node_for(k) for k in keys]
    assert t.distribution(2048) == j.distribution(2048)
    survivors = members[:-1] or members
    t.rebuild(survivors)
    j.rebuild(survivors)
    assert [t.node_for(k) for k in keys] == [j.node_for(k) for k in keys]


# -- membership and pressure -----------------------------------------------


def test_mixed_membership_and_ttl_expiry(mini):
    a = tsp.StatePlane(_resp(tsp, mini.port, 0.2), replica_id="hb-a",
                       namespace="m1", heartbeat_s=0.05)
    b = jsp.StatePlane(_resp(jsp, mini.port, 0.2), replica_id="hb-b",
                       namespace="m1", heartbeat_s=0.05)
    try:
        a.heartbeat_once()
        b.heartbeat_once()
        a.heartbeat_once()
        assert a.members() == b.members() == ["hb-a", "hb-b"]
        for k in ("k-123", "alpha", "bravo", "a prompt"):
            assert a.owner_of(k) == b.owner_of(k)
        # b stops beating: one TTL later it leaves a's ring
        assert _wait(lambda: a.heartbeat_once() == ["hb-a"], timeout=5.0,
                     step=0.05)
        assert a.owner_of("k-123") == "hb-a"
        # the explicit TTL is floored at two beats, as the reference does
        be = _resp(tsp, mini.port)
        assert tsp.StatePlane(be, replica_id="t1", heartbeat_s=2.0,
                              ttl_s=1.0).ttl_s == 4.0
        assert tsp.StatePlane(be, replica_id="t2", heartbeat_s=2.0,
                              ttl_s=10.0).ttl_s == 10.0
    finally:
        a.close(), b.close()


def test_fleet_pressure_from_the_same_rows(mini):
    rows = [
        ("port", "fp-a", {"firing": {"lat": "slow"}, "pending_items": 10,
                          "pool_saturation": 0.3, "level": 1}),
        ("jax", "fp-b", {"firing": {"lat": "fast", "err": "slow"},
                         "pending_items": 80, "pool_saturation": 0.1,
                         "level": 2}),
        ("port", "fp-c", {"engine_down": True, "level": 4}),
    ]
    planes = {rid: PKGS[pkg].StatePlane(_resp(PKGS[pkg], mini.port),
                                        replica_id=rid, namespace="m2")
              for pkg, rid, _ in rows}
    try:
        for pkg, rid, row in rows:
            planes[rid].publish_pressure(row)
        got = planes["fp-a"].fleet_pressure()
        want = planes["fp-b"].fleet_pressure()
        assert got == want
        assert (got["replicas"], got["pending_items"],
                got["pool_saturation"], got["firing"], got["levels"],
                got["max_level"], got["engine_down"]) == (
            3, 80.0, 0.3, {"lat": "fast", "err": "slow"},
            {"fp-a": 1, "fp-b": 2, "fp-c": 4}, 4, True)
    finally:
        for p in planes.values():
            p.close()


def test_report_shape_matches(mini):
    t = tsp.StatePlane(_resp(tsp, mini.port), replica_id="rep-t",
                       namespace="m3")
    j = jsp.StatePlane(_resp(jsp, mini.port), replica_id="rep-j",
                       namespace="m3b")
    try:
        t.heartbeat_once(), j.heartbeat_once()
        rt, rj = t.report(), j.report()
        assert sorted(rt) == sorted(rj)
        assert sorted(rt["backend"]) == sorted(rj["backend"])
        assert rt["members"] == ["rep-t"]
        assert rt["backend"]["available"] is True
        assert rt["ring"]["distribution"] == {"rep-t": 1.0}
    finally:
        t.close(), j.close()


# -- the shared cache across packages -------------------------------------


def _cache_pair(mini, ns, writer):
    """(writer plane, reader plane, writer cache, reader cache): one side
    of each package."""
    mods = (tsp, jsp) if writer == "port" else (jsp, tsp)
    embeds = {tsp: tharness.hash_embed(), jsp: jharness.hash_embed()}
    planes = [m.StatePlane(_resp(m, mini.port, 0.1),
                           replica_id=f"{ns}-{i}", namespace=ns)
              for i, m in enumerate(mods)]
    caches = [m.SharedSemanticCache(p, embeds[m])
              for m, p in zip(mods, planes)]
    return planes[0], planes[1], caches[0], caches[1]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mixed_fleet_cache_exact_and_similar(mini, writer):
    a, b, ca, cb = _cache_pair(mini, f"c1{writer}", writer)
    try:
        ca.add("what is contract law", "a legal answer", model="m-l")
        hit = cb.find_similar("what is contract law")
        assert hit is not None and hit.response == "a legal answer"
        assert hit.model == "m-l" and cb.stats().exact_hits == 1
        hit = cb.find_similar("what is contract law?", threshold=0.85)
        assert hit is not None and hit.response == "a legal answer"
        want = float(ca._normalize(ca.embed_fn("what is contract law?"))
                     @ ca._normalize(ca.embed_fn("what is contract law")))
        got = float(cb._matrix[0] @ cb._normalize(
            cb.embed_fn("what is contract law?")))
        assert abs(got - want) <= 1e-6
        ca.add("what is contract law", "updated answer")
        assert cb.find_similar("what is contract law").response \
            == "updated answer"
        assert len(a.backend.scan(a.key("cache", "entry", ""))) == 1
        # the reader writes back: the first writer sees it
        cb.add("how do I rotate the api credentials", "rotate them")
        assert ca.find_similar("how do I rotate the api credentials?",
                               threshold=0.85).response == "rotate them"
    finally:
        a.close(), b.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mixed_fleet_invalidate_clear_and_scoping(mini, writer):
    a, b, ca, cb = _cache_pair(mini, f"c2{writer}", writer)
    try:
        ca.add("q one", "r1")
        ca.add("q two", "r2")
        ca.add("query in math", "math resp", category="math")
        assert cb.find_similar("q one") is not None
        assert cb.find_similar("query in math", category="law") is None
        assert cb.find_similar("query in math",
                               category="math") is not None
        cb.invalidate("q one")
        assert ca.find_similar("q one", threshold=0.99) is None
        cb.clear()
        assert ca.find_similar("q two", threshold=0.99) is None
    finally:
        a.close(), b.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_interleaved_writers_mirror_converges(mini, writer):
    a, b, ca, cb = _cache_pair(mini, f"c3{writer}", writer)
    try:
        assert cb.find_similar("warm up the mirror") is None
        ca.add("what is contract law", "resp-from-a")
        cb.add("a completely different cooking query", "resp-b")
        hit = cb.find_similar("what is contract law?", threshold=0.85)
        assert hit is not None and hit.response == "resp-from-a"
    finally:
        a.close(), b.close()


def test_plane_loss_falls_back_to_the_local_cache():
    from semantic_router_tpu_torch.cache.semantic_cache import \
        InMemorySemanticCache

    srv = MiniRedis().start()
    port = srv.port
    embed = tharness.hash_embed()
    plane = tsp.StatePlane(_resp(tsp, port, 0.1), replica_id="lf",
                           namespace="lf")
    local = InMemorySemanticCache(embed, use_hnsw=False)
    cache = tsp.SharedSemanticCache(plane, embed, local=local)
    try:
        cache.add("before the outage", "shared")
        srv.stop()
        cache.add("during the outage", "local only")
        assert cache.find_similar("during the outage").response \
            == "local only"
        assert cache.stats().errors >= 1
        srv = MiniRedis(port=port).start()
        # the breaker's probe recovers the plane; reconcile replays the
        # buffered write
        assert _wait(lambda: cache.find_similar("during the outage")
                     is not None and plane.backend.available
                     and plane.backend.get_hash(cache._entry_key(
                         tsp.cache._qhash("during the outage"))) != {},
                     timeout=10.0, step=0.1)
    finally:
        plane.close()
        srv.stop()


def _completion(text):
    return {"id": "c", "object": "chat.completion", "model": "m",
            "choices": [{"index": 0, "finish_reason": "stop",
                         "message": {"role": "assistant", "content": text}}]}


def test_mixed_fleet_routers_over_engines(mini):
    """A JAX router and a port router, each built by its package's
    bootstrap over the same seeded embedding engine's weights, on one
    store: a routed answer written through one is the other's cache hit
    (exact and similar), with the same affinity, and the port's stored
    embedding agrees with the JAX one within 1e-4."""
    from semantic_router_tpu.engine import testing as jtesting
    from semantic_router_tpu.runtime.bootstrap import \
        build_router as jbuild_router
    from semantic_router_tpu.runtime.registry import \
        RuntimeRegistry as JRegistry
    from semantic_router_tpu_torch.engine import testing as ttesting
    from semantic_router_tpu_torch.runtime import RuntimeRegistry, \
        build_router, close_stateplane

    jeng = jtesting.make_embedding_engine(seed=21)
    teng = ttesting.make_embedding_engine(
        device="cpu", flax_params={n: t.params
                                   for n, t in jeng._tasks.items()})

    def raw(replica):
        return {
            "default_model": "m",
            "semantic_cache": {"enabled": True, "backend_type": "memory",
                               "similarity_threshold": 0.95},
            "routing": {
                "signals": {"keywords": [{"name": "legal", "keywords": [
                    "contract", "liability"]}]},
                "decisions": [{
                    "name": "legal_route", "priority": 10,
                    "rules": {"operator": "OR", "conditions": [
                        {"type": "keyword", "name": "legal"}]},
                    "modelRefs": [{"model": "legal-model"}],
                    "plugins": [{"type": "semantic-cache"}]}]},
            "stateplane": {"enabled": True, "backend": "resp",
                           "backend_config": {"port": mini.port},
                           "replica_id": replica, "namespace": "mixed",
                           "heartbeat_s": 0.05, "cooldown_s": 0.05}}

    jreg, treg = JRegistry.isolated(), RuntimeRegistry.isolated()
    jr = jbuild_router(JRouterConfig.from_dict(raw("jax-a")), jeng,
                       registry=jreg)
    tr = build_router(load_config(raw("port-b")), teng, registry=treg)
    jplane = jreg.get("stateplane")
    try:
        assert type(jr.cache).__name__ == type(tr.cache).__name__ == \
            "SharedSemanticCache"
        names = ["jax-a", "port-b"]
        assert _wait(lambda: jplane.members() == names
                     and treg.get("stateplane").members() == names)

        def body(text):
            return {"model": "auto",
                    "messages": [{"role": "user", "content": text}]}

        for writer, reader, q in (
                (jr, tr, "is this contract clause enforceable"),
                (tr, jr, "who carries the liability for the outage")):
            first = writer.route(body(q))
            assert first.kind == "route"
            writer.process_response(first, _completion(f"answer to {q}"))
            hit = reader.route(body(q))
            assert hit.kind == "cache_hit"
            assert hit.response_body["choices"][0]["message"][
                "content"] == f"answer to {q}"
            assert hit.headers["x-vsr-affinity-replica"] == \
                first.headers["x-vsr-affinity-replica"]
            similar = [r.route(body(q + "?")).kind for r in (jr, tr)]
            assert similar[0] == similar[1]
        key = tsp.cache._qhash("is this contract clause enforceable")
        stored = np.frombuffer(treg.get("stateplane").backend.get_hash(
            tr.cache._entry_key(key))["emb"], dtype="<f4")
        mine = tr.cache._normalize(tr.cache.embed_fn(
            "is this contract clause enforceable"))
        np.testing.assert_allclose(mine, stored, atol=1e-4)
    finally:
        jr.shutdown()
        tr.shutdown()
        jplane.close()
        close_stateplane(treg)
        jeng.shutdown()
        teng.shutdown()


# -- the decision mirror ---------------------------------------------------


def test_fleet_wide_durable_records_across_packages(mini):
    a = tsp.StatePlane(_resp(tsp, mini.port), replica_id="da",
                       namespace="dm1")
    b = jsp.StatePlane(_resp(jsp, mini.port), replica_id="db",
                       namespace="dm1")
    sa = tsp.StatePlaneDecisionStore(a, max_records=100)
    sb = jsp.StatePlaneDecisionStore(b, max_records=100)
    try:
        sa.add({"record_id": "r1", "trace_id": "t1", "ts_unix": time.time(),
                "kind": "route", "model": "m1", "decision": {"name": "d1"}})
        sb.add({"record_id": "r2", "trace_id": "t2",
                "ts_unix": time.time() + 1, "kind": "route", "model": "m2",
                "decision": {"name": "d2"}})
        assert _wait(lambda: sb.get("r1") is not None
                     and sa.get("r2") is not None)
        assert sb.get("t1")["record_id"] == "r1"
        assert sa.get("t2")["record_id"] == "r2"
        assert len(sa) == len(sb) == 2
        assert sa.list() == sb.list()
        assert [r["record_id"] for r in sa.list()] == ["r2", "r1"]
        assert sa.list(model="m1")[0]["record_id"] == "r1"
        assert sa.list(decision="d2")[0]["record_id"] == "r2"
    finally:
        sa.close(), sb.close()
        a.close(), b.close()


def test_retention_trims_oldest(mini):
    plane = tsp.StatePlane(_resp(tsp, mini.port), replica_id="dr",
                           namespace="dm2")
    store = tsp.StatePlaneDecisionStore(plane, max_records=5)
    store._stop.set()
    store._wake.set()
    store._writer.join(timeout=2.0)
    for i in range(12):
        store.add({"record_id": f"r{i:02d}", "trace_id": f"t{i}",
                   "ts_unix": 1000.0 + i, "kind": "route", "model": "m"})
    store._drain()
    store._trim()
    assert len(store) <= 5
    assert store.get("r11") is not None and store.get("r00") is None
    store.close()
    plane.close()


# -- the config seam -------------------------------------------------------


@pytest.mark.parametrize("block", [
    {}, {"enabled": True},
    {"enabled": True, "backend": "resp", "replica_id": "r",
     "namespace": "ns", "heartbeat_s": 0.5, "ttl_s": 3, "cooldown_s": 1,
     "ring_vnodes": 16, "backend_config": {"host": "h", "port": 7000},
     "share": {"cache": False, "explain": False}},
    {"enabled": True, "heartbeat_s": "soon", "ring_vnodes": "many",
     "ttl_s": None, "cooldown_s": -5, "namespace": "",
     "share": {"fleet": 0}},
])
def test_stateplane_config_matches_the_reference(block):
    got = load_config({"stateplane": dict(block)}).stateplane_config()
    want = JRouterConfig.from_dict(
        {"stateplane": dict(block)}).stateplane_config()
    assert got == want


def test_build_state_plane_seam():
    assert tsp.build_state_plane(RouterConfig()) is None
    plane = tsp.build_state_plane(load_config({"stateplane": {
        "enabled": True, "backend": "memory", "replica_id": "cfg-r",
        "heartbeat_s": 0.5}}))
    try:
        assert plane.replica_id == "cfg-r"
        plane.heartbeat_once()
        assert plane.members() == ["cfg-r"]
    finally:
        plane.close()


def test_router_default_has_no_plane_reads():
    from semantic_router_tpu_torch.router import Router

    router = Router(RouterConfig(default_model="m"))
    assert router.stateplane is None
    res = router.route({"model": "auto", "messages": [
        {"role": "user", "content": "hello"}]})
    assert "x-vsr-affinity-replica" not in res.headers
    router.shutdown()


SP_CONFIG = {
    "default_model": "m",
    "semantic_cache": {"enabled": True, "backend_type": "memory",
                       "similarity_threshold": 0.9},
    "stateplane": {"enabled": True, "backend": "resp",
                   "replica_id": "boot-a", "namespace": "boot",
                   "heartbeat_s": 0.05, "cooldown_s": 0.05},
    "resilience": {"enabled": True},
}


def test_bootstrap_attaches_carries_and_detaches(mini):
    from semantic_router_tpu_torch.engine.testing import \
        make_embedding_engine
    from semantic_router_tpu_torch.runtime import RuntimeRegistry, \
        apply_observability_knobs, build_router, close_stateplane
    from semantic_router_tpu_torch.runtime.events import EventBus

    import copy

    raw = copy.deepcopy(SP_CONFIG)
    raw["stateplane"]["backend_config"] = {"port": mini.port}
    cfg = load_config(raw)
    engine = make_embedding_engine(seed=3, device="cpu")
    registry = RuntimeRegistry.isolated()
    registry.events = EventBus()
    try:
        apply_observability_knobs(cfg, registry)
        router = build_router(cfg, engine, registry=registry)
        plane = registry.get("stateplane")
        assert plane is not None and router.stateplane is plane
        assert plane.members() == ["boot-a"]
        assert type(router.cache).__name__ == "SharedSemanticCache"
        assert type(router.cache.local).__name__ == "InMemorySemanticCache"
        assert registry.resilience.fleet is plane
        assert registry.resilience.report()["fleet_attached"] is True
        assert type(registry.explain.durable_store).__name__ == \
            "StatePlaneDecisionStore"
        # the cache embeds through the engine's embedding task
        router.cache.add("what is contract law", "answer", model="m")
        hit = router.cache.find_similar("what is contract law")
        assert hit is not None and hit.embedding.dtype == np.float32
        assert abs(float(np.linalg.norm(hit.embedding)) - 1.0) < 1e-5
        # a reload keeps the plane and the shared cache
        again = build_router(cfg, engine, registry=registry,
                             carry_from=router)
        assert registry.get("stateplane") is plane
        assert again.cache is router.cache
        router.shutdown()
        # a reload with the plane off detaches everything
        off = copy.deepcopy(raw)
        off["stateplane"]["enabled"] = False
        cfg_off = load_config(off)
        apply_observability_knobs(cfg_off, registry)
        third = build_router(cfg_off, engine, registry=registry,
                             carry_from=again)
        again.shutdown()
        assert registry.get("stateplane") is None
        assert third.stateplane is None
        assert type(third.cache).__name__ == "InMemorySemanticCache"
        assert registry.resilience.fleet is None
        assert registry.explain.durable_store is None
        assert _wait(lambda: not plane._thread)
        third.shutdown()
    finally:
        close_stateplane(registry)
        registry.runtimestats.stop()
        registry.slo.stop()
        registry.resilience.stop()
        engine.shutdown()


def test_bootstrap_survives_an_unbuildable_plane():
    from semantic_router_tpu_torch.runtime import RuntimeRegistry, \
        build_router

    cfg = load_config({"default_model": "m", "stateplane": {
        "enabled": True, "backend": "zookeeper"}})
    registry = RuntimeRegistry.isolated()
    router = build_router(cfg, None, registry=registry)
    try:
        assert router.stateplane is None
        assert registry.get("stateplane") is None
        assert router.route({"model": "auto", "messages": [
            {"role": "user", "content": "hi"}]}).kind == "route"
    finally:
        router.shutdown()


# -- the six convergence scenarios, both fleets ----------------------------


def _chaos_signal(pkg):
    base = ("semantic_router_tpu" if pkg == "jax"
            else "semantic_router_tpu_torch") + ".signals.base"
    import importlib

    b = importlib.import_module(base)

    class ProxiedSignal:
        signal_type = "chaos"
        engine = None

        def __init__(self, url):
            self.url = url

        def evaluate(self, ctx):
            with urllib.request.urlopen(self.url + "/health",
                                        timeout=5) as resp:
                resp.read()
            return b.SignalResult(signal_type="chaos",
                                  hits=[b.SignalHit(rule="reachable")])

    return ProxiedSignal


def _route(replica, text):
    return replica.router.route(
        {"model": "auto", "messages": [{"role": "user", "content": text}]})


OFFLINE_Q = "a legal question asked while the plane was down"


def _run_fleet(pkg):
    """The six phases of TestFleetConvergence on one package's fleet;
    returns what each phase observed."""
    import importlib

    root = "semantic_router_tpu" if pkg == "jax" \
        else "semantic_router_tpu_torch"
    mod = PKGS[pkg]
    H = importlib.import_module(root + ".router.headers")
    FaultProxy = importlib.import_module(
        root + ".router.fault_proxy").FaultProxy
    MockVLLM = importlib.import_module(
        root + ".router.mock_backend").MockVLLMServer
    Mini = JMiniRedis if pkg == "jax" else MiniRedis
    harness = jharness if pkg == "jax" else tharness
    mini = Mini().start()
    port = mini.port
    backend = MockVLLM().start()
    proxy = FaultProxy(backend.url, plan=["error"]).start()
    fleet = harness.ReplicaFleet(
        backend_factory=lambda: mod.GuardedBackend(
            mod.RespStateBackend(port=port), cooldown_s=0.2),
        n=3, heartbeat_s=0.2).start()
    out = {}
    try:
        r0 = fleet.replicas[0]
        r0.router.dispatcher.evaluators["chaos"] = \
            _chaos_signal(pkg)(proxy.url)
        if r0.router.dispatcher.used_types is not None:
            r0.router.dispatcher.used_types.add("chaos")
        mon = r0.registry.get("slo")
        mon.event_bus = r0.registry.get("events")
        mon.configure({"objectives": ["signal error-rate < 1% over 0.2s"]})
        r0.controller.bind(slo=mon)
        a, b, c = fleet.replicas
        names = sorted(r.name for r in fleet.replicas)
        # 1: membership and ring agreement
        out[1] = {"members": [r.plane.members() for r in fleet.replicas],
                  "owners": [[r.plane.owner_of(k) for r in fleet.replicas]
                             for k in ("alpha", "bravo", "charlie",
                                       "delta")]}
        # 2: a cache write on A hits on B and C
        text = "what does this contract clause mean"
        first = _route(a, text).kind
        a.router.cache.add(text, "a shared legal answer",
                           model="model-large")
        hits = [_route(o, text) for o in (b, c)]
        res = _route(a, "is this liability clause legal")
        out[2] = {"first": first, "kinds": [h.kind for h in hits],
                  "answers": [h.response_body["choices"][0]["message"][
                      "content"] for h in hits],
                  "affinity": [h.headers.get(H.AFFINITY) for h in hits]
                  + [res.headers.get(H.AFFINITY)]}
        # 3: overload on one replica converges the fleet
        mon.tick(now=100.0)
        kinds, errors = set(), 0
        for i in range(40):
            res = _route(r0, f"routine question number {i}")
            kinds.add(res.kind)
            errors += bool(res.report.results["chaos"].error)
        mon.tick(now=100.2)
        seen = []
        for _ in range(3):
            fleet.tick_all()
            seen.append(fleet.levels())
        reps = [r.controller.report() for r in fleet.replicas]
        out[3] = {"kinds": sorted(kinds), "errors": errors,
                  "degraded": mon.degraded(), "levels": seen,
                  "fleet": [(rep["fleet_attached"],
                             rep["pressure"]["fleet"]["aggregated"],
                             rep["pressure"]["fleet"]["replicas"],
                             rep["pressure"]["fleet"]["levels"])
                            for rep in reps]}
        # 4: recovery stays in lockstep
        with proxy._lock:
            proxy.plan = ["ok"]
            proxy._plan_i = 0
        series, t = r0.router.M, 100.2
        for _ in range(90):
            t += 0.2
            for _ in range(20):
                series.signal_latency.observe(0.001, family="chaos")
            mon.tick(now=t)
        rounds = []
        for _ in range(8):
            fleet.tick_all()
            rounds.append(fleet.levels())
        out[4] = {"degraded": mon.degraded(), "levels": rounds}
        # 5: the backend killed mid-run degrades every replica to local
        mini.stop()
        gone = _wait(lambda: not any(r.plane.available
                                     for r in fleet.replicas))
        a.router.cache.add(OFFLINE_Q, "buffered answer", model="m-l")
        offline = [_route(r, "is this contract enforceable offline")
                   for r in fleet.replicas]
        local_a, local_b = _route(a, OFFLINE_Q).kind, _route(b, OFFLINE_Q).kind
        fleet.tick_all()
        rep = a.plane.report()
        out[5] = {"gone": gone,
                  "kinds": [r.kind for r in offline],
                  "affinity": [H.AFFINITY in r.headers for r in offline],
                  "local": [local_a, local_b], "levels": fleet.levels(),
                  "members": a.plane.members() == names,
                  "report": (rep["fleet"].get("unreachable"),
                             rep["backend"]["available"])}
        # 6: a restart re-attaches and reconciles
        mini = Mini(port=port).start()
        back = _wait(lambda: all(r.plane.available
                                 for r in fleet.replicas), timeout=10.0,
                     step=0.05)
        joined = _wait(lambda: all(r.plane.members() == names
                                   for r in fleet.replicas), timeout=10.0,
                       step=0.05)
        replayed = _wait(lambda: _route(b, OFFLINE_Q).kind == "cache_hit",
                         timeout=10.0, step=0.1)
        out[6] = {"back": back, "joined": joined, "replayed": replayed,
                  "kinds": [_route(r, OFFLINE_Q).kind for r in (b, c)]}
    finally:
        fleet.stop()
        proxy.stop()
        backend.stop()
        mini.stop()
    return out


@pytest.fixture(scope="module")
def fleets():
    return {pkg: _run_fleet(pkg) for pkg in ("jax", "port")}


class TestFleetConvergence:
    def test_1_membership_and_ring_agreement(self, fleets):
        got, want = fleets["port"][1], fleets["jax"][1]
        assert got == want
        names = ["replica-0", "replica-1", "replica-2"]
        assert got["members"] == [names] * 3
        assert all(len(set(o)) == 1 for o in got["owners"])

    def test_2_cache_write_on_a_hits_on_b(self, fleets):
        got, want = fleets["port"][2], fleets["jax"][2]
        assert got == want
        assert got["first"] == "route"
        assert got["kinds"] == ["cache_hit"] * 2
        assert got["answers"] == ["a shared legal answer"] * 2
        assert set(got["affinity"]) <= {"replica-0", "replica-1",
                                        "replica-2"}

    def test_3_overload_on_one_replica_converges_fleet(self, fleets):
        got, want = fleets["port"][3], fleets["jax"][3]
        assert got == want
        assert got["kinds"] == ["route"] and got["errors"] == 40
        assert "signal_error_rate" in got["degraded"]
        assert got["levels"] == [[1] * 3, [2] * 3, [3] * 3]
        assert all(f[:3] == (True, True, 3) for f in got["fleet"])

    def test_4_recovery_stays_in_lockstep(self, fleets):
        got, want = fleets["port"][4], fleets["jax"][4]
        assert got == want
        assert got["degraded"] == []
        assert all(len(set(lv)) == 1 for lv in got["levels"])
        assert got["levels"][-1] == [0, 0, 0]

    def test_5_backend_killed_mid_run_degrades_to_local(self, fleets):
        got, want = fleets["port"][5], fleets["jax"][5]
        assert got == want
        assert got["gone"] and got["members"]
        assert set(got["kinds"]) <= {"route", "cache_hit"}
        assert all(got["affinity"])
        assert got["local"] == ["cache_hit", "route"]
        assert got["levels"] == [0, 0, 0]
        assert got["report"] == (True, False)

    def test_6_backend_restart_reattaches_and_reconciles(self, fleets):
        got, want = fleets["port"][6], fleets["jax"][6]
        assert got == want
        assert got["back"] and got["joined"] and got["replayed"]
        assert got["kinds"] == ["cache_hit", "cache_hit"]


# -- the HTTP surface, both servers ----------------------------------------


def _server(pkg, with_plane):
    import importlib

    root = "semantic_router_tpu" if pkg == "jax" \
        else "semantic_router_tpu_torch"
    mod = PKGS[pkg]
    harness = jharness if pkg == "jax" else tharness
    Router = importlib.import_module(root + ".router.pipeline").Router
    RouterServer = importlib.import_module(
        root + ".router.server").RouterServer
    Registry = importlib.import_module(
        root + ".runtime.registry").RuntimeRegistry
    MockVLLM = importlib.import_module(
        root + ".router.mock_backend").MockVLLMServer
    backend = MockVLLM().start()
    cfg = harness.fleet_config()
    plane = None
    if with_plane:
        plane = mod.StatePlane(mod.build_backend({"backend": "memory"}),
                               replica_id="srv-a", heartbeat_s=0.2)
        plane.heartbeat_once()
        registry = Registry.isolated(stateplane=plane)
        controller = registry.get("resilience")
        controller.bind(events=registry.get("events"), fleet=plane)
        controller.configure(cfg.resilience_config())
        router = Router(cfg, metrics=registry.metric_series(),
                        tracer=registry.tracer,
                        flightrec=registry.get("flightrec"),
                        explain=registry.get("explain"),
                        resilience=controller)
        router.stateplane = plane
    else:
        registry = Registry.isolated()
        router = Router(cfg, metrics=registry.metric_series())
    if pkg == "jax":
        srv = RouterServer(router, cfg, default_backend=backend.url,
                           registry=registry).start()
    else:
        srv = RouterServer(router, backend.url, registry=registry).start()

    def stop():
        srv.stop()
        router.shutdown()
        if plane is not None:
            plane.close()
        backend.stop()

    return srv, plane, stop


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read() or b"{}")


def test_debug_stateplane_and_external_metrics_fleet_max():
    got = {}
    stops = []
    try:
        for pkg in ("jax", "port"):
            srv, plane, stop = _server(pkg, True)
            stops.append(stop)
            mod = PKGS[pkg]
            status, rep = _get(srv.url + "/debug/stateplane")
            assert status == 200
            assert (rep["replica_id"], rep["members"],
                    rep["backend"]["available"]) == ("srv-a", ["srv-a"],
                                                     True)
            plane.backend.put(plane.key("replica", "srv-b"), b"{}",
                              ttl_s=30)
            plane.publish_pressure({"level": 0, "pending_items": 4.0})
            sibling = mod.StatePlane(plane.backend, replica_id="srv-b",
                                     namespace=plane.ns)
            sibling.publish_pressure({"level": 2, "pending_items": 9.0})
            status, doc = _get(srv.url + "/metrics/external")
            assert status == 200
            for item in doc["items"]:
                item.pop("timestamp")
            got[pkg] = (sorted(rep), doc)
        # the port's filter form (the reference serves the adapter path)
        status, one = _get(srv.url + "/metrics/external?metric="
                           "llm_queue_pressure")
        assert [i["metricName"] for i in one["items"]] == \
            ["llm_queue_pressure"]
    finally:
        for stop in stops:
            stop()
    assert got["port"] == got["jax"]
    items = got["port"][1]["items"]
    fleet = {i["metricName"]: i["value"] for i in items
             if i["metricLabels"].get("scope") == "fleet"}
    assert fleet == {"llm_degradation_level": "2",
                     "llm_queue_pressure": "9"}
    assert {i["metricLabels"].get("replica") for i in items
            if "replica" in i["metricLabels"]} == {"srv-a", "srv-b"}


def test_debug_stateplane_503_without_plane():
    srv, _, stop = _server("port", False)
    try:
        status, body = _get(srv.url + "/debug/stateplane")
        assert status == 503 and "stateplane" in body["error"]
        status, doc = _get(srv.url + "/metrics/external")
        assert status == 200 and len(doc["items"]) == 2
        assert all(i["metricLabels"] == {"scope": "fleet"}
                   for i in doc["items"])
    finally:
        stop()
