"""The port's ANN plane against the JAX package's, on the CPU.

The same rows through ``DeviceBank`` / ``AnnIndex`` of both packages (add,
delete, compact, tier growth) give the same top-k ids at f32 (scores
within 1e-5), at bf16 and int8 (the same ids where no near tie exists,
scores within 1e-5 of the JAX program's: the products are exact); equal
scores rank the lower slot first, also across the k-th place;
``measure_recall`` gives the JAX value; ``TierPolicy`` promotes, evicts
and compacts alike under the same hits; ``AnnSearcher`` batched and
unbatched give the JAX hits; ``VersionedRowSync`` converges a port index
on the rows a JAX ``SharedSemanticCache`` wrote over one ``MiniRedis``;
the port cache's ANN handoff (``attach_ann`` / ``similarity_owner`` /
fallback to the local cache); ``AnnPlane`` isolates a failing index and
stamps the reference's ``llm_ann_*`` series; the knobs normalize alike;
``apply_ann_knobs`` attaches, reconfigures and detaches.  Every plane is
closed."""

import threading
import time

import numpy as np
import pytest
import torch

from semantic_router_tpu import ann as jann
from semantic_router_tpu import stateplane as jsp
from semantic_router_tpu.observability.metrics import \
    MetricsRegistry as JMetricsRegistry
from semantic_router_tpu_torch import ann as tann
from semantic_router_tpu_torch import stateplane as tsp
from semantic_router_tpu_torch.ann import search as tsearch
from semantic_router_tpu_torch.observability.metrics import MetricsRegistry
from semantic_router_tpu_torch.state.resp import MiniRedis
from semantic_router_tpu_torch.stateplane.cache import _qhash
from semantic_router_tpu_torch.stateplane.vectorstore import \
    SharedVectorStore
from semantic_router_tpu_torch.stateplane.harness import hash_embed

EMBED = hash_embed()

DIM = 32
SCORE_TOL = 1e-5
TIE_GAP = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _knobs(**over):
    d = {"enabled": True, "min_capacity": 16, "max_capacity": 1024,
         "recall_floor": 0.0}
    d.update(over)
    return d


def _pair(mode="f32", **over):
    k = _knobs(quant=mode, **over)
    j = jann.AnnIndex("t", jann.normalize_ann(k), jann.TopKPrograms())
    t = tann.AnnIndex("t", tann.normalize_ann(k), tann.TopKPrograms(),
                      device="cpu")
    return j, t


def _clustered(n, dim=DIM, seed=3, clusters=12):
    """Unit rows in near-duplicate clusters (the cache's geometry)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, dim)).astype(np.float32)
    rows = centers[rng.integers(0, clusters, n)] \
        + 0.08 * rng.standard_normal((n, dim)).astype(np.float32)
    return tann.normalize_rows(rows)


def _same_hits(jhits, thits, exact):
    """The same ids (ids swapped inside a near tie allowed when not
    ``exact``) and scores within SCORE_TOL."""
    (jids, js), (tids, ts) = jhits, thits
    assert len(jids) == len(tids)
    np.testing.assert_allclose(ts, js, atol=SCORE_TOL)
    for i, (a, b) in enumerate(zip(jids, tids)):
        if a == b:
            continue
        assert not exact, (i, jids, tids)
        # a swap is allowed only between scores closer than TIE_GAP
        assert b in jids and abs(js[jids.index(b)] - js[i]) < TIE_GAP, \
            (i, jids, tids, js)


def _drive(j, t, rows):
    """The same mutation sequence on both indexes: bulk adds, a flush
    (publish), adds past the first tier, deletes, compaction, flush."""
    for idx in (j, t):
        for i in range(40):
            idx.add(f"e{i}", rows[i])
        idx.flush()
        for i in range(40, len(rows)):
            idx.add(f"e{i}", rows[i])
        for i in range(0, len(rows), 7):
            idx.delete(f"e{i}")
        idx.flush()
        idx.bank.compact()
        idx.bank.publish()


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_index_lookups_match_jax(mode):
    rows = _clustered(300)
    j, t = _pair(mode)
    try:
        _drive(j, t, rows)
        assert j.bank.report() == t.bank.report()
        assert sorted(j.ids()) == sorted(t.ids())
        queries = _clustered(24, seed=9)
        for q in queries:
            _same_hits(j.lookup(q, k=8), t.lookup(q, k=8),
                       exact=(mode == "f32"))
    finally:
        j.close()
        t.close()


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_program_scores_match_jax(mode):
    """The top-k step alone on one view's rows: slots equal where no
    near tie exists, scores within 1e-5, at every padded q_rows."""
    rows = _clustered(200, seed=4)
    jb = jann.DeviceBank(dim=DIM, min_capacity=16, mode=mode,
                         recall_floor=0.0)
    tb = tann.DeviceBank(dim=DIM, min_capacity=16, mode=mode,
                         recall_floor=0.0, device="cpu")
    ids = [f"r{i}" for i in range(len(rows))]
    jb.extend(ids, rows)
    tb.extend(ids, rows)
    jv, tv = jb.publish(), tb.publish()
    assert (jv.tier, jv.mode, jv.n_valid) == (tv.tier, tv.mode, tv.n_valid)
    assert tv.recall == jv.recall
    jp, tp = jann.TopKPrograms(), tann.TopKPrograms()
    for nq in (1, 3, 16, 64):
        q = _clustered(nq, seed=10 + nq)
        js, ji = jp.run(jv, q, 8)
        ts, ti = tp.run(tv, q, 8)
        assert ts.dtype == np.float32
        np.testing.assert_allclose(ts, js, atol=SCORE_TOL)
        gaps = np.abs(np.diff(js, axis=1)) < TIE_GAP
        near = np.zeros_like(ji, bool)
        near[:, 1:] |= gaps
        near[:, :-1] |= gaps
        assert (ti[~near] == ji[~near]).all()


def test_duplicate_rows_rank_the_lower_slot_first():
    """Exact duplicates (one prompt cached in several slots) tie; the
    lower slot ranks first, and a tie across the k-th place keeps the
    lower slots, as ``lax.top_k`` does."""
    base = _clustered(40, seed=5)
    rows = np.concatenate([base[:10], np.repeat(base[10:11], 6, axis=0),
                           base[11:]])
    j, t = _pair()
    try:
        for idx in (j, t):
            for i, r in enumerate(rows):
                idx.add(f"d{i:02d}", r)
            idx.flush()
        q = base[10]
        dups = {f"d{i:02d}" for i in range(10, 16)}
        dup_slots = sorted(t.bank._id2slot[i] for i in dups)
        for k in (2, 4, 6, 8):
            jh, th = j.lookup(q, k=k), t.lookup(q, k=k)
            assert th[0] == jh[0]
            m = min(k, 6)
            assert set(th[0][:m]) <= dups
            assert [t.bank._id2slot[i] for i in th[0][:m]] == dup_slots[:m]
    finally:
        j.close()
        t.close()
    # straight at the helper: ties straddling the k-th place
    scores = torch.tensor([[0.5, 0.9, 0.9, 0.1, 0.9, 0.9, -np.inf],
                           [0.3, 0.2, 0.9, 0.8, 0.7, 0.1, 0.0]])
    vals, idx, straddle = tsearch.topk_candidates(scores, 3)
    assert straddle.tolist() == [True, False]
    assert idx[1].tolist() == [2, 3, 4]
    vals, idx = tsearch.reselect_ties(scores, vals, idx, [0])
    assert idx.tolist() == [[1, 2, 4], [2, 3, 4]]
    assert vals[0].tolist() == [pytest.approx(0.9)] * 3


def test_fewer_live_rows_than_k_return_fewer_hits_never_a_tombstone():
    rows = _clustered(12, seed=6)
    j, t = _pair()
    try:
        for idx in (j, t):
            for i, r in enumerate(rows):
                idx.add(f"f{i}", r)
            idx.flush()
            for i in range(0, 12, 2):
                idx.delete(f"f{i}")
            idx.bank.publish()
        jh, th = j.lookup(rows[1], k=8), t.lookup(rows[1], k=8)
        assert th == jh or (th[0] == jh[0])
        assert len(th[0]) == 6
        assert not {f"f{i}" for i in range(0, 12, 2)} & set(th[0])
    finally:
        j.close()
        t.close()


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("seed", [0, 3])
def test_measure_recall_equals_jax(mode, seed):
    bank = _clustered(500, seed=seed + 20)
    want = jann.measure_recall(bank, mode, n_queries=32, seed=seed)
    got = tann.measure_recall(bank, mode, n_queries=32, seed=seed)
    assert got == want


def test_bad_geometry_falls_back_to_f32_and_stamps():
    rows = _clustered(100, seed=8)
    j, t = _pair("int8", recall_floor=1.0)
    try:
        for idx in (j, t):
            for i, r in enumerate(rows):
                idx.add(f"g{i}", r)
            idx.flush()
        jr, tr = j.bank.report(), t.bank.report()
        assert tr == jr
        if jr["recall"] < 1.0:
            assert tr["quant_fallback"] and tr["view_mode"] == "f32"
    finally:
        j.close()
        t.close()


def test_int8_view_quantizes_like_the_reference():
    """The per-row scale and the int8 rows placed on the device equal the
    reference's host quantization (round half to even)."""
    rows = _clustered(64, seed=12)
    rows[3] = 0.0  # an all-zero row: scale clamps at 1e-12
    view = tann.bank.place_view(rows, np.ones(64, bool), tuple(range(64)),
                                64, "int8", torch.device("cpu"))
    absmax = np.max(np.abs(rows), axis=1)
    scale = np.maximum(absmax / 127.0, 1e-12)
    q = np.clip(np.round(rows / scale[:, None]), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(view.scale.numpy(), scale)
    np.testing.assert_array_equal(view.qbank.numpy(), q.T)


def test_tier_policy_matches_jax():
    """The same hits and cycles: the same promotions (hottest first past
    the floor), evictions (coldest past the watermark at the max tier)
    and compactions, and the same resident sets."""
    rows = _clustered(80, seed=13)
    kw = dict(promote_ewma=0.5, promote_min_hits=0.3,
              evict_watermark=0.5, tombstone_ratio=0.2)
    sides = []
    for mod, dev in ((jann, {}), (tann, {"device": "cpu"})):
        bank = mod.DeviceBank(dim=DIM, min_capacity=16, max_capacity=32,
                              **dev)
        host = mod.HostTier()
        sides.append((bank, host, mod.TierPolicy(bank, host, **kw)))
    rng = np.random.default_rng(1)
    log = [[], []]
    for cycle in range(8):
        hits = [f"h{i}" for i in rng.integers(0, 80, 40)]
        for s, (bank, host, pol) in enumerate(sides):
            if cycle == 0:
                for i, r in enumerate(rows):
                    host.add(f"h{i}", r)
            if cycle == 5:
                for i in range(0, 80, 3):
                    host.delete(f"h{i}")
                    bank.delete(f"h{i}")
                    pol.forget(f"h{i}")
            pol.mark_hits(hits)
            log[s].append((pol.run_cycle(), sorted(bank.entry_ids()),
                           sorted(host.ids())))
    assert log[1] == log[0]
    for what in ("promoted", "evicted", "compacted"):
        assert any(c[what] for c, _, _ in log[0]), what


def test_host_scan_matches_jax():
    rows = _clustered(50, seed=14)
    jh, th = jann.HostTier(), tann.HostTier()
    for i, r in enumerate(rows):
        jh.add(f"s{i}", r)
        th.add(f"s{i}", r)
    for q in _clustered(5, seed=15):
        assert th.scan(q, 6)[0] == jh.scan(q, 6)[0]


def test_batched_and_unbatched_searchers_give_the_jax_hits():
    rows = _clustered(120, seed=16)
    j, t = _pair()
    tb = tann.AnnIndex("tb", tann.normalize_ann(_knobs(batch={
        "enabled": True, "max_batch": 8, "max_wait_ms": 5.0})),
        tann.TopKPrograms(), device="cpu")
    try:
        for idx in (j, t, tb):
            for i, r in enumerate(rows):
                idx.add(f"b{i}", r)
            idx.flush()
        queries = _clustered(16, seed=17)
        out = [None] * len(queries)

        def probe(i):
            out[i] = tb.searcher.search(queries[i], 8)

        threads = [threading.Thread(target=probe, args=(i,))
                   for i in range(len(queries))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(10)
        for i, q in enumerate(queries):
            want = j.searcher.search(q, 8)
            _same_hits(want, t.searcher.search(q, 8), exact=True)
            _same_hits(want, out[i], exact=True)
    finally:
        for idx in (j, t, tb):
            idx.close()


def test_program_keys_are_closed_and_registered():
    """Query rows and k pad to pow2 (capped at the tier and at 64 rows):
    one program per (tier, q_rows, k, mode), each noted with the catalog
    under group ``ann`` and each step recorded."""
    notes, steps = [], []

    class Catalog:
        def note_compile(self, *a, **kw):
            notes.append(a[:3])

    class Stats:
        def record_step(self, *a, **kw):
            steps.append((a, kw))

    rows = _clustered(64, seed=18)
    bank = tann.DeviceBank(dim=DIM, min_capacity=16, device="cpu")
    bank.extend([f"p{i}" for i in range(40)], rows[:40])
    view = bank.publish()
    progs = tann.TopKPrograms(catalog=Catalog(), runtime_stats=Stats())
    for nq, k in ((1, 3), (2, 4), (3, 5), (17, 8), (64, 100), (4, 7)):
        s, i = progs.run(view, rows[:nq], k)
        assert s.shape == (nq, min(k, view.tier))
    assert notes == [("ann", 64, "topk:q1:k4:f32"),
                     ("ann", 64, "topk:q2:k4:f32"),
                     ("ann", 64, "topk:q4:k8:f32"),
                     ("ann", 64, "topk:q32:k8:f32"),
                     ("ann", 64, "topk:q64:k64:f32")]
    assert [kw["compiled"] for _, kw in steps] == [True] * 5 + [False]
    assert steps[3][1]["padded_rows"] == 32


def test_a_lookup_keeps_its_view_across_a_publish():
    """A view taken before a publish keeps answering on its own tensors:
    publish never writes into a tensor a published view holds."""
    rows = _clustered(64, seed=19)
    bank = tann.DeviceBank(dim=DIM, min_capacity=16, device="cpu")
    bank.extend([f"v{i}" for i in range(32)], rows[:32])
    old = bank.publish()
    before = old.bank_t.clone()
    bank.extend([f"v{i}" for i in range(32, 64)], rows[32:])
    new = bank.publish()
    assert new is not old and new.tier == 64 and old.tier == 32
    assert torch.equal(old.bank_t, before)
    s, i = tann.TopKPrograms().run(old, rows[40:41], 4)
    assert (i < 32).all()


def test_knobs_normalize_like_jax():
    for raw in ({}, {"enabled": True}, {"quant": "INT8", "top_k": 0},
                {"min_capacity": 100, "max_capacity": 20,
                 "recall_floor": 7, "batch": {"enabled": True}},
                {"mesh": {"enabled": True, "tp": "x"}, "share": {
                    "cache": False}}):
        assert tann.normalize_ann(raw) == jann.normalize_ann(raw)


def test_plane_isolates_a_failing_index_and_stamps_the_series():
    reg = MetricsRegistry()
    plane = tann.AnnPlane(reg, device="cpu")
    try:
        plane.configure(tann.normalize_ann(_knobs(compact_interval_s=3600)))
        good, bad = plane.index("good"), plane.index("bad")
        rows = _clustered(20, seed=21)
        for i, r in enumerate(rows):
            good.add(f"g{i}", r)
        bad.maintain = lambda: (_ for _ in ()).throw(RuntimeError("boom"))
        out = plane.maintain_once()
        assert out["bad"] == {"failed": 1}
        assert out["good"]["published"] == 1
        assert good.lookup(rows[2], k=1)[0] == ["g2"]
        text = reg.expose()
        for name in ("llm_ann_bank_fill", "llm_ann_host_entries",
                     "llm_ann_lookups_total",
                     "llm_ann_maintenance_failures_total",
                     "llm_ann_local_fallback"):
            assert name in text, name
        assert 'llm_ann_maintenance_failures_total{index="bad"} 1' in text
        assert plane.report()["device"] == "cpu"
        with pytest.raises(ValueError, match="ann.mesh"):
            plane.configure(tann.normalize_ann(_knobs(
                mesh={"enabled": True})))
    finally:
        plane.close()
    jreg = JMetricsRegistry()
    jplane = jann.AnnPlane(jreg)
    jplane.close()
    names = {l.split()[2] for l in jreg.expose().splitlines()
             if l.startswith("# TYPE")}
    tnames = {l.split()[2] for l in reg.expose().splitlines()
              if l.startswith("# TYPE")}
    assert {n for n in names if n.startswith("llm_ann_")} \
        == {n for n in tnames if n.startswith("llm_ann_")}


# -- the state plane --------------------------------------------------------


@pytest.fixture()
def mini():
    srv = MiniRedis().start()
    yield srv
    srv.stop()


def _resp(mod, port, cooldown_s=0.2):
    return mod.GuardedBackend(mod.RespStateBackend(port=port),
                              cooldown_s=cooldown_s)


def test_row_sync_converges_on_rows_a_jax_cache_wrote(mini):
    jplane = jsp.StatePlane(_resp(jsp, mini.port), replica_id="j",
                            namespace="annx")
    tplane = tsp.StatePlane(_resp(tsp, mini.port), replica_id="t",
                            namespace="annx")
    jcache = jsp.SharedSemanticCache(jplane, EMBED)
    idx = tann.AnnIndex("cache", tann.normalize_ann(_knobs()),
                        tann.TopKPrograms(), device="cpu")
    sync = tann.cache_index_sync(tplane, idx, interval_s=0.05)
    try:
        prompts = [f"how do I cook pasta number {i}" for i in range(12)]
        for p in prompts:
            jcache.add(p, f"answer {p}", model="m")
        assert sync.sync_once()
        assert len(idx) == 12
        idx.flush()
        ids, scores = idx.lookup(EMBED(prompts[3]), k=1)
        assert scores[0] == pytest.approx(1.0, abs=1e-5)
        assert ids == [_qhash(prompts[3])]
        jcache.invalidate(prompts[0])
        assert sync.sync_once()
        assert len(idx) == 11
        assert not sync.sync_once()  # no sibling wrote: one GET, no scan
        # the port cache on the same rows, ANN-owned, finds the JAX rows
        tcache = tsp.SharedSemanticCache(tplane, EMBED)
        tcache.attach_ann(idx)
        assert tcache.similarity_owner() == "ann"
        hit = tcache.find_similar(prompts[5] + " please")
        assert hit is not None and hit.query == prompts[5]
    finally:
        sync.close()
        idx.close()
        jplane.close()
        tplane.close()


def test_plane_death_fails_open_to_local_only(mini):
    plane = tsp.StatePlane(_resp(tsp, mini.port), replica_id="d",
                           namespace="annd")
    idx = tann.AnnIndex("cache", tann.normalize_ann(_knobs()),
                        tann.TopKPrograms(), device="cpu")
    sync = tann.cache_index_sync(plane, idx, interval_s=0.05)
    cache = tsp.SharedSemanticCache(plane, EMBED)
    cache.attach_ann(idx)
    try:
        cache.add("what is the capital of france", "paris")
        sync.sync_once()
        idx.flush()
        port = mini.port
        mini.stop()
        assert not sync.sync_once()
        assert sync.local_only
        assert sync.report()["local_only"]
        # lookups keep answering (the store is gone: a miss, never a raise)
        cache.find_similar("what is the capital of france today")
        restarted = MiniRedis(port=port).start()
        try:
            deadline = time.time() + 5
            while time.time() < deadline:
                sync.mark_stale()
                sync.sync_once(force=True)
                if not sync.local_only:
                    break
                time.sleep(0.1)
            assert not sync.local_only
        finally:
            restarted.stop()
    finally:
        sync.close()
        idx.close()
        plane.close()


class _Broken:
    def lookup(self, *a, **kw):
        raise RuntimeError("device lost")

    def add(self, *a, **kw):
        pass

    def delete(self, *a, **kw):
        pass

    def ids(self):
        return []

    def __len__(self):
        return 0


def test_cache_handoff_gates_the_mirror_and_falls_back_on_failure():
    for mod in (jsp, tsp):
        plane = mod.StatePlane(mod.build_backend({"backend": "memory"}),
                               replica_id="h", namespace="annh")
        local = []

        class Local:
            def find_similar(self, query, threshold=None, category=""):
                local.append(query)
                return None

            def add(self, *a, **kw):
                pass

        cache = mod.SharedSemanticCache(plane, EMBED, local=Local())
        cache.add("alpha beta gamma", "r1")
        assert cache.similarity_owner() == "mirror"
        cache.attach_ann(_Broken())
        assert cache.similarity_owner() == "ann"
        assert cache._matrix is None  # the mirror is gated off
        # exact hits bypass the bank
        assert cache.find_similar("alpha beta gamma").response == "r1"
        assert cache.find_similar("alpha beta delta") is None
        assert local == ["alpha beta delta"]
        assert cache.stats().errors == 1
        cache.detach_ann()
        assert cache.similarity_owner() == "mirror"
        plane.close()


def test_apply_ann_knobs_attaches_reconfigures_and_detaches():
    from semantic_router_tpu_torch.config import load_config
    from semantic_router_tpu_torch.engine.testing import \
        make_shared_trunk_engine
    from semantic_router_tpu_torch.runtime import RuntimeRegistry, \
        apply_ann_knobs, build_router

    eng = make_shared_trunk_engine(device="cpu")
    reg = RuntimeRegistry.isolated(runtimestats=None)
    try:
        off = load_config({"ann": {"enabled": False}})
        router = build_router(off, eng, registry=reg)
        assert reg.get("ann") is None and router.vectorstores.ann is None
        on = load_config({"ann": {"enabled": True, "quant": "bf16"},
                          "vectorstore": {"backend": "ann"}})
        apply_ann_knobs(on, reg, router)
        plane = reg.get("ann")
        assert plane is not None and plane.device == torch.device("cpu")
        assert router.vectorstores.ann is plane
        apply_ann_knobs(load_config({"ann": {"enabled": True,
                                             "quant": "int8"}}),
                        reg, router)
        assert reg.get("ann") is plane and plane.knobs["quant"] == "int8"
        apply_ann_knobs(off, reg, router)
        assert reg.get("ann") is None and router.vectorstores.ann is None
        assert not any(t.name == "ann-maintain" and t.is_alive()
                       for t in threading.enumerate())
        router.shutdown()
    finally:
        eng.shutdown()


def test_top_sets_equal_the_full_sort_with_ties():
    """The recall gate's top-k sets: a partition, and the full sort for a
    row whose k-th score is tied, select exactly what ``np.argsort``
    selects."""
    rng = np.random.default_rng(4)
    scores = rng.standard_normal((32, 500)).astype(np.float32)
    scores[::3, 40:60] = scores[::3, 7:8]  # ties across the 10th place
    got = tann.bank._top_sets(scores, 10)
    want = np.argsort(-scores, axis=1)[:, :10]
    assert [set(r) for r in got] == [set(r) for r in want]


def test_bootstrap_shares_the_cache_and_the_stores_over_the_plane(mini):
    """Two routers over one store with the ANN plane on: the shared
    cache's similarity is the plane's ``cache`` index bound to the state
    plane's rows, and ``vectorstore.backend: memory`` rides the plane
    (``SharedVectorStore``) under ``share.vectorstore``."""
    from semantic_router_tpu_torch.config import load_config
    from semantic_router_tpu_torch.engine.testing import \
        make_embedding_engine
    from semantic_router_tpu_torch.runtime import RuntimeRegistry, \
        build_router, close_ann, close_stateplane

    def cfg(rid, share_vs=True):
        return load_config({
            "semantic_cache": {"enabled": True, "backend_type": "memory",
                               "use_hnsw": False,
                               "similarity_threshold": 0.5},
            "stateplane": {"enabled": True, "backend": "resp",
                           "backend_config": {"host": "127.0.0.1",
                                              "port": mini.port},
                           "replica_id": rid, "namespace": "annboot",
                           "share": {"vectorstore": share_vs}},
            "ann": {"enabled": True, "compact_interval_s": 3600}})

    eng = make_embedding_engine(device="cpu")
    regs = [RuntimeRegistry.isolated(runtimestats=None) for _ in range(3)]
    routers = []
    try:
        routers = [build_router(cfg(rid, share), eng, registry=reg)
                   for rid, share, reg in (("a", True, regs[0]),
                                           ("b", True, regs[1]),
                                           ("c", False, regs[2]))]
        a, b, c = routers
        assert a.cache.similarity_owner() == "ann"
        idx_b = regs[1].get("ann").index("cache")
        assert idx_b.sync is not None and idx_b.sync.plane is b.stateplane
        a.cache.add("where is the train station", "two blocks north")
        idx_b.sync.sync_once()
        idx_b.flush()
        hit = b.cache.find_similar("where is the train station please")
        assert hit is not None and hit.response == "two blocks north"
        assert a.vectorstores.backend == "stateplane"
        assert c.vectorstores.backend == "memory"
        a.vectorstores.create("kb").ingest("d", "Trains leave hourly.")
        assert isinstance(b.vectorstores.get("kb"), SharedVectorStore)
    finally:
        for r, reg in zip(routers, regs):
            r.shutdown()
            close_ann(reg)
            close_stateplane(reg)
        eng.shutdown()
