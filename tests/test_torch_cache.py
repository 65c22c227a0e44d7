"""The port's semantic cache and HNSW index (semantic_router_tpu_torch.cache)
on the CPU: the cases of tests/test_cache.py (HNSW recall against brute
force, TTL, fifo/lru/lfu, category threshold, invalidate, brute-force
equivalence), the same graph and answers as the JAX ``HNSWIndex`` for the
same seed and inserts, and the backend factory."""

import hashlib
import time

import numpy as np
import pytest

from semantic_router_tpu.cache import HNSWIndex as JHNSWIndex
from semantic_router_tpu.cache import InMemorySemanticCache as JCache
from semantic_router_tpu_torch.cache import (
    HNSWIndex,
    InMemorySemanticCache,
    build_cache,
)
from semantic_router_tpu_torch.config import SemanticCacheConfig


def toy_embed(dim=32):
    """Deterministic bag-of-words embedding."""

    def fn(text):
        v = np.zeros(dim, np.float32)
        for w in text.lower().split():
            h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
            v[h % dim] += 1.0
        n = np.linalg.norm(v)
        return v / n if n else v

    return fn


def _unit(rng, n, dim):
    data = rng.standard_normal((n, dim)).astype(np.float32)
    return data / np.linalg.norm(data, axis=1, keepdims=True)


class TestHNSW:
    def test_recall_vs_bruteforce(self):
        rng = np.random.default_rng(0)
        data = _unit(rng, 500, 16)
        idx = HNSWIndex(16, m=16, ef_construction=100, ef_search=64)
        for i, v in enumerate(data):
            idx.add(i, v)
        hits = 0
        for q in rng.standard_normal((20, 16)).astype(np.float32):
            true_top = set(np.argsort(-(data @ (q / np.linalg.norm(q))))[:10])
            hits += len({i for i, _ in idx.search(q, k=10)} & true_top)
        assert hits / 200 >= 0.85, f"recall {hits / 200}"

    @pytest.mark.parametrize("seed,m,n", [(0, 16, 300), (7, 4, 200),
                                          (3, 8, 64)])
    def test_same_graph_and_answers_as_jax(self, seed, m, n):
        rng = np.random.default_rng(seed)
        data = _unit(rng, n, 24)
        got = HNSWIndex(24, m=m, ef_construction=60, ef_search=32, seed=seed)
        want = JHNSWIndex(24, m=m, ef_construction=60, ef_search=32,
                          seed=seed)
        for i, v in enumerate(data):
            got.add(1000 + i, v)
            want.add(1000 + i, v)
        for i in range(0, n, 7):
            got.remove(1000 + i)
            want.remove(1000 + i)
        assert got._levels == want._levels
        assert got._links == want._links
        assert (got._entry, got._max_level) == (want._entry, want._max_level)
        for q in rng.standard_normal((15, 24)).astype(np.float32):
            a, b = got.search(q, k=8), want.search(q, k=8)
            assert [i for i, _ in a] == [i for i, _ in b]
            np.testing.assert_allclose([s for _, s in a], [s for _, s in b],
                                       atol=1e-6, rtol=0)

    def test_similarity_ordering(self):
        idx = HNSWIndex(4)
        idx.add(0, [1, 0, 0, 0])
        idx.add(1, [0, 1, 0, 0])
        idx.add(2, [0.9, 0.1, 0, 0])
        res = idx.search([1, 0, 0, 0], k=3)
        assert res[0][0] == 0
        assert res[0][1] == pytest.approx(1.0, abs=1e-5)
        assert res[1][0] == 2

    def test_remove(self):
        idx = HNSWIndex(4)
        for i in range(20):
            v = np.zeros(4)
            v[i % 4] = 1.0
            idx.add(i, v)
        idx.remove(0)
        assert 0 not in {i for i, _ in idx.search([1, 0, 0, 0], k=20)}
        assert len(idx) == 19

    def test_empty_search(self):
        assert HNSWIndex(4).search([1, 0, 0, 0]) == []


class TestSemanticCache:
    def make(self, **kw):
        defaults = dict(similarity_threshold=0.75, max_entries=10,
                        ttl_seconds=60, use_hnsw=True)
        defaults.update(kw)
        return InMemorySemanticCache(toy_embed(), **defaults)

    def test_exact_hit(self):
        c = self.make()
        c.add("what is kubernetes", "k8s is ...", model="m1")
        hit = c.find_similar("what is kubernetes")
        assert hit is not None and hit.response == "k8s is ..."
        assert hit.model == "m1"
        assert c.stats().exact_hits == 1

    def test_similar_hit_and_miss(self):
        c = self.make(similarity_threshold=0.5)
        c.add("how do I reset my password", "click forgot")
        assert c.find_similar("how do I reset my password please") is not None
        assert c.find_similar("completely unrelated quantum physics") is None
        s = c.stats()
        assert s.hits == 1 and s.misses == 1 and s.hit_rate == 0.5

    def test_ttl_expiry(self):
        c = self.make(ttl_seconds=0.05)
        c.add("q", "r")
        assert c.find_similar("q") is not None
        time.sleep(0.08)
        assert c.find_similar("q") is None

    def test_eviction_fifo(self):
        c = self.make(max_entries=3, eviction_policy="fifo",
                      similarity_threshold=0.99)
        for i in range(4):
            c.add(f"query number {i} xyz{i}", f"r{i}")
        assert c.stats().entries == 3 and c.stats().evictions == 1
        assert c.find_similar("query number 0 xyz0") is None
        assert c.find_similar("query number 3 xyz3") is not None

    def test_eviction_lru(self):
        c = self.make(max_entries=3, eviction_policy="lru",
                      similarity_threshold=0.99)
        c.add("aaa unique1", "r0")
        c.add("bbb unique2", "r1")
        c.add("ccc unique3", "r2")
        c.find_similar("aaa unique1")
        c.add("ddd unique4", "r3")  # evicts b (least recently used)
        assert c.find_similar("aaa unique1") is not None
        assert c.find_similar("bbb unique2") is None

    def test_eviction_lfu(self):
        c = self.make(max_entries=3, eviction_policy="lfu",
                      similarity_threshold=0.99)
        c.add("aaa unique1", "r0")
        c.add("bbb unique2", "r1")
        c.add("ccc unique3", "r2")
        for _ in range(3):
            c.find_similar("aaa unique1")
        c.find_similar("bbb unique2")
        c.add("ddd unique4", "r3")  # evicts c (least frequently used)
        assert c.find_similar("ccc unique3") is None
        assert c.find_similar("aaa unique1") is not None

    def test_category_threshold(self):
        c = InMemorySemanticCache(
            toy_embed(), similarity_threshold=0.95,
            category_thresholds={"chat": 0.3}, use_hnsw=False)
        c.add("hello there friend", "hi", category="chat")
        assert c.find_similar("hello there my friend",
                              category="chat") is not None
        assert c.find_similar("hello there my friend") is None

    def test_invalidate_and_clear(self):
        c = self.make()
        c.add("q1 abc", "r")
        c.invalidate("q1 abc")
        assert c.find_similar("q1 abc") is None
        c.add("q2 abc", "r")
        c.clear()
        assert c.stats().entries == 0 and c.find_similar("q2 abc") is None

    def test_readd_replaces(self):
        c = self.make()
        c.add("same query", "old")
        c.add("same query", "new")
        assert c.stats().entries == 1
        assert c.find_similar("same query").response == "new"

    def test_bruteforce_backend_equivalent(self):
        ch = self.make(use_hnsw=True, similarity_threshold=0.5)
        cb = self.make(use_hnsw=False, similarity_threshold=0.5)
        for c in (ch, cb):
            c.add("install the package with pip", "use pip install")
            c.add("configure the network adapter", "use nmcli")
        q = "install that package using pip"
        h1, h2 = ch.find_similar(q), cb.find_similar(q)
        assert h1 is not None and h2 is not None
        assert h1.response == h2.response

    @pytest.mark.parametrize("use_hnsw", [True, False])
    def test_same_answers_as_jax(self, use_hnsw):
        kw = dict(similarity_threshold=0.6, max_entries=8, ttl_seconds=60,
                  use_hnsw=use_hnsw, eviction_policy="lru")
        got, want = InMemorySemanticCache(toy_embed(), **kw), \
            JCache(toy_embed(), **kw)
        words = "alpha beta gamma delta epsilon zeta eta theta".split()
        rng = np.random.default_rng(5)
        for i in range(12):
            q = " ".join(rng.choice(words, 3))
            for c in (got, want):
                c.add(q, f"r{i}")
        for i in range(20):
            q = " ".join(rng.choice(words, 3))
            a, b = got.find_similar(q), want.find_similar(q)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.response == b.response
        sa, sb = got.stats(), want.stats()
        assert (sa.hits, sa.misses, sa.exact_hits, sa.evictions,
                sa.entries) == (sb.hits, sb.misses, sb.exact_hits,
                                sb.evictions, sb.entries)


class TestBuildCache:
    @pytest.mark.parametrize("backend,hnsw", [("memory", False),
                                              ("hnsw", True),
                                              ("hybrid", True)])
    def test_in_process_backends(self, backend, hnsw):
        cfg = SemanticCacheConfig(enabled=True, backend_type=backend,
                                  use_hnsw=False, similarity_threshold=0.7,
                                  max_entries=5, eviction_policy="lfu")
        c = build_cache(cfg, toy_embed())
        assert isinstance(c, InMemorySemanticCache)
        assert (c.use_hnsw, c.similarity_threshold, c.max_entries,
                c.eviction_policy) == (hnsw, 0.7, 5, "lfu")

    def test_disabled_is_none(self):
        assert build_cache(SemanticCacheConfig(), toy_embed()) is None

    @pytest.mark.parametrize("backend", ["redis", "valkey", "qdrant",
                                         "milvus", "nope"])
    def test_other_backends_raise(self, backend):
        cfg = SemanticCacheConfig(enabled=True, backend_type=backend)
        with pytest.raises(ValueError, match="not served by this port"
                           if backend != "nope" else "unsupported"):
            build_cache(cfg, toy_embed())
