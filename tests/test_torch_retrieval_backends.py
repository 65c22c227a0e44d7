"""The port's Qdrant and Milvus backends against the JAX package's, on the
CPU.

Each package's client speaks to the other's embedded server (the port's
``QdrantClient`` / ``MilvusClient`` against the JAX ``MiniQdrant`` /
``MiniMilvus``, the JAX clients against the port's), every wire call
answering alike on both servers; a cache or memory row one package
writes is read by the other.  Every semantic of
``tests/test_ann_backends.py`` holds on the port, against both packages'
servers: cache round trip, TTL, fail-open, memory round trip, auto-store,
cross-user deletes refused, metadata, consolidation, uncategorized
entries matching a categorized lookup, access statistics bumped by a
search, exact hits scoped to a category, and the cache / memory
factories."""

import hashlib
import time

import numpy as np
import pytest

from semantic_router_tpu.cache.ann_cache import \
    MilvusSemanticCache as JMilvusCache, QdrantSemanticCache as JQdrantCache
from semantic_router_tpu.memory.ann_store import \
    QdrantMemoryStore as JQdrantMemory
from semantic_router_tpu.state import milvus as jmilvus
from semantic_router_tpu.state import qdrant as jqdrant
from semantic_router_tpu_torch.cache.ann_cache import (
    MilvusSemanticCache,
    QdrantSemanticCache,
)
from semantic_router_tpu_torch.memory.ann_store import (
    MilvusMemoryStore,
    QdrantMemoryStore,
)
from semantic_router_tpu_torch.state import milvus as tmilvus
from semantic_router_tpu_torch.state import qdrant as tqdrant


def embed(text: str, dim: int = 16) -> np.ndarray:
    h = hashlib.sha256(text.encode()).digest()
    v = np.frombuffer((h * 3)[:dim * 4], dtype=np.uint32).astype(
        np.float32)
    v = v - v.mean()  # zero-mean: unrelated texts cosine near 0
    return v / np.linalg.norm(v)


SERVERS = {"qdrant": {"port": tqdrant.MiniQdrant, "jax": jqdrant.MiniQdrant},
           "milvus": {"port": tmilvus.MiniMilvus, "jax": jmilvus.MiniMilvus}}


@pytest.fixture(params=["port", "jax"])
def qdrant(request):
    s = SERVERS["qdrant"][request.param]()
    yield s
    s.stop()


@pytest.fixture(params=["port", "jax"])
def milvus(request):
    s = SERVERS["milvus"][request.param]()
    yield s
    s.stop()


# -- the wire ----------------------------------------------------------------


def _qdrant_calls(client):
    out = [client.collection_exists("c")]
    client.create_collection("c", 4)
    out.append(client.collection_exists("c"))
    pts = [{"id": f"00000000-0000-0000-0000-00000000000{i}",
            "vector": [1.0, float(i), 0.0, 0.5],
            "payload": {"k": "a" if i % 2 else "b", "i": i}}
           for i in range(6)]
    client.upsert("c", pts)
    out.append(client.search("c", [1.0, 2.0, 0.0, 0.5], limit=3))
    out.append(client.search("c", [1.0, 2.0, 0.0, 0.5], limit=4,
                             query_filter=tqdrant.match_filter("k", "a"),
                             with_vectors=True))
    out.append(client.search("c", [0.0, 0.0, 1.0, 0.0], limit=6,
                             score_threshold=0.1))
    out.append(client.search("c", [1.0, 0.0, 0.0, 0.0], limit=6,
                             query_filter=tqdrant.any_of_filter(
                                 "k", ["a", "zz"])))
    client.set_payload("c", {"seen": 1}, [pts[0]["id"]])
    out.append(sorted(p["id"] for p in client.scroll(
        "c", limit=2, query_filter=tqdrant.match_filter("seen", 1))))
    client.delete_points("c", ids=[pts[1]["id"]])
    client.delete_points("c", query_filter=tqdrant.match_filter("i", 2))
    out.append(sorted(p["payload"]["i"] for p in client.scroll("c")))
    client.delete_collection("c")
    out.append(client.collection_exists("c"))
    return out


def _milvus_calls(client):
    out = [client.has_collection("c")]
    client.create_collection("c", 4)
    out.append(client.has_collection("c"))
    rows = [{"id": f"r{i}", "vector": [1.0, float(i), 0.0, 0.5],
             "k": "a" if i % 2 else "b", "i": str(i)} for i in range(6)]
    client.insert("c", rows)
    out.append(client.search("c", [1.0, 2.0, 0.0, 0.5], limit=3))
    out.append(client.search("c", [1.0, 2.0, 0.0, 0.5], limit=4,
                             flt='k == "a" or k == "zz"',
                             output_fields=["*", "vector"]))
    out.append(client.query("c", flt='k != "a"'))
    client.delete("c", 'i == "3"')
    client.delete("c", 'i == "x\\" or 1 == 1"')  # an injection: no rows
    out.append(sorted(r["i"] for r in client.query("c")))
    client.drop_collection("c")
    out.append(client.has_collection("c"))
    return out


def _round(x):
    if isinstance(x, float):
        return round(x, 5)
    if isinstance(x, list):
        return [_round(v) for v in x]
    if isinstance(x, dict):
        return {k: _round(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("store", ["qdrant", "milvus"])
def test_each_client_speaks_to_each_server(store):
    calls = _qdrant_calls if store == "qdrant" else _milvus_calls
    clients = {"qdrant": (tqdrant.QdrantClient, jqdrant.QdrantClient),
               "milvus": (tmilvus.MilvusClient, jmilvus.MilvusClient)}
    seen = []
    for server in ("port", "jax"):
        for client in clients[store]:
            s = SERVERS[store][server]()
            try:
                seen.append(_round(calls(client(s.url))))
            finally:
                s.stop()
    assert all(x == seen[0] for x in seen[1:])


def test_escape_filter_value_equals_jax():
    for v in ('plain', 'a"b', 'back\\slash', '"; drop', ''):
        assert tmilvus.escape_filter_value(v) \
            == jmilvus.escape_filter_value(v)
    assert tqdrant.match_filter("k", 1) == jqdrant.match_filter("k", 1)
    assert tqdrant.any_of_filter("k", ["a", ""]) \
        == jqdrant.any_of_filter("k", ["a", ""])


@pytest.mark.parametrize("store", ["qdrant", "milvus"])
def test_rows_read_across_packages(store):
    s = SERVERS[store]["port"]()
    try:
        if store == "qdrant":
            t = QdrantSemanticCache(embed, base_url=s.url)
            j = JQdrantCache(embed, base_url=s.url)
        else:
            t = MilvusSemanticCache(embed, base_url=s.url)
            j = JMilvusCache(embed, base_url=s.url)
        t.add("port wrote this", "p", model="m1", category="geo")
        j.add("jax wrote this", "j", model="m2")
        for c in (t, j):
            assert c.find_similar("port wrote this").response == "p"
            assert c.find_similar("jax wrote this",
                                  threshold=0.99).response == "j"
        if store == "qdrant":
            jm = JQdrantMemory(embed, base_url=s.url)
            tm = QdrantMemoryStore(embed, base_url=s.url)
            item = jm.remember("ann", "likes green tea", source="crm")
            got = tm.find_by_id(item.id)
            assert (got.text, got.user_id, got.metadata) == (
                "likes green tea", "ann", {"source": "crm"})
            assert [i.id for i in tm.search("ann", "green tea")] \
                == [i.id for i in jm.search("ann", "green tea")]
    finally:
        s.stop()


# -- test_ann_backends.py's semantics on the port ---------------------------


def _cache_roundtrip(make_cache):
    c = make_cache()
    c.add("what is the capital of France", "Paris", model="m1",
          category="geo")
    hit = c.find_similar("what is the capital of France")
    assert hit is not None and hit.response == "Paris"
    assert c.stats().exact_hits == 1
    hit2 = c.find_similar("what is the capital of France",
                          threshold=0.99)
    assert hit2 is not None
    assert c.find_similar("completely unrelated query xyz",
                          threshold=0.99) is None
    c.invalidate("what is the capital of France")
    assert c.find_similar("what is the capital of France",
                          threshold=0.99) is None
    c.add("durable question", "durable answer")
    c2 = make_cache()
    hit3 = c2.find_similar("durable question")
    assert hit3 is not None and hit3.response == "durable answer"


def test_qdrant_cache_roundtrip(qdrant):
    _cache_roundtrip(lambda: QdrantSemanticCache(
        embed, base_url=qdrant.url, similarity_threshold=0.8))


def test_milvus_cache_roundtrip(milvus):
    _cache_roundtrip(lambda: MilvusSemanticCache(
        embed, base_url=milvus.url, similarity_threshold=0.8))


def test_qdrant_cache_ttl_expiry(qdrant):
    c = QdrantSemanticCache(embed, base_url=qdrant.url,
                            ttl_seconds=0.0001)
    c.add("old query", "old answer")
    time.sleep(0.01)
    assert c.find_similar("old query") is None


@pytest.mark.parametrize("cls", [QdrantSemanticCache, MilvusSemanticCache])
def test_cache_fails_open_when_down(cls):
    c = cls(embed, base_url="http://127.0.0.1:9", timeout_s=0.5)
    c.add("q", "r")  # swallowed
    assert c.find_similar("q") is None
    assert c.stats().errors >= 1


def _memory_roundtrip(make_store):
    s = make_store()
    item = s.remember("alice", "my email is bob@example.com and I "
                               "work at Initech")
    assert "<EMAIL>" in s.find_by_id(item.id).text
    s.remember("alice", "prefers tabs over spaces")
    s.remember("carol", "lives in Lyon")
    assert len(s.list("alice")) == 2
    assert len(s.list("carol")) == 1
    hits = s.search("alice", "tabs or spaces preference", limit=3)
    assert hits and "tabs" in hits[0].text
    s.remember("alice", "prefers tabs over spaces")
    assert len(s.list("alice")) == 2
    assert s.delete("alice", item.id) is True
    assert s.find_by_id(item.id) is None
    assert s.delete("alice", "nonexistent") is False
    s2 = make_store()
    assert len(s2.list("alice")) == 1


def test_qdrant_memory_roundtrip(qdrant):
    _memory_roundtrip(lambda: QdrantMemoryStore(embed, base_url=qdrant.url))


def test_milvus_memory_roundtrip(milvus):
    _memory_roundtrip(lambda: MilvusMemoryStore(embed, base_url=milvus.url))


def test_qdrant_memory_auto_store(qdrant):
    s = QdrantMemoryStore(embed, base_url=qdrant.url)
    n = s.auto_store("dave", [
        {"role": "user", "content": "my name is Dave and I live in Lisbon"},
        {"role": "assistant", "content": "Hi Dave!"}])
    assert n >= 1
    assert any("Lisbon" in i.text for i in s.list("dave"))


def test_cross_user_delete_rejected(qdrant):
    s = QdrantMemoryStore(embed, base_url=qdrant.url)
    item = s.remember("alice", "private fact about alice")
    assert s.delete("mallory", item.id) is False
    assert s.find_by_id(item.id) is not None
    assert s.delete("alice", item.id) is True


def test_metadata_round_trip(qdrant, milvus):
    for store in (QdrantMemoryStore(embed, base_url=qdrant.url),
                  MilvusMemoryStore(embed, base_url=milvus.url)):
        item = store.remember("u", "fact with provenance",
                              source="crm", priority="high")
        got = store.find_by_id(item.id)
        assert got.metadata == {"source": "crm", "priority": "high"}


def test_consolidation_refreshes_access_stats(qdrant):
    s = QdrantMemoryStore(embed, base_url=qdrant.url)
    s.remember("u", "prefers dark mode")
    before = s.list("u")[0]
    s.remember("u", "prefers dark mode")
    after = s.list("u")
    assert len(after) == 1
    assert after[0].access_count == before.access_count + 1


def test_uncategorized_entries_match_categorized_lookup(qdrant, milvus):
    for c in (QdrantSemanticCache(embed, base_url=qdrant.url),
              MilvusSemanticCache(embed, base_url=milvus.url)):
        c.add("plain question", "plain answer")
        assert c.find_similar("plain question", category="math") \
            is not None, type(c).__name__


def test_search_bumps_access_stats(qdrant):
    s = QdrantMemoryStore(embed, base_url=qdrant.url)
    s.remember("u", "enjoys cycling on weekends")
    hits = s.search("u", "cycling weekends hobby")
    assert hits and hits[0].access_count == 1
    assert s.list("u")[0].access_count == 1


def test_exact_hit_category_scoped(qdrant):
    c = QdrantSemanticCache(embed, base_url=qdrant.url)
    c.add("integrate x squared", "x^3/3", category="math")
    assert c.find_similar("integrate x squared", category="code",
                          threshold=1.01) is None
    assert c.find_similar("integrate x squared",
                          category="math") is not None
    assert c.find_similar("integrate x squared") is not None


def test_cache_factory_builds_ann_backends(qdrant, milvus):
    from semantic_router_tpu_torch.cache.semantic_cache import build_cache
    from semantic_router_tpu_torch.config.schema import SemanticCacheConfig

    q = build_cache(SemanticCacheConfig.from_dict({
        "enabled": True, "backend_type": "qdrant",
        "backend_config": {"base_url": qdrant.url}}), embed)
    assert isinstance(q, QdrantSemanticCache)
    m = build_cache(SemanticCacheConfig.from_dict({
        "enabled": True, "backend_type": "milvus",
        "backend_config": {"base_url": milvus.url}}), embed)
    assert isinstance(m, MilvusSemanticCache)


@pytest.mark.parametrize("backend", ["qdrant", "milvus"])
def test_memory_factory_builds_ann_store(backend, fixture_config_path):
    from semantic_router_tpu_torch.config import load_config
    from semantic_router_tpu_torch.engine.testing import \
        make_embedding_engine
    from semantic_router_tpu_torch.runtime import RuntimeRegistry, \
        build_router

    s = SERVERS[backend]["port"]()
    engine = make_embedding_engine(device="cpu")
    try:
        cfg = load_config(fixture_config_path)
        cfg.memory = {"backend": backend, "base_url": s.url}
        router = build_router(cfg, engine,
                              registry=RuntimeRegistry.isolated(
                                  runtimestats=None))
        want = QdrantMemoryStore if backend == "qdrant" \
            else MilvusMemoryStore
        assert isinstance(router.memory_store, want)
        router.memory_store.remember("u1", "likes espresso")
        assert router.memory_store.search("u1", "espresso coffee")
        router.shutdown()
        # no embedding task: the in-process store, stamped
        bare = build_router(cfg, None, registry=RuntimeRegistry.isolated(
            runtimestats=None))
        assert type(bare.memory_store).__name__ == "InMemoryMemoryStore"
        bare.shutdown()
    finally:
        engine.shutdown()
        s.stop()
