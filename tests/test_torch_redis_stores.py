"""The port's RESP-backed stores against the JAX package's on one
``MiniRedis``: the semantic cache (``RedisSemanticCache``), the Responses
API store (``RedisResponseStore``, on one server and on a cluster) and the
workflow state store (``RedisWorkflowStateStore``).  What one package
writes the other reads; hits, misses and similarities are equal within
1e-6 over ``hash_embed``; the factories pick the same backends."""

import time

import numpy as np
import pytest
import torch

from semantic_router_tpu.cache import redis_cache as jrc
from semantic_router_tpu.cache.semantic_cache import \
    build_cache as jbuild_cache
from semantic_router_tpu.config.schema import \
    SemanticCacheConfig as JCacheConfig
from semantic_router_tpu.looper import workflows as jw
from semantic_router_tpu.router import responseapi as jr
from semantic_router_tpu.state.rediscluster import \
    MiniRedisClusterNode as JClusterNode
from semantic_router_tpu.stateplane.harness import hash_embed as jhash_embed
from semantic_router_tpu_torch.cache import redis_cache as trc
from semantic_router_tpu_torch.cache.semantic_cache import build_cache
from semantic_router_tpu_torch.config.schema import SemanticCacheConfig
from semantic_router_tpu_torch.looper import workflows as tw
from semantic_router_tpu_torch.router import responseapi as tr
from semantic_router_tpu_torch.state.resp import MiniRedis, RedisClient
from semantic_router_tpu_torch.stateplane.harness import hash_embed

QUERIES = ["how do I sort a list in python", "what is the capital of france",
           "explain the liability clause of this contract",
           "how do I rotate the api credentials",
           "which model serves legal questions"]
PROBES = QUERIES + ["how do I sort a list in python?",
                    "what is the capital of spain",
                    "explain the liability clause in this contract",
                    "an unrelated question about cooking pasta"]


@pytest.fixture(scope="module")
def mini():
    server = MiniRedis().start()
    yield server
    server.stop()


def _pair(mini, prefix, writer):
    """(writer, reader) caches of the two packages over one prefix."""
    mk = {"port": lambda: trc.RedisSemanticCache(
              hash_embed(), port=mini.port, key_prefix=prefix,
              similarity_threshold=0.8, ttl_seconds=300),
          "jax": lambda: jrc.RedisSemanticCache(
              jhash_embed(), port=mini.port, key_prefix=prefix,
              similarity_threshold=0.8, ttl_seconds=300)}
    w = mk[writer]()
    w.clear()
    return w, mk["jax" if writer == "port" else "port"]


def test_hash_embed_equal():
    t, j = hash_embed(), jhash_embed()
    for q in PROBES:
        assert np.array_equal(t(q), j(q))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_entries_read_across_packages(mini, writer):
    w, make_reader = _pair(mini, f"x{writer}:cache", writer)
    for i, q in enumerate(QUERIES):
        w.add(q, f"answer {i}", model=f"m{i}", category="c")
    reader = make_reader()  # rebuilds its mirror by SCAN
    assert reader.stats().entries == len(QUERIES)
    for q in PROBES:
        a, b = w.find_similar(q), reader.find_similar(q)
        assert (a is None) == (b is None), q
        if a is not None:
            assert (a.query, a.response, a.model, a.category) == \
                (b.query, b.response, b.model, b.category)
            np.testing.assert_allclose(a.embedding, b.embedding, atol=1e-6)
    ws, rs = w.stats(), reader.stats()
    assert (ws.hits, ws.misses) == (rs.hits, rs.misses)
    assert rs.hits >= len(QUERIES) and rs.misses >= 1


def test_stored_bytes_equal(mini):
    """The same add through either package stores the same fields and the
    same little-endian float32 embedding bytes."""
    cli = RedisClient(port=mini.port)
    rows = {}
    for name, mod, emb in (("port", trc, hash_embed()),
                           ("jax", jrc, jhash_embed())):
        c = mod.RedisSemanticCache(emb, port=mini.port,
                                   key_prefix=f"b{name}:cache")
        c.clear()
        c.add(QUERIES[2], "resp", model="m", category="law")
        (key,) = list(cli.scan_iter(f"b{name}:cache:entry:*"))
        h = cli.hgetall(key.decode())
        h.pop(b"created")
        rows[name] = h
    assert rows["port"] == rows["jax"]
    assert rows["port"][b"emb"] == \
        (jhash_embed()(QUERIES[2]).astype("<f4")).tobytes()
    cli.close()


def test_card_dtype_embedding_is_written_as_float32(mini):
    """An embedding handed over as a bf16 tensor (``engine.quant``) is
    cast to float32 on the host: a JAX reader sees the float32 of the
    bf16 values."""
    base = hash_embed()

    def bf16_embed(text):
        return torch.from_numpy(base(text)).to(torch.bfloat16)

    c = trc.RedisSemanticCache(bf16_embed, port=mini.port,
                               key_prefix="bf:cache")
    c.clear()
    c.add(QUERIES[0], "r")
    want = torch.from_numpy(base(QUERIES[0])).to(torch.bfloat16).float()
    want = (want / want.norm()).numpy()
    reader = jrc.RedisSemanticCache(jhash_embed(), port=mini.port,
                                    key_prefix="bf:cache")
    np.testing.assert_allclose(reader._matrix[0], want, atol=1e-6)
    hit = reader.find_similar(QUERIES[0])
    assert hit is not None and hit.response == "r"


def test_server_side_expiry_counts_as_miss(mini):
    c = trc.RedisSemanticCache(hash_embed(), port=mini.port,
                               key_prefix="exp:cache", ttl_seconds=1)
    c.clear()
    c.add("ephemeral question", "answer")
    cli = RedisClient(port=mini.port)
    for key in cli.scan_iter("exp:cache:entry:*"):
        cli.execute("EXPIRE", key, 0)
    assert c.find_similar("ephemeral question") is None
    assert c.stats().entries == 0
    cli.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_invalidate_and_clear_across_packages(mini, writer):
    w, make_reader = _pair(mini, f"inv{writer}:cache", writer)
    w.add("query one", "resp one")
    w.add("query two", "resp two")
    reader = make_reader()
    reader.invalidate("query one")
    assert w.find_similar("query one", threshold=0.99) is None
    assert make_reader().stats().entries == 1
    reader.clear()
    assert make_reader().stats().entries == 0


def test_unreachable_store_fails_open():
    c = trc.RedisSemanticCache(hash_embed(), port=1, ttl_seconds=300)
    c.add("q", "r")
    assert c.find_similar("q") is None
    assert c.stats().errors >= 1


@pytest.mark.parametrize("backend", ["redis", "valkey"])
def test_build_cache_redis_branch(mini, backend):
    kw = dict(enabled=True, backend_type=backend, similarity_threshold=0.7,
              ttl_seconds=60, backend_config={"port": mini.port,
                                              "key_prefix": "f:cache"})
    got = build_cache(SemanticCacheConfig(**kw), hash_embed())
    want = jbuild_cache(JCacheConfig(**kw), jhash_embed())
    assert type(got).__name__ == type(want).__name__ == "RedisSemanticCache"
    assert (got.prefix, got.similarity_threshold, got.ttl_seconds,
            got.client.port) == (want.prefix, want.similarity_threshold,
                                 want.ttl_seconds, want.client.port)


# -- the Responses API store ---------------------------------------------


def _stored(mod, i):
    return mod.StoredResponse(
        id=f"resp_{i}", model="m",
        messages=[{"role": "user", "content": f"q{i} é"},
                  {"role": "assistant", "content": f"a{i}"}],
        created_t=1000.0 + i, metadata={"user": f"u{i}"})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_response_store_read_across_packages(mini, writer):
    w_mod, r_mod = (tr, jr) if writer == "port" else (jr, tr)
    w = w_mod.build_response_store({"backend": "redis", "port": mini.port,
                                    "key_prefix": f"r{writer}:resp",
                                    "ttl_seconds": 60})
    r = r_mod.build_response_store({"backend": "valkey", "port": mini.port,
                                    "key_prefix": f"r{writer}:resp"})
    for i in range(4):
        w.put(_stored(w_mod, i))
    for i in range(4):
        got, want = r.get(f"resp_{i}"), w.get(f"resp_{i}")
        assert (got.id, got.model, got.messages, got.created_t,
                got.metadata) == (want.id, want.model, want.messages,
                                  want.created_t, want.metadata)
    cli = RedisClient(port=mini.port)
    assert 0 < cli.ttl(f"r{writer}:resp:resp_0") <= 60
    cli.close()
    assert r.delete("resp_3") and w.get("resp_3") is None
    assert r.get("missing") is None


def test_response_store_fails_open():
    s = tr.RedisResponseStore(port=1)
    s.put(_stored(tr, 0))
    assert s.get("resp_0") is None and s.delete("resp_0") is False


@pytest.mark.parametrize("backend", ["redis-cluster", "valkey-cluster"])
def test_response_store_over_cluster(backend):
    half = 16384 // 2
    a = JClusterNode((0, half - 1)).start()
    b = JClusterNode((half, 16383)).start()
    for slot in range(16384):
        owner, other = (a, b) if slot < half else (b, a)
        other.peers[slot] = f"127.0.0.1:{owner.port}"
    cfg = {"backend": backend, "ttl_seconds": 60,
           "nodes": [{"host": "127.0.0.1", "port": a.port}]}
    try:
        t, j = tr.build_response_store(cfg), jr.build_response_store(cfg)
        for i in range(12):
            t.put(_stored(tr, i))
        for i in range(12):
            got = j.get(f"resp_{i}")
            assert got is not None and got.messages[0]["content"] == \
                f"q{i} é"
        assert a._data and b._data
        assert j.delete("resp_3") and t.get("resp_3") is None
    finally:
        a.stop()
        b.stop()


# -- the workflow state store --------------------------------------------


def _state(mod, sid):
    return mod.PendingToolState(
        state_id=sid, phase="step", step_index=1, model="m",
        messages=[{"role": "user", "content": "q"}],
        plan={"steps": [{"id": "s1"}]},
        step_results=[{"id": "s0", "role": "r", "responses": []}],
        sibling_responses=[{"model": "m2", "text": "t"}],
        original_body={"model": "auto"}, config={"mode": "static"},
        tool_trajectory=[{"tool": "x"}], usage={"m": {"total_tokens": 3}},
        created_t=1234.5)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_workflow_state_resumes_across_packages(mini, writer):
    w_mod, r_mod = (tw, jw) if writer == "port" else (jw, tw)
    cfg = {"workflow_state": {"backend": "redis", "port": mini.port,
                              "ttl_seconds": 30}}
    w = w_mod.build_workflow_state_store(cfg)
    r = r_mod.build_workflow_state_store(cfg)
    assert type(w).__name__ == type(r).__name__ == "RedisWorkflowStateStore"
    sid = f"wf{writer}{time.time_ns()}"
    w.put(_state(w_mod, sid))
    got = r.take(sid)
    assert got is not None
    assert got.__dict__ == _state(r_mod, sid).__dict__
    # the claim check: exactly one resumer wins
    assert r.take(sid) is None and w.take(sid) is None
