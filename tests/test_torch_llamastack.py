"""The port's Llama-Stack client, vector store and ``MiniLlamaStack``
against the JAX package's, on the CPU: each client against the other
package's server (store lifecycle, id/name resolution, chunk insert,
vector and RRF-hybrid search, file and store deletes, stats), hits equal
to the JAX client's on the JAX server, the manager's ``llamastack``
backend both ways, and ``build_router`` serving ``vectorstore.backend:
llamastack``."""

import zlib

import numpy as np
import pytest

from semantic_router_tpu.state import llamastack as jls
from semantic_router_tpu.vectorstore import store as jvs
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.runtime.bootstrap import build_router
from semantic_router_tpu_torch.state import llamastack as tls
from semantic_router_tpu_torch.vectorstore import store as tvs

DOCS = [
    ("runbook", "Restart the router with systemctl. Check the health "
                "endpoint after. Logs live under the journal."),
    ("mesh", "The TPU mesh shards batches. Collectives ride the ICI "
             "links. Lunch is at noon in the cafeteria."),
    ("gpu", "The H100 runs the flash attention kernel. Graphs replay "
            "the captured steps. Memory is eighty gigabytes."),
]
QUERIES = ["how do collectives use ICI links", "restart the router",
           "flash attention kernel on the card", "lunch"]


def embed(text):
    v = np.zeros(32, np.float32)
    for tok in text.lower().split():
        h = zlib.crc32(tok.encode())
        v[h % 32] += 1.0 if (h >> 1) % 2 else -1.0
    n = np.linalg.norm(v)
    return v / (n or 1.0)


@pytest.fixture
def servers():
    j, t = jls.MiniLlamaStack(embed).start(), tls.MiniLlamaStack(embed)
    t.start()
    yield {"jax": j, "port": t}
    j.stop()
    t.stop()


CLIENTS = {"jax": (jls.LlamaStackClient, jls.LlamaStackVectorStore),
           "port": (tls.LlamaStackClient, tls.LlamaStackVectorStore)}


def _hits(hits):
    """A hit list without the random ids: text, score, index, metadata."""
    return [(h.chunk.text, round(h.score, 6), h.chunk.index,
             sorted(h.chunk.metadata.items())) for h in hits]


def _fill(store):
    docs = [store.ingest(name, text, metadata={"source": name})
            for name, text in DOCS]
    return docs


def _searches(store, hybrid_store=None):
    out = []
    for q in QUERIES:
        out.append(_hits(store.search(q, top_k=3)))
        out.append(_hits(store.search(q, top_k=2, threshold=0.3)))
        if hybrid_store is not None:
            out.append(_hits(hybrid_store.search(q, top_k=3,
                                                 threshold=0.7)))
    return out


def _round_trip(client_pkg, server):
    cli_cls, store_cls = CLIENTS[client_pkg]
    cli = cli_cls(server.url)
    store = store_cls(cli, "kb", embed_fn=embed)
    hy = store_cls(cli, "hy", embed_fn=embed, search_type="hybrid")
    docs = _fill(store)
    _fill(hy)
    got = {"search": _searches(store, hy), "stats": store.stats()}
    again = store_cls(cli, "kb", embed_fn=embed)
    got["reattached"] = again.store_id == store.store_id
    got["resolved"] = (cli.resolve_store_id("kb") == store.store_id,
                       cli.resolve_store_id(store.store_id)
                       == store.store_id, cli.resolve_store_id("nope"))
    got["names"] = sorted(s["name"] for s in cli.list_stores())
    got["deleted"] = store.delete_document(docs[0].id)
    got["after"] = (store.stats(), _hits(store.search(QUERIES[1], top_k=3)))
    cli.delete_store(hy.store_id)
    got["names_after"] = sorted(s["name"] for s in cli.list_stores())
    return got


@pytest.mark.parametrize("client,server", [("port", "jax"),
                                           ("jax", "port"),
                                           ("port", "port")])
def test_each_client_against_the_other_server(servers, client, server):
    ref = jls.MiniLlamaStack(embed).start()
    try:
        want = _round_trip("jax", ref)
    finally:
        ref.stop()
    got = _round_trip(client, servers[server])
    assert got == want
    assert want["stats"] == {"documents": 3, "chunks": 3}
    assert all(want["search"][::3])
    # RRF scores are ~1/60: a cosine threshold never drops them
    assert all(s < 0.1 for _t, s, _i, _m in want["search"][2])


def test_the_port_server_answers_what_the_jax_server_answers(servers):
    """The same requests, byte-level payloads compared after the random
    ids are set aside."""
    out = {}
    for name, srv in servers.items():
        cli = jls.LlamaStackClient(srv.url)
        sid = cli.create_store("s", metadata={"k": "v"})
        cli.insert_chunks(sid, [
            {"content": text, "chunk_id": f"c{i}",
             "metadata": {"file_id": f"f{i % 2}", "index": i}}
            for i, (_n, text) in enumerate(DOCS)])
        rows = []
        for q in QUERIES:
            for kw in ({}, {"hybrid": True}, {"file_id": "f0"}):
                rows.append([(h["chunk_id"], h["file_id"],
                              round(h["score"], 6), h["content"],
                              h["metadata"])
                             for h in cli.search(sid, q, top_k=3, **kw)])
        info = cli.get_store(sid)
        cli._request("DELETE", f"/v1/vector_stores/{sid}/files/f1")
        with pytest.raises(Exception) as err:
            cli.get_store("vs_missing")
        out[name] = (rows, {k: v for k, v in info.items() if k != "id"},
                     cli.get_store(sid)["chunk_count"],
                     type(err.value).__name__)
    assert out["port"] == out["jax"]
    assert out["jax"][3] == "LlamaStackError"
    with pytest.raises(tls.LlamaStackError, match="404"):
        tls.LlamaStackClient(servers["jax"].url).get_store("vs_missing")


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_managers_share_stores_across_packages(servers, writer, reader):
    mods = {"jax": jvs, "port": tvs}
    url = servers["jax"].url
    w = mods[writer].VectorStoreManager(
        embed, backend="llamastack", backend_config={"url": url})
    _fill(w.create("team-kb"))
    want = _searches(w.get("team-kb"))
    r = mods[reader].VectorStoreManager(
        embed, backend="llamastack", backend_config={"url": url})
    assert r.get("nope") is None
    got = _searches(r.get("team-kb"))
    assert got == want
    assert r.delete("team-kb") and w.get("team-kb") is not None
    assert r.get("team-kb") is None


def test_build_router_serves_the_llamastack_backend(servers):
    cfg = load_config({"default_model": "m", "vectorstore": {
        "enabled": True, "backend": "llamastack", "backend_config": {
            "url": servers["port"].url, "collection_prefix": "t-"}}})
    router = build_router(cfg)
    try:
        mgr = router.vectorstores
        assert mgr.backend == "llamastack"
        store = mgr.get_or_create("kb")
        assert isinstance(store, tls.LlamaStackVectorStore)
        _fill(store)
        ref = jvs.VectorStoreManager(embed, backend="llamastack",
                                     backend_config={
                                         "url": servers["jax"].url})
        _fill(ref.create("kb"))
        assert _searches(store) == _searches(ref.get("kb"))
        assert store.search(QUERIES[0], top_k=1)
        names = [s["name"] for s in tls.LlamaStackClient(
            servers["port"].url).list_stores()]
        assert names == ["t-kb"]
    finally:
        router.shutdown()
