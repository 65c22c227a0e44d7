"""The port's vector stores against the JAX package's, on the CPU.

``chunk_text`` and ``format_rag_context`` give the JAX strings byte for
byte; the in-memory, ANN-backed and plane-shared stores return the JAX
hits (texts, documents, scores within 1e-5) on one embedding function;
``SQLiteVectorStore`` files written by either package open in the other;
a JAX replica and a port replica on one ``MiniRedis`` share one
``SharedVectorStore``; ``VectorStoreManager`` builds every backend the
port serves, attaches a sibling's stores by name, falls back to memory
(stamped) when the ANN backend has no plane, deletes as the reference
does, and refuses ``llamastack`` by name."""

import time

import numpy as np
import pytest

from semantic_router_tpu import ann as jann
from semantic_router_tpu import stateplane as jsp
from semantic_router_tpu import vectorstore as jvs
from semantic_router_tpu.state.qdrant import MiniQdrant as JMiniQdrant
from semantic_router_tpu.stateplane.vectorstore import \
    SharedVectorStore as JSharedVectorStore, store_exists as jstore_exists
from semantic_router_tpu.vectorstore.ann_store import \
    AnnVectorStore as JAnnVectorStore
from semantic_router_tpu.vectorstore.sqlite_store import \
    SQLiteVectorStore as JSQLiteVectorStore
from semantic_router_tpu_torch import ann as tann
from semantic_router_tpu_torch import stateplane as tsp
from semantic_router_tpu_torch import vectorstore as tvs
from semantic_router_tpu_torch.state.milvus import MiniMilvus
from semantic_router_tpu_torch.state.resp import MiniRedis
from semantic_router_tpu_torch.stateplane.harness import hash_embed
from semantic_router_tpu_torch.stateplane.vectorstore import \
    SharedVectorStore, store_exists
from semantic_router_tpu_torch.vectorstore.ann_store import AnnVectorStore
from semantic_router_tpu_torch.vectorstore.sqlite_store import \
    SQLiteVectorStore

EMBED = hash_embed(48)
TOL = 1e-5

TEXTS = [
    "",
    "One sentence only",
    "First. Second! Third? Fourth. Fifth. Sixth. Seventh.",
    "Lisbon sits on seven hills. Trams climb them. Zürich has a lake.\n"
    "東京 is large. Québec speaks French! Oslo is cold? Yes.",
    "a. b. c. d. e. f. g. h. i. j. k. l. m.",
    "No terminal punctuation here but a long run of words that goes on",
]
CORPUS = [
    ("pasta", "Boil the water before adding pasta. Salt the water well. "
              "Drain the pasta when it is al dente. Toss it with sauce."),
    ("rust", "The borrow checker enforces ownership. A value has one "
             "owner. References must not outlive the value."),
    ("trains", "Night trains cross Europe. Sleeper cabins hold two or "
               "four berths. Book early in summer."),
    ("tax", "Quarterly estimated taxes are due four times a year. Keep "
            "receipts for deductions. File before April."),
]
QUERIES = ["how long do I boil pasta", "what does the borrow checker do",
           "sleeper train berths", "when are estimated taxes due",
           "salt"]


def _rows(hits):
    return [(h.chunk.text, h.chunk.metadata.get("source", ""))
            for h in hits], [h.score for h in hits]


def _same(jhits, thits):
    jr, js = _rows(jhits)
    tr, ts = _rows(thits)
    assert tr == jr
    np.testing.assert_allclose(ts, js, atol=TOL)


def _ingest(store):
    for name, text in CORPUS:
        store.ingest(name, text, metadata={"source": name})


@pytest.mark.parametrize("i", range(len(TEXTS)))
@pytest.mark.parametrize("window", [(5, 1), (2, 0), (3, 2), (1, 0)])
def test_chunk_text_equals_jax(i, window):
    assert tvs.chunk_text(TEXTS[i], *window) \
        == jvs.chunk_text(TEXTS[i], *window)


@pytest.mark.parametrize("max_chars", [4000, 120, 30, 5])
def test_format_rag_context_equals_jax(max_chars):
    def hits(mod):
        out = []
        for i, (name, text) in enumerate(CORPUS):
            meta = {"source": name} if i % 2 == 0 else {}
            out.append(mod.SearchHit(mod.Chunk(id=f"c{i}",
                                               document_id=f"doc{i}",
                                               text=text, index=i,
                                               metadata=meta), 0.5))
        return out

    got = tvs.format_rag_context(hits(tvs), max_chars=max_chars)
    want = jvs.format_rag_context(hits(jvs), max_chars=max_chars)
    assert got == want and got
    assert tvs.format_rag_context([], max_chars) == ""


@pytest.mark.parametrize("hybrid", [True, False])
def test_in_memory_search_equals_jax(hybrid):
    j, t = jvs.InMemoryVectorStore(EMBED), tvs.InMemoryVectorStore(EMBED)
    _ingest(j)
    _ingest(t)
    assert t.stats() == j.stats()
    for q in QUERIES:
        _same(j.search(q, top_k=3, hybrid=hybrid),
              t.search(q, top_k=3, hybrid=hybrid))
    # keyword-only posture (no embedder) and a threshold
    jk, tk = jvs.InMemoryVectorStore(), tvs.InMemoryVectorStore()
    _ingest(jk)
    _ingest(tk)
    for q in QUERIES:
        _same(jk.search(q, threshold=0.2), tk.search(q, threshold=0.2))


def test_sqlite_files_open_across_packages(tmp_path):
    for writer, reader in ((JSQLiteVectorStore, SQLiteVectorStore),
                           (SQLiteVectorStore, JSQLiteVectorStore)):
        path = str(tmp_path / f"{writer.__module__.split('.')[0]}.db")
        w = writer(path, embed_fn=EMBED, chunk_sentences=2,
                   overlap_sentences=0)
        _ingest(w)
        doc = next(iter(w.documents))
        w.delete_document(doc)
        r = reader(path, embed_fn=EMBED)
        assert (r.chunk_sentences, r.overlap_sentences) == (2, 0)
        assert sorted(r.documents) == sorted(w.documents)
        assert {c.id: c.text for c in r.chunks.values()} \
            == {c.id: c.text for c in w.chunks.values()}
        for cid, c in w.chunks.items():
            np.testing.assert_array_equal(r.chunks[cid].embedding,
                                          c.embedding)
        for q in QUERIES:
            _same(w.search(q), r.search(q))
        w.close()
        r.close()


def test_ann_store_search_equals_jax():
    knobs = {"enabled": True, "min_capacity": 16}
    jidx = jann.AnnIndex("vs:kb", jann.normalize_ann(knobs),
                         jann.TopKPrograms())
    tidx = tann.AnnIndex("vs:kb", tann.normalize_ann(knobs),
                         tann.TopKPrograms(), device="cpu")
    j = JAnnVectorStore(jidx, embed_fn=EMBED, chunk_sentences=2,
                        overlap_sentences=0)
    t = AnnVectorStore(tidx, embed_fn=EMBED, chunk_sentences=2,
                       overlap_sentences=0)
    try:
        _ingest(j)
        _ingest(t)
        for q in QUERIES:  # host tier first, then the device bank
            _same(j.search(q, top_k=3), t.search(q, top_k=3))
        jidx.flush()
        tidx.flush()
        assert tidx.bank.report()["entries"] == len(t.chunks)
        for q in QUERIES:
            _same(j.search(q, top_k=3), t.search(q, top_k=3))
            _same(j.search(q, top_k=3, hybrid=False),
                  t.search(q, top_k=3, hybrid=False))
        doc = next(iter(t.documents))
        n = len(t.documents[doc].chunk_ids)
        assert t.delete_document(doc)
        assert len(tidx) == len(t.chunks) and n
    finally:
        jidx.close()
        tidx.close()


@pytest.fixture()
def mini():
    srv = MiniRedis().start()
    yield srv
    srv.stop()


def _plane(mod, port, rid):
    be = mod.GuardedBackend(mod.RespStateBackend(port=port), cooldown_s=0.2)
    return mod.StatePlane(be, replica_id=rid, namespace="vsx")


def test_shared_store_is_one_store_across_packages(mini):
    jp, tp = _plane(jsp, mini.port, "j"), _plane(tsp, mini.port, "t")
    try:
        assert not store_exists(tp, "kb") and not jstore_exists(jp, "kb")
        j = JSharedVectorStore(jp, "kb", embed_fn=EMBED)
        assert store_exists(tp, "kb")
        t = SharedVectorStore(tp, "kb", embed_fn=EMBED)
        for i, (name, text) in enumerate(CORPUS):
            (j if i % 2 else t).ingest(name, text,
                                       metadata={"source": name})
        for q in QUERIES:
            _same(j.search(q, top_k=3), t.search(q, top_k=3))
        assert t.stats()["chunks"] == j.stats()["chunks"] > 0
        doc = next(iter(t._docs))
        assert j.delete_document(doc)  # a doc the port wrote
        for q in QUERIES:
            _same(j.search(q, top_k=3), t.search(q, top_k=3))
        assert t.stats() == j.stats()
    finally:
        jp.close()
        tp.close()


def test_shared_store_fails_open_and_replays(mini):
    tp = _plane(tsp, mini.port, "t")
    try:
        t = SharedVectorStore(tp, "kb2", embed_fn=EMBED)
        t.ingest("pasta", CORPUS[0][1], metadata={"source": "pasta"})
        port = mini.port
        mini.stop()
        t.ingest("rust", CORPUS[1][1], metadata={"source": "rust"})
        assert t.stats()["local_documents"] == 1
        hits = t.search("borrow checker", top_k=2)
        assert hits and hits[0].chunk.metadata["source"] == "rust"
        back = MiniRedis(port=port).start()
        try:
            deadline = time.time() + 5
            while t.stats()["local_documents"] and time.time() < deadline:
                time.sleep(0.25)  # past the breaker's cooldown
                t.reconcile()
            assert t.stats()["local_documents"] == 0
            # the restarted store is empty: only the replayed ingest
            assert t.stats()["documents"] == 1
        finally:
            back.stop()
    finally:
        tp.close()


def test_manager_backends(tmp_path, mini):
    # memory and sqlite (a persisted store re-attaches by name)
    m = tvs.VectorStoreManager(EMBED)
    m.create("a")
    with pytest.raises(ValueError, match="exists"):
        m.create("a")
    assert m.list() == ["a"] and m.delete("a") and not m.delete("a")
    s = tvs.VectorStoreManager(EMBED, backend="sqlite",
                               base_path=str(tmp_path))
    _ingest(s.create("kb"))
    s2 = tvs.VectorStoreManager(EMBED, backend="sqlite",
                                base_path=str(tmp_path))
    assert s2.get("kb").stats() == s.get("kb").stats()
    assert s2.delete("kb") and s2.get("kb") is None
    # ann without a plane: in-memory, stamped; with one: AnnVectorStore
    a = tvs.VectorStoreManager(EMBED, backend="ann")
    assert type(a.create("x")) is tvs.InMemoryVectorStore
    plane = tann.AnnPlane(__import__(
        "semantic_router_tpu_torch.observability.metrics",
        fromlist=["MetricsRegistry"]).MetricsRegistry(), device="cpu")
    try:
        a.ann = plane
        st = a.create("y")
        assert isinstance(st, AnnVectorStore) and st.index.name == "vs:y"
        _ingest(st)
        assert a.delete("y") and len(st.index) == 0
    finally:
        plane.close()
    # stateplane: a sibling's store attaches by name; delete drops its rows
    tp = _plane(tsp, mini.port, "m")
    try:
        p1 = tvs.VectorStoreManager(EMBED, backend="stateplane",
                                    stateplane=tp)
        _ingest(p1.create("kb"))
        p2 = tvs.VectorStoreManager(EMBED, backend="stateplane",
                                    stateplane=tp)
        assert isinstance(p2.get("kb"), SharedVectorStore)
        assert p2.get("nope") is None
        assert p2.delete("kb") and not store_exists(tp, "kb")
    finally:
        tp.close()
    # qdrant and milvus: the external collections
    jq, mm = JMiniQdrant(), MiniMilvus()
    try:
        for backend, url in (("qdrant", jq.url), ("milvus", mm.url)):
            x = tvs.VectorStoreManager(EMBED, backend=backend,
                                       backend_config={"url": url})
            _ingest(x.create("kb"))
            y = tvs.VectorStoreManager(EMBED, backend=backend,
                                       backend_config={"url": url})
            hits = y.get("kb").search("boil pasta", top_k=1)
            assert hits and hits[0].chunk.metadata["source"] == "pasta"
            assert y.delete("kb") and y.get("kb") is None
    finally:
        jq.stop()
        mm.stop()
    with pytest.raises(ValueError, match="llamastack"):
        tvs.VectorStoreManager(EMBED, backend="llamastack")
