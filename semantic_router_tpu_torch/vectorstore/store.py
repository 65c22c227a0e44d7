"""Vector store + RAG retrieval layer.

The port's copy of ``semantic_router_tpu.vectorstore.store``:
``chunk_text`` and ``format_rag_context`` give the same strings byte for
byte.  Capability parity with pkg/vectorstore (11.6k LoC): document
ingestion with sentence-window chunking (pipeline.go, chunking.go),
embedding-indexed chunk search with hybrid (vector + keyword) scoring
(hybrid.go), a named multi-store manager (manager.go, service.go; the
reference's durable metadata registry is not served by this port yet),
and the RAG plugin contract consumed by the router pipeline
(extproc/req_filter_rag.go — context retrieved per request and injected
ahead of the model call).  External backends (Milvus / Qdrant) plug
behind the same protocol; the reference's Llama-Stack backend is not
served by this port yet, and a manager asked for it raises by name.
"""

from __future__ import annotations

import re
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol, Sequence

import numpy as np

from ..router.promptcompression import split_sentences

_WORD = re.compile(r"\w+", re.UNICODE)


@dataclass
class Chunk:
    id: str
    document_id: str
    text: str
    index: int
    embedding: Optional[np.ndarray] = None
    metadata: Dict[str, str] = field(default_factory=dict)


@dataclass
class Document:
    id: str
    name: str
    text: str
    metadata: Dict[str, str] = field(default_factory=dict)
    created_t: float = field(default_factory=time.time)
    chunk_ids: List[str] = field(default_factory=list)


@dataclass
class SearchHit:
    chunk: Chunk
    score: float
    vector_score: float = 0.0
    keyword_score: float = 0.0


def chunk_text(text: str, chunk_sentences: int = 5,
               overlap_sentences: int = 1) -> List[str]:
    """Sentence-window chunking with overlap (chunking.go role)."""
    sents = split_sentences(text)
    if not sents:
        return []
    step = max(1, chunk_sentences - overlap_sentences)
    out = []
    for start in range(0, len(sents), step):
        window = sents[start:start + chunk_sentences]
        if window:
            out.append(" ".join(window))
        if start + chunk_sentences >= len(sents):
            break
    return out


class VectorStore(Protocol):
    def ingest(self, name: str, text: str,
               metadata: Optional[Dict[str, str]] = None) -> Document: ...

    def search(self, query: str, top_k: int = 5, threshold: float = 0.0,
               hybrid: bool = True) -> List[SearchHit]: ...

    def delete_document(self, document_id: str) -> bool: ...


class InMemoryVectorStore:
    def __init__(self, embed_fn: Optional[Callable[[str], np.ndarray]] = None,
                 chunk_sentences: int = 5, overlap_sentences: int = 1,
                 hybrid_weight: float = 0.3) -> None:
        self.embed_fn = embed_fn
        self.chunk_sentences = chunk_sentences
        self.overlap_sentences = overlap_sentences
        self.hybrid_weight = hybrid_weight
        self.documents: Dict[str, Document] = {}
        self.chunks: Dict[str, Chunk] = {}
        self._lock = threading.RLock()

    def ingest(self, name: str, text: str,
               metadata: Optional[Dict[str, str]] = None) -> Document:
        doc = Document(id=uuid.uuid4().hex[:12], name=name, text=text,
                       metadata=dict(metadata or {}))
        pieces = chunk_text(text, self.chunk_sentences,
                            self.overlap_sentences)
        with self._lock:
            for i, piece in enumerate(pieces):
                emb = None
                if self.embed_fn is not None:
                    emb = np.asarray(self.embed_fn(piece), np.float32)
                chunk = Chunk(id=uuid.uuid4().hex[:12], document_id=doc.id,
                              text=piece, index=i, embedding=emb,
                              metadata=dict(doc.metadata))
                self.chunks[chunk.id] = chunk
                doc.chunk_ids.append(chunk.id)
            self.documents[doc.id] = doc
        return doc

    def search(self, query: str, top_k: int = 5, threshold: float = 0.0,
               hybrid: bool = True) -> List[SearchHit]:
        with self._lock:
            chunks = list(self.chunks.values())
        if not chunks:
            return []
        v_scores = np.zeros(len(chunks))
        if self.embed_fn is not None:
            q = np.asarray(self.embed_fn(query), np.float32)
            for i, c in enumerate(chunks):
                if c.embedding is not None:
                    v_scores[i] = float(c.embedding @ q)
        k_scores = np.zeros(len(chunks))
        if hybrid or self.embed_fn is None:
            q_words = set(w.lower() for w in _WORD.findall(query))
            if q_words:
                for i, c in enumerate(chunks):
                    words = set(w.lower() for w in _WORD.findall(c.text))
                    if words:
                        k_scores[i] = len(q_words & words) / len(q_words)
        w = self.hybrid_weight if (hybrid and self.embed_fn is not None) \
            else (1.0 if self.embed_fn is None else 0.0)
        final = (1 - w) * v_scores + w * k_scores
        order = np.argsort(-final)
        out = []
        for i in order[:top_k]:
            if final[i] < threshold:
                break
            out.append(SearchHit(chunks[i], float(final[i]),
                                 float(v_scores[i]), float(k_scores[i])))
        return out

    def delete_document(self, document_id: str) -> bool:
        with self._lock:
            doc = self.documents.pop(document_id, None)
            if doc is None:
                return False
            for cid in doc.chunk_ids:
                self.chunks.pop(cid, None)
            return True

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"documents": len(self.documents),
                    "chunks": len(self.chunks)}


class VectorStoreManager:
    """Named stores (manager.go role).

    ``backend="sqlite"`` + ``base_path`` makes every named store durable
    (one DB file per store under base_path); previously-persisted stores
    are re-attached lazily by name after a restart."""

    def __init__(self, embed_fn: Optional[Callable] = None,
                 backend: str = "memory",
                 base_path: Optional[str] = None,
                 backend_config: Optional[Dict] = None,
                 stateplane=None, ann=None) -> None:
        if backend == "llamastack":
            raise ValueError("vectorstore.backend 'llamastack' is not "
                             "served by this port yet")
        self.embed_fn = embed_fn
        self.backend = backend
        self.base_path = base_path
        self.backend_config = dict(backend_config or {})
        # backend="stateplane": named stores live on the shared state
        # plane (stateplane.SharedVectorStore) — rows ingested through
        # one replica retrieve on every replica
        self.stateplane = stateplane
        # backend="ann": chunk vectors live on the device ANN plane
        # (ann.AnnPlane) — bootstrap's apply_ann_knobs
        # sets this handle; None means fall back to in-memory stores
        self.ann = ann
        self._stores: Dict[str, InMemoryVectorStore] = {}
        self._lock = threading.Lock()
        # serializes CREATE end-to-end (rare admin op; network I/O is
        # fine here) without ever holding the hot _lock across I/O —
        # see create() for why both locks exist
        self._create_lock = threading.Lock()
        self._qdrant = None

    def _qdrant_client(self):
        if self._qdrant is None:
            from ..state.qdrant import QdrantClient

            self._qdrant = QdrantClient(
                self.backend_config.get("url", "http://127.0.0.1:6333"),
                api_key=self.backend_config.get("api_key", ""))
        return self._qdrant

    def _milvus_client(self):
        if getattr(self, "_milvus", None) is None:
            from ..state.milvus import MilvusClient

            self._milvus = MilvusClient(
                self.backend_config.get("url", "http://127.0.0.1:19530"),
                token=self.backend_config.get("token", ""))
        return self._milvus

    def _new_store(self, name: str, **kwargs) -> InMemoryVectorStore:
        if self.backend == "ann":
            if self.ann is not None:
                from .ann_store import AnnVectorStore

                return AnnVectorStore(self.ann.index(f"vs:{name}"),
                                      embed_fn=self.embed_fn, **kwargs)
            # operator asked for the device bank but ann.enabled never
            # attached a plane: serve in-memory rather than fail, and
            # say so (the knob table documents this fallback)
            from ..observability.logging import component_event

            component_event("vectorstore", "ann_backend_fallback",
                            level="warning", store=name,
                            reason="no ANN plane attached; "
                                   "using in-memory store")
        if self.backend == "stateplane" and self.stateplane is not None:
            from ..stateplane.vectorstore import SharedVectorStore

            return SharedVectorStore(self.stateplane, name,
                                     embed_fn=self.embed_fn, **kwargs)
        if self.backend == "sqlite":
            import os

            from .sqlite_store import SQLiteVectorStore

            base = self.base_path or "."
            os.makedirs(base, exist_ok=True)
            return SQLiteVectorStore(
                os.path.join(base, f"{name}.vectorstore.db"),
                embed_fn=self.embed_fn, **kwargs)
        if self.backend == "qdrant":
            from ..state.qdrant import QdrantVectorStore

            prefix = self.backend_config.get("collection_prefix", "vsr-")
            return QdrantVectorStore(
                self._qdrant_client(), f"{prefix}{name}",
                embed_fn=self.embed_fn, **kwargs)
        if self.backend == "milvus":
            from ..state.milvus import MilvusVectorStore

            prefix = self.backend_config.get("collection_prefix", "vsr_")
            return MilvusVectorStore(
                self._milvus_client(), f"{prefix}{name}",
                embed_fn=self.embed_fn, **kwargs)
        return InMemoryVectorStore(self.embed_fn, **kwargs)

    def _db_path(self, name: str) -> str:
        import os

        return os.path.join(self.base_path or ".", f"{name}.vectorstore.db")

    @staticmethod
    def _close_store(store) -> None:
        """Release a fully-constructed store that lost a publish race
        (open sqlite handle / remote attachment must not leak)."""
        for closer in ("close", "stop"):
            fn = getattr(store, closer, None)
            if callable(fn):
                try:
                    fn()
                except Exception:
                    pass
                return

    def create(self, name: str, **kwargs) -> InMemoryVectorStore:
        import os

        # _create_lock serializes create-vs-create end-to-end, so a
        # true duplicate still raises at this pre-check (the original
        # single-lock semantics).  The hot _lock is NEVER held across
        # construction: remote backends do network I/O there (stateplane
        # attach, qdrant/milvus collection calls) and holding the
        # manager lock across a round-trip stalls every store op — the
        # lock-order witness flagged exactly that edge.
        with self._create_lock:
            with self._lock:
                if name in self._stores or (
                        self.backend == "sqlite"
                        and os.path.exists(self._db_path(name))):
                    raise ValueError(f"store {name!r} exists")
            store = self._new_store(name, **kwargs)
            with self._lock:
                published = self._stores.setdefault(name, store)
                if published is not store and kwargs:
                    # with creates serialized, the only racer here is a
                    # READER (get()) that discovered our freshly-written
                    # artifacts and re-attached — but its attachment was
                    # built WITHOUT our kwargs, so the creator's
                    # configured store must win the mapping.  The
                    # reader's object stays alive (it may already be in
                    # use; both back the same artifacts).
                    self._stores[name] = store
                    published = store
            if published is not store:
                # kwargs-less creation lost to an equivalent reader
                # attachment: drop our duplicate handle, keep theirs
                self._close_store(store)
                store = published
        return store

    def get(self, name: str) -> Optional[InMemoryVectorStore]:
        import os

        with self._lock:
            store = self._stores.get(name)
            if store is None and self.backend == "sqlite" \
                    and os.path.exists(self._db_path(name)):
                store = self._new_store(name)  # re-attach persisted store
                self._stores[name] = store
            if store is not None or self.backend not in ("qdrant",
                                                         "milvus",
                                                         "stateplane"):
                return store
        # remote probes are network round-trips: NEVER hold the manager
        # lock across them (a slow server would stall every store op)
        try:
            if self.backend == "stateplane":
                from ..stateplane.vectorstore import store_exists

                # a SIBLING replica may have created this store on the
                # plane — attach to it by name, like the sqlite re-attach
                exists = self.stateplane is not None \
                    and store_exists(self.stateplane, name)
            elif self.backend == "qdrant":
                prefix = self.backend_config.get("collection_prefix",
                                                 "vsr-")
                exists = self._qdrant_client().collection_exists(
                    f"{prefix}{name}")
            else:
                prefix = self.backend_config.get("collection_prefix",
                                                 "vsr_")
                exists = self._milvus_client().has_collection(
                    f"{prefix}{name}")
            if not exists:
                return None
            store = self._new_store(name)
        except Exception:
            return None  # unreachable server: behave as absent
        with self._lock:  # publish (first attacher wins)
            published = self._stores.setdefault(name, store)
        if published is not store:
            self._close_store(store)  # lost the race: release the dup
        return published

    def get_or_create(self, name: str) -> InMemoryVectorStore:
        existing = self.get(name)
        if existing is not None:
            return existing
        # _create_lock: creation (here AND create()) is serialized, so
        # create(name, **kwargs) can never lose its publish to a
        # kwargs-less builder racing through this path — the only
        # publisher that can beat a creation is get()'s reader-attach,
        # which attaches to the creator's own artifacts
        with self._create_lock:
            with self._lock:
                store = self._stores.get(name)
            if store is not None:
                return store
            # remote-backend construction does network I/O — build
            # OUTSIDE the hot lock (same invariant get() documents),
            # publish under it
            built = self._new_store(name)
            with self._lock:
                store = self._stores.setdefault(name, built)
            if store is not built:
                self._close_store(built)  # reader attached first
        return store

    def list(self) -> List[str]:
        with self._lock:
            return sorted(self._stores)

    def delete(self, name: str) -> bool:
        import os

        with self._lock:
            store = self._stores.pop(name, None)
        if store is not None and hasattr(store, "close"):
            store.close()
        # durable cleanup runs OUTSIDE the lock (file IO / network)
        if self.backend == "sqlite" \
                and os.path.exists(self._db_path(name)):
            # remove the persisted file even when the store was never
            # re-attached this process — otherwise it resurrects
            os.remove(self._db_path(name))
            return True
        if self.backend == "stateplane" and self.stateplane is not None:
            try:
                plane = self.stateplane
                keys = plane.backend.scan(plane.key("vs", name, ""))
                if keys:
                    plane.backend.delete(*keys)
                    return True
            except Exception:
                pass
        elif self.backend == "ann" and store is not None:
            # tombstone every chunk the store indexed on the device bank
            idx = getattr(store, "index", None)
            if idx is not None:
                try:
                    for cid in idx.ids():
                        idx.delete(cid)
                    return True
                except Exception:
                    pass
        elif self.backend == "qdrant":
            prefix = self.backend_config.get("collection_prefix", "vsr-")
            try:
                if self._qdrant_client().collection_exists(
                        f"{prefix}{name}"):
                    self._qdrant_client().delete_collection(
                        f"{prefix}{name}")
                    return True
            except Exception:
                pass
        elif self.backend == "milvus":
            prefix = self.backend_config.get("collection_prefix", "vsr_")
            try:
                if self._milvus_client().has_collection(
                        f"{prefix}{name}"):
                    self._milvus_client().drop_collection(
                        f"{prefix}{name}")
                    return True
            except Exception:
                pass
        return store is not None


def format_rag_context(hits: Sequence[SearchHit],
                       max_chars: int = 4000) -> str:
    """Retrieved chunks → injected context block (req_filter_rag.go)."""
    parts = []
    total = 0
    for h in hits:
        piece = f"[{h.chunk.metadata.get('source', h.chunk.document_id)}] " \
                f"{h.chunk.text}"
        if total + len(piece) > max_chars:
            if not parts:  # always include at least one (truncated) chunk
                parts.append(piece[:max_chars])
            break
        total += len(piece)
        parts.append(piece)
    if not parts:
        return ""
    return ("Relevant context:\n" + "\n---\n".join(parts))
