"""Plane-shared vector store: RAG rows visible to every replica.

The port's copy of ``semantic_router_tpu.stateplane.vectorstore``: the
same keys and bytes, so a JAX replica and a port replica on one store
share one vector store.

Implements the vectorstore.store.VectorStore protocol over a StatePlane
backend so a document ingested through replica A retrieves on replica B:

- ``{ns}:vs:{store}:doc:{id}``   → JSON document row (name, metadata,
  chunk ids);
- ``{ns}:vs:{store}:chunk:{id}`` → hash {text, doc, index, emb, meta};
- ``{ns}:vs:{store}:ver``        → write counter; searches compare it
  (one get) and resync the in-proc chunk mirror only on drift.

Search runs over the mirror at memory speed (same hybrid
vector+keyword scoring as the in-proc store); the plane is only paid on
writes, on version drift, and for payloads already mirrored locally.
Backend loss degrades to a local in-memory store (ingests buffered for
replay, searches over whatever is mirrored + local) — fail open, like
every stateful layer behind the plane.
"""

from __future__ import annotations

import json
import re
import threading
import uuid
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from ..vectorstore.store import (
    Chunk,
    Document,
    InMemoryVectorStore,
    SearchHit,
    chunk_text,
)
from .backend import StateBackendUnavailable

_WORD = re.compile(r"\w+", re.UNICODE)

PENDING_REPLAY_CAP = 64


class SharedVectorStore:
    def __init__(self, plane, name: str,
                 embed_fn: Optional[Callable[[str], np.ndarray]] = None,
                 chunk_sentences: int = 5, overlap_sentences: int = 1,
                 hybrid_weight: float = 0.3) -> None:
        self.plane = plane
        self.backend = plane.backend
        self.name = name
        self.embed_fn = embed_fn
        self.chunk_sentences = chunk_sentences
        self.overlap_sentences = overlap_sentences
        self.hybrid_weight = hybrid_weight
        self._lock = threading.Lock()
        self._chunks: Dict[str, Chunk] = {}      # mirror
        self._docs: Dict[str, Document] = {}
        self._seen_ver = -1
        self._local = InMemoryVectorStore(
            embed_fn, chunk_sentences=chunk_sentences,
            overlap_sentences=overlap_sentences,
            hybrid_weight=hybrid_weight)
        self._pending: deque = deque(maxlen=PENDING_REPLAY_CAP)
        self.backend.on_recover(self.reconcile)
        try:
            self._mark_exists()
            self._resync()
        except StateBackendUnavailable:
            pass

    # -- keys ---------------------------------------------------------------

    def _k(self, *parts: str) -> str:
        return self.plane.key("vs", self.name, *parts)

    def _mark_exists(self) -> None:
        """The store's existence marker — VectorStoreManager.get on a
        sibling replica probes this before attaching."""
        if self.backend.get(self._k("ver")) is None:
            self.backend.put(self._k("ver"), b"0")

    # -- mirror -------------------------------------------------------------

    def _resync(self) -> None:
        ver_raw = self.backend.get(self._k("ver"))
        ver = int(ver_raw) if ver_raw else 0
        doc_prefix = self._k("doc", "")
        chunk_prefix = self._k("chunk", "")
        docs: Dict[str, Document] = {}
        for k in self.backend.scan(doc_prefix):
            raw = self.backend.get(k)
            if not raw:
                continue
            try:
                row = json.loads(raw)
            except (ValueError, UnicodeDecodeError):
                continue
            did = k[len(doc_prefix):]
            docs[did] = Document(
                id=did, name=row.get("name", ""), text="",
                metadata=dict(row.get("metadata", {}) or {}),
                chunk_ids=list(row.get("chunk_ids", []) or []))
        referenced = set()
        for d in docs.values():
            referenced.update(d.chunk_ids)
        chunks: Dict[str, Chunk] = {}
        for k in self.backend.scan(chunk_prefix):
            cid = k[len(chunk_prefix):]
            if cid not in referenced:
                # no live doc row lists this chunk: either a mid-ingest
                # backend failure stranded it (the doc row never
                # landed; reconcile() replays under fresh ids) or a
                # sibling's ingest is in flight and its doc row lands
                # next (their ver bump triggers the resync that picks
                # it up).  Unreferenced rows must never serve hits —
                # they would double every replayed chunk forever.
                continue
            h = self.backend.get_hash(k)
            if not h:
                continue
            emb = np.frombuffer(h["emb"], dtype=np.float32) \
                if h.get("emb") else None
            try:
                meta = json.loads(h.get("meta", b"{}"))
            except (ValueError, UnicodeDecodeError):
                meta = {}
            chunks[cid] = Chunk(
                id=cid, document_id=h.get("doc", b"").decode(),
                text=h.get("text", b"").decode(),
                index=int(h.get("index", b"0") or 0),
                embedding=emb, metadata=meta)
        with self._lock:
            self._docs = docs
            self._chunks = chunks
            self._seen_ver = ver

    def _maybe_resync(self) -> None:
        ver_raw = self.backend.get(self._k("ver"))
        ver = int(ver_raw) if ver_raw else 0
        with self._lock:
            stale = ver != self._seen_ver
        if stale:
            self._resync()

    # -- VectorStore --------------------------------------------------------

    def ingest(self, name: str, text: str,
               metadata: Optional[Dict[str, str]] = None) -> Document:
        doc = Document(id=uuid.uuid4().hex[:12], name=name, text=text,
                       metadata=dict(metadata or {}))
        pieces = chunk_text(text, self.chunk_sentences,
                            self.overlap_sentences)
        chunks: List[Chunk] = []
        for i, piece in enumerate(pieces):
            emb = None
            if self.embed_fn is not None:
                emb = np.asarray(self.embed_fn(piece), np.float32)
            chunk = Chunk(id=uuid.uuid4().hex[:12], document_id=doc.id,
                          text=piece, index=i, embedding=emb,
                          metadata=dict(doc.metadata))
            chunks.append(chunk)
            doc.chunk_ids.append(chunk.id)
        try:
            for chunk in chunks:
                row = {"text": chunk.text, "doc": doc.id,
                       "index": str(chunk.index),
                       "meta": json.dumps(chunk.metadata)}
                if chunk.embedding is not None:
                    row["emb"] = chunk.embedding.tobytes()
                self.backend.put_hash(self._k("chunk", chunk.id), row)
            self.backend.put(self._k("doc", doc.id), json.dumps({
                "name": doc.name, "metadata": doc.metadata,
                "chunk_ids": doc.chunk_ids}).encode())
            ver = self.backend.incr(self._k("ver"))
        except StateBackendUnavailable:
            # plane down: land locally + buffer for replay on recovery
            # (the local doc id rides along so the replay can retire
            # the local copy — otherwise every replayed chunk would
            # search double forever).  Chunk rows that landed BEFORE
            # the failure are orphans (no doc row references them, so
            # _resync never mirrors them) — their keys ride along too
            # so reconcile() can reap the bytes once the plane returns.
            stranded = tuple(self._k("chunk", c.id) for c in chunks) \
                + (self._k("doc", doc.id),)
            local_doc = self._local.ingest(name, text, metadata=metadata)
            self._pending.append((name, text, dict(metadata or {}),
                                  local_doc.id, stranded))
            return local_doc
        with self._lock:
            self._docs[doc.id] = doc
            for chunk in chunks:
                self._chunks[chunk.id] = chunk
            if ver == self._seen_ver + 1:
                self._seen_ver = ver
            # else: a sibling ingested between our last resync and this
            # incr — keep _seen_ver stale so the next search resyncs
            # and mirrors their rows too
        return doc

    def search(self, query: str, top_k: int = 5, threshold: float = 0.0,
               hybrid: bool = True) -> List[SearchHit]:
        try:
            self._maybe_resync()
        except StateBackendUnavailable:
            pass  # search over the last good mirror + local
        with self._lock:
            chunks = list(self._chunks.values())
        # plane-down ingests live only in the local store: merge them in
        local_hits = self._local.search(query, top_k=top_k,
                                        threshold=threshold,
                                        hybrid=hybrid) \
            if self._local.chunks else []
        if not chunks:
            return local_hits
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
        out: List[SearchHit] = []
        for i in order[:top_k]:
            if final[i] < threshold:
                break
            out.append(SearchHit(chunks[i], float(final[i]),
                                 float(v_scores[i]), float(k_scores[i])))
        if local_hits:
            out = sorted(out + local_hits, key=lambda h: -h.score)[:top_k]
        return out

    def delete_document(self, document_id: str) -> bool:
        with self._lock:
            doc = self._docs.pop(document_id, None)
            chunk_ids = list(doc.chunk_ids) if doc else []
            for cid in chunk_ids:
                self._chunks.pop(cid, None)
        try:
            if doc is None:
                # a sibling may own it: read the doc row from the plane
                raw = self.backend.get(self._k("doc", document_id))
                if raw is None:
                    return self._local.delete_document(document_id)
                chunk_ids = list(json.loads(raw).get("chunk_ids", []))
            keys = [self._k("doc", document_id)] + \
                [self._k("chunk", cid) for cid in chunk_ids]
            self.backend.delete(*keys)
            self.backend.incr(self._k("ver"))
            return True
        except StateBackendUnavailable:
            return doc is not None

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"documents": len(self._docs),
                    "chunks": len(self._chunks),
                    "local_documents": len(self._local.documents)}

    # -- recovery -----------------------------------------------------------

    def reconcile(self) -> None:
        """Replay plane-down ingests (retiring each one's local copy —
        the plane row replaces it, never duplicates it), then resync
        the mirror."""
        pending: List = []
        while True:
            try:
                pending.append(self._pending.popleft())
            except IndexError:
                break
        for i, (name, text, metadata, local_id,
                stranded) in enumerate(pending):
            try:
                # reap any chunk/doc rows the failed ingest stranded on
                # the plane before it died (never searchable — no doc
                # row references them — but bytes otherwise leak across
                # every outage); the replay below writes fresh ids
                if stranded:
                    self.backend.delete(*stranded)
                self.ingest(name, text, metadata=metadata)
                # drop the plane-down copy: either the plane row now
                # holds it, or the failed replay re-buffered a FRESH
                # local copy — the old one is redundant either way
                self._local.delete_document(local_id)
            except Exception:
                self._pending.extendleft(reversed(pending[i:]))
                break
        try:
            self._resync()
        except StateBackendUnavailable:
            pass

    def close(self) -> None:
        pass


def store_exists(plane, name: str) -> bool:
    """Has ANY replica created this named store on the plane?  (The
    VectorStoreManager cross-replica attach probe.)"""
    try:
        return plane.backend.get(plane.key("vs", name, "ver")) is not None
    except StateBackendUnavailable:
        return False
