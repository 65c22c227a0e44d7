"""Plane-shared semantic cache: N replicas, one entry set.

The port's copy of ``semantic_router_tpu.stateplane.cache``.  Similarity
is owned by one path at a time (``similarity_owner()``): the on-device
ANN plane's ``cache`` index once ``apply_ann_knobs`` attaches it
(``attach_ann``; a failure of the device path falls back to the local
cache, never fails a request), else numpy over the in-process mirror on
the host.  The query embedding comes off the card once per lookup
(``host_f32``), and only when the exact path missed.

Same hybrid layout as cache/redis_cache.py (payloads external, the
similarity index in-proc) but generic over the StateBackend seam and
fleet-aware:

- entry key = sha256(query): exact-match dedupe falls out of the
  keyspace (a rewrite overwrites, never duplicates), and the exact-hit
  path is one get_hash — no embedding forward;
- a version counter (``{ns}:cache:ver``) increments on every write;
  readers compare it (one get) before a similarity search and resync
  their in-proc mirror only when siblings actually wrote — that is how
  an entry written through replica A becomes a hit on replica B within
  one lookup, without per-request scans;
- every backend failure degrades to the LOCAL cache (the wrapped
  in-proc backend the router would have run anyway): writes land
  locally and queue bounded for replay; reads serve local entries.  On
  breaker recovery the pending writes replay and the mirror resyncs —
  reconciliation, not amnesia.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..cache.redis_cache import host_f32
from ..cache.semantic_cache import CacheEntry, CacheStats
from .backend import StateBackendUnavailable

PENDING_REPLAY_CAP = 256


def _qhash(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:32]


class SharedSemanticCache:
    """CacheBackend over a StatePlane; ``local`` is the fail-open
    fallback (any CacheBackend — typically the in-proc cache built from
    the operator's semantic_cache block)."""

    def __init__(self, plane, embed_fn: Callable[[str], np.ndarray],
                 similarity_threshold: float = 0.8,
                 ttl_seconds: float = 3600.0,
                 local=None) -> None:
        self.plane = plane
        self.backend = plane.backend
        self.embed_fn = embed_fn
        self.similarity_threshold = similarity_threshold
        self.ttl_seconds = ttl_seconds
        self.local = local
        # when the on-device ANN plane attaches (bootstrap
        # apply_ann_knobs → attach_ann), similarity routes through its
        # "cache" index and the in-proc mirror below gates OFF — there
        # is exactly ONE similarity interpretation point at a time
        # (similarity_owner() says which)
        self._ann = None
        self._ids: List[str] = []
        self._matrix: Optional[np.ndarray] = None
        self._seen_ver = -1
        self._lock = threading.Lock()
        self._stats = CacheStats()
        # writes that landed local-only while the plane was down; each
        # is (query, response, model, category) — replayed on recovery
        self._pending: deque = deque(maxlen=PENDING_REPLAY_CAP)
        self.backend.on_recover(self.reconcile)
        try:
            self._resync()
        except StateBackendUnavailable:
            pass

    # -- keys ---------------------------------------------------------------

    def _entry_key(self, qh: str) -> str:
        return self.plane.key("cache", "entry", qh)

    def _ver_key(self) -> str:
        return self.plane.key("cache", "ver")

    # -- mirror -------------------------------------------------------------

    def _resync(self) -> None:
        """Rebuild the in-proc (id, embedding) mirror from the plane;
        called at attach, on version drift, and on recovery.  Embeddings
        already mirrored are reused (an entry key is a content hash, so
        the same key means the same query text), so steady-state drift
        costs one get + one scan + one get_hash per NEW entry — not a
        full refetch of the entry set on the routing thread."""
        ver_raw = self.backend.get(self._ver_key())
        ver = int(ver_raw) if ver_raw else 0
        prefix = self.plane.key("cache", "entry", "")
        keys = self.backend.scan(prefix)
        with self._lock:
            known = {qh: i for i, qh in enumerate(self._ids)}
            old = self._matrix
        ids, vecs = [], []
        for k in keys:
            qh = k[len(prefix):]
            i = known.get(qh)
            if i is not None and old is not None and i < len(old):
                ids.append(qh)
                vecs.append(old[i])
                continue
            emb = self.backend.get_hash(k).get("emb")
            if emb:
                ids.append(qh)
                vecs.append(np.frombuffer(emb, dtype=np.float32))
        with self._lock:
            self._ids = ids
            self._matrix = np.stack(vecs) if vecs else None
            self._seen_ver = ver
            self._stats.entries = len(ids)

    def _maybe_resync(self) -> None:
        ver_raw = self.backend.get(self._ver_key())
        ver = int(ver_raw) if ver_raw else 0
        with self._lock:
            stale = ver != self._seen_ver
        if stale:
            self._resync()

    def _append_mirror(self, qh: str, vec: np.ndarray, ver: int) -> None:
        with self._lock:
            if qh in self._ids:
                i = self._ids.index(qh)
                if self._matrix is not None:
                    self._matrix[i] = vec
            else:
                self._ids.append(qh)
                row = vec[None, :]
                self._matrix = row if self._matrix is None \
                    else np.concatenate([self._matrix, row])
            if ver == self._seen_ver + 1:
                self._seen_ver = ver
            # else: sibling writes landed between our last resync and
            # this incr — leave _seen_ver stale so the next lookup's
            # drift check resyncs and mirrors THEIR entries too
            self._stats.entries = len(self._ids)

    def _drop_mirror(self, qh: str) -> None:
        with self._lock:
            try:
                i = self._ids.index(qh)
            except ValueError:
                return
            self._ids.pop(i)
            if self._matrix is not None:
                self._matrix = np.delete(self._matrix, i, axis=0)
                if not self._ids:
                    self._matrix = None
            self._stats.entries = len(self._ids)

    @staticmethod
    def _normalize(v) -> np.ndarray:
        v = host_f32(v)
        n = float(np.linalg.norm(v))
        return v / n if n > 0 else v

    # -- ANN plane handoff --------------------------------------------------

    def attach_ann(self, index) -> None:
        """Route similarity through the on-device ANN plane: seed the
        index with whatever the mirror already holds, then gate the
        mirror OFF.  Before this gate, an attached
        external index AND the in-proc mirror could both answer
        similarity with drifting thresholds; now exactly one owner
        interprets it at a time.  The exact sha256 path is untouched."""
        with self._lock:
            ids = list(self._ids)
            matrix = self._matrix
            self._ids = []
            self._matrix = None
        if matrix is not None:
            for i, qh in enumerate(ids):
                index.add(qh, matrix[i])
        self._ann = index

    def detach_ann(self) -> None:
        """ann.enabled flipped off: rebuild the in-proc mirror from the
        plane so similarity keeps answering without the device bank."""
        if self._ann is None:
            return
        self._ann = None
        try:
            self._resync()
        except StateBackendUnavailable:
            pass

    def similarity_owner(self) -> str:
        """Which path owns similarity lookups right now —
        ``"ann"`` (device bank) or ``"mirror"`` (in-proc matrix)."""
        return "ann" if self._ann is not None else "mirror"

    # -- CacheBackend -------------------------------------------------------

    def add(self, query: str, response: str, model: str = "",
            category: str = "") -> None:
        vec = self._normalize(self.embed_fn(query))
        qh = _qhash(query)
        try:
            self.backend.put_hash(self._entry_key(qh), {
                "query": query, "response": response, "model": model,
                "category": category, "created": repr(time.time()),
                "emb": vec.tobytes()},
                ttl_s=self.ttl_seconds or None)
            ver = self.backend.incr(self._ver_key())
        except StateBackendUnavailable:
            self._stats.errors += 1
            self._pending.append((query, response, model, category))
            if self.local is not None:
                try:
                    self.local.add(query, response, model=model,
                                   category=category)
                except Exception:
                    pass
            return
        ann = self._ann
        if ann is not None:
            ann.add(qh, vec)  # mirror gated off: the bank owns the vec
        else:
            self._append_mirror(qh, vec, ver)
        self._stats.additions += 1

    def find_similar(self, query: str, threshold: Optional[float] = None,
                     category: str = "") -> Optional[CacheEntry]:
        thresh = self.similarity_threshold if threshold is None \
            else threshold
        qh = _qhash(query)
        ann = self._ann
        try:
            # exact path first: one plane read, no embedding forward
            # (bypasses the ANN bank too — a sha256 hit needs no top-k)
            h = self.backend.get_hash(self._entry_key(qh))
            if h:
                entry = self._entry_from_hash(h)
                if not category or not entry.category \
                        or entry.category == category:
                    self._stats.hits += 1
                    self._stats.exact_hits += 1
                    return entry
            if ann is None:
                self._maybe_resync()
        except StateBackendUnavailable:
            self._stats.errors += 1
            return self._local_find(query, threshold, category)
        if ann is not None:
            # ANN owns similarity (similarity_owner() == "ann"); any
            # device-path failure degrades like a plane failure would —
            # a device error mid hot-flip must cost a cache miss,
            # never fail the request (the pre-ANN mirror path couldn't)
            try:
                return self._ann_find(ann, query, thresh, category)
            except Exception:
                self._stats.errors += 1
                return self._local_find(query, threshold, category)
        with self._lock:
            matrix = self._matrix
            ids = list(self._ids)
        if matrix is None or not ids:
            self._stats.misses += 1
            return None
        q = self._normalize(self.embed_fn(query))
        sims = matrix @ q
        order = np.argsort(-sims)
        for i in order[:8]:
            if sims[i] < thresh:
                break
            kid = ids[i]
            try:
                h = self.backend.get_hash(self._entry_key(kid))
            except StateBackendUnavailable:
                self._stats.errors += 1
                return self._local_find(query, threshold, category)
            if not h:  # expired server-side: the store wins
                self._drop_mirror(kid)
                continue
            entry = self._entry_from_hash(h, embedding=matrix[i])
            if category and entry.category \
                    and entry.category != category:
                continue
            self._stats.hits += 1
            return entry
        self._stats.misses += 1
        return None

    def _ann_find(self, ann, query: str, thresh: float,
                  category: str) -> Optional[CacheEntry]:
        """ANN-owned similarity: candidates come off the device bank /
        host tier, each verified against the plane before serving
        (expired server-side rows retire from the index — the store
        wins, same contract as the mirror path)."""
        q = self._normalize(self.embed_fn(query))
        ids, scores = ann.lookup(q)
        for kid, score in zip(ids, scores):
            if score < thresh:
                break
            h = self.backend.get_hash(self._entry_key(kid))
            if not h:  # expired server-side: the store wins
                ann.delete(kid)
                continue
            entry = self._entry_from_hash(h)
            if category and entry.category \
                    and entry.category != category:
                continue
            self._stats.hits += 1
            return entry
        self._stats.misses += 1
        return None

    def _local_find(self, query: str, threshold: Optional[float],
                    category: str) -> Optional[CacheEntry]:
        """Plane-down read path: serve whatever the local fallback
        holds (fail open, never an error up the pipeline)."""
        if self.local is None:
            self._stats.misses += 1
            return None
        try:
            hit = self.local.find_similar(query, threshold=threshold,
                                          category=category)
        except Exception:
            hit = None
        if hit is None:
            self._stats.misses += 1
        else:
            self._stats.hits += 1
        return hit

    @staticmethod
    def _entry_from_hash(h: Dict[str, bytes],
                         embedding: Optional[np.ndarray] = None
                         ) -> CacheEntry:
        emb = embedding
        if emb is None and h.get("emb"):
            emb = np.frombuffer(h["emb"], dtype=np.float32)
        return CacheEntry(
            request_id=0,
            query=h.get("query", b"").decode(),
            response=h.get("response", b"").decode(),
            model=h.get("model", b"").decode(),
            category=h.get("category", b"").decode(),
            embedding=emb, hit_count=1)

    def invalidate(self, query: str) -> None:
        qh = _qhash(query)
        try:
            self.backend.delete(self._entry_key(qh))
            self.backend.incr(self._ver_key())
        except StateBackendUnavailable:
            self._stats.errors += 1
        self._drop_mirror(qh)
        if self._ann is not None:
            self._ann.delete(qh)
        if self.local is not None:
            try:
                self.local.invalidate(query)
            except Exception:
                pass

    def clear(self) -> None:
        try:
            prefix = self.plane.key("cache", "entry", "")
            keys = self.backend.scan(prefix)
            if keys:
                self.backend.delete(*keys)
            self.backend.incr(self._ver_key())
        except StateBackendUnavailable:
            self._stats.errors += 1
        with self._lock:
            self._ids = []
            self._matrix = None
            self._stats.entries = 0
        ann = self._ann
        if ann is not None:
            for kid in ann.ids():
                ann.delete(kid)
        if self.local is not None:
            try:
                self.local.clear()
            except Exception:
                pass

    def stats(self) -> CacheStats:
        ann = self._ann
        with self._lock:
            s = CacheStats(**self._stats.__dict__)
            s.entries = len(self._ids)
        if ann is not None:
            s.entries = len(ann)
        return s

    # -- recovery -----------------------------------------------------------

    def reconcile(self) -> None:
        """Breaker-recovery hook: replay writes buffered while the
        plane was down, then resync the mirror so this replica sees
        what the fleet wrote in the meantime."""
        pending: List[Tuple[str, str, str, str]] = []
        while True:
            try:
                pending.append(self._pending.popleft())
            except IndexError:
                break
        for query, response, model, category in pending:
            try:
                self.add(query, response, model=model, category=category)
            except Exception:
                break
        try:
            if self._ann is None:  # ann-owned: its sync reconverges
                self._resync()
        except StateBackendUnavailable:
            pass
