"""Semantic cache: exact + similarity lookup over request embeddings.

The port's own copy of the in-process backend of
``semantic_router_tpu.cache.semantic_cache``: an exact hash map checked
first, then an HNSW index (or brute-force cosine over the whole store),
TTL expiry, fifo/lru/lfu eviction, per-category similarity thresholds and
hit/miss stats.  The embedding function is injected (the engine's
embedding task); distances are normalized-dot matmuls.
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .hnsw import HNSWIndex


@dataclass
class CacheEntry:
    request_id: int
    query: str
    response: str
    model: str = ""
    category: str = ""
    embedding: Optional[np.ndarray] = None
    created_t: float = field(default_factory=time.time)
    last_access_t: float = field(default_factory=time.time)
    hit_count: int = 0


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    exact_hits: int = 0
    evictions: int = 0
    entries: int = 0
    additions: int = 0
    errors: int = 0  # external-backend IO failures (fail-open occurrences)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


def _hash(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


class InMemorySemanticCache:
    """In-memory backend: exact hash map + HNSW (or brute-force) ANN.

    ``use_hnsw=False`` switches to exact brute-force cosine over the whole
    store (one [N, d] @ [d] matmul) — the small-N fast path.
    """

    def __init__(self, embed_fn: Callable[[str], np.ndarray],
                 similarity_threshold: float = 0.8,
                 max_entries: int = 1000,
                 ttl_seconds: float = 3600.0,
                 eviction_policy: str = "fifo",
                 use_hnsw: bool = True,
                 category_thresholds: Optional[Dict[str, float]] = None
                 ) -> None:
        self.embed_fn = embed_fn
        self.similarity_threshold = similarity_threshold
        self.max_entries = max_entries
        self.ttl_seconds = ttl_seconds
        self.eviction_policy = eviction_policy
        self.use_hnsw = use_hnsw
        self.category_thresholds = category_thresholds or {}
        self._entries: Dict[int, CacheEntry] = {}
        self._exact: Dict[str, int] = {}
        self._index: Optional[HNSWIndex] = None
        self._next_id = 0
        self._stats = CacheStats()
        self._lock = threading.RLock()

    # -- CacheBackend ------------------------------------------------------

    def add(self, query: str, response: str, model: str = "",
            category: str = "") -> None:
        emb = np.asarray(self.embed_fn(query), dtype=np.float32)
        n = np.linalg.norm(emb)
        if n > 0:
            emb = emb / n
        with self._lock:
            # replace a previous entry for the same query (otherwise the old
            # row becomes an unreachable duplicate still served via ANN)
            old = self._exact.get(_hash(query))
            if old is not None:
                self._remove(old)
            if len(self._entries) >= self.max_entries:
                self._evict()
            rid = self._next_id
            self._next_id += 1
            entry = CacheEntry(rid, query, response, model, category, emb)
            self._entries[rid] = entry
            self._exact[_hash(query)] = rid
            if self.use_hnsw:
                if self._index is None:
                    self._index = HNSWIndex(dim=emb.shape[-1])
                self._index.add(rid, emb)
            self._stats.entries = len(self._entries)

    def find_similar(self, query: str, threshold: Optional[float] = None,
                     category: str = "") -> Optional[CacheEntry]:
        if threshold is None:
            threshold = self.category_thresholds.get(
                category, self.similarity_threshold)
        now = time.time()
        with self._lock:
            # exact path first (reference: 100% exact hit, <5 ms);
            # category-scoped like the similarity path
            rid = self._exact.get(_hash(query))
            if rid is not None:
                entry = self._entries.get(rid)
                if entry is not None and self._live(entry, now) and \
                        (not category or not entry.category
                         or entry.category == category):
                    self._touch(entry)
                    self._stats.hits += 1
                    self._stats.exact_hits += 1
                    return entry
        emb = np.asarray(self.embed_fn(query), dtype=np.float32)
        n = np.linalg.norm(emb)
        if n > 0:
            emb = emb / n
        with self._lock:
            best: Optional[Tuple[float, CacheEntry]] = None
            if self.use_hnsw and self._index is not None and len(self._index):
                for rid, sim in self._index.search(emb, k=5):
                    entry = self._entries.get(rid)
                    if entry is None or not self._live(entry, now):
                        continue
                    if category and entry.category and entry.category != category:
                        continue
                    if best is None or sim > best[0]:
                        best = (sim, entry)
            elif self._entries:
                # snapshot first: _live() may expire-and-remove entries
                live = [e for e in list(self._entries.values())
                        if self._live(e, now)
                        and (not category or not e.category
                             or e.category == category)]
                if live:
                    mat = np.stack([e.embedding for e in live])
                    sims = mat @ emb
                    i = int(np.argmax(sims))
                    best = (float(sims[i]), live[i])
            if best is not None and best[0] >= threshold:
                self._touch(best[1])
                self._stats.hits += 1
                return best[1]
            self._stats.misses += 1
            return None

    def invalidate(self, query: str) -> None:
        with self._lock:
            rid = self._exact.pop(_hash(query), None)
            if rid is not None:
                self._remove(rid)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._exact.clear()
            self._index = None
            self._stats.entries = 0

    def stats(self) -> CacheStats:
        with self._lock:
            s = CacheStats(**self._stats.__dict__)
            s.entries = len(self._entries)
            return s

    # -- internals ---------------------------------------------------------

    def _live(self, entry: CacheEntry, now: float) -> bool:
        if self.ttl_seconds and now - entry.created_t > self.ttl_seconds:
            self._remove(entry.request_id)
            return False
        return True

    def _touch(self, entry: CacheEntry) -> None:
        entry.last_access_t = time.time()
        entry.hit_count += 1

    def _remove(self, rid: int) -> None:
        entry = self._entries.pop(rid, None)
        if entry is not None:
            self._exact.pop(_hash(entry.query), None)
            if self._index is not None:
                self._index.remove(rid)
            self._stats.entries = len(self._entries)

    def _evict(self) -> None:
        if not self._entries:
            return
        if self.eviction_policy == "lru":
            victim = min(self._entries.values(),
                         key=lambda e: e.last_access_t)
        elif self.eviction_policy == "lfu":
            victim = min(self._entries.values(),
                         key=lambda e: (e.hit_count, e.created_t))
        else:  # fifo
            victim = min(self._entries.values(), key=lambda e: e.created_t)
        self._remove(victim.request_id)
        self._stats.evictions += 1


def build_cache(cfg, embed_fn: Callable[[str], np.ndarray]):
    """The backend a ``SemanticCacheConfig`` names: ``memory``, ``hnsw``
    and ``hybrid`` are in-process; ``redis`` / ``valkey`` is the
    ``RedisSemanticCache`` over the RESP client (its ``backend_config``:
    host, port, db, password, key_prefix); ``qdrant`` and ``milvus`` are
    the external ANN stores of ``cache.ann_cache`` (``backend_config``:
    base_url, api_key / token, db_name, collection)."""
    if not cfg.enabled:
        return None
    if cfg.backend_type in ("memory", "hnsw", "hybrid"):
        return InMemorySemanticCache(
            embed_fn,
            similarity_threshold=cfg.similarity_threshold,
            max_entries=cfg.max_entries,
            ttl_seconds=cfg.ttl_seconds,
            eviction_policy=cfg.eviction_policy,
            use_hnsw=cfg.backend_type != "memory" or cfg.use_hnsw,
        )
    if cfg.backend_type in ("redis", "valkey"):
        from .redis_cache import RedisSemanticCache

        bc = cfg.backend_config or {}
        return RedisSemanticCache(
            embed_fn,
            host=bc.get("host", "127.0.0.1"),
            port=int(bc.get("port", 6379)),
            db=int(bc.get("db", 0)),
            password=str(bc.get("password", "")),
            key_prefix=bc.get("key_prefix", "vsr:cache"),
            similarity_threshold=cfg.similarity_threshold,
            ttl_seconds=cfg.ttl_seconds,
        )
    if cfg.backend_type == "qdrant":
        from .ann_cache import QdrantSemanticCache

        bc = cfg.backend_config or {}
        return QdrantSemanticCache(
            embed_fn,
            base_url=bc.get("base_url", "http://127.0.0.1:6333"),
            api_key=str(bc.get("api_key", "")),
            collection=bc.get("collection", "vsr_cache"),
            similarity_threshold=cfg.similarity_threshold,
            ttl_seconds=cfg.ttl_seconds,
        )
    if cfg.backend_type == "milvus":
        from .ann_cache import MilvusSemanticCache

        bc = cfg.backend_config or {}
        return MilvusSemanticCache(
            embed_fn,
            base_url=bc.get("base_url", "http://127.0.0.1:19530"),
            token=str(bc.get("token", "")),
            db_name=bc.get("db_name", "default"),
            collection=bc.get("collection", "vsr_cache"),
            similarity_threshold=cfg.similarity_threshold,
            ttl_seconds=cfg.ttl_seconds,
        )
    raise ValueError(f"unsupported cache backend {cfg.backend_type!r} "
                     f"(backends: memory|hnsw|hybrid|redis|valkey|"
                     f"qdrant|milvus)")
