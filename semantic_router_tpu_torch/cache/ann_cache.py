"""External ANN semantic-cache backends: Qdrant + Milvus.

The port's copy of ``semantic_router_tpu.cache.ann_cache``; a query
embedding on the card comes to the host once (``host_f32``).

Reference parity: ``pkg/cache/qdrant_cache.go`` and
``pkg/cache/milvus_cache.go`` — the semantic cache's entries live in an
external vector database so every router replica shares one cache and
restarts lose nothing. Same ``CacheBackend`` protocol as the in-memory
and Redis backends; same fail-open contract (an unreachable store is a
miss + ``stats.errors``, never an exception into the data plane).

Entry layout (both stores): one point per cached query with the
normalized query embedding as the vector and
``{query, query_hash, response, model, category, created_t}`` as
payload. Exact hits resolve by ``query_hash`` filter (no similarity
scan); similarity hits are server-side vector search with the
per-category threshold applied client-side. TTL is enforced on read
(expired entries are deleted lazily, the reference's TTL-on-access
shape)."""

from __future__ import annotations

import time
import uuid
from typing import Callable, Dict, Optional

import numpy as np

from .redis_cache import host_f32
from .semantic_cache import CacheEntry, CacheStats, _hash

__all__ = ["QdrantSemanticCache", "MilvusSemanticCache"]


def _point_id(query_hash: str) -> str:
    """Deterministic UUID from the query hash (Qdrant point ids must be
    UUIDs or unsigned ints; re-adding the same query overwrites)."""
    return str(uuid.UUID(query_hash[:32]))


class _AnnCacheBase:
    def __init__(self, embed_fn: Callable[[str], np.ndarray],
                 similarity_threshold: float = 0.8,
                 ttl_seconds: float = 3600.0,
                 category_thresholds: Optional[Dict[str, float]] = None
                 ) -> None:
        self.embed_fn = embed_fn
        self.similarity_threshold = similarity_threshold
        self.ttl_seconds = ttl_seconds
        self.category_thresholds = category_thresholds or {}
        self._stats = CacheStats()
        self._dim: Optional[int] = None
        self._ready = False

    def _embed(self, text: str) -> np.ndarray:
        v = host_f32(self.embed_fn(text))
        n = np.linalg.norm(v)
        return v / n if n > 0 else v

    def _expired(self, created_t: float) -> bool:
        return self.ttl_seconds > 0 and \
            time.time() - created_t > self.ttl_seconds

    def _threshold(self, category: str,
                   override: Optional[float]) -> float:
        if override is not None:
            return override
        if category and category in self.category_thresholds:
            return self.category_thresholds[category]
        return self.similarity_threshold

    def stats(self) -> CacheStats:
        return self._stats

    @staticmethod
    def _entry(payload: Dict, emb=None) -> CacheEntry:
        return CacheEntry(
            request_id=0,
            query=payload.get("query", ""),
            response=payload.get("response", ""),
            model=payload.get("model", ""),
            category=payload.get("category", ""),
            embedding=emb,
            created_t=float(payload.get("created_t", 0.0)),
            hit_count=1)

    # template methods -------------------------------------------------

    def _ensure(self, dim: int) -> None:
        raise NotImplementedError

    def add(self, query: str, response: str, model: str = "",
            category: str = "") -> None:
        try:
            emb = self._embed(query)
            self._ensure(emb.shape[0])
            self._upsert(query, emb, response, model, category)
            self._stats.additions += 1
        except Exception:
            self._stats.errors += 1  # fail-open: a dead store drops adds

    def find_similar(self, query: str, threshold: Optional[float] = None,
                     category: str = "") -> Optional[CacheEntry]:
        try:
            exact = self._exact_lookup(_hash(query))
            if exact is not None:
                # category-scoped like the in-memory backend: mismatch
                # only when both sides carry a category
                if category and exact.category \
                        and exact.category != category:
                    exact = None
            if exact is not None:
                if self._expired(exact.created_t):
                    self.invalidate(exact.query)
                else:
                    self._stats.hits += 1
                    self._stats.exact_hits += 1
                    return exact
            emb = self._embed(query)
            self._ensure(emb.shape[0])
            # over-fetch so an expired top-1 can't hide a live
            # second-best (lazy TTL deletion)
            for hit in self._search(emb,
                                    self._threshold(category, threshold),
                                    category, limit=5):
                if self._expired(hit.created_t):
                    self.invalidate(hit.query)
                    continue
                self._stats.hits += 1
                return hit
        except Exception:
            self._stats.errors += 1
            self._stats.misses += 1
            return None
        self._stats.misses += 1
        return None


class QdrantSemanticCache(_AnnCacheBase):
    def __init__(self, embed_fn, *, base_url: str = "http://127.0.0.1:6333",
                 api_key: str = "", collection: str = "vsr_cache",
                 similarity_threshold: float = 0.8,
                 ttl_seconds: float = 3600.0,
                 category_thresholds: Optional[Dict[str, float]] = None,
                 timeout_s: float = 10.0) -> None:
        super().__init__(embed_fn, similarity_threshold, ttl_seconds,
                         category_thresholds)
        from ..state.qdrant import QdrantClient

        self.client = QdrantClient(base_url, api_key=api_key,
                                   timeout_s=timeout_s)
        self.collection = collection

    def _ensure(self, dim: int) -> None:
        if not self._ready:
            if not self.client.collection_exists(self.collection):
                self.client.create_collection(self.collection, dim,
                                              distance="Cosine")
            self._ready = True

    def _upsert(self, query, emb, response, model, category) -> None:
        qh = _hash(query)
        self.client.upsert(self.collection, [{
            "id": _point_id(qh),
            "vector": emb.tolist(),
            "payload": {"query": query, "query_hash": qh,
                        "response": response, "model": model,
                        "category": category,
                        "created_t": time.time()}}])

    def _exact_lookup(self, qh: str) -> Optional[CacheEntry]:
        from ..state.qdrant import match_filter

        # one existence probe, then remembered — the exact path runs on
        # every routed request and must not pay an extra round trip
        if not self._ready:
            if not self.client.collection_exists(self.collection):
                return None
            self._ready = True
        pts = self.client.scroll(self.collection, limit=1,
                                 query_filter=match_filter("query_hash",
                                                           qh))
        if not pts:
            return None
        return self._entry(pts[0].get("payload", {}))

    def _search(self, emb, threshold, category, limit=5):
        from ..state.qdrant import match_filter

        # in-memory semantics: an entry is excluded only when BOTH
        # sides carry a category and they differ — uncategorized
        # entries match any categorized lookup
        from ..state.qdrant import any_of_filter

        flt = any_of_filter("category", [category, ""]) \
            if category else None
        hits = self.client.search(self.collection, emb, limit=limit,
                                  score_threshold=threshold,
                                  query_filter=flt)
        return [self._entry(h.get("payload", {}), emb) for h in hits]

    def invalidate(self, query: str) -> None:
        from ..state.qdrant import match_filter

        try:
            self.client.delete_points(
                self.collection,
                query_filter=match_filter("query_hash", _hash(query)))
        except Exception:
            self._stats.errors += 1

    def clear(self) -> None:
        try:
            self.client.delete_collection(self.collection)
            self._ready = False
        except Exception:
            self._stats.errors += 1


class MilvusSemanticCache(_AnnCacheBase):
    def __init__(self, embed_fn, *,
                 base_url: str = "http://127.0.0.1:19530",
                 token: str = "", db_name: str = "default",
                 collection: str = "vsr_cache",
                 similarity_threshold: float = 0.8,
                 ttl_seconds: float = 3600.0,
                 category_thresholds: Optional[Dict[str, float]] = None,
                 timeout_s: float = 10.0) -> None:
        super().__init__(embed_fn, similarity_threshold, ttl_seconds,
                         category_thresholds)
        from ..state.milvus import MilvusClient

        self.client = MilvusClient(base_url, token=token,
                                   db_name=db_name, timeout_s=timeout_s)
        self.collection = collection

    def _ensure(self, dim: int) -> None:
        if not self._ready:
            if not self.client.has_collection(self.collection):
                self.client.create_collection(self.collection, dim,
                                              metric="COSINE")
            self._ready = True

    def _upsert(self, query, emb, response, model, category) -> None:
        from ..state.milvus import escape_filter_value

        qh = _hash(query)
        # re-adding a query replaces its row (Milvus insert never
        # overwrites, so delete-by-hash first)
        self.client.delete(self.collection,
                           f'query_hash == "{escape_filter_value(qh)}"')
        self.client.insert(self.collection, [{
            "id": _point_id(qh),
            "vector": emb.tolist(),
            "query": query, "query_hash": qh, "response": response,
            "model": model, "category": category,
            "created_t": time.time()}])

    def _exact_lookup(self, qh: str) -> Optional[CacheEntry]:
        from ..state.milvus import escape_filter_value

        if not self._ready:
            if not self.client.has_collection(self.collection):
                return None
            self._ready = True
        rows = self.client.query(
            self.collection,
            flt=f'query_hash == "{escape_filter_value(qh)}"', limit=1)
        return self._entry(rows[0]) if rows else None

    def _search(self, emb, threshold, category, limit=5):
        from ..state.milvus import escape_filter_value

        flt = (f'category == "{escape_filter_value(category)}" '
               f'or category == ""') if category else ""
        hits = self.client.search(self.collection, emb, limit=limit,
                                  flt=flt)
        out = []
        for h in hits:
            score = float(h.get("distance", h.get("score", 0.0)))
            if score >= threshold:
                out.append(self._entry(h, emb))
        return out

    def invalidate(self, query: str) -> None:
        from ..state.milvus import escape_filter_value

        try:
            qh = escape_filter_value(_hash(query))
            self.client.delete(self.collection,
                               f'query_hash == "{qh}"')
        except Exception:
            self._stats.errors += 1

    def clear(self) -> None:
        try:
            self.client.drop_collection(self.collection)
            self._ready = False
        except Exception:
            self._stats.errors += 1
