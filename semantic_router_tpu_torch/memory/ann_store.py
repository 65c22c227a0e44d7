"""External ANN memory stores: Qdrant + Milvus.

The port's copy of ``semantic_router_tpu.memory.ann_store``.

Reference parity: ``pkg/memory/milvus_store*.go`` — the reference's
DEFAULT memory backend keeps user memories in Milvus so every replica
shares them and restarts lose nothing; a Qdrant twin follows the same
shape. Implements the full ``MemoryStore`` surface the router and
management API consume (add/remember/search/list/delete/find_by_id/
auto_store) with the same semantics as the in-proc store: PII
sanitization before write, near-duplicate consolidation (top-1
similarity >= dedup threshold refreshes instead of inserting), hybrid
rank (vector score OR'd with keyword overlap, store.py:184-191)."""

from __future__ import annotations

import time
import uuid
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .store import (
    MemoryExtractor,
    MemoryItem,
    keyword_score,
    sanitize_pii,
)

__all__ = ["QdrantMemoryStore", "MilvusMemoryStore"]


class _AnnMemoryBase:
    def __init__(self, embed_fn: Callable[[str], np.ndarray],
                 dedup_threshold: float = 0.92) -> None:
        if embed_fn is None:
            raise ValueError("ANN memory stores need an embed function")
        self.embed_fn = embed_fn
        self.dedup_threshold = dedup_threshold
        self._ready = False

    def _embed(self, text: str) -> np.ndarray:
        v = np.asarray(self.embed_fn(text), np.float32)
        n = np.linalg.norm(v)
        return v / n if n > 0 else v

    @staticmethod
    def _item(row: Dict) -> MemoryItem:
        import json as _json

        try:
            metadata = _json.loads(row.get("metadata_json") or "{}")
        except (TypeError, ValueError):
            metadata = {}
        return MemoryItem(
            id=str(row.get("mem_id", "")),
            user_id=str(row.get("user_id", "")),
            text=str(row.get("text", "")),
            kind=str(row.get("kind", "fact")),
            created_t=float(row.get("created_t", 0.0)),
            last_access_t=float(row.get("last_access_t", 0.0)),
            access_count=int(row.get("access_count", 0)),
            metadata=metadata if isinstance(metadata, dict) else {})

    # -- MemoryStore ----------------------------------------------------

    def add(self, item: MemoryItem) -> None:
        item.text = sanitize_pii(item.text)
        emb = self._embed(item.text)
        self._ensure(emb.shape[0])
        # consolidation: a near-duplicate refreshes (bumped access
        # stats re-written) instead of inserting — in-proc semantics
        near = self._vector_search(item.user_id, emb, limit=1)
        if near and near[0][1] >= self.dedup_threshold:
            existing = near[0][0]
            existing.last_access_t = time.time()
            existing.access_count += 1
            # the stored vector (or the near-identical new one) — never
            # a fresh embedding forward pass just to rewrite stats
            vec = existing.embedding if existing.embedding is not None \
                else emb
            self._replace(existing, np.asarray(vec, np.float32))
            return
        self._upsert(item, emb)

    def remember(self, user_id: str, text: str, kind: str = "fact",
                 **metadata: str) -> MemoryItem:
        item = MemoryItem(id=uuid.uuid4().hex[:12], user_id=user_id,
                          text=text, kind=kind, metadata=dict(metadata))
        self.add(item)
        return item

    def search(self, user_id: str, query: str, limit: int = 5,
               threshold: float = 0.0,
               hybrid: bool = True) -> List[MemoryItem]:
        emb = self._embed(query)
        self._ensure(emb.shape[0])
        scored: Dict[str, tuple] = {}
        for item, score in self._vector_search(user_id, emb,
                                               limit=max(limit, 8)):
            scored[item.id] = (item, score)
        if hybrid:
            # keyword leg over the user's memories (hybrid OR, matching
            # the in-proc store) — bounded listing
            for item in self._list_user(user_id, max_rows=512):
                ks = keyword_score(query, item.text)
                prev = scored.get(item.id)
                if prev is None or ks > prev[1]:
                    scored[item.id] = (item, max(
                        ks, prev[1] if prev else 0.0))
        ranked = sorted(scored.values(), key=lambda t: -t[1])
        out = [item for item, score in ranked[:limit]
               if score >= threshold]
        now = time.time()
        for item in out:
            item.last_access_t = now
            item.access_count += 1
        try:
            self._touch(out)
        except Exception:
            pass  # stats write-back is best-effort
        return out

    def list(self, user_id: str) -> List[MemoryItem]:
        return self._list_user(user_id, max_rows=10_000)

    def auto_store(self, user_id: str, messages: Sequence[dict],
                   extractor: Optional[MemoryExtractor] = None) -> int:
        extractor = extractor or MemoryExtractor()
        facts = extractor.extract(messages)
        for fact in facts:
            self.remember(user_id, fact)
        return len(facts)


class QdrantMemoryStore(_AnnMemoryBase):
    def __init__(self, embed_fn, *, base_url: str = "http://127.0.0.1:6333",
                 api_key: str = "", collection: str = "vsr_memory",
                 dedup_threshold: float = 0.92,
                 timeout_s: float = 10.0) -> None:
        super().__init__(embed_fn, dedup_threshold)
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

    def _payload(self, item: MemoryItem) -> Dict:
        import json as _json

        return {"mem_id": item.id, "user_id": item.user_id,
                "text": item.text, "kind": item.kind,
                "created_t": item.created_t,
                "last_access_t": item.last_access_t,
                "access_count": item.access_count,
                "metadata_json": _json.dumps(item.metadata or {})}

    def _upsert(self, item: MemoryItem, emb: np.ndarray) -> None:
        self.client.upsert(self.collection, [{
            "id": str(uuid.uuid5(uuid.NAMESPACE_OID, item.id)),
            "vector": emb.tolist(),
            "payload": self._payload(item)}])

    # same point id -> Qdrant upsert overwrites in place
    _replace = _upsert

    def _vector_search(self, user_id, emb, limit):
        from ..state.qdrant import match_filter

        if not self.client.collection_exists(self.collection):
            return []
        hits = self.client.search(
            self.collection, emb, limit=limit,
            query_filter=match_filter("user_id", user_id),
            with_vectors=True)
        out = []
        for h in hits:
            item = self._item(h.get("payload", {}))
            if h.get("vector") is not None:
                item.embedding = np.asarray(h["vector"], np.float32)
            out.append((item, float(h.get("score", 0.0))))
        return out

    def _list_user(self, user_id: str,
                   max_rows: int) -> List[MemoryItem]:
        from ..state.qdrant import match_filter

        if not self.client.collection_exists(self.collection):
            return []
        pts = self.client.scroll(self.collection, limit=min(max_rows, 256),
                                 query_filter=match_filter("user_id",
                                                           user_id),
                                 max_total=max_rows)
        return [self._item(p.get("payload", {})) for p in pts]

    def _touch(self, items) -> None:
        for item in items:
            self.client.set_payload(
                self.collection,
                {"last_access_t": item.last_access_t,
                 "access_count": item.access_count},
                [str(uuid.uuid5(uuid.NAMESPACE_OID, item.id))])

    def delete(self, user_id: str, memory_id: str) -> bool:
        from ..state.qdrant import match_filter

        item = self.find_by_id(memory_id)
        # ownership check matches the in-proc/SQLite stores: another
        # user's memory id must not be deletable cross-user
        if item is None or item.user_id != user_id:
            return False
        self.client.delete_points(
            self.collection,
            query_filter=match_filter("mem_id", memory_id))
        return True

    def find_by_id(self, memory_id: str) -> Optional[MemoryItem]:
        from ..state.qdrant import match_filter

        if not self.client.collection_exists(self.collection):
            return None
        pts = self.client.scroll(self.collection, limit=1,
                                 query_filter=match_filter("mem_id",
                                                           memory_id))
        return self._item(pts[0].get("payload", {})) if pts else None


class MilvusMemoryStore(_AnnMemoryBase):
    def __init__(self, embed_fn, *,
                 base_url: str = "http://127.0.0.1:19530",
                 token: str = "", db_name: str = "default",
                 collection: str = "vsr_memory",
                 dedup_threshold: float = 0.92,
                 timeout_s: float = 10.0) -> None:
        super().__init__(embed_fn, dedup_threshold)
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

    def _upsert(self, item: MemoryItem, emb: np.ndarray) -> None:
        import json as _json

        self.client.insert(self.collection, [{
            "id": str(uuid.uuid5(uuid.NAMESPACE_OID, item.id)),
            "vector": emb.tolist(),
            "mem_id": item.id, "user_id": item.user_id,
            "text": item.text, "kind": item.kind,
            "created_t": item.created_t,
            "last_access_t": item.last_access_t,
            "access_count": item.access_count,
            "metadata_json": _json.dumps(item.metadata or {})}])

    def _replace(self, item: MemoryItem, emb: np.ndarray) -> None:
        from ..state.milvus import escape_filter_value

        # Milvus insert never overwrites: delete the old row first
        self.client.delete(
            self.collection,
            f'mem_id == "{escape_filter_value(item.id)}"')
        self._upsert(item, emb)

    def _vector_search(self, user_id, emb, limit):
        from ..state.milvus import escape_filter_value

        if not self.client.has_collection(self.collection):
            return []
        hits = self.client.search(
            self.collection, emb, limit=limit,
            flt=f'user_id == "{escape_filter_value(user_id)}"',
            output_fields=["*", "vector"])
        out = []
        for h in hits:
            item = self._item(h)
            if h.get("vector") is not None:
                item.embedding = np.asarray(h["vector"], np.float32)
            out.append((item,
                        float(h.get("distance", h.get("score", 0.0)))))
        return out

    def _list_user(self, user_id: str,
                   max_rows: int) -> List[MemoryItem]:
        from ..state.milvus import escape_filter_value

        if not self.client.has_collection(self.collection):
            return []
        rows = self.client.query(
            self.collection,
            flt=f'user_id == "{escape_filter_value(user_id)}"',
            limit=min(max_rows, self.client.MAX_QUERY_LIMIT))
        return [self._item(r) for r in rows]

    def _touch(self, items) -> None:
        for item in items:
            if item.embedding is not None:
                self._replace(item, item.embedding)

    def delete(self, user_id: str, memory_id: str) -> bool:
        from ..state.milvus import escape_filter_value

        item = self.find_by_id(memory_id)
        if item is None or item.user_id != user_id:
            return False
        self.client.delete(
            self.collection,
            f'mem_id == "{escape_filter_value(memory_id)}"')
        return True

    def find_by_id(self, memory_id: str) -> Optional[MemoryItem]:
        from ..state.milvus import escape_filter_value

        if not self.client.has_collection(self.collection):
            return None
        rows = self.client.query(
            self.collection,
            flt=f'mem_id == "{escape_filter_value(memory_id)}"', limit=1)
        return self._item(rows[0]) if rows else None
