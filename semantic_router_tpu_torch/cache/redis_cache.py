"""Redis/Valkey-backed semantic cache (reference: pkg/cache hybrid/external
backends — milvus_cache.go / qdrant_cache.go / cache_factory.go:24).

The port's copy of ``semantic_router_tpu.cache.redis_cache``: the same
keys and the same stored bytes, so a JAX replica and a port replica read
each other's entries.  ``emb`` is little-endian float32: an embedding
that comes off the card in another dtype (``engine.quant``) is cast to
float32 on the host before it is written.

Durable layout (hybrid design, like the reference's hybrid cache: payloads
in the external store, the similarity index in-proc):

  {prefix}:entry:{id}  → hash {query, response, model, emb} with server TTL

An in-process mirror (ids + L2-normalised embedding matrix) serves
similarity search at memory speed; it is rebuilt by SCAN on startup, so a
router restart — or a second replica pointing at the same store — sees all
live entries.  A mirror hit whose key has since expired/been evicted
server-side is dropped and counted as a miss (server state wins).
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, Optional

import numpy as np

from ..state.resp import ConnectionError_, RedisClient
from .semantic_cache import CacheEntry, CacheStats


def host_f32(v) -> np.ndarray:
    """One embedding as a flat little-endian float32 array on the host:
    a tensor (on the card, in any float dtype) is moved and cast once."""
    if hasattr(v, "detach"):
        v = v.detach().to("cpu").float().numpy()
    return np.asarray(v, dtype="<f4").ravel()


class RedisSemanticCache:
    def __init__(self, embed_fn: Callable[[str], np.ndarray],
                 host: str = "127.0.0.1", port: int = 6379,
                 db: int = 0, password: str = "",
                 key_prefix: str = "vsr:cache",
                 similarity_threshold: float = 0.8,
                 ttl_seconds: int = 3600,
                 client: Optional[RedisClient] = None) -> None:
        self.embed_fn = embed_fn
        self.prefix = key_prefix
        self.similarity_threshold = similarity_threshold
        self.ttl_seconds = ttl_seconds
        self.client = client or RedisClient(host, port, db, password)
        self._ids: list[str] = []
        self._matrix: Optional[np.ndarray] = None
        self._lock = threading.Lock()
        self._stats = CacheStats()
        self._resync()

    # -- mirror maintenance ---------------------------------------------

    def _resync(self) -> None:
        """Rebuild the in-proc similarity mirror from the store (startup /
        restart / second replica attach)."""
        ids, vecs = [], []
        try:
            for key in self.client.scan_iter(f"{self.prefix}:entry:*"):
                kid = key.decode().rsplit(":", 1)[-1]
                emb = self.client.hget(key.decode(), "emb")
                if emb:
                    ids.append(kid)
                    vecs.append(np.frombuffer(emb, dtype="<f4"))
        except ConnectionError_:
            return  # fail open: empty mirror, store unreachable
        with self._lock:
            self._ids = ids
            self._matrix = np.stack(vecs) if vecs else None
            self._stats.entries = len(ids)

    def _append_mirror(self, kid: str, vec: np.ndarray) -> None:
        with self._lock:
            self._ids.append(kid)
            row = vec[None, :]
            self._matrix = row if self._matrix is None \
                else np.concatenate([self._matrix, row])
            self._stats.entries = len(self._ids)

    def _drop_mirror(self, kid: str) -> None:
        with self._lock:
            try:
                i = self._ids.index(kid)
            except ValueError:
                return
            self._ids.pop(i)
            if self._matrix is not None:
                self._matrix = np.delete(self._matrix, i, axis=0)
                if not len(self._ids):
                    self._matrix = None
            self._stats.entries = len(self._ids)

    @staticmethod
    def _normalize(v: np.ndarray) -> np.ndarray:
        v = host_f32(v)
        n = float(np.linalg.norm(v))
        return v / n if n > 0 else v

    # -- CacheBackend ----------------------------------------------------

    def add(self, query: str, response: str, model: str = "",
            category: str = "") -> None:
        vec = self._normalize(self.embed_fn(query))
        kid = uuid.uuid4().hex[:16]
        key = f"{self.prefix}:entry:{kid}"
        try:
            self.client.hset(key, {
                "query": query, "response": response, "model": model,
                "category": category, "created": repr(time.time()),
                "emb": vec.tobytes()})
            if self.ttl_seconds > 0:
                self.client.expire(key, self.ttl_seconds)
        except ConnectionError_:
            self._stats.errors += 1
            return
        self._append_mirror(kid, vec)
        self._stats.additions += 1

    def find_similar(self, query: str, threshold: Optional[float] = None,
                     category: str = "") -> Optional[CacheEntry]:
        thresh = self.similarity_threshold if threshold is None else threshold
        with self._lock:
            matrix = self._matrix
            ids = list(self._ids)
        if matrix is None or not len(ids):
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
                h = self.client.hgetall(f"{self.prefix}:entry:{kid}")
            except ConnectionError_:
                self._stats.errors += 1
                return None
            if not h:  # expired/evicted server-side: drop and continue
                self._drop_mirror(kid)
                continue
            self._stats.hits += 1
            return CacheEntry(
                request_id=0,
                query=h.get(b"query", b"").decode(),
                response=h.get(b"response", b"").decode(),
                model=h.get(b"model", b"").decode(),
                category=h.get(b"category", b"").decode(),
                embedding=matrix[i],
                hit_count=1)
        self._stats.misses += 1
        return None

    def invalidate(self, query: str) -> None:
        # exact-match invalidation by stored query text
        try:
            for key in self.client.scan_iter(f"{self.prefix}:entry:*"):
                h = self.client.hget(key.decode(), "query")
                if h is not None and h.decode() == query:
                    self.client.delete(key.decode())
                    self._drop_mirror(key.decode().rsplit(":", 1)[-1])
        except ConnectionError_:
            self._stats.errors += 1

    def clear(self) -> None:
        try:
            keys = [k.decode() for k in
                    self.client.scan_iter(f"{self.prefix}:entry:*")]
            if keys:
                self.client.delete(*keys)
        except ConnectionError_:
            self._stats.errors += 1
        with self._lock:
            self._ids = []
            self._matrix = None
            self._stats.entries = 0

    def stats(self) -> CacheStats:
        return self._stats
