"""Durable user-memory store (``memory.backend: sqlite``, stdlib
``sqlite3``).  The in-memory hybrid store's behavior (PII sanitize,
dedup / consolidation, eviction) is kept by delegating to
InMemoryMemoryStore and mirroring the touched user's state after each
change to SQLite, so a restart recovers every user's memories from the
file.  The port's copy of the JAX package's ``memory/sqlite_store.py``,
with the same table (a file written by one package loads in the other)."""

from __future__ import annotations

import json
import sqlite3
import threading
from typing import Callable, Optional

import numpy as np

from .store import InMemoryMemoryStore, MemoryItem

_SCHEMA = """
CREATE TABLE IF NOT EXISTS memories (
    memory_id    TEXT PRIMARY KEY,
    user_id      TEXT NOT NULL,
    text         TEXT NOT NULL,
    kind         TEXT NOT NULL DEFAULT 'fact',
    created_t    REAL NOT NULL,
    last_access_t REAL NOT NULL,
    access_count INTEGER NOT NULL DEFAULT 0,
    embedding    BLOB,
    metadata     TEXT NOT NULL DEFAULT '{}'
);
CREATE INDEX IF NOT EXISTS idx_memories_user ON memories (user_id);
"""


class SQLiteMemoryStore(InMemoryMemoryStore):
    def __init__(self, path: str,
                 embed_fn: Optional[Callable[[str], np.ndarray]] = None,
                 **kwargs) -> None:
        super().__init__(embed_fn=embed_fn, **kwargs)
        self.path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._db_lock = threading.Lock()
        with self._db_lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()
        self._load()

    def _load(self) -> None:
        with self._db_lock:
            rows = self._conn.execute(
                "SELECT memory_id, user_id, text, kind, created_t, "
                "last_access_t, access_count, embedding, metadata "
                "FROM memories").fetchall()
        with self._lock:
            for (mid, uid, text, kind, created, accessed, count, emb,
                 meta) in rows:
                item = MemoryItem(
                    id=mid, user_id=uid, text=text, kind=kind,
                    embedding=np.frombuffer(emb, np.float32)
                    if emb else None,
                    created_t=created, last_access_t=accessed,
                    access_count=count, metadata=json.loads(meta))
                self._items.setdefault(uid, []).append(item)

    def _persist_user(self, user_id: str) -> None:
        """Mirror the user's full post-mutation state (dedup refreshes and
        evictions in the parent make row-level deltas unreliable)."""
        with self._lock:
            items = list(self._items.get(user_id, ()))
        with self._db_lock:
            self._conn.execute("DELETE FROM memories WHERE user_id = ?",
                               (user_id,))
            for it in items:
                self._conn.execute(
                    "INSERT OR REPLACE INTO memories VALUES "
                    "(?,?,?,?,?,?,?,?,?)",
                    (it.id, it.user_id, it.text, it.kind, it.created_t,
                     it.last_access_t, it.access_count,
                     it.embedding.astype(np.float32).tobytes()
                     if it.embedding is not None else None,
                     json.dumps(it.metadata)))
            self._conn.commit()

    def add(self, item: MemoryItem) -> None:
        super().add(item)
        self._persist_user(item.user_id)

    def delete(self, user_id: str, memory_id: str) -> bool:
        ok = super().delete(user_id, memory_id)
        if ok:
            self._persist_user(user_id)
        return ok

    def close(self) -> None:
        with self._db_lock:
            self._conn.close()
