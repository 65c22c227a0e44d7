"""Durable vector store: the in-memory hybrid index mirrored to SQLite.

The port's copy of ``semantic_router_tpu.vectorstore.sqlite_store``: the
same schema and float32 embedding bytes, so each package opens the
other's file.

Reference: pkg/vectorstore with Milvus/Qdrant backends + a Postgres
metadata registry (metadata_registry_postgres.go).  Search stays in-proc
(numpy over the loaded matrix — memory speed, like the reference's local
HNSW over external payloads); documents/chunks/embeddings persist in
SQLite so ingests survive restarts and a new replica warm-starts from the
shared file.  A Milvus/Qdrant client drops in behind the same class."""

from __future__ import annotations

import json
import sqlite3
import threading
from typing import Callable, Dict, Optional

import numpy as np

from .store import Chunk, Document, InMemoryVectorStore

_SCHEMA = """
CREATE TABLE IF NOT EXISTS store_meta (
    key   TEXT PRIMARY KEY,
    value TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS documents (
    doc_id   TEXT PRIMARY KEY,
    name     TEXT NOT NULL,
    text     TEXT NOT NULL,
    metadata TEXT NOT NULL DEFAULT '{}'
);
CREATE TABLE IF NOT EXISTS chunks (
    chunk_id  TEXT PRIMARY KEY,
    doc_id    TEXT NOT NULL,
    idx       INTEGER NOT NULL,
    text      TEXT NOT NULL,
    embedding BLOB,
    metadata  TEXT NOT NULL DEFAULT '{}'
);
CREATE INDEX IF NOT EXISTS idx_chunks_doc ON chunks (doc_id);
"""


class SQLiteVectorStore(InMemoryVectorStore):
    _META_PARAMS = ("chunk_sentences", "overlap_sentences", "hybrid_weight")

    def __init__(self, path: str,
                 embed_fn: Optional[Callable[[str], np.ndarray]] = None,
                 **kwargs) -> None:
        self.path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._db_lock = threading.Lock()
        with self._db_lock:
            self._conn.executescript(_SCHEMA)
            # re-attach restores the store's original chunking/search
            # params; explicit kwargs override and re-persist
            persisted = {k: json.loads(v) for k, v in self._conn.execute(
                "SELECT key, value FROM store_meta").fetchall()}
            params = {k: persisted[k] for k in self._META_PARAMS
                      if k in persisted}
            params.update(kwargs)
            for k in self._META_PARAMS:
                if k in params:
                    self._conn.execute(
                        "INSERT OR REPLACE INTO store_meta VALUES (?,?)",
                        (k, json.dumps(params[k])))
            self._conn.commit()
        super().__init__(embed_fn=embed_fn, **params)
        self._load()

    def _load(self) -> None:
        with self._db_lock:
            doc_rows = self._conn.execute(
                "SELECT doc_id, name, text, metadata FROM documents"
            ).fetchall()
            chunk_rows = self._conn.execute(
                "SELECT chunk_id, doc_id, idx, text, embedding, metadata "
                "FROM chunks ORDER BY idx").fetchall()
        with self._lock:
            for doc_id, name, text, meta in doc_rows:
                self.documents[doc_id] = Document(
                    id=doc_id, name=name, text=text,
                    metadata=json.loads(meta))
            for cid, doc_id, idx, text, emb, meta in chunk_rows:
                chunk = Chunk(
                    id=cid, document_id=doc_id, text=text, index=idx,
                    embedding=np.frombuffer(emb, np.float32)
                    if emb else None,
                    metadata=json.loads(meta))
                self.chunks[cid] = chunk
                doc = self.documents.get(doc_id)
                if doc is not None:
                    doc.chunk_ids.append(cid)

    def ingest(self, name: str, text: str,
               metadata: Optional[Dict[str, str]] = None) -> Document:
        doc = super().ingest(name, text, metadata)
        with self._db_lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO documents VALUES (?,?,?,?)",
                (doc.id, doc.name, doc.text, json.dumps(doc.metadata)))
            for cid in doc.chunk_ids:
                c = self.chunks[cid]
                self._conn.execute(
                    "INSERT OR REPLACE INTO chunks VALUES (?,?,?,?,?,?)",
                    (c.id, c.document_id, c.index, c.text,
                     c.embedding.astype(np.float32).tobytes()
                     if c.embedding is not None else None,
                     json.dumps(c.metadata)))
            self._conn.commit()
        return doc

    def delete_document(self, document_id: str) -> bool:
        ok = super().delete_document(document_id)
        if ok:
            with self._db_lock:
                self._conn.execute("DELETE FROM documents WHERE doc_id = ?",
                                   (document_id,))
                self._conn.execute("DELETE FROM chunks WHERE doc_id = ?",
                                   (document_id,))
                self._conn.commit()
        return ok

    def close(self) -> None:
        with self._db_lock:
            self._conn.close()
