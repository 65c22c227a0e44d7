"""Postgres-backed vectorstore metadata registry.

The port's copy of ``semantic_router_tpu.vectorstore.pg_registry``: the
same tables and statements, so a registry one package's manager wrote is
attached by the other's.

Reference role: pkg/vectorstore/metadata_registry_postgres.go — the
``vector_store_registry`` / ``file_registry`` tables that record which
named stores and ingested files exist, so a restarted router re-attaches
its stores at boot (``LoadFromRegistry``, SURVEY.md §5 checkpoint/resume
row). Runs over the zero-dependency v3 wire client (state/postgres.py);
every statement uses extended-protocol $N parameters.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

from ..state.postgres import PostgresClient

_SCHEMA = [
    """CREATE TABLE IF NOT EXISTS vector_store_registry (
        name       TEXT PRIMARY KEY,
        backend    TEXT NOT NULL DEFAULT '',
        config     TEXT NOT NULL DEFAULT '{}',
        created_at DOUBLE PRECISION NOT NULL
    )""",
    """CREATE TABLE IF NOT EXISTS file_registry (
        file_id    TEXT PRIMARY KEY,
        store_name TEXT NOT NULL,
        name       TEXT NOT NULL DEFAULT '',
        chunks     INTEGER NOT NULL DEFAULT 0,
        metadata   TEXT NOT NULL DEFAULT '{}',
        created_at DOUBLE PRECISION NOT NULL
    )""",
    "CREATE INDEX IF NOT EXISTS idx_file_store ON file_registry "
    "(store_name)",
]


class PostgresMetadataRegistry:
    def __init__(self, client: Optional[PostgresClient] = None,
                 host: str = "127.0.0.1", port: int = 5432,
                 user: str = "postgres", database: str = "postgres",
                 password: str = "") -> None:
        self.client = client or PostgresClient(
            host=host, port=port, user=user, database=database,
            password=password)
        for stmt in _SCHEMA:
            self.client.query(stmt)

    # -- stores --------------------------------------------------------

    def register_store(self, name: str, backend: str = "",
                       config: Optional[Dict] = None) -> None:
        self.client.execute(
            "INSERT INTO vector_store_registry (name, backend, config, "
            "created_at) VALUES ($1,$2,$3,$4) "
            "ON CONFLICT (name) DO UPDATE SET backend = $2, config = $3",
            (name, backend, json.dumps(config or {}), time.time()))

    def unregister_store(self, name: str) -> None:
        self.client.execute(
            "DELETE FROM file_registry WHERE store_name = $1", (name,))
        self.client.execute(
            "DELETE FROM vector_store_registry WHERE name = $1", (name,))

    def list_stores(self) -> List[str]:
        res = self.client.execute(
            "SELECT name FROM vector_store_registry ORDER BY name")
        return [r[0] for r in res.rows if r and r[0] is not None]

    # -- files ---------------------------------------------------------

    def register_file(self, store_name: str, file_id: str,
                      name: str = "", chunks: int = 0,
                      metadata: Optional[Dict] = None) -> None:
        self.client.execute(
            "INSERT INTO file_registry (file_id, store_name, name, "
            "chunks, metadata, created_at) VALUES ($1,$2,$3,$4,$5,$6) "
            "ON CONFLICT (file_id) DO UPDATE SET chunks = $4, "
            "metadata = $5",
            (file_id, store_name, name, chunks,
             json.dumps(metadata or {}), time.time()))

    def list_files(self, store_name: str) -> List[Dict]:
        res = self.client.execute(
            "SELECT file_id, name, chunks, metadata FROM file_registry "
            "WHERE store_name = $1 ORDER BY created_at", (store_name,))
        return [{"file_id": r[0], "name": r[1],
                 "chunks": int(r[2] or 0),
                 "metadata": json.loads(r[3] or "{}")}
                for r in res.rows]

    def close(self) -> None:
        self.client.close()
