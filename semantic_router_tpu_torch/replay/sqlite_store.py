"""The replay store on a SQLite file: the surface of ``ReplayStore``
(add / list / get / len, and close) over one table whose rows hold the
record as JSON beside its indexed columns — the reference package's
schema, so either package opens the other's file."""

from __future__ import annotations

import json
import sqlite3
import threading
from dataclasses import asdict
from typing import List, Optional

from .recorder import ReplayRecord

_SCHEMA = """
CREATE TABLE IF NOT EXISTS replay_records (
    record_id   TEXT PRIMARY KEY,
    request_id  TEXT NOT NULL,
    timestamp   REAL NOT NULL,
    decision    TEXT NOT NULL DEFAULT '',
    model       TEXT NOT NULL DEFAULT '',
    kind        TEXT NOT NULL DEFAULT 'route',
    payload     TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_replay_ts ON replay_records (timestamp);
CREATE INDEX IF NOT EXISTS idx_replay_decision ON replay_records (decision);
CREATE INDEX IF NOT EXISTS idx_replay_model ON replay_records (model);
"""


class SQLiteReplayStore:
    """The newest ``max_records`` records in the file at ``path``."""

    def __init__(self, path: str, max_records: int = 100_000) -> None:
        self.path = path
        self.max_records = max_records
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    def add(self, record: ReplayRecord) -> None:
        payload = json.dumps(asdict(record))
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO replay_records "
                "(record_id, request_id, timestamp, decision, model, kind, "
                "payload) VALUES (?,?,?,?,?,?,?)",
                (record.record_id, record.request_id, record.timestamp,
                 record.decision, record.model, record.kind, payload))
            self._conn.execute(
                "DELETE FROM replay_records WHERE record_id IN ("
                "SELECT record_id FROM replay_records ORDER BY timestamp "
                "DESC LIMIT -1 OFFSET ?)", (self.max_records,))
            self._conn.commit()

    def list(self, limit: int = 100, decision: str = "",
             model: str = "", since: float = 0.0) -> List[ReplayRecord]:
        q = "SELECT payload FROM replay_records WHERE timestamp >= ?"
        args: list = [since]
        if decision:
            q += " AND decision = ?"
            args.append(decision)
        if model:
            q += " AND model = ?"
            args.append(model)
        q += " ORDER BY timestamp DESC LIMIT ?"
        args.append(limit)
        with self._lock:
            rows = self._conn.execute(q, args).fetchall()
        return [ReplayRecord(**json.loads(r[0])) for r in rows]

    def get(self, record_id: str) -> Optional[ReplayRecord]:
        with self._lock:
            row = self._conn.execute(
                "SELECT payload FROM replay_records WHERE record_id = ?",
                (record_id,)).fetchone()
        return ReplayRecord(**json.loads(row[0])) if row else None

    def __len__(self) -> int:
        with self._lock:
            return self._conn.execute(
                "SELECT COUNT(*) FROM replay_records").fetchone()[0]

    def close(self) -> None:
        with self._lock:
            self._conn.close()
