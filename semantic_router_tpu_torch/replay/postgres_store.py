"""The replay store in a Postgres table, over the port's wire client
(``state/postgres.py``): the surface of ``ReplayStore`` (add / list /
get / len, and close), the reference package's table, every statement
on the extended protocol (``$N`` parameters, so no payload text is
spliced into SQL)."""

from __future__ import annotations

import json
from dataclasses import asdict
from typing import List, Optional

from ..state.postgres import PostgresClient
from .recorder import ReplayRecord

_SCHEMA = [
    """CREATE TABLE IF NOT EXISTS replay_records (
        record_id   TEXT PRIMARY KEY,
        request_id  TEXT NOT NULL,
        timestamp   DOUBLE PRECISION NOT NULL,
        decision    TEXT NOT NULL DEFAULT '',
        model       TEXT NOT NULL DEFAULT '',
        kind        TEXT NOT NULL DEFAULT 'route',
        payload     TEXT NOT NULL
    )""",
    "CREATE INDEX IF NOT EXISTS idx_replay_ts ON replay_records "
    "(timestamp)",
    "CREATE INDEX IF NOT EXISTS idx_replay_decision ON replay_records "
    "(decision)",
    "CREATE INDEX IF NOT EXISTS idx_replay_model ON replay_records "
    "(model)",
]


class PostgresReplayStore:
    """The newest ``max_records`` records in ``replay_records``, over
    ``client`` or a client of its own on (host, port, user, database,
    password)."""

    def __init__(self, client: Optional[PostgresClient] = None,
                 host: str = "127.0.0.1", port: int = 5432,
                 user: str = "postgres", database: str = "postgres",
                 password: str = "", max_records: int = 100_000) -> None:
        self.client = client or PostgresClient(
            host=host, port=port, user=user, database=database,
            password=password)
        self.max_records = max_records
        for stmt in _SCHEMA:
            self.client.query(stmt)

    def add(self, record: ReplayRecord) -> None:
        payload = json.dumps(asdict(record))
        self.client.execute(
            "INSERT INTO replay_records (record_id, request_id, "
            "timestamp, decision, model, kind, payload) "
            "VALUES ($1,$2,$3,$4,$5,$6,$7) "
            "ON CONFLICT (record_id) DO UPDATE SET payload = $7",
            (record.record_id, record.request_id, record.timestamp,
             record.decision, record.model, record.kind, payload))
        # Postgres has no LIMIT -1: a bare OFFSET keeps the newest N
        self.client.execute(
            "DELETE FROM replay_records WHERE record_id IN ("
            "SELECT record_id FROM replay_records ORDER BY timestamp "
            "DESC OFFSET $1)", (self.max_records,))

    def list(self, limit: int = 100, decision: str = "",
             model: str = "", since: float = 0.0) -> List[ReplayRecord]:
        q = "SELECT payload FROM replay_records WHERE timestamp >= $1"
        args: list = [since]
        if decision:
            args.append(decision)
            q += f" AND decision = ${len(args)}"
        if model:
            args.append(model)
            q += f" AND model = ${len(args)}"
        args.append(limit)
        q += f" ORDER BY timestamp DESC LIMIT ${len(args)}"
        res = self.client.execute(q, args)
        return [ReplayRecord(**json.loads(r[0])) for r in res.rows
                if r and r[0] is not None]

    def get(self, record_id: str) -> Optional[ReplayRecord]:
        res = self.client.execute(
            "SELECT payload FROM replay_records WHERE record_id = $1",
            (record_id,))
        if not res.rows or res.rows[0][0] is None:
            return None
        return ReplayRecord(**json.loads(res.rows[0][0]))

    def __len__(self) -> int:
        res = self.client.execute("SELECT COUNT(*) FROM replay_records")
        return int(res.scalar() or 0)

    def close(self) -> None:
        self.client.close()
