"""Durable decision-record backend (SQLite).

The explain ring (observability/explain.py) is bounded and in-process:
a restart — or just enough traffic — erases the audit trail an incident
review needs.  This store (the port's copy of the reference's
``observability/explain_store.py``: add/list/get/len, a JSON payload
column, bounded retention) makes
``observability.decisions.durable: {backend: sqlite, path: ...}`` give
decision records a durable mirror, and
``GET /debug/decisions?source=durable`` serves post-restart audits.

Cost posture: ``add`` rides the explainer's sink fan-out on the ROUTING
thread, so it must never pay a disk transaction there — it appends to a
bounded in-memory queue (overflow drops oldest, counted) and a
background writer owns the INSERT/COMMIT.  Retention (the
O(max_records) ORDER-BY walk) runs once per ``RETENTION_EVERY`` writes,
not per record.  Reads drain the queue first, so a record is queryable
the moment its response left the router — no flush race for audits.
"""

from __future__ import annotations

import json
import sqlite3
import threading
from collections import deque
from typing import Any, Dict, List, Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS decision_records (
    record_id   TEXT PRIMARY KEY,
    trace_id    TEXT NOT NULL DEFAULT '',
    request_id  TEXT NOT NULL DEFAULT '',
    ts_unix     REAL NOT NULL,
    kind        TEXT NOT NULL DEFAULT 'route',
    model       TEXT NOT NULL DEFAULT '',
    decision    TEXT NOT NULL DEFAULT '',
    payload     TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_decision_ts ON decision_records (ts_unix);
CREATE INDEX IF NOT EXISTS idx_decision_model ON decision_records (model);
CREATE INDEX IF NOT EXISTS idx_decision_name ON decision_records (decision);
CREATE INDEX IF NOT EXISTS idx_decision_trace ON decision_records (trace_id);
"""

QUEUE_CAPACITY = 1024
RETENTION_EVERY = 128


class SQLiteDecisionStore:
    """Durable mirror of the explain ring: queue-buffered writes on the
    request path, one background writer, bounded by ``max_records``."""

    def __init__(self, path: str, max_records: int = 100_000) -> None:
        self.path = path
        self.max_records = max_records
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()          # guards the connection
        self._queue: deque = deque(maxlen=QUEUE_CAPACITY)
        self.dropped = 0                        # queue-overflow count
        self._since_retention = 0
        self._wake = threading.Event()
        self._stop = threading.Event()
        with self._lock:
            # WAL keeps the writer's commits off readers' critical path
            try:
                self._conn.execute("PRAGMA journal_mode=WAL")
            except sqlite3.Error:
                pass
            self._conn.executescript(_SCHEMA)
            self._conn.commit()
        self._writer = threading.Thread(target=self._writer_loop,
                                        daemon=True,
                                        name="decision-store-writer")
        self._writer.start()

    # -- write path (request thread: queue append only) -------------------

    def add(self, record: Dict[str, Any]) -> None:
        if len(self._queue) == self._queue.maxlen:
            self.dropped += 1  # bounded: a slow disk sheds, never blocks
        self._queue.append(record)
        self._wake.set()

    # -- background writer -------------------------------------------------

    def _writer_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=0.5)
            self._wake.clear()
            try:
                self._drain()
            except Exception:
                pass  # a sick disk must not kill the thread

    def _drain(self) -> int:
        """Flush queued records into the table; retention amortized to
        once per RETENTION_EVERY rows.  Called by the writer thread and
        (synchronously) by every read, so queries always see the
        records already handed to add()."""
        n = 0
        with self._lock:
            while True:
                try:
                    record = self._queue.popleft()
                except IndexError:
                    break
                self._insert_locked(record)
                n += 1
                self._since_retention += 1
            if n:
                if self._since_retention >= RETENTION_EVERY:
                    self._since_retention = 0
                    self._conn.execute(
                        "DELETE FROM decision_records WHERE record_id IN ("
                        "SELECT record_id FROM decision_records ORDER BY "
                        "ts_unix DESC LIMIT -1 OFFSET ?)",
                        (self.max_records,))
                self._conn.commit()
        return n

    def _insert_locked(self, record: Dict[str, Any]) -> None:
        payload = json.dumps(record, sort_keys=True,
                             separators=(",", ":"))
        decision = (record.get("decision") or {}).get("name", "") \
            if isinstance(record.get("decision"), dict) else ""
        self._conn.execute(
            "INSERT OR REPLACE INTO decision_records "
            "(record_id, trace_id, request_id, ts_unix, kind, model, "
            "decision, payload) VALUES (?,?,?,?,?,?,?,?)",
            (str(record.get("record_id", "")),
             str(record.get("trace_id", "")),
             str(record.get("request_id", "")),
             float(record.get("ts_unix", 0.0)),
             str(record.get("kind", "")),
             str(record.get("model", "")),
             decision, payload))

    # -- reads -------------------------------------------------------------

    def list(self, limit: int = 50, model: str = "", decision: str = "",
             kind: str = "", since: float = 0.0, rule: str = "",
             family: str = "") -> List[Dict[str, Any]]:
        """Newest-first filtered listing — the same filter surface the
        in-process ring serves.  ``model``/``decision``/``kind`` push
        down to indexed SQL; ``rule``/``family`` live inside the JSON
        payload, so they filter while walking the cursor lazily (stops
        at ``limit`` matches, never materializes the table)."""
        self._drain()
        limit = max(0, int(limit))
        if limit == 0:
            return []
        q = "SELECT payload FROM decision_records WHERE ts_unix >= ?"
        args: list = [since]
        if model:
            q += " AND model = ?"
            args.append(model)
        if decision:
            q += " AND decision = ?"
            args.append(decision)
        if kind:
            q += " AND kind = ?"
            args.append(kind)
        q += " ORDER BY ts_unix DESC"
        out: List[Dict[str, Any]] = []
        with self._lock:
            cursor = self._conn.execute(q, args)
            while len(out) < limit:
                rows = cursor.fetchmany(max(limit, 64))
                if not rows:
                    break
                for (payload,) in rows:
                    rec = json.loads(payload)
                    if rule and rule not in (rec.get("decision") or {}
                                             ).get("matched_rules", ()):
                        continue
                    if family:
                        row = rec.get("signals", {}).get(family)
                        if not row or not row.get("hits"):
                            continue
                    out.append(rec)
                    if len(out) >= limit:
                        break
        return out

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        """Record by record id OR trace id — the same dual lookup the
        in-process ring serves."""
        self._drain()
        with self._lock:
            row = self._conn.execute(
                "SELECT payload FROM decision_records WHERE record_id = ?",
                (key,)).fetchone()
            if row is None:
                row = self._conn.execute(
                    "SELECT payload FROM decision_records WHERE "
                    "trace_id = ? ORDER BY ts_unix DESC LIMIT 1",
                    (key,)).fetchone()
        return json.loads(row[0]) if row else None

    def __len__(self) -> int:
        self._drain()
        with self._lock:
            return self._conn.execute(
                "SELECT COUNT(*) FROM decision_records").fetchone()[0]

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        self._writer.join(timeout=2.0)
        try:
            self._drain()
        except Exception:
            pass
        with self._lock:
            self._conn.close()
