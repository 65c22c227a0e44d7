"""Plane-shared durable decision-record mirror.

The port's copy of ``semantic_router_tpu.stateplane.explain_mirror``.

Same add/list/get/len surface as observability/explain_store.py's
SQLite store — the explainer's ``attach_durable`` cannot tell them
apart — but records land on the state plane, so ``GET /debug/decisions
?source=durable`` on ANY replica serves the fleet's audit trail, and a
replica restart loses nothing (retention = the plane's TTL + the
bounded record cap, whichever trims first).

Cost posture copied from the SQLite mirror: ``add`` rides the
explainer's sink fan-out on the ROUTING thread, so it only appends to a
bounded in-memory queue; a background writer owns the plane round
trips.  A dead plane sheds writes (counted) — the in-proc explain ring
still holds the recent records, exactly the local-fallback posture the
plane promises everywhere else.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .backend import StateBackendUnavailable

QUEUE_CAPACITY = 1024
RETENTION_EVERY = 128


class StatePlaneDecisionStore:
    def __init__(self, plane, max_records: int = 10_000,
                 ttl_s: float = 24 * 3600.0) -> None:
        self.plane = plane
        self.backend = plane.backend
        self.max_records = max_records
        self.ttl_s = ttl_s
        self._queue: deque = deque(maxlen=QUEUE_CAPACITY)
        self.dropped = 0            # queue overflow
        self.shed = 0               # plane-down writes shed
        self._since_retention = 0
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._writer = threading.Thread(target=self._writer_loop,
                                        daemon=True,
                                        name="stateplane-decisions")
        self._writer.start()

    # -- keys ---------------------------------------------------------------

    def _k(self, rid: str) -> str:
        return self.plane.key("decisions", rid)

    # -- write path (request thread: queue append only) ---------------------

    def add(self, record: Dict[str, Any]) -> None:
        if len(self._queue) == self._queue.maxlen:
            self.dropped += 1
        self._queue.append(record)
        self._wake.set()

    # -- background writer ---------------------------------------------------

    def _writer_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=0.5)
            self._wake.clear()
            try:
                self._drain()
            except Exception:
                pass

    def _drain(self) -> int:
        n = 0
        while True:
            try:
                record = self._queue.popleft()
            except IndexError:
                break
            rid = str(record.get("record_id", "")) or f"r{time.time()}"
            payload = json.dumps(record, sort_keys=True,
                                 separators=(",", ":")).encode()
            try:
                self.backend.put(self._k(rid), payload,
                                 ttl_s=self.ttl_s or None)
            except StateBackendUnavailable:
                self.shed += 1
                continue  # fail open; the in-proc ring still has it
            n += 1
            self._since_retention += 1
        if self._since_retention >= RETENTION_EVERY:
            self._since_retention = 0
            try:
                self._trim()
            except StateBackendUnavailable:
                pass
        return n

    def _trim(self) -> None:
        """Bounded retention: drop the oldest records past
        ``max_records`` (amortized to once per RETENTION_EVERY writes,
        and O(records) only then)."""
        keys = self.backend.scan(self.plane.key("decisions", ""))
        overflow = len(keys) - self.max_records
        if overflow <= 0:
            return
        rows = []
        for k in keys:
            raw = self.backend.get(k)
            if not raw:
                continue
            try:
                ts = float(json.loads(raw).get("ts_unix", 0.0))
            except (ValueError, UnicodeDecodeError):
                ts = 0.0
            rows.append((ts, k))
        rows.sort()
        stale = [k for _, k in rows[:overflow]]
        if stale:
            self.backend.delete(*stale)

    # -- reads ---------------------------------------------------------------

    def _all_records(self) -> List[Dict[str, Any]]:
        out = []
        for k in self.backend.scan(self.plane.key("decisions", "")):
            raw = self.backend.get(k)
            if not raw:
                continue
            try:
                out.append(json.loads(raw))
            except (ValueError, UnicodeDecodeError):
                continue
        out.sort(key=lambda r: -float(r.get("ts_unix", 0.0)))
        return out

    def list(self, limit: int = 50, model: str = "", decision: str = "",
             kind: str = "", since: float = 0.0, rule: str = "",
             family: str = "") -> List[Dict[str, Any]]:
        self._drain()
        limit = max(0, int(limit))
        if limit == 0:
            return []
        out: List[Dict[str, Any]] = []
        try:
            records = self._all_records()
        except StateBackendUnavailable:
            return []
        for rec in records:
            if since and float(rec.get("ts_unix", 0.0)) < since:
                continue
            if model and rec.get("model") != model:
                continue
            dec = (rec.get("decision") or {})
            if decision and (dec.get("name", "")
                             if isinstance(dec, dict) else "") != decision:
                continue
            if kind and rec.get("kind") != kind:
                continue
            if rule and rule not in (dec.get("matched_rules", ())
                                     if isinstance(dec, dict) else ()):
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
        self._drain()
        try:
            raw = self.backend.get(self._k(key))
            if raw:
                return json.loads(raw)
            # trace-id fallback: the same dual lookup every other
            # decision store serves
            for rec in self._all_records():
                if rec.get("trace_id") == key:
                    return rec
        except StateBackendUnavailable:
            return None
        return None

    def __len__(self) -> int:
        self._drain()
        try:
            return len(self.backend.scan(self.plane.key("decisions", "")))
        except StateBackendUnavailable:
            return 0

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        self._writer.join(timeout=2.0)
        try:
            self._drain()
        except Exception:
            pass
