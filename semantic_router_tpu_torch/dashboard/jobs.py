"""The dashboard's durable jobs: a ``JobRunner`` runs registered job kinds
on a pool of daemon workers and records each job's every transition
(pending, running, then done or failed) in a ``JobStore`` — a SQLite file
when given a path, else an in-memory database, the reference package's
table either way.  A job found ``running`` or ``pending`` when a store
opens belonged to a process that ended: it reads ``interrupted``.

The server registers ``selection_benchmark`` (the benchmark runner, then
selector artifacts trained on its corpus) and ``accuracy_eval`` (labelled
queries through the live router); any callable ``params -> result`` may
register.  ``wait(job_id, timeout_s)`` blocks until a job ends.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional

PENDING, RUNNING, DONE, FAILED, INTERRUPTED = (
    "pending", "running", "done", "failed", "interrupted")


@dataclass
class Job:
    job_id: str
    kind: str
    params: Dict[str, Any] = field(default_factory=dict)
    status: str = PENDING
    created_t: float = 0.0
    started_t: float = 0.0
    finished_t: float = 0.0
    result: Optional[Dict[str, Any]] = None
    error: str = ""

    def public(self) -> Dict[str, Any]:
        return asdict(self)


class JobStore:
    """One row per job, rewritten at each transition."""

    _SCHEMA = """
    CREATE TABLE IF NOT EXISTS dashboard_jobs (
        job_id   TEXT PRIMARY KEY,
        kind     TEXT NOT NULL,
        status   TEXT NOT NULL,
        created  REAL NOT NULL,
        payload  TEXT NOT NULL
    )"""

    def __init__(self, path: str = "") -> None:
        self._conn = sqlite3.connect(path or ":memory:",
                                     check_same_thread=False)
        self._lock = threading.Lock()
        self._closed = False
        with self._lock:
            self._conn.execute(self._SCHEMA)
            # jobs are not re-queued at start: an unfinished row read here
            # belonged to a process that ended
            self._conn.execute(
                "UPDATE dashboard_jobs SET status = ? "
                "WHERE status IN (?, ?)",
                (INTERRUPTED, RUNNING, PENDING))
            self._conn.commit()

    def put(self, job: Job) -> None:
        with self._lock:
            if self._closed:
                # a job's last write after shutdown: it reads interrupted
                return
            self._conn.execute(
                "INSERT OR REPLACE INTO dashboard_jobs "
                "(job_id, kind, status, created, payload) "
                "VALUES (?,?,?,?,?)",
                (job.job_id, job.kind, job.status, job.created_t,
                 json.dumps(job.public())))
            self._conn.commit()

    def get(self, job_id: str) -> Optional[Job]:
        with self._lock:
            if self._closed:
                return None
            row = self._conn.execute(
                "SELECT payload, status FROM dashboard_jobs "
                "WHERE job_id = ?", (job_id,)).fetchone()
        if row is None:
            return None
        d = json.loads(row[0])
        d["status"] = row[1]  # the interruption marking wins
        return Job(**d)

    def list(self, limit: int = 50) -> List[Job]:
        with self._lock:
            if self._closed:
                return []
            rows = self._conn.execute(
                "SELECT payload, status FROM dashboard_jobs "
                "ORDER BY created DESC LIMIT ?", (limit,)).fetchall()
        out = []
        for payload, status in rows:
            d = json.loads(payload)
            d["status"] = status
            out.append(Job(**d))
        return out

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._conn.close()


class JobRunner:
    def __init__(self, store: Optional[JobStore] = None,
                 max_workers: int = 2) -> None:
        self.store = store or JobStore()
        self._kinds: Dict[str, Callable[[Dict[str, Any]],
                                        Dict[str, Any]]] = {}
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="dashboard-job")
        self._ended: Dict[str, threading.Event] = {}
        self._ended_lock = threading.Lock()

    def register(self, kind: str,
                 fn: Callable[[Dict[str, Any]], Dict[str, Any]]) -> None:
        self._kinds[kind] = fn

    def kinds(self) -> List[str]:
        return sorted(self._kinds)

    def submit(self, kind: str,
               params: Optional[Dict[str, Any]] = None) -> Job:
        """Queue a job of ``kind``; KeyError for an unknown kind."""
        if kind not in self._kinds:
            raise KeyError(f"unknown job kind {kind!r}")
        job = Job(job_id=uuid.uuid4().hex[:12], kind=kind,
                  params=dict(params or {}), created_t=time.time())
        with self._ended_lock:
            self._ended[job.job_id] = threading.Event()
        self.store.put(job)
        self._pool.submit(self._run, job)
        return job

    def wait(self, job_id: str, timeout_s: float) -> Optional[Job]:
        """The job once it ended (done or failed), or None when it has
        not ended within ``timeout_s`` (or was not submitted here)."""
        with self._ended_lock:
            ended = self._ended.get(job_id)
        if ended is None or not ended.wait(timeout_s):
            return None
        return self.store.get(job_id)

    def _run(self, job: Job) -> None:
        try:
            job.status = RUNNING
            job.started_t = time.time()
            self.store.put(job)
            try:
                job.result = self._kinds[job.kind](job.params)
                job.status = DONE
            except Exception as exc:
                job.status = FAILED
                job.error = f"{type(exc).__name__}: {exc}"[:500]
            job.finished_t = time.time()
            try:
                self.store.put(job)
            except Exception as exc:
                # a result that does not serialize must not leave the row
                # running
                job.status = FAILED
                job.result = None
                job.error = f"result not persistable: {exc}"[:500]
                try:
                    self.store.put(job)
                except Exception:
                    pass
        finally:
            with self._ended_lock:
                ended = self._ended.get(job.job_id)
            if ended is not None:
                ended.set()

    def shutdown(self) -> None:
        """Cancel the queued jobs, let the running ones finish (their
        workers joined), then close the store."""
        self._pool.shutdown(wait=True, cancel_futures=True)
        self.store.close()
