"""StateBackend: the one seam every shared-state consumer plugs behind.

The port's copy of ``semantic_router_tpu.stateplane.backend``.  The
narrow KV+hash surface the shared subsystems (semantic cache, explain
mirror, shed ladder, upstream circuits) need, with three
implementations:

- :class:`InMemoryStateBackend` — dict-backed, single process (the
  ``enabled=false``-equivalent posture and the unit-test default);
- :class:`RespStateBackend` — any Redis/Valkey/KeyDB server through the
  existing zero-dependency RESP2 client (``state/resp.py``), including
  the embedded :class:`~..state.resp.MiniRedis` for dev/test fleets;
- :class:`SQLiteStateBackend` — one WAL-mode file shared by N local
  processes; the multi-replica-on-one-host and CI posture.

:class:`GuardedBackend` wraps any of them with the failure policy the
plane promises: every operation failure raises ONE exception type
(:class:`StateBackendUnavailable`), trips a circuit breaker so the next
requests fail in nanoseconds instead of a TCP timeout each, and a
cooldown later lets a single probe through; on success the registered
``on_recover`` callbacks fire (mirror resync, pending-write replay) —
that is how "backend killed mid-run" degrades to local state with zero
request failures and re-attaches cleanly when it returns.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Protocol


class StateBackendUnavailable(Exception):
    """The one failure type plane consumers catch (fail-open)."""


class StateBackend(Protocol):
    """Narrow KV+hash contract (bytes values; prefix scan; TTL)."""

    def ping(self) -> bool: ...

    def put(self, key: str, value: bytes,
            ttl_s: Optional[float] = None) -> None: ...

    def get(self, key: str) -> Optional[bytes]: ...

    def delete(self, *keys: str) -> int: ...

    def put_hash(self, key: str, mapping: Dict[str, bytes],
                 ttl_s: Optional[float] = None) -> None: ...

    def get_hash(self, key: str) -> Dict[str, bytes]: ...

    def scan(self, prefix: str) -> List[str]: ...

    def incr(self, key: str, by: int = 1) -> int: ...

    def close(self) -> None: ...


def _to_bytes(v) -> bytes:
    if isinstance(v, bytes):
        return v
    return str(v).encode()


# ---------------------------------------------------------------------------
# in-memory
# ---------------------------------------------------------------------------


class InMemoryStateBackend:
    """Process-local backend: the dev/unit-test posture.  TTL is lazy
    (checked on access) like MiniRedis."""

    def __init__(self) -> None:
        self._data: Dict[str, object] = {}
        self._expiry: Dict[str, float] = {}
        self._lock = threading.Lock()

    def _alive(self, key: str) -> bool:
        exp = self._expiry.get(key)
        if exp is not None and exp <= time.monotonic():
            self._data.pop(key, None)
            self._expiry.pop(key, None)
            return False
        return key in self._data

    def ping(self) -> bool:
        return True

    def put(self, key: str, value: bytes,
            ttl_s: Optional[float] = None) -> None:
        with self._lock:
            self._data[key] = bytes(value)
            if ttl_s:
                self._expiry[key] = time.monotonic() + float(ttl_s)
            else:
                self._expiry.pop(key, None)

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            if not self._alive(key):
                return None
            v = self._data[key]
            return v if isinstance(v, bytes) else None

    def delete(self, *keys: str) -> int:
        n = 0
        with self._lock:
            for key in keys:
                if self._alive(key):
                    del self._data[key]
                    self._expiry.pop(key, None)
                    n += 1
        return n

    def put_hash(self, key: str, mapping: Dict[str, bytes],
                 ttl_s: Optional[float] = None) -> None:
        with self._lock:
            h = self._data.get(key) if self._alive(key) else None
            if not isinstance(h, dict):
                h = {}
            h.update({k: _to_bytes(v) for k, v in mapping.items()})
            self._data[key] = h
            if ttl_s:
                self._expiry[key] = time.monotonic() + float(ttl_s)

    def get_hash(self, key: str) -> Dict[str, bytes]:
        with self._lock:
            if not self._alive(key):
                return {}
            h = self._data.get(key)
            return dict(h) if isinstance(h, dict) else {}

    def scan(self, prefix: str) -> List[str]:
        with self._lock:
            return sorted(k for k in list(self._data)
                          if k.startswith(prefix) and self._alive(k))

    def incr(self, key: str, by: int = 1) -> int:
        with self._lock:
            cur = 0
            if self._alive(key):
                v = self._data.get(key)
                try:
                    cur = int(v) if not isinstance(v, dict) else 0
                except (TypeError, ValueError):
                    cur = 0
            cur += by
            self._data[key] = str(cur).encode()
            return cur

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# RESP (Redis / Valkey / MiniRedis)
# ---------------------------------------------------------------------------


class RespStateBackend:
    """Any RESP2 server through the existing state/resp.py client."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 db: int = 0, password: str = "",
                 timeout_s: float = 5.0, client=None) -> None:
        from ..state.resp import RedisClient

        self.client = client or RedisClient(host, port, db, password,
                                            timeout_s=timeout_s)

    def ping(self) -> bool:
        return self.client.ping()

    def put(self, key: str, value: bytes,
            ttl_s: Optional[float] = None) -> None:
        if ttl_s:
            self.client.execute("SET", key, value, "PX",
                                max(1, int(float(ttl_s) * 1000)))
        else:
            self.client.execute("SET", key, value)

    def get(self, key: str) -> Optional[bytes]:
        return self.client.get(key)

    def delete(self, *keys: str) -> int:
        return self.client.delete(*keys) if keys else 0

    def put_hash(self, key: str, mapping: Dict[str, bytes],
                 ttl_s: Optional[float] = None) -> None:
        self.client.hset(key, {k: _to_bytes(v)
                               for k, v in mapping.items()})
        if ttl_s:
            self.client.expire(key, max(1, int(float(ttl_s))))

    def get_hash(self, key: str) -> Dict[str, bytes]:
        return {k.decode(): v
                for k, v in self.client.hgetall(key).items()}

    def scan(self, prefix: str) -> List[str]:
        # escape glob metacharacters in the prefix so a literal '*'/'['
        # in a key namespace cannot widen the match
        esc = "".join(f"[{c}]" if c in "*?[]" else c for c in prefix)
        return sorted(k.decode() for k in
                      self.client.scan_iter(f"{esc}*"))

    def incr(self, key: str, by: int = 1) -> int:
        return self.client.incr(key, by)

    def close(self) -> None:
        self.client.close()


# ---------------------------------------------------------------------------
# SQLite (file shared by N local processes)
# ---------------------------------------------------------------------------

_SQLITE_SCHEMA = """
CREATE TABLE IF NOT EXISTS state_entries (
    key     TEXT NOT NULL,
    field   TEXT NOT NULL DEFAULT '',
    value   BLOB NOT NULL,
    expires REAL,
    PRIMARY KEY (key, field)
);
"""


class SQLiteStateBackend:
    """One WAL-mode DB file as the plane store: N replicas on one host
    (or CI) share it the way they would share a Redis.  Plain KV rows
    use field='' ; hash fields get one row each."""

    def __init__(self, path: str, busy_timeout_ms: int = 5000) -> None:
        import sqlite3

        self.path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            try:
                self._conn.execute("PRAGMA journal_mode=WAL")
            except Exception:
                pass
            self._conn.execute(f"PRAGMA busy_timeout={busy_timeout_ms}")
            self._conn.executescript(_SQLITE_SCHEMA)
            self._conn.commit()

    @staticmethod
    def _exp(ttl_s: Optional[float]) -> Optional[float]:
        return time.time() + float(ttl_s) if ttl_s else None

    def _live_clause(self) -> str:
        return "(expires IS NULL OR expires > ?)"

    def ping(self) -> bool:
        with self._lock:
            self._conn.execute("SELECT 1").fetchone()
        return True

    def put(self, key: str, value: bytes,
            ttl_s: Optional[float] = None) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO state_entries "
                "(key, field, value, expires) VALUES (?, '', ?, ?)",
                (key, bytes(value), self._exp(ttl_s)))
            self._conn.commit()

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM state_entries WHERE key=? AND "
                f"field='' AND {self._live_clause()}",
                (key, time.time())).fetchone()
        return bytes(row[0]) if row else None

    def delete(self, *keys: str) -> int:
        if not keys:
            return 0
        with self._lock:
            n = 0
            for key in keys:
                cur = self._conn.execute(
                    "DELETE FROM state_entries WHERE key=?", (key,))
                n += 1 if cur.rowcount else 0
            self._conn.commit()
        return n

    def put_hash(self, key: str, mapping: Dict[str, bytes],
                 ttl_s: Optional[float] = None) -> None:
        exp = self._exp(ttl_s)
        with self._lock:
            for f, v in mapping.items():
                self._conn.execute(
                    "INSERT OR REPLACE INTO state_entries "
                    "(key, field, value, expires) VALUES (?, ?, ?, ?)",
                    (key, str(f), _to_bytes(v), exp))
            self._conn.commit()

    def get_hash(self, key: str) -> Dict[str, bytes]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT field, value FROM state_entries WHERE key=? AND "
                f"field != '' AND {self._live_clause()}",
                (key, time.time())).fetchall()
        return {f: bytes(v) for f, v in rows}

    def scan(self, prefix: str) -> List[str]:
        esc = prefix.replace("\\", "\\\\").replace("%", "\\%") \
            .replace("_", "\\_")
        with self._lock:
            rows = self._conn.execute(
                "SELECT DISTINCT key FROM state_entries WHERE key LIKE ? "
                f"ESCAPE '\\' AND {self._live_clause()}",
                (esc + "%", time.time())).fetchall()
        return sorted(r[0] for r in rows)

    def incr(self, key: str, by: int = 1) -> int:
        with self._lock:
            # BEGIN IMMEDIATE holds the write lock across the
            # read-modify-write so concurrent increments from SIBLING
            # PROCESSES serialize too (the threading.Lock only covers
            # this one); version counters must never lose a bump or
            # sibling replicas stop resyncing their mirrors
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                row = self._conn.execute(
                    "SELECT value FROM state_entries WHERE key=? AND "
                    f"field='' AND {self._live_clause()}",
                    (key, time.time())).fetchone()
                try:
                    cur = int(row[0]) if row else 0
                except (TypeError, ValueError):
                    cur = 0
                cur += by
                self._conn.execute(
                    "INSERT OR REPLACE INTO state_entries "
                    "(key, field, value, expires) VALUES (?, '', ?, NULL)",
                    (key, str(cur).encode()))
                self._conn.commit()
            except Exception:
                self._conn.rollback()
                raise
        return cur

    def close(self) -> None:
        with self._lock:
            self._conn.close()


# ---------------------------------------------------------------------------
# guarded wrapper (circuit breaker + recovery hooks)
# ---------------------------------------------------------------------------

_OPS = ("ping", "put", "get", "delete", "put_hash", "get_hash", "scan",
        "incr")


class GuardedBackend:
    """Failure containment around any StateBackend.

    - Every inner-call exception becomes :class:`StateBackendUnavailable`
      and OPENS the breaker; while open, calls raise immediately (no
      per-request connect timeouts on a dead plane).
    - After ``cooldown_s`` one probe call passes through; success CLOSES
      the breaker and fires the ``on_recover`` callbacks so consumers
      resync their mirrors / replay buffered writes.
    """

    def __init__(self, inner, cooldown_s: float = 2.0,
                 on_error: Optional[Callable[[str], None]] = None) -> None:
        self.inner = inner
        self.cooldown_s = max(0.05, float(cooldown_s))
        self.on_error = on_error
        self._lock = threading.Lock()
        self._open_until = 0.0
        self._probing = False
        self.available = True
        self.errors = 0
        self.last_error = ""
        self.roundtrips = 0
        self.roundtrip_s_total = 0.0
        self._recover_cbs: List[Callable[[], None]] = []

    def on_recover(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._recover_cbs.append(fn)

    def off_recover(self, fn: Callable[[], None]) -> None:
        """Unregister a recovery callback (no-op when absent) — a
        consumer that rebinds/closes must unhook, or superseded objects
        stay alive and keep firing on every recovery."""
        with self._lock:
            try:
                self._recover_cbs.remove(fn)
            except ValueError:
                pass

    def _admit(self) -> None:
        """Breaker gate: closed → go; open → fail fast, except ONE
        probe per cooldown window."""
        now = time.monotonic()
        with self._lock:
            if self.available:
                return
            if now >= self._open_until and not self._probing:
                self._probing = True  # this caller is the probe
                return
        raise StateBackendUnavailable(
            f"state backend down ({self.last_error})")

    def _ok(self) -> None:
        fire = False
        with self._lock:
            if not self.available:
                self.available = True
                fire = True
            self._probing = False
        if fire:
            # recovery work (pending-write replay, mirror resync) is
            # seconds of round trips — the successful probe is often a
            # ROUTING thread, which must not pay for it.  One daemon
            # thread per recovery event (rare by construction).
            cbs = list(self._recover_cbs)

            def _recover() -> None:
                for fn in cbs:
                    try:
                        fn()
                    except Exception:
                        pass

            threading.Thread(target=_recover, daemon=True,
                             name="stateplane-recover").start()

    def _fail(self, exc: Exception) -> None:
        with self._lock:
            self.available = False
            self._probing = False
            self.errors += 1
            self.last_error = f"{type(exc).__name__}: {exc}"[:200]
            self._open_until = time.monotonic() + self.cooldown_s
        if self.on_error is not None:
            try:
                self.on_error(self.last_error)
            except Exception:
                pass

    def _call(self, op: str, *args, **kwargs):
        self._admit()
        t0 = time.perf_counter()
        try:
            out = getattr(self.inner, op)(*args, **kwargs)
        except StateBackendUnavailable:
            raise
        except Exception as exc:
            self._fail(exc)
            raise StateBackendUnavailable(
                f"state backend {op} failed: "
                f"{type(exc).__name__}: {exc}") from exc
        dt = time.perf_counter() - t0
        with self._lock:
            # replica threads share one guarded backend; the two
            # counters move together or the mean roundtrip lies
            self.roundtrips += 1
            self.roundtrip_s_total += dt
        self._ok()
        return out

    # one wrapper per op (explicit > getattr magic for grep/typing)
    def ping(self) -> bool:
        return self._call("ping")

    def put(self, key, value, ttl_s=None) -> None:
        return self._call("put", key, value, ttl_s)

    def get(self, key):
        return self._call("get", key)

    def delete(self, *keys) -> int:
        return self._call("delete", *keys)

    def put_hash(self, key, mapping, ttl_s=None) -> None:
        return self._call("put_hash", key, mapping, ttl_s)

    def get_hash(self, key):
        return self._call("get_hash", key)

    def scan(self, prefix):
        return self._call("scan", prefix)

    def incr(self, key, by: int = 1) -> int:
        return self._call("incr", key, by)

    def mean_roundtrip_s(self) -> float:
        return self.roundtrip_s_total / self.roundtrips \
            if self.roundtrips else 0.0

    def report(self) -> Dict[str, object]:
        return {
            "backend": type(self.inner).__name__,
            "available": self.available,
            "errors": self.errors,
            "last_error": self.last_error,
            "roundtrips": self.roundtrips,
            "mean_roundtrip_ms": round(self.mean_roundtrip_s() * 1e3, 4),
            "cooldown_s": self.cooldown_s,
        }

    def close(self) -> None:
        try:
            self.inner.close()
        except Exception:
            pass


def build_backend(sp_cfg: Dict) -> GuardedBackend:
    """Backend from a normalized stateplane config block
    (config.schema.RouterConfig.stateplane_config)."""
    kind = str(sp_cfg.get("backend", "memory")).lower()
    bc = dict(sp_cfg.get("backend_config", {}) or {})
    if kind in ("resp", "redis", "valkey"):
        inner = RespStateBackend(
            host=str(bc.get("host", "127.0.0.1")),
            port=int(bc.get("port", 6379)),
            db=int(bc.get("db", 0)),
            password=str(bc.get("password", "")),
            timeout_s=float(bc.get("timeout_s", 5.0)))
    elif kind == "sqlite":
        path = str(bc.get("path", "") or sp_cfg.get("path", ""))
        if not path:
            raise ValueError("stateplane backend 'sqlite' needs "
                             "backend_config.path")
        inner = SQLiteStateBackend(path)
    elif kind == "memory":
        inner = InMemoryStateBackend()
    else:
        raise ValueError(f"unsupported stateplane backend {kind!r} "
                         f"(backends: memory|resp|redis|valkey|sqlite)")
    return GuardedBackend(inner,
                          cooldown_s=float(sp_cfg.get("cooldown_s", 2.0)))


__all__ = [
    "StateBackend", "StateBackendUnavailable", "InMemoryStateBackend",
    "RespStateBackend", "SQLiteStateBackend", "GuardedBackend",
    "build_backend",
]
