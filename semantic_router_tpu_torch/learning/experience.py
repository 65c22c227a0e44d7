"""Per-(decision, tier, model) routing experience with durable backends.

Reference parity: ``pkg/extproc/router_learning_runtime.go`` — the
learning runtime keeps a verdict ledger per model scoped to the decision
that routed it (plus decision-agnostic roll-ups), seeded from the
model's configured quality score so cold models aren't random. Verdicts
are the reference's four outcome classes (router_learning_outcome.go):

  good_fit | underpowered | overprovisioned | failed

plus EWMAs for latency / cache-hit / input-cost used as score
adjustments. Fail-open missing-state semantics: an unknown key returns
the neutral default (seed 0.5, weight 2) — learning never blocks
routing.

Durability: the in-proc map writes through to an optional SQLite file
(read whole at open) or a Redis / valkey hash through the port's own RESP
client (``state.resp``), which it hydrates from lazily, key by key, so
learned state survives restarts and is shared across replicas (Redis).
The port's own copy of ``semantic_router_tpu.learning.experience``."""

from __future__ import annotations

import json
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional

VERDICTS = ("good_fit", "underpowered", "overprovisioned", "failed")


@dataclass
class ModelExperience:
    quality_seed: float = 0.5
    seed_weight: float = 2.0
    good_fit: int = 0
    underpowered: int = 0
    overprovisioned: int = 0
    failed: int = 0
    latency_ewma: float = 0.0      # normalized [0, 1]
    cache_hit_ewma: float = 0.0
    cost_ewma: float = 0.0
    last_updated: float = 0.0

    @property
    def total(self) -> int:
        return (self.good_fit + self.underpowered +
                self.overprovisioned + self.failed)


def _key(decision: str, tier: int, model: str) -> str:
    return f"{decision}|{tier}|{model}"


_EWMA = 0.2  # weight of the newest observation


class ExperienceStore:
    """In-proc experience map with optional durable write-through."""

    def __init__(self, backend: Optional[Dict] = None) -> None:
        self._exp: Dict[str, ModelExperience] = {}
        self._lock = threading.Lock()
        self._db = None
        self._redis = None
        self._redis_prefix = "vsr:learning"
        backend = backend or {}
        kind = str(backend.get("backend", "")).lower()
        if kind == "sqlite" and backend.get("path"):
            self._open_sqlite(backend["path"])
        elif kind in ("redis", "valkey"):
            self._open_redis(backend)

    # -- durable backends -----------------------------------------------

    def _open_sqlite(self, path: str) -> None:
        import sqlite3

        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS learning_experience ("
            "key TEXT PRIMARY KEY, doc TEXT NOT NULL)")
        self._db.commit()
        for key, doc in self._db.execute(
                "SELECT key, doc FROM learning_experience"):
            try:
                self._exp[key] = ModelExperience(**json.loads(doc))
            except (TypeError, ValueError):
                continue

    def _open_redis(self, backend: Dict) -> None:
        from ..state.resp import RedisClient

        self._redis = RedisClient(
            host=backend.get("host", "127.0.0.1"),
            port=int(backend.get("port", 6379)),
            db=int(backend.get("db", 0)),
            password=str(backend.get("password", "")))
        self._redis_prefix = backend.get("key_prefix", "vsr:learning")

    def _persist(self, key: str, exp: ModelExperience) -> None:
        doc = json.dumps(asdict(exp))
        try:
            if self._db is not None:
                self._db.execute(
                    "INSERT INTO learning_experience (key, doc) "
                    "VALUES (?, ?) ON CONFLICT(key) DO UPDATE SET "
                    "doc = excluded.doc", (key, doc))
                self._db.commit()
            if self._redis is not None:
                self._redis.execute("HSET", self._redis_prefix, key, doc)
        except Exception:
            pass  # durable mirror is best-effort; in-proc state stands

    def _hydrate(self, key: str) -> Optional[ModelExperience]:
        """Lazy read-through for Redis (another replica may have learned
        this key); SQLite hydrates fully at open."""
        if self._redis is None:
            return None
        try:
            doc = self._redis.execute("HGET", self._redis_prefix, key)
            if doc:
                return ModelExperience(**json.loads(doc))
        except Exception:
            pass
        return None

    # -- API -------------------------------------------------------------

    def snapshot(self, decision: str, tier: int,
                 model: str) -> ModelExperience:
        """Most specific ledger available, falling back through the
        roll-up keys, then the fail-open neutral default."""
        with self._lock:
            for key in (_key(decision, tier, model),
                        _key("", tier, model), _key("", 0, model)):
                exp = self._exp.get(key)
                if exp is None:
                    exp = self._hydrate(key)
                    if exp is not None:
                        self._exp[key] = exp
                if exp is not None:
                    return ModelExperience(**asdict(exp))  # copy
        return ModelExperience()

    def record(self, decision: str, tier: int, model: str, verdict: str,
               count: int = 1, latency_norm: Optional[float] = None,
               cache_hit: Optional[bool] = None,
               cost_norm: Optional[float] = None,
               quality_seed: Optional[float] = None) -> None:
        if verdict not in VERDICTS or not model:
            return
        keys = [_key(decision, tier, model)]
        if decision:
            keys.append(_key("", tier, model))
        if tier != 0:
            keys.append(_key("", 0, model))
        # roll-ups must dedupe (decision="" tier=0 appears once)
        seen = set()
        with self._lock:
            for key in keys:
                if key in seen:
                    continue
                seen.add(key)
                exp = self._exp.get(key) or self._hydrate(key)
                if exp is None:
                    exp = ModelExperience()
                    if quality_seed is not None:
                        exp.quality_seed = min(max(quality_seed, 0.0),
                                               1.0)
                self._exp[key] = exp
                setattr(exp, verdict,
                        getattr(exp, verdict) + max(count, 1))
                if latency_norm is not None:
                    exp.latency_ewma = ((1 - _EWMA) * exp.latency_ewma
                                        + _EWMA * min(max(
                                            latency_norm, 0.0), 1.0))
                if cache_hit is not None:
                    exp.cache_hit_ewma = ((1 - _EWMA) *
                                          exp.cache_hit_ewma
                                          + _EWMA * float(cache_hit))
                if cost_norm is not None:
                    exp.cost_ewma = ((1 - _EWMA) * exp.cost_ewma
                                     + _EWMA * min(max(cost_norm, 0.0),
                                                   1.0))
                exp.last_updated = time.time()
                self._persist(key, exp)

    def export(self) -> Dict[str, Dict]:
        """Every ledger held in this process, {key: fields} (a copy)."""
        with self._lock:
            return {k: asdict(v) for k, v in sorted(self._exp.items())}

    def close(self) -> None:
        if self._db is not None:
            try:
                self._db.close()
            except Exception:
                pass
