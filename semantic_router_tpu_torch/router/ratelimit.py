"""Local rate limiting: a token bucket per (user, model).

The port's copy of ``semantic_router_tpu.router.ratelimit``, without the
remote-check hook (an RLS client), which no config of the reference
sets: a bucket's rate is the user's override, else the model's, else the
default, and no rate is no limit.  The router checks every request
before any other work (``Router._route_impl``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass
class RateLimitDecision:
    allowed: bool
    source: str = "local"  # local | disabled
    retry_after_s: float = 0.0


class TokenBucket:
    def __init__(self, rate_per_s: float, burst: float) -> None:
        self.rate = rate_per_s
        self.burst = burst
        self.tokens = burst
        self.last = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self) -> None:
        """Clock-refresh + token top-up (callers hold the lock) — the ONE
        refill definition so take() and peek() can never disagree."""
        now = time.monotonic()
        self.tokens = min(self.burst,
                          self.tokens + (now - self.last) * self.rate)
        self.last = now

    def take(self, n: float = 1.0) -> Tuple[bool, float]:
        with self._lock:
            self._refill()
            if self.tokens >= n:
                self.tokens -= n
                return True, 0.0
            needed = (n - self.tokens) / self.rate if self.rate > 0 else 60.0
            return False, needed

    def peek(self, n: float = 1.0) -> bool:
        """Would ``take(n)`` succeed right now? Consumes nothing."""
        with self._lock:
            self._refill()
            return self.tokens >= n


class RateLimiter:
    """Per-(user, model) buckets with defaults + overrides."""

    def __init__(self, requests_per_minute: float = 0.0, burst: int = 0,
                 per_user: Optional[Dict[str, float]] = None,
                 per_model: Optional[Dict[str, float]] = None) -> None:
        self.default_rpm = requests_per_minute
        # burst=0 means "derive from the bucket's resolved rpm" — deriving
        # from the GLOBAL rpm here would give per-user/per-model override
        # buckets capacity 1 when the global rpm is 0
        self.configured_burst = burst
        self.per_user = per_user or {}
        self.per_model = per_model or {}
        self._buckets: Dict[Tuple[str, str], TokenBucket] = {}
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, cfg: Dict) -> "RateLimiter":
        return cls(
            requests_per_minute=float(cfg.get("requests_per_minute", 0)),
            burst=int(cfg.get("burst", 0)),
            per_user={k: float(v) for k, v in
                      (cfg.get("per_user", {}) or {}).items()},
            per_model={k: float(v) for k, v in
                       (cfg.get("per_model", {}) or {}).items()},
        )

    def _rpm_for(self, user: str, model: str) -> float:
        if user in self.per_user:
            return self.per_user[user]
        if model in self.per_model:
            return self.per_model[model]
        return self.default_rpm

    def check(self, user: str = "", model: str = "") -> RateLimitDecision:
        rpm = self._rpm_for(user, model)
        if rpm <= 0:
            return RateLimitDecision(True, source="disabled")
        key = (user, model)
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                burst = self.configured_burst or max(1, int(rpm / 6))
                bucket = TokenBucket(rpm / 60.0, float(burst))
                self._buckets[key] = bucket
        ok, wait = bucket.take()
        return RateLimitDecision(ok, source="local", retry_after_s=wait)

    def peek(self, user: str = "", model: str = "") -> bool:
        """Non-consuming preview: False only when the bucket for (user,
        model) is currently empty — a guard for speculative work, not an
        enforcement point: route() still runs the real check()."""
        rpm = self._rpm_for(user, model)
        if rpm <= 0:
            return True
        with self._lock:
            bucket = self._buckets.get((user, model))
        if bucket is None:
            return True  # nothing consumed yet → first take will pass
        return bucket.peek()
