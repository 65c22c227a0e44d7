"""Upstream resilience plane: health-scored backends, budgeted failover,
deadline propagation.

The port's copy of ``semantic_router_tpu.resilience.upstream``:

- ``UpstreamHealth`` — a passive per-(model, endpoint) health scorer fed
  by every forward outcome: EWMA error rate and latency, and a
  consecutive-failure circuit breaker with half-open probing;
- the selection-time candidate mask: a model whose every endpoint has an
  open circuit is never chosen while alternatives exist
  (``Router._select_model`` consults ``model_open``);
- budgeted failover: the server re-routes a failed attempt to the
  next-best candidate under a token-bucket retry budget with jittered
  backoff; retries are refused outright at degradation >= L2
  (``retry.disable_at_level``), so a retry storm never amplifies an
  overload the shed ladder is fighting;
- deadline propagation: an end-to-end budget (``x-vsr-deadline`` or the
  operator's default) derives per-attempt timeouts, and the remaining
  budget is forwarded upstream.

Disabled by default (``resilience.upstream.enabled: false``): the plane
is never constructed and routing is byte-identical.  The reference's
fleet-shared open circuits and fleet retry budget ride the shared state
plane, which this port refuses at load; they are left out.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, Optional, Tuple

from ..observability.logging import component_event
from .controller import TokenBucket

__all__ = ["UpstreamHealth", "parse_deadline", "attempt_timeout",
           "DEADLINE_HEADER"]

DEADLINE_HEADER = "x-vsr-deadline"

# breaker states
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


def parse_deadline(headers: Optional[Dict[str, str]], default_s: float,
                   header: str = DEADLINE_HEADER) -> float:
    """Remaining end-to-end budget in seconds for this request.

    The client speaks either form: a relative budget in seconds
    (``x-vsr-deadline: 30``) or an absolute unix-epoch deadline
    (values > 1e9, e.g. ``x-vsr-deadline: 1735689600.5``).  Malformed
    or absent values fall back to ``default_s`` — a bad header must
    never fail the request it was trying to protect."""
    raw = (headers or {}).get(header, "")
    if raw:
        try:
            val = float(raw)
            if val > 1e9:  # absolute epoch seconds
                val = val - time.time()
            if val > 0:
                return min(val, default_s) if default_s > 0 else val
        except (TypeError, ValueError):
            pass
    return default_s


def attempt_timeout(remaining_s: float, attempts_left: int,
                    floor_s: float, cap_s: float) -> float:
    """Per-attempt timeout from the remaining deadline: split what's
    left across the attempts still available, floored so one slow
    candidate can't eat the whole budget and every later attempt gets a
    real chance, capped by the operator's flat forward timeout — and
    never beyond what actually remains."""
    remaining_s = max(0.001, float(remaining_s))
    share = remaining_s / max(1, int(attempts_left))
    return min(max(share, floor_s), cap_s, remaining_s)


class _Endpoint:
    """Mutable health state for one (model, endpoint) pair."""

    __slots__ = ("model", "endpoint", "state", "consecutive_failures",
                 "error_ewma", "latency_ewma_ms", "opened_at",
                 "probe_started_at", "total", "failures", "opens",
                 "last_seen")

    def __init__(self, model: str, endpoint: str) -> None:
        self.model = model
        self.endpoint = endpoint
        self.state = CLOSED
        self.consecutive_failures = 0
        self.error_ewma = 0.0
        self.latency_ewma_ms = 0.0
        self.opened_at = 0.0
        # monotonic start of the in-flight half-open probe (0 = none);
        # a timestamp, not a flag, so a probe whose forward never
        # completed (retry denied after allow(), caller crash) EXPIRES
        # instead of wedging the endpoint in half-open forever
        self.probe_started_at = 0.0
        self.total = 0
        self.failures = 0
        self.opens = 0
        self.last_seen = 0.0

    def row(self) -> Dict[str, Any]:
        return {"model": self.model, "endpoint": self.endpoint,
                "state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "error_rate_ewma": round(self.error_ewma, 4),
                "latency_ewma_ms": round(self.latency_ewma_ms, 2),
                "opened_at_unix": round(self.opened_at, 3),
                "requests": self.total, "failures": self.failures,
                "opens": self.opens}


def _default_cfg() -> Dict[str, Any]:
    """Seed knobs from the one interpretation point
    (RouterConfig.upstream_config over an empty config), so a directly
    constructed plane and a bootstrap-configured one never drift on
    defaults."""
    from ..config.schema import RouterConfig

    out = RouterConfig().upstream_config()
    out.pop("enabled", None)
    return out


class UpstreamHealth:
    """The health plane.  One per RuntimeRegistry (``upstreams`` slot);
    only constructed when ``resilience.upstream.enabled``."""

    def __init__(self, registry=None) -> None:
        if registry is None:
            from ..observability.metrics import default_registry

            registry = default_registry
        self.cfg: Dict[str, Any] = _default_cfg()
        self._eps: Dict[Tuple[str, str], _Endpoint] = {}
        self._lock = threading.Lock()
        self._rng = random.Random(0xC1BC)

        # bound surfaces (bind())
        self.event_bus = None
        self.resilience = None   # DegradationController (retry gate)

        self._retry_bucket = self._build_bucket()

        self.requests = registry.counter(
            "llm_upstream_requests_total",
            "Forward attempts per upstream, by model/endpoint/outcome")
        self.failovers = registry.counter(
            "llm_upstream_failovers_total",
            "Requests re-routed to a next-best candidate after an "
            "upstream failure, by the model that finally served")
        self.retries = registry.counter(
            "llm_upstream_retries_total",
            "Failover/retry budget decisions (granted vs denied with "
            "the denial reason)")
        self.breaker_transitions = registry.counter(
            "llm_upstream_breaker_transitions_total",
            "Upstream circuit-breaker state transitions, by new state")
        self.open_gauge = registry.gauge(
            "llm_upstream_breaker_open",
            "Upstream circuits currently open")
        self.attempt_latency = registry.histogram(
            "llm_upstream_attempt_latency_seconds",
            "Per-attempt upstream forward latency")

    # -- configuration -----------------------------------------------------

    def _build_bucket(self) -> TokenBucket:
        r = self.cfg["retry"]
        per_s = max(1e-6, float(r["budget_per_s"]))
        # TokenBucket capacity = burst_s * refill; express the burst
        # COUNT the operator configured in those terms
        return TokenBucket(per_s, float(r["burst"]) / per_s)

    def configure(self, cfg: Dict[str, Any]) -> None:
        """Apply the normalized resilience.upstream block (boot + hot
        reload); malformed values keep their previous setting."""
        cfg = dict(cfg or {})
        with self._lock:
            for block in ("breaker", "retry", "deadline"):
                if isinstance(cfg.get(block), dict):
                    merged = dict(self.cfg[block])
                    merged.update(cfg[block])
                    self.cfg[block] = merged
            self._retry_bucket = self._build_bucket()

    def bind(self, events=None, resilience=None) -> "UpstreamHealth":
        if events is not None:
            self.event_bus = events
        if resilience is not None:
            self.resilience = resilience
        return self

    # -- passive feed ------------------------------------------------------

    def record(self, model: str, endpoint: str, ok: bool,
               latency_s: float = 0.0, kind: str = "") -> None:
        """One forward outcome.  ``endpoint`` may be "" (health then
        tracks the model level).
        Never raises — health accounting must not fail a request."""
        now = time.monotonic()
        transition = None
        with self._lock:
            key = (model, endpoint)
            ep = self._eps.get(key)
            if ep is None:
                ep = self._eps[key] = _Endpoint(model, endpoint)
            alpha = float(self.cfg["breaker"]["ewma_alpha"])
            ep.total += 1
            ep.last_seen = now
            ep.error_ewma = (1 - alpha) * ep.error_ewma \
                + alpha * (0.0 if ok else 1.0)
            if latency_s > 0:
                ep.latency_ewma_ms = latency_s * 1e3 if not \
                    ep.latency_ewma_ms else (1 - alpha) \
                    * ep.latency_ewma_ms + alpha * latency_s * 1e3
            ep.probe_started_at = 0.0
            if ok:
                ep.consecutive_failures = 0
                if ep.state != CLOSED:
                    ep.state = CLOSED
                    transition = CLOSED
            else:
                ep.failures += 1
                ep.consecutive_failures += 1
                trip = int(self.cfg["breaker"]["failures"])
                err_trip = float(self.cfg["breaker"]["error_rate"])
                if ep.state == HALF_OPEN:
                    # the probe failed: straight back to open, fresh
                    # cooldown
                    ep.state = OPEN
                    ep.opened_at = now
                    ep.opens += 1
                    transition = OPEN
                elif ep.state == CLOSED and (
                        ep.consecutive_failures >= trip
                        # EWMA trip: an endpoint failing every other
                        # request never strings `trip` consecutive
                        # failures but is just as unhealthy — trips on
                        # sustained error rate once >= 10 samples exist
                        # (0 or >= 1 disables this leg)
                        or (0.0 < err_trip < 1.0 and ep.total >= 10
                            and ep.error_ewma >= err_trip)):
                    ep.state = OPEN
                    ep.opened_at = now
                    ep.opens += 1
                    transition = OPEN
            snapshot = ep.row()
            open_count = sum(1 for e in self._eps.values()
                             if e.state == OPEN)
        try:
            self.requests.inc(model=model, endpoint=endpoint or "-",
                              outcome="ok" if ok else (kind or "error"))
            if latency_s > 0:
                self.attempt_latency.observe(latency_s)
        except Exception:
            pass
        if transition is not None:
            self._on_transition(transition, snapshot, open_count)

    def _on_transition(self, new_state: str, row: Dict[str, Any],
                       open_count: int) -> None:
        try:
            self.breaker_transitions.inc(state=new_state)
            self.open_gauge.set(float(open_count))
        except Exception:
            pass
        bus = self.event_bus
        if bus is not None:
            try:
                from ..runtime.events import (
                    UPSTREAM_RECOVERED,
                    UPSTREAM_UNHEALTHY,
                )

                bus.emit(UPSTREAM_UNHEALTHY if new_state == OPEN
                         else UPSTREAM_RECOVERED,
                         model=row["model"], endpoint=row["endpoint"],
                         error_rate=row["error_rate_ewma"],
                         consecutive=row["consecutive_failures"])
            except Exception:
                pass
        component_event("upstream", "breaker_" + new_state,
                        model=row["model"], endpoint=row["endpoint"],
                        error_rate=row["error_rate_ewma"])

    # -- gates -------------------------------------------------------------

    def allow(self, model: str, endpoint: str) -> bool:
        """Circuit gate for one forward attempt.  Open circuits block
        until the cooldown elapses, then admit exactly ONE half-open
        probe at a time; unknown endpoints always pass."""
        now = time.monotonic()
        with self._lock:
            ep = self._eps.get((model, endpoint))
            if ep is None or ep.state == CLOSED:
                return True
            open_s = float(self.cfg["breaker"]["open_s"])
            if ep.state == OPEN:
                if now - ep.opened_at >= open_s:
                    ep.state = HALF_OPEN
                    ep.probe_started_at = now
                    return True
                return False
            # half-open: one probe in flight at a time — but a probe
            # that never reported back (denied retry, caller crash)
            # expires after open_s so the endpoint can't wedge
            if ep.probe_started_at == 0.0 \
                    or now - ep.probe_started_at >= open_s:
                ep.probe_started_at = now
                return True
            return False

    def model_open(self, model: str) -> bool:
        """Selection-time mask: True when every known endpoint of
        ``model`` has an open circuit still inside its cooldown (a
        probe-ready circuit un-masks the model so traffic can drive the
        half-open probe)."""
        now = time.monotonic()
        with self._lock:
            open_s = float(self.cfg["breaker"]["open_s"])
            seen = 0
            for (m, e), ep in self._eps.items():
                if m != model:
                    continue
                seen += 1
                if ep.state != OPEN or now - ep.opened_at >= open_s:
                    return False
            return seen > 0

    def health_score(self, model: str) -> float:
        """Re-rank weight in [0, 1]: 1 - mean EWMA error rate across
        the model's endpoints (1.0 when unknown)."""
        with self._lock:
            rates = [ep.error_ewma for (m, _e), ep in self._eps.items()
                     if m == model]
        if not rates:
            return 1.0
        return max(0.0, 1.0 - sum(rates) / len(rates))

    def try_retry(self) -> Tuple[bool, str]:
        """One failover/retry attempt against the token-bucket budget
        and the degradation gate — at ladder level >= disable_at_level
        (default L2) retries are refused outright so a retry storm can
        never amplify the overload the shed ladder is fighting."""
        level = 0
        res = self.resilience
        if res is not None:
            try:
                level = int(res.level())
            except Exception:
                level = 0
        if level >= int(self.cfg["retry"]["disable_at_level"]):
            try:
                self.retries.inc(granted="false", reason="degraded")
            except Exception:
                pass
            return False, f"degraded_l{level}"
        granted = self._retry_bucket.try_take(1.0)
        if not granted:
            try:
                # the same string as the failover_path entry
                self.retries.inc(granted="false",
                                 reason="budget_exhausted")
            except Exception:
                pass
            return False, "budget_exhausted"
        try:
            self.retries.inc(granted="true", reason="-")
        except Exception:
            pass
        return True, ""

    def retry_on(self, kind: str) -> bool:
        return kind in (self.cfg["retry"].get("on") or [])

    def max_attempts(self) -> int:
        return max(1, int(self.cfg["retry"]["max_attempts"]))

    def backoff_s(self, attempt: int) -> float:
        """Jittered exponential backoff before retry ``attempt``
        (1-based), capped at 1s."""
        base = float(self.cfg["retry"]["backoff_ms"]) / 1e3
        with self._lock:
            jitter = 0.5 + self._rng.random()
        return min(1.0, base * (2 ** max(0, attempt - 1)) * jitter)

    # -- reporting (GET /debug/resilience) ---------------------------------

    def report(self) -> Dict[str, Any]:
        with self._lock:
            rows = [ep.row() for ep in self._eps.values()]
            cfg = {k: (dict(v) if isinstance(v, dict) else v)
                   for k, v in self.cfg.items()}
        rows.sort(key=lambda r: (r["model"], r["endpoint"]))
        return {
            "enabled": True,
            "endpoints": rows,
            "open_circuits": sum(1 for r in rows
                                 if r["state"] == OPEN),
            "retry_budget": {
                "fill_ratio": round(
                    self._retry_bucket.fill_ratio(), 4),
                "budget_per_s": float(
                    self.cfg["retry"]["budget_per_s"]),
                "burst": float(self.cfg["retry"]["burst"])},
            "config": cfg,
        }
