"""Closed-loop overload control: the degradation ladder.

The port's copy of ``semantic_router_tpu.resilience.controller``: a
deterministic, hysteresis-guarded shed ladder that trades optional work
for headroom one rung at a time, priority-aware so the requests that
matter keep full service the longest.

Levels (each includes everything below it)::

    L0 normal           full service
    L1 shed_optional    semantic-cache writes off, prompt compression
                        off, trace sampling -> 0, decision-record
                        sampling floored — the work nobody misses
    L2 brownout         low-priority requests route without the learned
                        families (classifier-bank capacity kept for
                        high-priority traffic; with the cascade attached,
                        a truncated cascade instead)
    L3 admission        cost-model-aware token bucket per priority
                        class; the lowest class gets 429 + Retry-After;
                        critical never queues
    L4 fail_static      configured default model, zero signal
                        extraction (also the dead-engine posture: an
                        engine_failed runtime event jumps here)

Inputs per tick: SLO alert severities (subscribed from the runtime event
bus), batcher queue depth and dispatch-pool saturation (the runtime-stats
providers), and engine lifecycle events.  Escalation is one rung per
``escalate_ticks`` overloaded ticks; de-escalation needs
``hysteresis_ticks`` consecutive healthy ticks and also steps one rung.

Every transition emits a ``degradation_level_changed`` runtime event,
moves the ``llm_degradation_level`` gauge and counts in
``llm_degradation_transitions_total``; sheds count in
``llm_shed_total{level,priority}``.  The L0 hot path is one integer read.

With a state plane bound (``bind(fleet=plane)``, under
``stateplane.share.fleet``), every tick publishes this replica's pressure
to the plane and steps from the fleet aggregate (worst queues anywhere,
the union of firing alerts), so N replicas climb and recover as one; a
plane failure steps from the local sensors alone.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from .costmodel import CostModel
from .priority import PRIORITY_CLASSES, RANKS, rank_of

L0_NORMAL = 0
L1_SHED_OPTIONAL = 1
L2_BROWNOUT = 2
L3_ADMISSION = 3
L4_FAIL_STATIC = 4

LEVEL_NAMES = ("normal", "shed_optional", "brownout", "admission",
               "fail_static")


def level_name(level: int) -> str:
    return LEVEL_NAMES[max(0, min(level, len(LEVEL_NAMES) - 1))]


@dataclass
class Disposition:
    """What the ladder says about one request — read-only for the
    pipeline (router.pipeline consumes it, never mutates)."""

    level: int = 0
    action: str = "allow"        # "allow" | "shed"
    priority: str = "normal"
    use_learned: bool = True     # False -> heuristic-only (L2 brownout)
    shed_optional: bool = False  # L1+: skip cache writes / compression
    fail_static: bool = False    # L4: static model, zero extraction
    retry_after_s: float = 0.0   # set on shed
    reason: str = ""
    # families that stay active even when use_learned is False — the L2
    # safety floor (jailbreak screening survives the brownout)
    keep_families: tuple = ()


_ALLOW = Disposition()  # the immutable L0 fast path


class TokenBucket:
    """Device-second token bucket (L3 admission): capacity and refill
    are in estimated device-seconds, so admission tracks what the
    hardware can actually absorb, not a request count guess."""

    def __init__(self, refill_per_s: float, burst_s: float) -> None:
        self.refill_per_s = max(1e-9, float(refill_per_s))
        self.capacity = max(1e-9, float(burst_s) * self.refill_per_s)
        self._tokens = self.capacity
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def try_take(self, cost_s: float, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            elapsed = max(0.0, now - self._last)
            self._last = now
            self._tokens = min(self.capacity,
                               self._tokens + elapsed * self.refill_per_s)
            if self._tokens >= cost_s:
                self._tokens -= cost_s
                return True
            return False

    def fill_ratio(self) -> float:
        with self._lock:
            return self._tokens / self.capacity

    def wait_s(self, cost_s: float) -> float:
        """Seconds until ``cost_s`` tokens exist — the Retry-After
        estimate for a shed caller."""
        with self._lock:
            deficit = cost_s - self._tokens
        return max(0.0, deficit / self.refill_per_s)


class DegradationController:
    """The ladder state machine.  One per RuntimeRegistry (``resilience``
    slot); bound to that registry's event bus / SLO monitor /
    runtimestats / tracer / explainer at bootstrap."""

    def __init__(self, registry=None, cost_model: Optional[CostModel] = None
                 ) -> None:
        if registry is None:
            from ..observability.metrics import default_registry

            registry = default_registry
        self.registry = registry
        self.cost_model = cost_model or CostModel()
        self.enabled = False
        self.interval_s = 2.0
        self.max_level = L4_FAIL_STATIC
        self.escalate_ticks = 1
        self.hysteresis_ticks = 3
        self.queue_high_watermark = 64.0
        self.saturation_high_watermark = 0.9
        # classes at/below this rank lose learned signals at L2
        self.brownout_min_rank = RANKS["normal"]
        # the class 429'd outright at L3 (everything of lower or equal
        # rank); critical never pays admission
        self.reject_min_rank = RANKS["low"]
        self.admission_target_utilization = 0.8
        self.admission_burst_s = 2.0
        self.fail_static_model = ""
        self.trace_sample_floor = 0.0
        self.decision_sample_floor = 0.1
        # L2 brownout safety floor: these signal families stay active
        # even for priority classes that route heuristic-only — the
        # jailbreak screen is cheap relative to the risk of browning it
        # out (signals.dispatch.SAFETY_FAMILIES is the default set)
        from ..signals.dispatch import SAFETY_FAMILIES

        self.brownout_keep = frozenset(SAFETY_FAMILIES)
        # ceiling for the drain-rate Retry-After estimate (a deep queue
        # must not tell clients to come back in an hour)
        self.retry_after_cap_s = 60.0

        self._level = L0_NORMAL
        self._over_ticks = 0
        self._healthy_ticks = 0
        self._firing: Dict[str, str] = {}     # objective -> severity
        self._alert_scopes: Dict[str, str] = {}  # objective -> scope
        self._engine_down = False
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._last_pressure: Dict[str, Any] = {}
        self.transitions: List[Dict[str, Any]] = []  # bounded history
        self.shed_count = 0

        # bound services (bind()); all optional — a controller with no
        # sensors simply never escalates
        self.event_bus = None
        self.slo = None
        self.runtime_stats = None
        # the shared state plane (stateplane.StatePlane): ticks then step
        # from the fleet's aggregate pressure
        self.fleet = None
        self._unsubscribe: Optional[Callable[[], None]] = None
        # knob-shedding targets (L1 side effects) + saved values
        self._tracer = None
        self._explain = None
        self._saved_knobs: Optional[Dict[str, float]] = None

        self.level_gauge = registry.gauge(
            "llm_degradation_level",
            "Current degradation-ladder level (0=normal .. "
            "4=fail-static)")
        self.shed_total = registry.counter(
            "llm_shed_total",
            "Requests shed by the degradation ladder, by level and "
            "priority class")
        self.transitions_total = registry.counter(
            "llm_degradation_transitions_total",
            "Degradation-ladder level transitions by direction")
        self.bucket_fill = registry.gauge(
            "llm_admission_bucket_fill",
            "Admission token-bucket fill ratio per priority class "
            "(L3 only; 1.0 = full headroom)")
        self.level_gauge.set(0.0)

    # -- configuration -----------------------------------------------------

    def configure(self, res_cfg: Dict[str, Any]) -> None:
        """Apply the ``resilience`` config block (boot + hot reload).
        Malformed values keep their previous setting — resilience config
        must never stop the server."""
        res_cfg = dict(res_cfg or {})

        def _f(key: str, cur: float, lo: float = 0.0) -> float:
            try:
                return max(lo, float(res_cfg.get(key, cur)))
            except (TypeError, ValueError):
                return cur

        old_level = self._level
        with self._lock:
            self.enabled = bool(res_cfg.get("enabled", True))
            self.interval_s = _f("interval_s", self.interval_s, 0.05)
            try:
                self.max_level = max(0, min(L4_FAIL_STATIC, int(
                    res_cfg.get("max_level", self.max_level))))
            except (TypeError, ValueError):
                pass
            self.escalate_ticks = max(1, int(_f(
                "escalate_ticks", self.escalate_ticks)))
            self.hysteresis_ticks = max(1, int(_f(
                "hysteresis_ticks", self.hysteresis_ticks)))
            self.queue_high_watermark = _f("queue_high_watermark",
                                           self.queue_high_watermark)
            self.saturation_high_watermark = _f(
                "saturation_high_watermark",
                self.saturation_high_watermark)
            self.brownout_min_rank = rank_of(
                str(res_cfg.get("brownout_class", "")),
                self.brownout_min_rank)
            if "brownout_keep_families" in res_cfg:
                try:
                    self.brownout_keep = frozenset(
                        str(f) for f in
                        (res_cfg.get("brownout_keep_families") or ()))
                except TypeError:
                    pass
            try:
                self.retry_after_cap_s = max(1.0, float(res_cfg.get(
                    "retry_after_cap_s", self.retry_after_cap_s)))
            except (TypeError, ValueError):
                pass
            adm = dict(res_cfg.get("admission", {}) or {})
            try:
                self.admission_target_utilization = max(0.01, min(1.0, float(
                    adm.get("target_utilization",
                            self.admission_target_utilization))))
            except (TypeError, ValueError):
                pass
            try:
                self.admission_burst_s = max(0.1, float(
                    adm.get("burst_s", self.admission_burst_s)))
            except (TypeError, ValueError):
                pass
            self.reject_min_rank = rank_of(
                str(adm.get("reject_class", "")), self.reject_min_rank)
            try:
                self.cost_model.default_request_cost_s = max(1e-6, float(
                    adm.get("default_cost_ms",
                            self.cost_model.default_request_cost_s * 1e3))
                    / 1e3)
            except (TypeError, ValueError):
                pass
            fs = dict(res_cfg.get("fail_static", {}) or {})
            self.fail_static_model = str(fs.get(
                "model", self.fail_static_model))
            self.trace_sample_floor = _f("trace_sample_floor",
                                         self.trace_sample_floor)
            self.decision_sample_floor = _f("decision_sample_floor",
                                            self.decision_sample_floor)
            retired_buckets = list(self._buckets)
            self._buckets = {}  # rebuilt on next L3 entry / tick
            if not self.enabled and self._level != L0_NORMAL:
                # a disabled controller never ticks again — a latched
                # level would brown out traffic forever
                self._set_level_locked(L0_NORMAL, "disabled")
            new_level = self._level
        for cls in retired_buckets:
            try:  # reconfigure retires old buckets: publish full headroom
                self.bucket_fill.set(1.0, priority=cls)
            except Exception:
                pass
        if new_level != old_level:
            self._after_transition(old_level, new_level)

    def bind(self, events=None, slo=None, runtimestats=None,
             tracer=None, explain=None,
             fleet=None) -> "DegradationController":
        """Attach the sensor/effect surfaces (registry slots).  Re-bind
        is idempotent: the previous event subscription is dropped.
        ``fleet`` is a stateplane.StatePlane — ticks then aggregate
        fleet-wide pressure instead of this process's alone."""
        if runtimestats is not None:
            self.runtime_stats = runtimestats
            self.cost_model.runtime_stats = runtimestats
        if slo is not None:
            self.slo = slo
        if fleet is not None:
            self.fleet = fleet
        if tracer is not None or explain is not None:
            # the knob-shed path reads/writes these under the lock; a
            # hot-reload rebind racing an L1 transition must not tear
            # the save/restore pairing
            with self._lock:
                if tracer is not None:
                    self._tracer = tracer
                if explain is not None:
                    self._explain = explain
        if events is not None and events is not self.event_bus:
            if self._unsubscribe is not None:
                try:
                    self._unsubscribe()
                except Exception:
                    pass
            self.event_bus = events
            self._unsubscribe = events.subscribe(self._on_event)
        return self

    # -- event intake ------------------------------------------------------

    def _on_event(self, ev) -> None:
        """Runtime-event subscriber: SLO alert transitions + engine
        lifecycle.  Must never raise (the bus swallows, but a broken
        subscriber still burns log volume)."""
        try:
            from ..runtime.events import (
                ENGINE_FAILED,
                ENGINE_READY,
                SLO_ALERT_FIRING,
                SLO_ALERT_RESOLVED,
            )

            if ev.stage == SLO_ALERT_FIRING:
                name = str(ev.detail.get("objective", ""))
                with self._lock:
                    self._firing[name] = str(
                        ev.detail.get("severity", "fast"))
                    # the scope is kept for /debug/resilience
                    self._alert_scopes[name] = str(
                        ev.detail.get("scope", "local") or "local")
            elif ev.stage == SLO_ALERT_RESOLVED:
                name = str(ev.detail.get("objective", ""))
                with self._lock:
                    self._firing.pop(name, None)
                    self._alert_scopes.pop(name, None)
            elif ev.stage == ENGINE_FAILED:
                with self._lock:
                    self._engine_down = True
            elif ev.stage == ENGINE_READY:
                with self._lock:
                    self._engine_down = False
        except Exception:
            pass

    # -- pressure ----------------------------------------------------------

    def _queue_pressure(self) -> Dict[str, float]:
        """Max pending-items / pool-saturation across batchers, read
        from the runtimestats providers without touching its gauges."""
        rs = self.runtime_stats
        out = {"pending_items": 0.0, "pool_saturation": 0.0}
        if rs is None:
            return out
        try:
            stats = rs.provider_stats()
        except Exception:
            return out
        for row in stats.values():
            out["pending_items"] = max(out["pending_items"],
                                       float(row.get("pending_items", 0.0)))
            out["pool_saturation"] = max(
                out["pool_saturation"],
                float(row.get("pool_saturation", 0.0)))
        return out

    def _alert_severities(self) -> Dict[str, str]:
        """Event-fed severities, with a poll of the SLO monitor's
        degraded() as a safety net for alerts that fired before this
        controller was bound (severity defaults to slow — events carry
        the real one)."""
        with self._lock:
            firing = dict(self._firing)
        slo = self.slo
        if slo is not None:
            try:
                for name in slo.degraded():
                    firing.setdefault(name, "slow")
            except Exception:
                pass
        return firing

    def _fleet_exchange(self, firing: Dict[str, str],
                        queues: Dict[str, float]
                        ) -> Optional[Dict[str, Any]]:
        """Publish this replica's pressure to the state plane and read
        the fleet aggregate.  Any plane failure returns None — the tick
        proceeds on LOCAL sensors only, so a partition degrades to
        per-replica behavior instead of flapping the ladder or (worse)
        treating the outage itself as overload."""
        if self.fleet is None:
            return None
        try:
            with self._lock:
                level = self._level
                engine_down = self._engine_down
            self.fleet.publish_pressure({
                "firing": dict(firing),
                "pending_items": queues["pending_items"],
                "pool_saturation": queues["pool_saturation"],
                "engine_down": engine_down,
                "level": level,
                "interval_s": self.interval_s,
            })
            return self.fleet.fleet_pressure()
        except Exception:
            return None

    def _drain_retry_s(self, fallback: float) -> float:
        """Retry-After from the LIVE queue drain rate: backlog depth ×
        the warm per-row device cost (runtimestats EWMAs through the
        cost model) estimates when the queue will actually have
        headroom again — replacing the static ladder-interval guess.
        Pre-telemetry (or empty queue) keeps the fallback."""
        try:
            pending = float(self._last_pressure.get("pending_items",
                                                    0.0))
            per_row = self.cost_model.cost_per_row_s()
            if per_row and pending > 0:
                return max(1.0, min(self.retry_after_cap_s,
                                    pending * per_row))
        except Exception:
            pass
        return max(1.0, fallback)

    # -- the ladder --------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> int:
        """One control-loop pass; returns the (possibly new) level.
        Deterministic given sensor state; ``now`` is accepted for callers
        that drive the loop on an explicit clock (the ladder itself counts
        ticks, not seconds)."""
        if not self.enabled:
            return self._level
        firing = self._alert_severities()
        queues = self._queue_pressure()
        fleet_view = self._fleet_exchange(firing, queues)
        if fleet_view is not None:
            # the fleet aggregate is the sensor: worst queues anywhere,
            # union of firing alerts — every replica steps from the
            # same inputs, so levels converge within one poll interval
            for name, sev in (fleet_view.get("firing") or {}).items():
                if firing.get(name) != "fast":
                    firing[name] = str(sev)
            queues["pending_items"] = max(
                queues["pending_items"],
                float(fleet_view.get("pending_items", 0.0)))
            queues["pool_saturation"] = max(
                queues["pool_saturation"],
                float(fleet_view.get("pool_saturation", 0.0)))
        fast = any(sev == "fast" for sev in firing.values())
        slow = bool(firing) and not fast
        pending = queues["pending_items"]
        sat = queues["pool_saturation"]
        overloaded = fast or pending >= self.queue_high_watermark \
            or sat >= self.saturation_high_watermark
        stressed = slow or pending >= 0.5 * self.queue_high_watermark \
            or sat >= 0.85 * self.saturation_high_watermark
        with self._lock:
            engine_down = self._engine_down
            self._last_pressure = {
                "firing": firing, "pending_items": pending,
                "pool_saturation": sat, "engine_down": engine_down,
                "overloaded": overloaded, "stressed": stressed,
            }
            if self.fleet is not None:
                self._last_pressure["fleet"] = {
                    "aggregated": fleet_view is not None,
                    "replicas": (fleet_view or {}).get("replicas", 0),
                    "levels": (fleet_view or {}).get("levels", {}),
                }
            old = self._level
            if engine_down:
                # a dead engine IS the fail-static posture — jump, don't
                # climb (every learned family would fail open anyway)
                self._over_ticks = self._healthy_ticks = 0
                if self._level < self.max_level:
                    self._set_level_locked(self.max_level, "engine_failed")
            elif overloaded:
                self._healthy_ticks = 0
                self._over_ticks += 1
                if self._over_ticks >= self.escalate_ticks \
                        and self._level < self.max_level:
                    self._over_ticks = 0
                    self._set_level_locked(
                        self._level + 1,
                        "fast_alert" if fast else "queue_pressure")
            elif stressed:
                # the hysteresis band: neither escalate nor recover —
                # boundary-riding load holds its level (no flapping)
                self._over_ticks = 0
                self._healthy_ticks = 0
            else:
                self._over_ticks = 0
                self._healthy_ticks += 1
                if self._healthy_ticks >= self.hysteresis_ticks \
                        and self._level > L0_NORMAL:
                    self._healthy_ticks = 0
                    self._set_level_locked(self._level - 1, "recovered")
            new = self._level
        if new != old:
            self._after_transition(old, new)
        if new >= L3_ADMISSION:
            self._refresh_buckets()
        elif old >= L3_ADMISSION:
            self._retire_buckets()
        return new

    def _retire_buckets(self) -> None:
        """Leaving admission control: drop the buckets and publish full
        headroom — a frozen 0.1 fill on a healthy router would mislead
        the next incident review."""
        with self._lock:
            buckets, self._buckets = dict(self._buckets), {}
        for cls in buckets:
            try:
                self.bucket_fill.set(1.0, priority=cls)
            except Exception:
                pass

    def _set_level_locked(self, new: int, reason: str) -> None:
        """Move the ladder (caller holds the lock); metrics/events land
        in _after_transition OUTSIDE the lock."""
        old = self._level
        if new == old:
            return
        self._level = new
        self.transitions.append({
            "from": old, "to": new, "reason": reason,
            "at_unix": time.time()})
        del self.transitions[:-64]
        self._pending_transition = (old, new, reason)

    def _after_transition(self, old: int, new: int) -> None:
        reason = ""
        pending = getattr(self, "_pending_transition", None)
        if pending is not None and pending[0] == old and pending[1] == new:
            reason = pending[2]
            self._pending_transition = None
        direction = "escalate" if new > old else "de_escalate"
        try:
            self.level_gauge.set(float(new))
            self.transitions_total.inc(direction=direction)
        except Exception:
            pass
        self._apply_knob_effects(old, new)
        bus = self.event_bus
        if bus is not None:
            try:
                from ..runtime.events import DEGRADATION_LEVEL_CHANGED

                bus.emit(DEGRADATION_LEVEL_CHANGED,
                         from_level=old, to_level=new,
                         from_name=level_name(old), to_name=level_name(new),
                         direction=direction, reason=reason)
            except Exception:
                pass

    def _apply_knob_effects(self, old: int, new: int) -> None:
        """L1 knob shedding: entering the ladder drops trace sampling to
        the floor and floors decision-record sampling; returning to L0
        restores the operator's values exactly.  Idempotent per edge.

        Runs under self._lock: _after_transition deliberately fires
        outside the lock, so the tick thread and an engine-failed jump
        can reach here concurrently — the save/restore swap of
        _saved_knobs must be atomic or a restore loses the operator's
        values.  The body only sets foreign plain attributes (no lock
        acquisitions), so holding the lock here cannot invert."""
        try:
            with self._lock:
                self._apply_knob_effects_locked(old, new)
        except Exception:
            pass

    def _apply_knob_effects_locked(self, old: int, new: int) -> None:
        """The edge logic; caller holds self._lock."""
        if old == L0_NORMAL and new > L0_NORMAL \
                and self._saved_knobs is None:
            saved: Dict[str, float] = {}
            if self._tracer is not None:
                saved["trace_sample_rate"] = float(
                    getattr(self._tracer, "sample_rate", 0.0))
                self._tracer.sample_rate = self.trace_sample_floor
            if self._explain is not None:
                saved["decision_sample_rate"] = float(
                    getattr(self._explain, "sample_rate", 1.0))
                self._explain.sample_rate = min(
                    saved["decision_sample_rate"],
                    self.decision_sample_floor)
            self._saved_knobs = saved
        elif new == L0_NORMAL and self._saved_knobs is not None:
            saved, self._saved_knobs = self._saved_knobs, None
            if self._tracer is not None \
                    and "trace_sample_rate" in saved:
                self._tracer.sample_rate = saved["trace_sample_rate"]
            if self._explain is not None \
                    and "decision_sample_rate" in saved:
                self._explain.sample_rate = \
                    saved["decision_sample_rate"]

    def resync_knob_effects(self) -> None:
        """Re-shed the sampling knobs after a config hot reload.  The
        reload path re-applies the OPERATOR values to the tracer and
        explainer unconditionally; while the ladder is degraded that
        would silently undo the L1 shed — and a later recovery would
        restore pre-reload values.  Forgetting the stale save and
        re-running the L0→current edge saves the fresh operator values
        and floors them again.  One critical section end to end: a
        de-escalation to L0 interleaving between the forget and the
        re-apply would otherwise skip its restore and strand the
        floors."""
        try:
            with self._lock:
                if self._level > L0_NORMAL:
                    self._saved_knobs = None
                    self._apply_knob_effects_locked(L0_NORMAL,
                                                    self._level)
        except Exception:
            pass

    # -- admission (the hot path) -----------------------------------------

    def _refresh_buckets(self) -> None:
        """(Re)build the per-class token buckets and publish fill
        gauges; refill splits the target device utilization across the
        classes that pay admission (critical is exempt, the reject class
        gets nothing)."""
        with self._lock:
            if not self._buckets:
                paying = [c for c in PRIORITY_CLASSES
                          if 0 < RANKS[c] < self.reject_min_rank]
                per_class = self.admission_target_utilization / max(
                    1, len(paying))
                self._buckets = {
                    c: TokenBucket(per_class, self.admission_burst_s)
                    for c in paying}
            buckets = dict(self._buckets)
        for cls, bucket in buckets.items():
            try:
                self.bucket_fill.set(round(bucket.fill_ratio(), 4),
                                     priority=cls)
            except Exception:
                pass

    def level(self) -> int:
        return self._level

    def shed_optional_active(self) -> bool:
        return self._level >= L1_SHED_OPTIONAL

    def browned_out(self, priority: str) -> bool:
        """Read-only: would this priority class route heuristic-only
        right now?  Reads without consuming admission tokens — shed and
        admission decisions stay in route(), which answers the request."""
        lvl = self._level
        if lvl >= L4_FAIL_STATIC:
            return True
        return lvl >= L2_BROWNOUT \
            and rank_of(priority) >= self.brownout_min_rank

    def admit(self, priority: str, n_signals: int = 1) -> Disposition:
        """The per-request gate.  L0 returns a shared immutable ALLOW —
        one integer compare on the healthy path."""
        lvl = self._level
        if lvl == L0_NORMAL or not self.enabled:
            return _ALLOW
        rank = rank_of(priority)
        if lvl >= L4_FAIL_STATIC:
            return Disposition(level=lvl, priority=priority,
                               use_learned=False, shed_optional=True,
                               fail_static=True, reason="fail_static")
        use_learned = True
        if lvl >= L2_BROWNOUT and rank >= self.brownout_min_rank:
            use_learned = False
        if lvl >= L3_ADMISSION and rank > 0:
            if rank >= self.reject_min_rank:
                # Retry-After from the live drain rate (fallback: the
                # static recovery-window guess this replaced)
                retry = self._drain_retry_s(
                    self.interval_s * self.hysteresis_ticks)
                return self._shed(lvl, priority, retry,
                                  "lowest_class_rejected")
            if not self._buckets:
                self._refresh_buckets()
            bucket = self._buckets.get(priority)
            if bucket is not None:
                cost = self.cost_model.request_cost_s(n_signals)
                if not bucket.try_take(cost):
                    return self._shed(lvl, priority,
                                      max(bucket.wait_s(cost),
                                          self._drain_retry_s(1.0)),
                                      "admission_bucket_empty")
        return Disposition(level=lvl, priority=priority,
                           use_learned=use_learned, shed_optional=True,
                           reason=level_name(lvl),
                           keep_families=tuple(self.brownout_keep)
                           if not use_learned else ())

    def _shed(self, lvl: int, priority: str, retry_after_s: float,
              reason: str) -> Disposition:
        with self._lock:
            # admit() is lock-free on the healthy path; shedding is
            # already the slow path, and concurrent sheds must not
            # lose counts
            self.shed_count += 1
        try:
            self.shed_total.inc(level=level_name(lvl), priority=priority)
        except Exception:
            pass
        return Disposition(level=lvl, action="shed", priority=priority,
                           use_learned=False, shed_optional=True,
                           retry_after_s=retry_after_s, reason=reason)

    # -- reads -------------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        """GET /debug/resilience payload."""
        with self._lock:
            buckets = {c: round(b.fill_ratio(), 4)
                       for c, b in self._buckets.items()}
            return {
                "enabled": self.enabled,
                "level": self._level,
                "level_name": level_name(self._level),
                "max_level": self.max_level,
                "interval_s": self.interval_s,
                "hysteresis_ticks": self.hysteresis_ticks,
                "escalate_ticks": self.escalate_ticks,
                "brownout_class": PRIORITY_CLASSES[min(
                    self.brownout_min_rank, len(PRIORITY_CLASSES) - 1)],
                "brownout_keep_families": sorted(self.brownout_keep),
                "fleet_attached": self.fleet is not None,
                "reject_class": PRIORITY_CLASSES[min(
                    self.reject_min_rank, len(PRIORITY_CLASSES) - 1)],
                "pressure": dict(self._last_pressure),
                "alert_scopes": dict(self._alert_scopes),
                "admission_buckets": buckets,
                "cost_model": self.cost_model.report(),
                "shed_count": self.shed_count,
                "transitions": list(self.transitions[-16:]),
            }

    # -- lifecycle ---------------------------------------------------------

    def start(self, interval_s: Optional[float] = None
              ) -> "DegradationController":
        """Start (or retune) the background control loop; idempotent."""
        if interval_s is not None:
            self.interval_s = max(0.05, float(interval_s))
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:
                    pass  # the control loop must never die loudly

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="degradation-controller")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None


# process-global default (single-router posture, same pattern as
# default_slo_monitor): disabled and thread-less until bootstrap
# configures it — a bare Router() pays one integer read per request
default_degradation_controller = DegradationController()
