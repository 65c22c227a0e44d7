"""Runtime lifecycle events: a small process-local bus.

The port's copy of ``semantic_router_tpu.runtime.events``.  Components
emit typed lifecycle events (checkpoint downloads, engine ready or
failed, SLO alert transitions, degradation-ladder moves, flywheel
promotion moves, upstream circuit transitions, config reloads),
subscribers react (the degradation controller, the SLO-burn capture,
the flywheel's rollback, the Kubernetes operator's status), a bounded
ring keeps recent history (``recent``), and ``wait_for`` blocks until a
stage is seen.

Emission never hurts the emitter: subscriber exceptions are swallowed and
logged; the bus is lock-protected and the ring bounded.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional

# checkpoint download at boot (runtime/bootstrap.py build_engine,
# runtime/modeldownload.py)
DOWNLOAD_STARTED = "download_started"
DOWNLOAD_DONE = "download_done"
DOWNLOAD_FAILED = "download_failed"
# engine lifecycle (runtime/bootstrap.py warm_engine)
ENGINE_READY = "engine_ready"
ENGINE_FAILED = "engine_failed"
# SLO burn-rate alert transitions (observability/slo.py)
SLO_ALERT_FIRING = "slo_alert_firing"
SLO_ALERT_RESOLVED = "slo_alert_resolved"
# an SLO-burn-triggered profiler capture (observability/programstats.py)
SLO_CAPTURE = "slo_capture"
# degradation-ladder transitions (resilience/controller.py)
DEGRADATION_LEVEL_CHANGED = "degradation_level_changed"
# flywheel promotion-ladder transitions (flywheel/controller.py)
FLYWHEEL_STATE_CHANGED = "flywheel_state_changed"
# upstream circuit-breaker transitions (resilience/upstream.py)
UPSTREAM_UNHEALTHY = "upstream_unhealthy"
UPSTREAM_RECOVERED = "upstream_recovered"
# a config hot reload swapped the live router (runtime/bootstrap.py
# attach_config_watcher)
CONFIG_RELOADED = "config_reloaded"


@dataclass
class RuntimeEvent:
    stage: str
    detail: Dict[str, Any] = field(default_factory=dict)
    ts: float = 0.0
    event_id: str = ""

    def public(self) -> Dict[str, Any]:
        """The event as JSON-able data (``/dashboard/api/events``)."""
        return asdict(self)


class EventBus:
    def __init__(self, history: int = 256) -> None:
        self._subs: List[Callable[[RuntimeEvent], None]] = []
        self._ring: List[RuntimeEvent] = []
        self._history = history
        self._lock = threading.Lock()

    def subscribe(self, fn: Callable[[RuntimeEvent], None]
                  ) -> Callable[[], None]:
        """Register; returns an unsubscribe callable."""
        with self._lock:
            self._subs.append(fn)

        def unsubscribe() -> None:
            with self._lock:
                try:
                    self._subs.remove(fn)
                except ValueError:
                    pass

        return unsubscribe

    def emit(self, stage: str, **detail: Any) -> RuntimeEvent:
        ev = RuntimeEvent(stage=stage, detail=detail, ts=time.time(),
                          event_id=uuid.uuid4().hex[:10])
        with self._lock:
            self._ring.append(ev)
            if len(self._ring) > self._history:
                del self._ring[: len(self._ring) - self._history]
            subs = list(self._subs)
        for fn in subs:
            try:
                fn(ev)
            except Exception:
                from ..observability.logging import component_event

                component_event("modelruntime", "subscriber_error",
                                level="warning", stage=stage)
        return ev

    def recent(self, limit: int = 50,
               stage: str = "") -> List[RuntimeEvent]:
        if limit <= 0:
            return []  # evs[-0:] would be the whole ring, not none
        with self._lock:
            evs = list(self._ring)
        if stage:
            evs = [e for e in evs if e.stage == stage]
        return evs[-limit:][::-1]

    def wait_for(self, stage: str, timeout: float = 10.0
                 ) -> Optional[RuntimeEvent]:
        """The latest event of ``stage`` already in the ring, else the
        first one emitted within ``timeout`` seconds, else None: the
        startup-sequencing primitive."""
        got: List[RuntimeEvent] = []
        cond = threading.Event()

        def on(ev: RuntimeEvent) -> None:
            if ev.stage == stage:
                got.append(ev)
                cond.set()

        unsub = self.subscribe(on)
        try:
            with self._lock:
                for ev in reversed(self._ring):
                    if ev.stage == stage:
                        return ev
            if cond.wait(timeout):
                return got[0]
            return None
        finally:
            unsub()


# the process-default bus; registries built ``isolated()`` get their own
default_bus = EventBus()
