"""Slow-request flight recorder: bounded retention of full span trees.

A trace backend answers "what is p99 doing" only if the interesting
traces survive sampling — the recorder guarantees the pathological ones
do, in-process and dumpable without any collector:

- the **slowest N** requests seen so far (min-heap eviction), and
- every request breaching ``threshold_s`` (bounded ring, newest wins),

each retained as the request's full span tree (router stages, signal
fan-out, batch.wait/ride with the batch.execute link) plus caller
metadata.  ``/debug/flightrec`` on the management API dumps it; tests
call ``dump()`` directly.  ``consider()`` takes a *span provider*
callable so the serialization cost is only paid for requests actually
retained.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .tracing import Span


def span_to_dict(span: Span) -> Dict[str, Any]:
    return {
        "name": span.name,
        "trace_id": span.trace_id,
        "span_id": span.span_id,
        "parent_id": span.parent_id,
        "start_t": span.start_t,
        "end_t": span.end_t,
        "duration_s": round(span.duration_s, 6),
        "attributes": dict(span.attributes),
        "links": [dict(l) for l in span.links],
    }


class FlightRecorder:
    def __init__(self, slowest_n: int = 16,
                 threshold_s: Optional[float] = None,
                 breach_capacity: int = 64) -> None:
        self.slowest_n = slowest_n
        self.threshold_s = threshold_s
        self.breach_capacity = breach_capacity
        # heap of (duration_s, seq, record): smallest of the kept slowest
        # at the root, so admission is an O(log n) replace
        self._slowest: List[tuple] = []
        self._breaches: deque = deque(maxlen=breach_capacity)
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self.considered = 0
        self.retained = 0
        # tail-based sampling hook: called with the trace id of every
        # retained request (Router wires it to Tracer.force_sample), so
        # threshold-breaching / slowest-N traces are force-kept by the
        # sampler, not just recorded locally
        self.on_retain: Optional[Callable[[str], None]] = None
        # the SLO-burn capture's cross-links (programstats'
        # SLOCaptureController.links): a dump carries them, so an
        # incident's slow requests point at the trace taken at the burn
        self.capture_provider: Optional[
            Callable[[], List[Dict[str, Any]]]] = None

    def configure(self, slowest_n: Optional[int] = None,
                  threshold_s: Optional[float] = None,
                  breach_capacity: Optional[int] = None) -> None:
        """Apply operator config (observability.flight_recorder) to the
        live instance — registry-slotted, so bootstrap mutates in place."""
        with self._lock:
            if slowest_n is not None:
                self.slowest_n = int(slowest_n)
                while len(self._slowest) > self.slowest_n:
                    heapq.heappop(self._slowest)
            if threshold_s is not None:
                self.threshold_s = float(threshold_s) or None
            if breach_capacity is not None:
                self.breach_capacity = int(breach_capacity)
                self._breaches = deque(self._breaches,
                                       maxlen=self.breach_capacity)

    # -- recording --------------------------------------------------------

    def consider(self, request_id: str, trace_id: str, duration_s: float,
                 span_provider: Callable[[], List[Span]],
                 meta: Optional[Dict[str, Any]] = None) -> bool:
        """Offer one finished request; returns True when retained.  The
        span provider runs only on admission — the steady-state fast path
        is two comparisons under the lock."""
        with self._lock:
            self.considered += 1
            breach = self.threshold_s is not None \
                and duration_s >= self.threshold_s
            slow = len(self._slowest) < self.slowest_n or (
                self._slowest and duration_s > self._slowest[0][0])
            slow = slow and self.slowest_n > 0
            if not (breach or slow):
                return False
        try:
            spans = [span_to_dict(s) for s in span_provider()]
        except Exception:
            spans = []
        record = {
            "request_id": request_id,
            "trace_id": trace_id,
            "duration_s": round(duration_s, 6),
            "recorded_unix": time.time(),
            "meta": dict(meta or {}),
            "spans": spans,
        }
        with self._lock:
            # re-check under the lock: another thread may have filled the
            # heap between the admission probe and here — retained/True
            # must reflect what was actually stored
            stored = False
            if breach:
                self._breaches.append(record)
                stored = True
            if slow and self.slowest_n > 0:
                entry = (duration_s, next(self._seq), record)
                if len(self._slowest) < self.slowest_n:
                    heapq.heappush(self._slowest, entry)
                    stored = True
                elif duration_s > self._slowest[0][0]:
                    heapq.heapreplace(self._slowest, entry)
                    stored = True
            if stored:
                self.retained += 1
        if stored and self.on_retain is not None:
            try:  # a sampling-hook error must never surface into routing
                self.on_retain(trace_id)
            except Exception:
                pass
        return stored

    # -- reading ----------------------------------------------------------

    def dump(self) -> Dict[str, Any]:
        with self._lock:
            slowest = [r for _, _, r in
                       sorted(self._slowest, key=lambda e: -e[0])]
            out = {
                "slowest_n": self.slowest_n,
                "threshold_s": self.threshold_s,
                "considered": self.considered,
                "retained": self.retained,
                "slowest": slowest,
                "breaches": list(self._breaches),
            }
        provider = self.capture_provider
        if provider is not None:
            # outside the lock: the provider reads another subsystem
            try:
                out["slo_captures"] = provider()
            except Exception:
                pass
        return out

    def clear(self) -> None:
        with self._lock:
            self._slowest.clear()
            self._breaches.clear()


default_flight_recorder = FlightRecorder()
