"""Lightweight span tracing with OTLP-compatible structure.

Capability parity with pkg/observability/tracing (tracing.go:43-140 +
per-concept span helpers :189-266 and W3C propagation.go): signal /
decision / plugin / upstream spans with attributes, W3C traceparent
extraction+injection so router spans parent backend spans.  Spans collect
into an in-proc ring buffer (inspectable by tests and the flight
recorder) and go to any registered sinks.  The port's copy of
``semantic_router_tpu.observability.tracing``, without an OpenTelemetry
SDK backend.

Spans carry TWO clock pairs: epoch times (``start_t``/``end_t``,
``time.time``) for OTLP export, and monotonic times (``start_pc``/
``end_pc``, ``time.perf_counter``) that ``duration_s`` reads — an NTP
step mid-span can skew the exported wall-clock but can never produce a
negative duration.  Spans also carry OTLP span *links* (non-parental
references to spans in other traces) — the mechanism batch tracing uses
to tie a request's ``batch.ride`` span to the shared ``batch.execute``
device-step span (observability.batchtrace).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_TRACEPARENT = "traceparent"

_HEX = frozenset("0123456789abcdef")


def _is_hex(s: str, n: int) -> bool:
    return len(s) == n and not (set(s) - _HEX)


def _rand_hex(n: int) -> str:
    """os.urandom-backed id material: fork-safe (no shared PRNG state
    cloned into workers) and collision-resistant, unlike the seeded
    ``random`` module."""
    return os.urandom((n + 1) // 2).hex()[:n]


def new_trace_id() -> str:
    return _rand_hex(32)


def new_span_id() -> str:
    return _rand_hex(16)


def trace_id_in_ratio(trace_id: str, rate: float,
                      default: bool = True) -> bool:
    """THE deterministic trace-id ratio convention, in one place:
    rightmost 8 hex chars over 0xFFFFFFFF (OTel TraceIdRatioBased —
    externally-minted W3C ids often carry timestamps in the HIGH bytes,
    which would skew a prefix ratio to 0% or 100%; trace-context level
    2 guarantees the randomness lives in the rightmost 7 bytes).

    Batch-trace sampling, decision-record sampling, and flywheel canary
    membership all route through this so a request's detailed trace,
    audit record, and canary assignment co-sample.  ``default`` answers
    unparseable ids: telemetry fails open (sample), a canary fails
    closed (incumbent)."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    try:
        return int(trace_id[-8:], 16) / 0xFFFFFFFF < rate
    except (TypeError, ValueError):
        return default


# Cross-instance active-span context: the innermost open span of THIS
# thread regardless of which Tracer opened it.  Batch tracing captures
# from here at enqueue time (the batcher cannot know which tracer the
# request bound), and the signal fan-out re-establishes it on worker
# threads.
_ACTIVE = threading.local()


def active_span() -> Optional[Tuple["Tracer", "Span"]]:
    """(tracer, span) of the calling thread's innermost open span, or
    None.  The capture seam for observability.batchtrace."""
    return getattr(_ACTIVE, "top", None)


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: str = ""
    start_t: float = field(default_factory=time.time)
    end_t: float = 0.0
    attributes: Dict[str, object] = field(default_factory=dict)
    # OTLP span links: non-parental references into OTHER traces
    # ({"trace_id": ..., "span_id": ...})
    links: List[Dict[str, str]] = field(default_factory=list)
    # monotonic pair backing duration_s (epoch pair stays for OTLP)
    start_pc: float = field(default_factory=time.perf_counter)
    end_pc: float = 0.0

    def set(self, **attrs) -> None:
        self.attributes.update(attrs)

    def add_link(self, trace_id: str, span_id: str) -> None:
        self.links.append({"trace_id": trace_id, "span_id": span_id})

    def end(self) -> None:
        self.end_t = time.time()
        self.end_pc = time.perf_counter()

    @property
    def duration_s(self) -> float:
        """Monotonic duration: immune to NTP steps between start and end
        (time.time deltas went negative under clock slew — VERDICT-class
        bug; the epoch pair is export-only)."""
        return (self.end_pc or time.perf_counter()) - self.start_pc


@dataclass
class PendingTrace:
    """A trace begun before its root span exists: the streamed-prefetch
    seam.  The ExtProc filter's early signal evaluation runs while the
    request body is still arriving, before ``route()`` opens
    ``router.route``; (trace_id, root_span_id) minted when the prefetch
    is enqueued let its spans parent under the root span the request
    will have, because ``route()`` later adopts both ids."""

    tracer: "Tracer"
    trace_id: str
    root_span_id: str
    parent_id: str = ""  # the caller's traceparent member, if any


class Tracer:
    def __init__(self, capacity: int = 2048,
                 sample_rate: float = 0.1,
                 force_capacity: int = 1024) -> None:
        self.capacity = capacity
        # fraction of traces that get DETAILED batch tracing — the fenced
        # split-program per-stage timing (observability.batchtrace).
        # Trace CONTINUITY (batch.wait/ride spans + step links) is never
        # sampled away; only the device-syncing detail is, so the default
        # hot path pays no extra fences.  Deterministic per trace_id, so
        # a trace is all-or-nothing.
        self.sample_rate = sample_rate
        # tail-based keep set: trace ids the flight recorder retained
        # (threshold breach / slowest-N) are force-sampled from then on —
        # continued activity on a pathological trace gets the detailed
        # treatment regardless of sample_rate.  Bounded FIFO so a breach
        # storm can't grow it unboundedly.
        self.force_capacity = force_capacity
        self._forced: Dict[str, None] = {}
        self._spans: List[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._sinks: List = []  # callables(span) invoked on span end

    # -- tail-based sampling ----------------------------------------------

    def force_sample(self, trace_id: str) -> None:
        """Pin a trace as sampled (flight-recorder retention hook): every
        later sampling decision for this trace id returns True."""
        if not trace_id:
            return
        with self._lock:
            self._forced[trace_id] = None
            while len(self._forced) > self.force_capacity:
                self._forced.pop(next(iter(self._forced)))

    def is_force_sampled(self, trace_id: str) -> bool:
        return trace_id in self._forced

    def add_sink(self, sink) -> None:
        with self._lock:
            self._sinks.append(sink)

    def remove_sink(self, sink) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    # -- context propagation (W3C traceparent) ----------------------------

    @staticmethod
    def extract(headers: Dict[str, str]) -> tuple[str, str]:
        """traceparent → (trace_id, parent_span_id); fresh ids if absent.

        Validated per W3C trace-context: 32-hex non-zero trace-id and
        16-hex non-zero parent-id — a malformed member restarts the trace
        instead of propagating garbage ids downstream."""
        tp = headers.get(_TRACEPARENT, "")
        parts = tp.split("-")
        if len(parts) == 4 and _is_hex(parts[1], 32) \
                and parts[1] != "0" * 32:
            if _is_hex(parts[2], 16) and parts[2] != "0" * 16:
                return parts[1], parts[2]
        return new_trace_id(), ""

    @staticmethod
    def inject(trace_id: str, span_id: str,
               headers: Dict[str, str]) -> None:
        headers[_TRACEPARENT] = f"00-{trace_id}-{span_id}-01"

    # -- spans -------------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, trace_id: str = "", parent_id: str = "",
             **attrs):
        current = getattr(self._local, "span", None)
        if not trace_id:
            trace_id = current.trace_id if current else new_trace_id()
        if not parent_id and current is not None:
            parent_id = current.span_id
        s = Span(name, trace_id, new_span_id(), parent_id,
                 attributes=dict(attrs))
        prev = current
        prev_active = getattr(_ACTIVE, "top", None)
        self._local.span = s
        _ACTIVE.top = (self, s)
        try:
            yield s
        finally:
            s.end()
            self._local.span = prev
            _ACTIVE.top = prev_active
            self._finish(s)

    def record(self, span: Span) -> None:
        """Record an externally-constructed span (batch tracing builds
        spans with explicit timestamps on the batch runner thread): ring
        + sinks, ending it first if the caller didn't."""
        if not span.end_t:
            span.end()
        self._finish(span)

    def _finish(self, s: Span) -> None:
        with self._lock:
            self._spans.append(s)
            if len(self._spans) > self.capacity:
                del self._spans[:len(self._spans) - self.capacity]
            sinks = list(self._sinks)
        for sink in sinks:  # exporters (OTLP); never raise into spans
            try:
                sink(s)
            except Exception:
                pass

    def decision_span(self, **attrs):
        return self.span("decision.evaluate", **attrs)

    def spans(self, name_prefix: str = "") -> List[Span]:
        with self._lock:
            return [s for s in self._spans
                    if s.name.startswith(name_prefix)]

    def trace(self, trace_id: str) -> List[Span]:
        """Every retained span of one trace (flight recorder / tests)."""
        with self._lock:
            return [s for s in self._spans if s.trace_id == trace_id]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


default_tracer = Tracer()
