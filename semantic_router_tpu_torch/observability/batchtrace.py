"""Cross-batch trace propagation: request traces that survive the batcher.

The fused batcher executes on background dispatch threads where the
thread-local ``Tracer`` context is lost — before this module, a request's
trace ended at ``signals.evaluate`` and the hottest path (queue wait,
bucket choice, the shared trunk forward, head demux) was invisible.  The
fix mirrors how production LLM servers attribute a request's latency to
the batch iteration it rode in:

1. **Capture** — ``capture()`` snapshots the submitting thread's active
   ``(tracer, trace_id, span_id)`` into the ``BatchItem`` at enqueue time
   (engine.batcher), plus a deterministic per-trace *sampled* bit from
   the tracer's ``sample_rate``.

2. **Step span** — the batch runner opens ONE ``batch.execute`` span per
   device step (its own trace: the step is shared by many requests), with
   batch size / fill ratio / padded-vs-real rows / fused task mix / per-
   stage timings as attributes.

3. **Ride spans** — each originating request's trace receives
   ``batch.wait`` (enqueue → dispatch), ``batch.tokenize`` (host encode
   or EncodingCache hit), and ``batch.ride`` (dispatch → results)
   children, the ride span carrying an OTLP span *link* to the shared
   step span, plus per-stage child spans (trunk forward, head matmul,
   demux) so tail latency decomposes per request.

4. **Two-tier cost model** — a batch with no traced item skips the step
   entirely (one list scan, no spans).  Traced items always get the
   continuity spans above (cheap host-side bookkeeping), but the
   *detailed* per-stage attribution — the fenced two-call (trunk, heads)
   execution with a CUDA event synchronized between stages
   (``BatchStep.fence``) — only runs when a trace is SAMPLED
   (``Tracer.sample_rate``, default 10%), so the device syncs never
   become the default hot path.

The port's copy of ``semantic_router_tpu.observability.batchtrace``.  The
sampled split execution runs the trunk and the heads as two eager calls,
where the unsampled step replays one CUDA graph: the same kernels in the
same order, held by the parity tests to the fused step's logits within
1e-4.  It never captures a graph, so a sampled batch adds no capture in
the middle of a burst.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from .tracing import Span, Tracer, active_span, new_span_id, new_trace_id

STEP_SPAN = "batch.execute"
RIDE_SPAN = "batch.ride"
WAIT_SPAN = "batch.wait"
TOKENIZE_SPAN = "batch.tokenize"
STAGE_PREFIX = "batch."


@dataclass
class TraceContext:
    """The portable slice of a request's trace: enough to emit spans into
    it from any thread, plus the tracer that owns the ring/sinks."""

    tracer: Tracer
    trace_id: str
    span_id: str
    sampled: bool = True


def _sampled(tracer: Tracer, trace_id: str) -> bool:
    """Deterministic per-trace sampling from the tracer's sample_rate:
    every span of one trace makes the same choice, so a sampled trace is
    complete and an unsampled one costs nothing downstream.  Traces the
    flight recorder force-kept (tail-based sampling) are always
    detailed, whatever the rate."""
    forced = getattr(tracer, "is_force_sampled", None)
    if forced is not None and forced(trace_id):
        return True
    from .tracing import trace_id_in_ratio

    rate = float(getattr(tracer, "sample_rate", 1.0))
    return trace_id_in_ratio(trace_id, rate, default=True)


def capture() -> Optional[TraceContext]:
    """Snapshot the calling thread's active span as a TraceContext, or
    None when no trace is open (the untraced hot path: one thread-local
    read)."""
    top = active_span()
    if top is None:
        return None
    tracer, span = top
    return TraceContext(tracer, span.trace_id, span.span_id,
                        _sampled(tracer, span.trace_id))


@contextlib.contextmanager
def activate(ctx: Optional[TraceContext], name: str, **attrs):
    """Re-establish a captured context on another thread by opening a
    named child span there (the signal fan-out's propagation seam); a
    None context degrades to a no-op."""
    if ctx is None:
        yield None
        return
    with ctx.tracer.span(name, trace_id=ctx.trace_id,
                         parent_id=ctx.span_id, **attrs) as s:
        yield s


def _mk_span(name: str, trace_id: str, parent_id: str,
             t0_pc: float, t1_pc: float, offset: float,
             **attrs) -> Span:
    """Span from monotonic endpoints: epoch pair derived via the current
    perf→epoch offset, monotonic pair kept exact for duration_s."""
    s = Span(name, trace_id, new_span_id(), parent_id,
             start_t=t0_pc + offset, attributes=dict(attrs))
    s.start_pc = t0_pc
    s.end_pc = t1_pc
    s.end_t = t1_pc + offset
    return s


class BatchStep:
    """One device step's tracing state: stage timers + the traced items.

    Created by ``start_step`` only when ≥1 item carries a trace context;
    ``detailed`` is True when any of those traces is sampled — the
    runner gates the fenced split-program stage timing on it.  The
    runner times stages through ``stage()``/``fence()`` and ``finish()``
    emits the step span plus every per-request wait/tokenize/ride span
    tree (call it in a ``finally`` so failing batches still trace)."""

    def __init__(self, name: str, traced: List[Tuple[Any, TraceContext]],
                 attrs: Dict[str, Any], detailed: bool = True) -> None:
        self.trace_id = new_trace_id()
        self.span_id = new_span_id()
        self.name = name
        self.attrs = dict(attrs)
        self.traced = traced
        self.detailed = detailed
        self.start_pc = time.perf_counter()
        self.stages: List[Tuple[str, float, float]] = []
        self._finished = False

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.append((name, t0, time.perf_counter()))

    def fence(self, value) -> None:
        """Block until the device finishes ``value`` so the enclosing
        stage's wall-clock is device time, not dispatch time: a CUDA
        event recorded on the current stream, then synchronized.  Only
        ever called on the sampled path (never inside a graph capture) —
        the untraced path never syncs.  A host tensor is already done, so
        its fence does nothing."""
        import torch

        if isinstance(value, torch.Tensor) and value.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(value.device))
            event.synchronize()

    def finish(self) -> None:
        if self._finished:  # idempotent: callers run it in a finally
            return
        self._finished = True
        end_pc = time.perf_counter()
        offset = time.time() - time.perf_counter()
        stage_attrs = {f"stage.{n}_ms": round((t1 - t0) * 1e3, 3)
                       for n, t0, t1 in self.stages}
        step = _mk_span(self.name, self.trace_id, "",
                        self.start_pc, end_pc, offset,
                        **self.attrs, **stage_attrs)
        step.span_id = self.span_id
        tracers = []
        for _, ctx in self.traced:
            if all(t is not ctx.tracer for t in tracers):
                tracers.append(ctx.tracer)
        for t in tracers:
            t.record(step)

        for item, ctx in self.traced:
            payload = getattr(item, "payload", None)
            enq = getattr(item, "enqueue_t", self.start_pc)
            wait = _mk_span(WAIT_SPAN, ctx.trace_id, ctx.span_id,
                            enq, self.start_pc, offset,
                            wait_ms=round((self.start_pc - enq) * 1e3, 3))
            ctx.tracer.record(wait)
            tok_s = float(getattr(payload, "tok_s", 0.0) or 0.0)
            if tok_s > 0.0 or getattr(payload, "tok_cached", False):
                sub = float(getattr(payload, "submit_t", enq) or enq)
                tok = _mk_span(
                    TOKENIZE_SPAN, ctx.trace_id, ctx.span_id,
                    sub - tok_s, sub, offset,
                    cache_hit=bool(getattr(payload, "tok_cached", False)))
                ctx.tracer.record(tok)
            ride = _mk_span(RIDE_SPAN, ctx.trace_id, ctx.span_id,
                            self.start_pc, end_pc, offset, **self.attrs)
            ride.add_link(self.trace_id, self.span_id)
            for n, t0, t1 in self.stages:
                ctx.tracer.record(_mk_span(
                    STAGE_PREFIX + n, ctx.trace_id, ride.span_id,
                    t0, t1, offset))
            ctx.tracer.record(ride)


def stage(step: Optional[BatchStep], name: str):
    """Stage guard for the batch runners: records a timed stage only
    when the step exists AND its trace is sampled (detailed) — one
    helper instead of the same conditional at every call site."""
    if step is None or not step.detailed:
        return contextlib.nullcontext()
    return step.stage(name)


def start_step(items, *, group: str, bucket: int, max_batch: int,
               padded_rows: int, kind: str = "fused",
               name: str = STEP_SPAN) -> Optional[BatchStep]:
    """Open per-step tracing iff any batch item carries a trace context;
    the common untraced case is one list scan and a None.  The step is
    ``detailed`` (fenced per-stage timing) only when some traced item's
    trace is sampled."""
    traced = [(it, it.trace) for it in items
              if getattr(it, "trace", None) is not None]
    if not traced:
        return None
    detailed = any(ctx.sampled for _, ctx in traced)
    mix: Dict[str, int] = {}
    for it in items:
        for task in getattr(getattr(it, "payload", None), "tasks", ()) or ():
            mix[task] = mix.get(task, 0) + 1
    attrs = {
        "group": group,
        "bucket": int(bucket),
        "kind": kind,
        "batch_size": len(items),
        "padded_rows": int(padded_rows),
        "real_rows": len(items),
        "fill_ratio": round(len(items) / max(1, max_batch), 4),
    }
    if mix:
        attrs["task_mix"] = ",".join(
            f"{t}:{n}" for t, n in sorted(mix.items()))
    return BatchStep(name, traced, attrs, detailed=detailed)
