"""Dynamic batching shim — the host-side front end of the engine.

The port's copy of ``semantic_router_tpu.engine.batcher``:

- requests are grouped by (group_key, seq-len bucket); sequences pad to
  the bucket edge and batches pad to the next power of two ≤
  max_batch_size, so the device sees a small closed set of shapes;
- adaptive wait: the scheduler waits at most ``max_wait_ms`` past the
  oldest queued item, but fires at once when a batch is full or the queue
  holds a single item;
- fail-open: a runner error resolves every future of the batch with the
  exception instead of wedging callers;
- concurrent dispatch: ready batches go to a small worker pool, at most
  ONE in-flight batch per group by default, so a slow bucket cannot park
  live traffic on others;
- composition hooks (``_inflight_cap``, ``_group_full``,
  ``_ready_immediately``, ``_take_batch``): the packing scheduler
  (engine.packing.scheduler) overrides them; the defaults here are the
  fixed-row batching above;
- cancellation: a future cancelled while queued is dropped before its
  batch runs; once a batch starts, its futures can no longer be cancelled;
- tracing: each item captures the submitting thread's trace context at
  enqueue (observability.batchtrace), so the runner can emit the
  request's batch.wait / batch.ride spans from a dispatch thread; each
  dispatched batch feeds ``llm_batcher_queue_wait_seconds`` (with the
  request's trace id as exemplar) and ``llm_batcher_batch_fill_ratio``.

The runner receives (group_key, list[BatchItem]) and returns one result
per item; it owns padding and stacking since shapes are model-specific.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence

from ..observability.batchtrace import capture as _capture_trace


@dataclass
class BatchItem:
    payload: Any
    future: Future = field(default_factory=Future)
    enqueue_t: float = field(default_factory=time.perf_counter)
    # the originating request's (tracer, trace_id, span_id, sampled),
    # captured at enqueue — None on untraced requests
    trace: Any = field(default_factory=_capture_trace)
    # packed steps this item was passed over by the packing scheduler's
    # lookahead: bounded by its starvation_steps knob
    deferred: int = 0


BatchRunner = Callable[[Hashable, List[BatchItem]], Sequence[Any]]


def pow2_batch(n: int, max_batch: int) -> int:
    """Smallest power of two ≥ n, capped at max_batch (a non-power-of-two
    cap adds exactly one extra batch shape)."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


def pick_bucket(seq_len: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``seq_len``; past the largest bucket it
    clamps to buckets[-1] and the batch builder clips the encoding there
    (the result is then marked truncated)."""
    for b in buckets:
        if seq_len <= b:
            return b
    return buckets[-1]


class _DispatchPool:
    """N daemon worker threads over a queue (daemon, so a forward wedged in
    a CUDA call cannot block process exit); shutdown() CANCELS still-queued
    batches instead of running them against torn-down state."""

    def __init__(self, workers: int, name: str) -> None:
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._stopped = False
        # serialises submit's check+put against shutdown's flag+drain
        self._guard = threading.Lock()
        # workers inside a batch (the saturation the degradation ladder
        # reads), under a lock of its own: += is not atomic
        self._busy = 0
        self._busy_lock = threading.Lock()
        self._threads = []
        for i in range(max(1, workers)):
            t = threading.Thread(target=self._work, daemon=True,
                                 name=f"{name}-{i}")
            t.start()
            self._threads.append(t)

    def stats(self) -> dict:
        """Queued batches and busy / total workers: all busy with a
        backlog means the dispatch pool is the bottleneck."""
        return {"workers": len(self._threads), "queued": self._q.qsize(),
                "busy": self._busy}

    def submit(self, run: Callable, cancel: Callable, *args: Any) -> None:
        with self._guard:
            if self._stopped:
                raise RuntimeError("dispatch pool stopped")
            self._q.put((run, cancel, args))

    def _work(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            run, cancel, args = item
            with self._busy_lock:
                self._busy += 1
            try:
                (cancel if self._stopped else run)(*args)
            finally:
                with self._busy_lock:
                    self._busy -= 1

    def shutdown(self, timeout: float = 5.0) -> None:
        with self._guard:
            self._stopped = True
            for _ in self._threads:
                self._q.put(None)
        # drain-and-cancel what is still queued; re-put any sentinel the
        # drain steals so no idle worker blocks in get() forever
        stolen = 0
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                stolen += 1
            else:
                _, cancel, args = item
                cancel(*args)
        for _ in range(stolen):
            self._q.put(None)
        for t in self._threads:
            t.join(timeout=timeout)


class DynamicBatcher:
    """Coalesces concurrent requests into padded batches per group."""

    def __init__(self, runner: BatchRunner, max_batch_size: int = 32,
                 max_wait_ms: float = 2.0, name: str = "batcher",
                 dispatch_workers: int = 4, metrics=None) -> None:
        self.runner = runner
        self.name = name
        self.max_batch_size = max(1, max_batch_size)
        self.max_wait_s = max_wait_ms / 1000.0
        self._queues: Dict[Hashable, List[BatchItem]] = {}
        self._inflight: Dict[Hashable, int] = {}
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stop = False
        self._stats = {"batches": 0, "items": 0, "max_batch": 0,
                       "cancelled": 0, "observe_errors": 0}
        # the MetricSeries the batch observations go to (None: the
        # process default series)
        self._metrics = metrics
        self._pool = _DispatchPool(dispatch_workers,
                                   name=f"{name}-dispatch")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self._thread.start()

    # -- public ------------------------------------------------------------

    def submit(self, group_key: Hashable, payload: Any) -> Future:
        return self.submit_many(group_key, [payload])[0]

    def submit_many(self, group_key: Hashable,
                    payloads: Sequence[Any]) -> List[Future]:
        items = [BatchItem(p) for p in payloads]
        with self._wake:
            if self._stop:
                raise RuntimeError("batcher stopped")
            self._queues.setdefault(group_key, []).extend(items)
            self._wake.notify()
        return [i.future for i in items]

    def _series(self):
        if self._metrics is not None:
            return self._metrics
        from ..observability.metrics import default_series

        return default_series

    def _observe_batch(self, batch: List[BatchItem]) -> None:
        """Queue-wait + occupancy series per dispatched batch.  Runs on
        the single picker thread, so it fails open — an observability
        error must never kill the loop all serving depends on — but
        counts the failure (``stats()["observe_errors"]``)."""
        try:
            s = self._series()
            now = time.perf_counter()
            for item in batch:
                # exemplar: the waiting request's trace id, so a slow
                # queue-wait bucket links to the trace that landed there
                tid = item.trace.trace_id if item.trace is not None else None
                s.batcher_queue_wait.observe(now - item.enqueue_t,
                                             exemplar=tid,
                                             batcher=self.name)
            s.batcher_fill_ratio.observe(len(batch) / self.max_batch_size,
                                         batcher=self.name)
        except Exception:
            with self._lock:
                self._stats["observe_errors"] += 1

    def queue_depths(self) -> dict:
        """Live congestion snapshot for the runtime-stats sampler
        (llm_dispatcher_queue_depth) and the degradation ladder: queued
        items/groups, in-flight groups, and the dispatch pool's queued
        batches, busy workers and saturation."""
        with self._lock:
            out = {
                "pending_items": sum(len(v) for v in
                                     self._queues.values()),
                "pending_groups": sum(1 for v in self._queues.values()
                                      if v),
                "inflight_groups": sum(1 for v in self._inflight.values()
                                       if v > 0),
            }
        pool = self._pool.stats()
        out["pool_queued"] = pool["queued"]
        out["pool_busy"] = pool["busy"]
        out["pool_saturation"] = (pool["busy"] / pool["workers"]
                                  if pool["workers"] else 0.0)
        return out

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
        out["fill_ratio_mean"] = (out["items"] / out["batches"]
                                  / self.max_batch_size
                                  if out["batches"] else 0.0)
        return out

    def shutdown(self, timeout: float = 5.0) -> None:
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        self._thread.join(timeout=timeout)
        self._pool.shutdown(timeout=timeout)
        with self._lock:
            for items in self._queues.values():
                for it in items:
                    if not it.future.done():
                        it.future.set_exception(RuntimeError("batcher stopped"))
            self._queues.clear()

    # -- composition hooks (engine.packing.scheduler overrides them) -------

    def _inflight_cap(self, key: Hashable) -> int:
        """Most concurrent in-flight steps of a group: 1 keeps per-group
        ordering; the packing scheduler raises it (continuous
        admission)."""
        return 1

    def _group_full(self, key: Hashable, items: List[BatchItem]) -> bool:
        """True when the group should fire without waiting."""
        return len(items) >= self.max_batch_size

    def _ready_immediately(self, key: Hashable,
                           items: List[BatchItem]) -> bool:
        """Readiness before max_wait because something else provides the
        accumulation window (a step of the group in flight)."""
        return False

    def _take_batch(self, key: Hashable, items: List[BatchItem]) -> tuple:
        """Split a group's queue into (batch to dispatch, remainder)."""
        return items[:self.max_batch_size], items[self.max_batch_size:]

    # -- scheduler loop ----------------------------------------------------

    def _ready_group(self) -> Optional[Hashable]:
        """A group is ready when full (or ready at once), or its oldest
        item aged past max_wait, or (low-QPS fast path) it holds the only
        pending item.  A group at its in-flight cap is never ready."""
        now = time.perf_counter()
        oldest_key, oldest_age = None, -1.0
        total = 0
        for key, items in self._queues.items():
            if not items or self._inflight.get(key, 0) \
                    >= self._inflight_cap(key):
                continue
            total += len(items)
            if self._group_full(key, items) \
                    or self._ready_immediately(key, items):
                return key
            age = now - items[0].enqueue_t
            if age > oldest_age:
                oldest_key, oldest_age = key, age
        if oldest_key is None:
            return None
        if oldest_age >= self.max_wait_s:
            return oldest_key
        if total == len(self._queues.get(oldest_key, ())) and total <= 1:
            return oldest_key
        return None

    def _next_deadline(self) -> Optional[float]:
        deadline = None
        for key, items in self._queues.items():
            if items and self._inflight.get(key, 0) \
                    < self._inflight_cap(key):
                d = items[0].enqueue_t + self.max_wait_s
                deadline = d if deadline is None else min(deadline, d)
        return deadline

    def _loop(self) -> None:
        while True:
            with self._wake:
                while not self._stop:
                    key = self._ready_group()
                    if key is not None:
                        break
                    deadline = self._next_deadline()
                    timeout = None if deadline is None else \
                        max(0.0, deadline - time.perf_counter())
                    self._wake.wait(timeout=timeout)
                if self._stop:
                    return
                items = self._queues[key]
                batch, rest = self._take_batch(key, items)
                if not batch:  # a planner must never wedge the group
                    batch, rest = items[:1], items[1:]
                self._queues[key] = rest
                self._inflight[key] = self._inflight.get(key, 0) + 1
            self._observe_batch(batch)
            try:
                self._pool.submit(self._dispatch, self._cancel_batch,
                                  key, batch)
            except RuntimeError:  # pool shut down underneath us
                self._cancel_batch(key, batch)

    def _release_inflight(self, key: Hashable) -> None:
        n = self._inflight.get(key, 0)
        if n <= 1:
            self._inflight.pop(key, None)
        else:
            self._inflight[key] = n - 1

    def _dispatch(self, key: Hashable, batch: List[BatchItem]) -> None:
        try:
            self._run_batch(key, batch)
        finally:
            with self._wake:
                self._release_inflight(key)
                self._wake.notify()

    def _cancel_batch(self, key: Hashable, batch: List[BatchItem]) -> None:
        """Shutdown raced this batch out of the pool queue: fail its
        futures rather than running the model against torn-down state."""
        with self._wake:
            self._release_inflight(key)
        for item in batch:
            if not item.future.done():
                item.future.set_exception(RuntimeError("batcher stopped"))

    def _run_batch(self, key: Hashable, batch: List[BatchItem]) -> None:
        # claim every future: a cancelled one drops out of the batch, the
        # rest can no longer be cancelled mid-run
        live = [it for it in batch if it.future.set_running_or_notify_cancel()]
        with self._lock:
            self._stats["cancelled"] += len(batch) - len(live)
            if live:
                self._stats["batches"] += 1
                self._stats["items"] += len(live)
                self._stats["max_batch"] = max(self._stats["max_batch"],
                                               len(live))
        if not live:
            return
        try:
            results = self.runner(key, live)
            if len(results) != len(live):
                raise RuntimeError(
                    f"runner returned {len(results)} results for "
                    f"{len(live)} items")
            for item, res in zip(live, results):
                item.future.set_result(res)
        except Exception as exc:  # fail open: propagate to callers
            for item in live:
                if not item.future.done():
                    item.future.set_exception(exc)
