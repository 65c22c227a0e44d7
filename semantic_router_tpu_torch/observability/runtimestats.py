"""Always-on runtime telemetry: device-step sampler + process gauges.

The port's copy of ``semantic_router_tpu.observability.runtimestats``.
Request traces and the profiler answer questions on demand; this layer
continuously answers "is the engine healthy and where did the step time
go": an always-on, low-overhead accounting of every device step plus
periodic process/device gauges, scraped into the metrics registry.

Cost model
----------
The engine's batch runners call :meth:`RuntimeStats.record_step` once
per device step — one bounded ``deque.append`` on the untraced hot path
(no locks, no histogram math, no jit changes).  A background sampler
thread (or any scrape/report call) drains the deque and aggregates into:

- a **per-program registry** keyed by ``(group, bucket, variant)``
  (variant: ``fused`` trunk-group batches / ``fused_detailed`` sampled
  split batches / ``split`` per-task and embedding batches) recording
  the cold first execution (a CUDA graph capture on the card, the first
  eager run on the CPU) apart from the warm execute EWMA + histogram,
  and padding-waste / token-fill accounting;
- **the step log**: the last ``max_steps`` steps' detail records (the
  engine's ``steps()`` is a view of it, per engine);
- **process gauges**: host RSS, device memory from
  ``torch.cuda.memory_stats`` / ``mem_get_info`` plus the CUDA-graph pool
  bytes the engines report (absent on the CPU — skipped), dispatcher
  queue depths + dispatch-pool saturation (providers registered by the
  engine/batcher), GC pauses (``gc.callbacks``), and live thread count.

``enabled = False`` short-circuits ``record_step`` before the append.
"""

from __future__ import annotations

import gc
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

EWMA_ALPHA = 0.2  # ~ last 5 steps dominate the warm execute estimate

_STEP_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0, 2.5, 5.0)
_COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                    30.0, 60.0, 120.0)

# llm_device_memory_bytes mapping: canonical stat label (the reference's)
# → accepted key spellings in the row read from ``torch.cuda``, first
# present wins.  ``bytes_limit`` is the card's total from
# ``mem_get_info``; ``bytes_reserved`` (the caching allocator's pool) and
# ``graph_pool_bytes`` (the CUDA-graph pools the engines' captures
# reserved) are the port's own.  The CPU reports nothing.
DEVICE_MEMORY_STATS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("bytes_in_use", ("bytes_in_use", "allocated_bytes.all.current")),
    ("bytes_limit", ("bytes_limit", "mem_get_info.total")),
    ("peak_bytes_in_use", ("peak_bytes_in_use",
                           "allocated_bytes.all.peak")),
    ("bytes_reserved", ("reserved_bytes.all.current",)),
    ("graph_pool_bytes", ("graph_pool_bytes",)),
)


@dataclass
class ProgramStats:
    """Accounting for ONE program shape family (group, bucket, variant).
    ``compiles`` counts the cold first executions of its device shapes —
    each a CUDA graph capture on the card; the cold step's wall-clock
    (eager run + capture) lands in ``compile_s_total``, never in the
    warm-execute EWMA/histogram."""

    group: str
    bucket: int
    variant: str
    compiles: int = 0
    compile_s_total: float = 0.0
    executes: int = 0
    execute_s_total: float = 0.0
    execute_ewma_s: float = 0.0
    last_execute_s: float = 0.0
    rows_real: int = 0
    rows_padded: int = 0
    # packed-row accounting (engine.packing): token-level fill — the
    # row-level ratio above cannot see intra-row padding once several
    # prompts share a row, so packed steps report the real token counts
    tokens_real: int = 0
    tokens_padded: int = 0
    segments_real: int = 0

    def snapshot(self) -> Dict[str, Any]:
        waste = (self.rows_padded - self.rows_real) / self.rows_padded \
            if self.rows_padded else 0.0
        out = {
            "group": self.group, "bucket": self.bucket,
            "variant": self.variant,
            "compiles": self.compiles,
            "compile_s_total": round(self.compile_s_total, 6),
            "executes": self.executes,
            "execute_s_total": round(self.execute_s_total, 6),
            "execute_ewma_s": round(self.execute_ewma_s, 6),
            "last_execute_s": round(self.last_execute_s, 6),
            "rows_real": self.rows_real,
            "rows_padded": self.rows_padded,
            "padding_waste_ratio": round(waste, 4),
            "fill_ratio_mean": round(1.0 - waste, 4),
        }
        if self.tokens_padded:
            tfill = self.tokens_real / self.tokens_padded
            out["tokens_real"] = self.tokens_real
            out["tokens_padded"] = self.tokens_padded
            out["token_fill_ratio"] = round(tfill, 4)
            out["token_waste_ratio"] = round(1.0 - tfill, 4)
        if self.segments_real:
            out["segments_real"] = self.segments_real
        return out


class RuntimeStats:
    """The always-on device-step sampler + process gauge scraper, bound
    to one metrics registry (default: the process registry — the
    single-engine posture, like ``metrics.default_series``)."""

    def __init__(self, registry=None, max_pending: int = 8192,
                 ewma_alpha: float = EWMA_ALPHA,
                 max_steps: int = 4096) -> None:
        if registry is None:
            from .metrics import default_registry

            registry = default_registry
        self.registry = registry
        self.enabled = True
        self.ewma_alpha = ewma_alpha
        # hot-path target: bounded, thread-safe appends; aggregation
        # happens on the sampler thread / at scrape time
        self._pending: deque = deque(maxlen=max_pending)
        self._dropped = 0
        # the step log: per source (an engine), the detail records of
        # its newest ``max_steps`` steps, for the engines' steps() views
        self.max_steps = max_steps
        self._steps: Dict[int, deque] = {}
        # memory providers (an engine's CUDA-graph pool bytes), folded
        # into the device rows
        self._memory: Dict[str, Callable[[], Dict[str, float]]] = {}
        self._programs: Dict[Tuple[str, int, str], ProgramStats] = {}
        self._providers: Dict[str, Callable[[], Dict[str, float]]] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.interval_s = 10.0
        self._gc_t0: Optional[float] = None
        self._gc_cb_installed = False
        # per-generation accumulators the callback writes (plain
        # GIL-atomic adds — gen-0 collections fire constantly and the
        # callback must stay nearly free); sample_process publishes the
        # deltas to the counter series
        self._gc_counts: Dict[str, int] = {}
        self._gc_published: Dict[str, int] = {}
        self._last_process_sample: Dict[str, Any] = {}
        # per-signal-family warm-cost EWMAs (seconds), the series a
        # cheap → expensive signal ordering reads.  Bounded: family names
        # come from config, not requests.
        self._family_costs: Dict[str, Tuple[int, float]] = {}

        self.step_seconds = registry.histogram(
            "llm_runtime_step_seconds",
            "Warm device-step wall time by batch group/variant (cold "
            "compile steps land in llm_runtime_compile_step_seconds)",
            buckets=_STEP_BUCKETS)
        self.compile_steps = registry.counter(
            "llm_runtime_program_compiles_total",
            "Distinct device shapes compiled per batch group — on the "
            "card each is one CUDA graph capture")
        self.compile_seconds = registry.histogram(
            "llm_runtime_compile_step_seconds",
            "Cold-step wall time (eager run + graph capture) per "
            "batch group", buckets=_COMPILE_BUCKETS)
        self.step_rows = registry.counter(
            "llm_runtime_step_rows_total",
            "Device batch rows by kind: real rows carried requests, "
            "padding rows were shape-bucket waste")
        self.step_tokens = registry.counter(
            "llm_runtime_step_tokens_total",
            "Device batch TOKENS by kind on packing-accounted steps: "
            "real tokens carried prompts, padding tokens were row waste "
            "(engine.packing's fill surface)")
        self.rss_bytes = registry.gauge(
            "llm_process_rss_bytes", "Router process resident set size")
        self.threads = registry.gauge(
            "llm_process_threads", "Live Python threads in the process")
        self.device_memory = registry.gauge(
            "llm_device_memory_bytes",
            "Per-device memory from torch.cuda memory_stats() / "
            "mem_get_info() and the CUDA-graph pools (the CPU reports "
            "nothing)")
        self.queue_stats = registry.gauge(
            "llm_dispatcher_queue_depth",
            "Dispatcher queue depth + dispatch-pool saturation by "
            "batcher and stat")
        self.gc_pause = registry.histogram(
            "llm_gc_pause_seconds",
            "Stop-the-world CPython GC pause durations by generation")
        self.gc_collections = registry.counter(
            "llm_gc_collections_total", "GC collections by generation")

    # -- hot path ----------------------------------------------------------

    def record_step(self, group: str, bucket: int, variant: str,
                    rows: int, padded_rows: int, seconds: float,
                    compiled: bool = False, tokens_real: int = 0,
                    tokens_padded: int = 0, segments: int = 0,
                    detail: Optional[Dict[str, Any]] = None,
                    source: Any = None) -> None:
        """One device step, called by the engine's batch runners on the
        untraced hot path: a bounded deque append (aggregation is
        deferred to flush()).  Fused steps additionally carry token-level
        fill (``tokens_real``/``tokens_padded``) and the segment count.
        ``detail`` (the engine's own record of the step: flavor, graph,
        layers, kernels) lands in the step log under ``source``, which
        ``steps(source)`` reads back."""
        if not self.enabled:
            return
        if detail is not None:
            log = self._steps.get(id(source))
            if log is None:
                log = self._steps.setdefault(
                    id(source), deque(maxlen=self.max_steps))
            log.append(detail)
        if len(self._pending) == self._pending.maxlen:
            # bounded: backpressure never blocks serving.  The lock is
            # only taken on this saturated branch — the healthy path
            # stays a lock-free deque append.
            with self._lock:
                self._dropped += 1
        self._pending.append((group, int(bucket), variant, int(rows),
                              int(padded_rows), float(seconds),
                              bool(compiled), int(tokens_real),
                              int(tokens_padded), int(segments)))

    # -- aggregation -------------------------------------------------------

    def flush(self) -> int:
        """Drain pending step samples into the program registry + metric
        series; returns the number of samples aggregated.  Runs on the
        sampler thread and at scrape/report time."""
        n = 0
        while True:
            try:
                sample = self._pending.popleft()
            except IndexError:
                break
            (group, bucket, variant, rows, padded, secs, compiled,
             tok_real, tok_padded, segments) = sample
            key = (group, bucket, variant)
            with self._lock:
                p = self._programs.get(key)
                if p is None:
                    p = ProgramStats(group, bucket, variant)
                    self._programs[key] = p
                p.rows_real += rows
                p.rows_padded += padded
                p.tokens_real += tok_real
                p.tokens_padded += tok_padded
                p.segments_real += segments
                if compiled:
                    p.compiles += 1
                    p.compile_s_total += secs
                else:
                    p.executes += 1
                    p.execute_s_total += secs
                    p.last_execute_s = secs
                    p.execute_ewma_s = secs if p.executes == 1 else (
                        self.ewma_alpha * secs
                        + (1.0 - self.ewma_alpha) * p.execute_ewma_s)
            if compiled:
                self.compile_steps.inc(group=group)
                self.compile_seconds.observe(secs, group=group)
            else:
                self.step_seconds.observe(secs, group=group,
                                          variant=variant)
            self.step_rows.inc(rows, group=group, kind="real")
            if padded > rows:
                self.step_rows.inc(padded - rows, group=group,
                                   kind="padding")
            if tok_padded:
                self.step_tokens.inc(tok_real, group=group, kind="real")
                if tok_padded > tok_real:
                    self.step_tokens.inc(tok_padded - tok_real,
                                         group=group, kind="padding")
            n += 1
        return n

    # -- process gauges ----------------------------------------------------

    def register_provider(self, name: str,
                          fn: Callable[[], Dict[str, float]]) -> None:
        """Register a stat provider (e.g. a batcher's queue depths):
        ``fn() -> {stat: value}`` scraped into
        llm_dispatcher_queue_depth{batcher=name, stat=...}.  Keyed by
        name so a rebuilt engine replaces, never duplicates."""
        with self._lock:
            self._providers[name] = fn

    def unregister_provider(self, name: str, fn: Optional[Callable] = None
                            ) -> None:
        """Remove a provider; with ``fn`` given, only when the current
        mapping IS that callable — engine A shutting down must not rip
        out engine B's live provider registered under the same name."""
        with self._lock:
            if fn is None or self._providers.get(name) is fn:
                self._providers.pop(name, None)

    def provider_stats(self) -> Dict[str, Dict[str, float]]:
        """One pass over the registered providers WITHOUT touching the
        gauges — the read the resilience controller polls for queue
        pressure (sample_process publishes the same values to series).
        A failing provider is skipped, never fatal."""
        with self._lock:
            providers = list(self._providers.items())
        queues: Dict[str, Dict[str, float]] = {}
        for name, fn in providers:
            try:
                stats = fn() or {}
            except Exception:
                continue  # a torn-down batcher must not kill sampling
            queues[name] = {}
            for stat, value in stats.items():
                try:
                    queues[name][str(stat)] = float(value)
                except (TypeError, ValueError):
                    continue
        return queues

    def register_memory_provider(self, name: str,
                                 fn: Callable[[], Dict[str, float]]
                                 ) -> None:
        """Register ``fn() -> {stat: bytes}`` (an engine's CUDA-graph
        pool bytes), summed into every device row; keyed by name so a
        rebuilt engine replaces, never duplicates."""
        with self._lock:
            self._memory[name] = fn

    def unregister_memory_provider(self, name: str,
                                   fn: Optional[Callable] = None) -> None:
        with self._lock:
            if fn is None or self._memory.get(name) is fn:
                self._memory.pop(name, None)

    @staticmethod
    def _torch_memory(index: int) -> Dict[str, float]:
        """One card's allocator stats and its total memory."""
        import torch

        ms = dict(torch.cuda.memory_stats(index))
        _free, total = torch.cuda.mem_get_info(index)
        ms["mem_get_info.total"] = total
        return ms

    def device_memory_row(self, d) -> Dict[str, Any]:
        """Publish one device's memory stats through the
        DEVICE_MEMORY_STATS spelling table and return the report row.
        ``d`` is a CUDA device index (``torch.cuda``'s stats and total,
        plus the registered providers' bytes) or any object with ``id``,
        ``platform`` and ``memory_stats()``.  A device without memory
        stats yields the identity row only — the gauge stays empty
        rather than publishing zeros that read as 'no memory in use'."""
        if isinstance(d, int):
            row: Dict[str, Any] = {"device": str(d), "platform": "cuda"}
            try:
                ms = self._torch_memory(d)
            except Exception:
                ms = {}
            with self._lock:
                providers = list(self._memory.values())
            for fn in providers:
                try:
                    for stat, v in (fn() or {}).items():
                        ms[stat] = ms.get(stat, 0) + float(v)
                except Exception:
                    continue  # a torn-down engine must not kill sampling
        else:
            row = {"device": str(getattr(d, "id", "?")),
                   "platform": getattr(d, "platform", "")}
            try:
                ms = d.memory_stats() or {}
            except Exception:
                ms = {}
        for stat, spellings in DEVICE_MEMORY_STATS:
            for spelling in spellings:
                if spelling in ms:
                    self.device_memory.set(
                        float(ms[spelling]), device=row["device"],
                        stat=stat)
                    row[stat] = int(ms[spelling])
                    break
        return row

    @staticmethod
    def _read_rss_bytes() -> float:
        try:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
            return float(pages * os.sysconf("SC_PAGE_SIZE"))
        except (OSError, ValueError, IndexError):
            try:
                import resource

                # ru_maxrss is KiB on Linux (peak, not current — the
                # portable fallback when /proc is unavailable)
                return float(resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss * 1024)
            except Exception:
                return 0.0

    def sample_process(self) -> Dict[str, Any]:
        """One pass over the process gauges; returns the sample dict
        (also retained for report())."""
        sample: Dict[str, Any] = {"sampled_unix": time.time()}
        rss = self._read_rss_bytes()
        if rss:
            self.rss_bytes.set(rss)
            sample["rss_bytes"] = int(rss)
        n_threads = threading.active_count()
        self.threads.set(float(n_threads))
        sample["threads"] = n_threads

        devices: List[Dict[str, Any]] = []
        try:
            import torch

            if torch.cuda.is_available():
                for i in range(torch.cuda.device_count()):
                    devices.append(self.device_memory_row(i))
        except Exception:
            pass  # no card: host gauges still report
        sample["devices"] = devices

        queues = self.provider_stats()
        for name, stats in queues.items():
            for stat, v in stats.items():
                self.queue_stats.set(v, batcher=name, stat=stat)
        sample["queues"] = queues
        # publish GC collection counts accumulated by the callback;
        # read-inc-write runs under the lock so a concurrent
        # /debug/runtime scrape and the sampler thread can't both claim
        # the same delta (double-counting the monotonic counter)
        with self._lock:
            deltas = []
            for gen, count in list(self._gc_counts.items()):
                delta = count - self._gc_published.get(gen, 0)
                if delta > 0:
                    deltas.append((gen, delta))
                    self._gc_published[gen] = count
        for gen, delta in deltas:
            self.gc_collections.inc(delta, generation=gen)
        self._last_process_sample = sample
        return sample

    # -- GC pause capture --------------------------------------------------

    def _gc_callback(self, phase: str, info: Dict[str, Any]) -> None:
        # gen-0 collections fire hundreds of times per second under
        # load: the callback does plain attribute math only; the
        # locked histogram observe is reserved for pauses long enough to
        # matter (≥1ms — the stop-the-world events operators chase)
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif phase == "stop" and self._gc_t0 is not None:
            pause = time.perf_counter() - self._gc_t0
            self._gc_t0 = None
            gen = str(info.get("generation", ""))
            self._gc_counts[gen] = self._gc_counts.get(gen, 0) + 1
            if pause >= 1e-3:
                try:
                    self.gc_pause.observe(pause, generation=gen)
                except Exception:
                    pass

    def _install_gc_callback(self) -> None:
        if not self._gc_cb_installed:
            gc.callbacks.append(self._gc_callback)
            self._gc_cb_installed = True

    def _remove_gc_callback(self) -> None:
        if self._gc_cb_installed:
            try:
                gc.callbacks.remove(self._gc_callback)
            except ValueError:
                pass
            self._gc_cb_installed = False

    # -- sampler lifecycle -------------------------------------------------

    def start(self, interval_s: Optional[float] = None) -> "RuntimeStats":
        """Start (or retune) the background sampler: flush + process
        gauges every ``interval_s``.  Idempotent — a config hot-reload
        just updates the interval."""
        if interval_s is not None:
            self.interval_s = max(0.05, float(interval_s))
        self._install_gc_callback()
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.flush()
                    self.sample_process()
                except Exception:
                    pass  # telemetry must never die loudly

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="runtime-stats-sampler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None
        self._remove_gc_callback()

    # -- reading -----------------------------------------------------------

    def note_family_cost(self, family: str, seconds: float) -> None:
        """One observed signal-family evaluation (wall seconds): the
        first sample seeds the EWMA, later ones blend at
        ``ewma_alpha``."""
        if not self.enabled or seconds < 0.0:
            return
        with self._lock:
            if family not in self._family_costs \
                    and len(self._family_costs) >= 128:
                return  # bounded against pathological family churn
            n, ewma = self._family_costs.get(family, (0, 0.0))
            ewma = seconds if n == 0 else (
                self.ewma_alpha * seconds + (1.0 - self.ewma_alpha) * ewma)
            self._family_costs[family] = (n + 1, ewma)

    def family_costs(self) -> Dict[str, float]:
        """Warm-cost EWMA per signal family, in seconds."""
        with self._lock:
            return {f: ewma for f, (_n, ewma) in
                    sorted(self._family_costs.items())}

    def steps(self, source: Any = None) -> List[Dict[str, Any]]:
        """The step log's detail records of ``source``, oldest first."""
        return [dict(d) for d in list(self._steps.get(id(source), ()))]

    def drop_steps(self, source: Any = None) -> None:
        """Forget ``source``'s step log (its engine shut down)."""
        self._steps.pop(id(source), None)

    def programs(self) -> List[Dict[str, Any]]:
        self.flush()
        with self._lock:
            return [p.snapshot() for _, p in sorted(self._programs.items())]

    def retire(self, group: Optional[str] = None,
               variant_prefix: Optional[str] = None) -> int:
        """Drop program rows a hot flip just invalidated (quant / kernel
        / mesh rebuilds retire a trunk group; a packing disable retires
        every ``packed*`` variant).  The census purge in
        ``engine/classify.py`` calls this in the same breath — without
        it, repeated flips grow the (group, bucket, variant) registry
        and /debug/runtime keeps reporting EWMAs of programs that no
        longer exist.  Pending samples are flushed first so a dead
        program's in-flight step can't resurrect its row."""
        self.flush()
        with self._lock:
            keys = [k for k in self._programs
                    if (group is None or k[0] == group)
                    and (variant_prefix is None
                         or k[2].startswith(variant_prefix))]
            for k in keys:
                del self._programs[k]
        return len(keys)

    def report(self, sample: bool = True) -> Dict[str, Any]:
        """Operator snapshot for GET /debug/runtime: the program registry
        plus the latest (optionally fresh) process sample."""
        progs = self.programs()
        proc = self.sample_process() if sample \
            else dict(self._last_process_sample)
        return {
            "enabled": self.enabled,
            "sampler_running": self._thread is not None
            and self._thread.is_alive(),
            "interval_s": self.interval_s,
            "dropped_samples": self._dropped,
            "programs": progs,
            "process": proc,
        }

    def clear(self) -> None:
        with self._lock:
            self._programs.clear()
            self._family_costs.clear()
        self._pending.clear()
        self._steps.clear()
        self._dropped = 0


# process-global default (single-engine/dev posture, same pattern as
# metrics.default_series) — NOT started: the sampler thread is explicit
# (bootstrap) so imports never spawn threads
default_runtime_stats = RuntimeStats()
