"""Program-level performance observatory: step cost accounting + rooflines.

The port's counterpart of ``semantic_router_tpu.observability.programstats``.
runtimestats answers "how long did each device step take"; this module
answers "how much work is in that step, and what fraction of the card's
roofline did the warm path achieve":

- the engine's first execution of every step key (the one a CUDA graph
  is captured from on the card) runs under :class:`StepCost`, and the
  engine registers the count with :meth:`ProgramCatalog.note_compile`.
  The count is the FLOPs of the aten matmuls the step runs
  (``torch.utils.flop_counter.FlopCounterMode``) plus, for each of the
  three hand-written kernels, the ``cost`` its wrapper reports
  (``ops._cuda.note_cost``).  A wrapper reports the same cost whether it
  launches its kernel or runs its plain version, and the plain version's
  own aten work is not counted again, so a step's count does not depend
  on what implements it.  Bytes are the wrappers' (each input read once,
  each output written once) plus each counted matmul's operands and
  result; elementwise passes are not counted, so the bytes are a lower
  bound;
- :meth:`ProgramCatalog.catalog` joins the counts with the runtimestats
  warm-execute EWMAs into achieved-FLOP/s, achieved-bytes/s and
  roofline-fraction rows against the card's peak tier (H100 SXM / PCIe
  from NVIDIA's datasheet; the CPU tier is an order-of-magnitude
  placeholder and every CPU row says so), published as
  ``llm_program_{flops,bytes,hbm_peak_bytes,roofline_fraction}`` gauges
  and served at ``GET /debug/programs``.

The catalog key is the reference's ``(group, bucket, variant, quant,
kernels, mesh)``.  Failure posture: a count that fails records an
``error`` row; it never breaks serving.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

# -- per-device peak table ----------------------------------------------------
#
# (substring-of-device-name, tier) — first match wins, the CPU placeholder
# is the fallback.  NVIDIA H100 Tensor Core GPU datasheet: dense (no
# sparsity) BF16 tensor FLOP/s, HBM bandwidth, HBM capacity.
_PEAK_TIERS: Tuple[Tuple[Tuple[str, ...], Dict[str, Any]], ...] = (
    (("h100 pcie",), {
        "tier": "h100-pcie", "flops_per_s": 756e12,
        "hbm_bytes_per_s": 2.0e12, "hbm_bytes": 80 * 10**9,
        "peak_note": "NVIDIA H100 datasheet, H100 PCIe: 756 TFLOP/s "
                     "dense BF16 tensor, 2.0 TB/s HBM2e, 80 GB"}),
    (("h100",), {
        "tier": "h100-sxm", "flops_per_s": 989e12,
        "hbm_bytes_per_s": 3.35e12, "hbm_bytes": 80 * 10**9,
        "peak_note": "NVIDIA H100 datasheet, H100 SXM: 989 TFLOP/s "
                     "dense BF16 tensor, 3.35 TB/s HBM3, 80 GB"}),
)

_CPU_TIER: Dict[str, Any] = {
    "tier": "cpu-placeholder", "flops_per_s": 1e11,
    "hbm_bytes_per_s": 5e10, "hbm_bytes": 0,
    "placeholder": True,
    "peak_note": "CPU placeholder tier (~100 GFLOP/s, ~50 GB/s): an "
                 "order-of-magnitude stand-in, NOT a measured host peak "
                 "— roofline fractions on CPU are only comparable "
                 "within one machine and one run",
}


def peak_for(device_name: str, platform: str = "") -> Dict[str, Any]:
    """Peak-throughput tier for a ``torch.cuda.get_device_name`` string
    (substring match against the datasheet table; anything unrecognized
    — and every CPU — gets the flagged placeholder tier)."""
    kind = (device_name or "").lower()
    if platform.lower() != "cpu":
        for needles, tier in _PEAK_TIERS:
            if any(n in kind for n in needles):
                return dict(tier)
    return dict(_CPU_TIER)


def _local_device_tier(device: str = "") -> Dict[str, Any]:
    """The tier of the card the engine serves on (``device`` "cpu" or
    "" with no card: the placeholder)."""
    try:
        import torch

        if device != "cpu" and torch.cuda.is_available():
            name = torch.cuda.get_device_name(0)
            tier = peak_for(name, "cuda")
            tier.update({"device_kind": name, "platform": "cuda",
                         "device_count": torch.cuda.device_count()})
            return tier
    except Exception:
        pass
    tier = dict(_CPU_TIER)
    tier.update({"device_kind": "", "platform": "cpu", "device_count": 0})
    return tier


# -- counting one step --------------------------------------------------------

# the aten ops whose operands and result count as the step's bytes (the
# ones FlopCounterMode counts FLOPs for on this path)
_MATMUL_OPS = ("mm", "addmm", "bmm", "baddbmm", "matmul", "linear",
               "_scaled_mm", "convolution")


class StepCost:
    """Context manager counting one step's work on the calling thread:
    ``flops`` and ``bytes_accessed`` after the block (see the module
    docstring), ``kernels`` the wrappers' own costs by kernel."""

    def __init__(self) -> None:
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self._stack = None

    def __enter__(self) -> "StepCost":
        import contextlib

        from torch.utils.flop_counter import FlopCounterMode

        from ..ops import _cuda

        self._flop_mode = FlopCounterMode(display=False)
        # no module tracking: its forward hooks are process-wide, and would
        # run (and fail, under inference mode) in the forwards of other
        # threads while this one counts a step
        self._flop_mode.mod_tracker = _GlobalOnly()
        self._byte_mode = _matmul_bytes_mode()
        stack = contextlib.ExitStack()
        self._costs = stack.enter_context(_cuda.recording_costs())
        stack.enter_context(self._flop_mode)
        stack.enter_context(self._byte_mode)
        self._stack = stack
        return self

    def __exit__(self, *exc) -> bool:
        self._stack.__exit__(*exc)
        flops = float(self._flop_mode.get_total_flops())
        nbytes = float(self._byte_mode.nbytes)
        for name, f, b in self._costs:
            row = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                                 "bytes": 0.0})
            row["calls"] += 1
            row["flops"] += f
            row["bytes"] += b
            flops += f
            nbytes += b
        self.flops, self.bytes_accessed = flops, nbytes
        return False


class _GlobalOnly:
    """FlopCounterMode's module tracker, minus the modules: every count
    goes to "Global", and no hook is installed."""

    parents = ("Global",)

    def __enter__(self) -> "_GlobalOnly":
        return self

    def __exit__(self, *exc) -> bool:
        return False


def _matmul_bytes_mode():
    """A dispatch mode adding up the bytes of every matmul-class aten
    op's tensor operands and result."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class _MatmulBytes(TorchDispatchMode):
        def __init__(self) -> None:
            super().__init__()
            self.nbytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = getattr(func, "_overloadpacket", func).__name__
            if name in _MATMUL_OPS:
                for t in list(args) + list((kwargs or {}).values()) + [out]:
                    if isinstance(t, torch.Tensor):
                        self.nbytes += t.numel() * t.element_size()
            return out

    return _MatmulBytes()


# -- cost rows ----------------------------------------------------------------

# catalog key: (group, bucket, variant, quant, kernels, mesh)
Key = Tuple[str, int, str, str, str, str]


@dataclass
class ProgramCost:
    """The cost count of ONE step variant.  When the same key runs a new
    padded shape, the newest count wins — the catalog describes what is
    serving NOW, history belongs to the runtimestats compile counters."""

    group: str
    bucket: int
    variant: str
    quant: str = "off"
    kernels: str = "off"
    mesh: str = "off"
    measured_variant: str = ""
    shape: Tuple[int, ...] = ()
    flops: float = 0.0
    bytes_accessed: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    hbm_peak_bytes: int = 0
    capture_s: float = 0.0
    captured_unix: float = 0.0
    kernel_costs: Optional[Dict[str, Dict[str, float]]] = None
    error: str = ""

    def key(self) -> Key:
        return (self.group, self.bucket, self.variant, self.quant,
                self.kernels, self.mesh)

    def snapshot(self) -> Dict[str, Any]:
        out = {
            "group": self.group, "bucket": self.bucket,
            "variant": self.variant, "quant": self.quant,
            "kernels": self.kernels, "mesh": self.mesh,
            "shape": list(self.shape),
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "hbm_peak_bytes": self.hbm_peak_bytes,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "capture_s": round(self.capture_s, 6),
        }
        if self.kernel_costs:
            out["kernel_costs"] = {k: dict(v) for k, v in
                                   sorted(self.kernel_costs.items())}
        if self.error:
            out["error"] = self.error
        return out


class ProgramCatalog:
    """Catalog of every live step variant's cost count, bound to one
    metrics registry (same single-binding discipline as RuntimeStats).
    Hot path cost: none — counts are taken at a key's first execution
    only."""

    def __init__(self, registry=None, max_programs: int = 512) -> None:
        if registry is None:
            from .metrics import default_registry

            registry = default_registry
        self.registry = registry
        self.enabled = True
        self.max_programs = max_programs
        # the SLO-burn capture armed on this catalog (bootstrap's
        # apply_observability_knobs); None until enabled
        self.slo_capture: Optional["SLOCaptureController"] = None
        self._lock = threading.Lock()
        self._costs: Dict[Key, ProgramCost] = {}
        self._capture_errors = 0
        # the device the registering engine serves on ("cpu" → the
        # placeholder tier even on a machine with a card)
        self.device = ""

        self.flops_gauge = registry.gauge(
            "llm_program_flops",
            "Cost-model FLOPs per step variant "
            "(group/bucket/variant/quant/kernels/mesh)")
        self.bytes_gauge = registry.gauge(
            "llm_program_bytes",
            "Cost-model bytes accessed per step variant")
        self.hbm_gauge = registry.gauge(
            "llm_program_hbm_peak_bytes",
            "Step footprint (argument + output + graph-pool bytes) per "
            "step variant")
        self.roofline_gauge = registry.gauge(
            "llm_program_roofline_fraction",
            "Achieved FLOP/s over the roofline-attainable peak "
            "min(peak_flops, intensity * peak_bw) for the device tier; "
            "CPU-tier fractions use a placeholder peak (see "
            "/debug/programs peak_note)")

    # -- capture -----------------------------------------------------------

    def note_compile(self, group: str, bucket: int, variant: str,
                     shape: Tuple[int, ...], cost: Optional[StepCost] = None,
                     *, measured_variant: str = "", quant: str = "off",
                     kernels: str = "off", mesh: str = "off",
                     argument_bytes: int = 0, output_bytes: int = 0,
                     temp_bytes: int = 0, capture_s: float = 0.0,
                     error: str = "") -> None:
        """Register a fresh step's count (``cost``; None with ``error``
        when the count failed).  Bounded: past ``max_programs`` live keys,
        new notes are dropped."""
        if not self.enabled:
            return
        row = ProgramCost(
            group=group, bucket=int(bucket), variant=variant,
            quant=quant or "off", kernels=kernels or "off",
            mesh=mesh or "off",
            measured_variant=measured_variant or variant,
            shape=tuple(int(s) for s in shape),
            argument_bytes=int(argument_bytes),
            output_bytes=int(output_bytes), temp_bytes=int(temp_bytes),
            capture_s=float(capture_s), captured_unix=time.time(),
            error=error)
        row.hbm_peak_bytes = row.argument_bytes + row.output_bytes \
            + row.temp_bytes
        if cost is not None:
            row.flops = cost.flops
            row.bytes_accessed = cost.bytes_accessed
            row.kernel_costs = dict(cost.kernels)
        key = row.key()
        with self._lock:
            if key not in self._costs \
                    and len(self._costs) >= self.max_programs:
                return
            if error:
                self._capture_errors += 1
            self._costs[key] = row

    # -- retirement --------------------------------------------------------

    def retire(self, group: Optional[str] = None,
               variant_prefix: Optional[str] = None) -> int:
        """Drop cost rows (and their gauge samples) of steps a rebuild or
        a flip retired.  Matches by exact ``group`` and/or variant
        prefix."""
        with self._lock:
            keys = [k for k in list(self._costs)
                    if (group is None or k[0] == group)
                    and (variant_prefix is None
                         or k[2].startswith(variant_prefix))]
            rows = [self._costs.pop(k) for k in keys]
        for cost in rows:
            self._remove_gauges(cost)
        return len(keys)

    def _labels(self, cost: ProgramCost) -> Dict[str, str]:
        return {"group": cost.group, "bucket": str(cost.bucket),
                "variant": cost.variant, "quant": cost.quant,
                "kernels": cost.kernels, "mesh": cost.mesh}

    def _remove_gauges(self, cost: ProgramCost) -> None:
        labels = self._labels(cost)
        for g in (self.flops_gauge, self.bytes_gauge, self.hbm_gauge,
                  self.roofline_gauge):
            g.remove(**labels)

    # -- reading -----------------------------------------------------------

    def rows(self) -> List[ProgramCost]:
        with self._lock:
            return [self._costs[k] for k in sorted(self._costs)]

    def catalog(self, runtime_stats=None) -> Dict[str, Any]:
        """The joined observatory read: cost rows x runtimestats warm
        EWMAs -> achieved FLOP/s, bytes/s and roofline fraction against
        the device-tier peaks.  Publishes the llm_program_* gauges as a
        side effect (same scrape-refresh discipline as
        RuntimeStats.report)."""
        tier = _local_device_tier(self.device)
        peak_flops = float(tier.get("flops_per_s") or 0.0)
        peak_bw = float(tier.get("hbm_bytes_per_s") or 0.0)

        measured: Dict[Tuple[str, int, str], Dict[str, Any]] = {}
        if runtime_stats is not None:
            for m in runtime_stats.programs():
                measured[(m["group"], m["bucket"], m["variant"])] = m

        rows: List[Dict[str, Any]] = []
        for cost in self.rows():
            row = cost.snapshot()
            labels = self._labels(cost)
            self.flops_gauge.set(cost.flops, **labels)
            self.bytes_gauge.set(cost.bytes_accessed, **labels)
            self.hbm_gauge.set(float(cost.hbm_peak_bytes), **labels)
            m = measured.get((cost.group, cost.bucket,
                              cost.measured_variant))
            if m is not None:
                row["measured_variant"] = cost.measured_variant
                row["executes"] = m.get("executes", 0)
                row["execute_ewma_s"] = m.get("execute_ewma_s", 0.0)
                fill = m.get("token_fill_ratio",
                             m.get("fill_ratio_mean", 0.0))
                row["token_fill_ratio"] = fill
                ewma = float(m.get("execute_ewma_s") or 0.0)
                if ewma > 0.0 and cost.flops > 0.0:
                    achieved = cost.flops / ewma
                    row["achieved_flops_per_s"] = achieved
                    row["useful_flops_per_s"] = achieved * float(fill)
                    if cost.bytes_accessed > 0.0:
                        row["achieved_bytes_per_s"] = \
                            cost.bytes_accessed / ewma
                        intensity = cost.flops / cost.bytes_accessed
                        row["arithmetic_intensity"] = intensity
                        attainable = min(peak_flops, intensity * peak_bw) \
                            if peak_flops and peak_bw else 0.0
                        if attainable > 0.0:
                            frac = achieved / attainable
                            row["roofline_fraction"] = frac
                            row["bound"] = "compute" \
                                if intensity * peak_bw >= peak_flops \
                                else "memory"
                            self.roofline_gauge.set(frac, **labels)
            rows.append(row)

        with self._lock:
            errors = self._capture_errors
        out = {
            "enabled": self.enabled,
            "device": tier,
            "programs": rows,
            "catalog_size": len(rows),
            "pending_captures": 0,
            "capture_errors": errors,
        }
        if self.slo_capture is not None:
            out["slo_captures"] = self.slo_capture.links()
        return out

    def report(self, runtime_stats=None) -> Dict[str, Any]:
        """Operator snapshot for GET /debug/programs."""
        return self.catalog(runtime_stats=runtime_stats)

    def clear(self) -> None:
        for cost in self.rows():
            self._remove_gauges(cost)
        with self._lock:
            self._costs.clear()
            self._capture_errors = 0


# -- SLO-burn-triggered capture ----------------------------------------------


class SLOCaptureController:
    """One bounded profiler trace + a program-catalog snapshot per firing
    SLO alert.  Subscribes to the runtime event bus; on
    ``slo_alert_firing`` (cooldown-gated, so a flapping alert cannot
    profile the process to death) it starts the ``ProfilerControl``'s
    ``torch.profiler`` trace for ``trace_s`` seconds and snapshots the
    catalog's rows into a bounded ring, which the flight recorder's dump
    links."""

    def __init__(self, catalog: Optional[ProgramCatalog] = None,
                 runtime_stats=None, profiler=None, flightrec=None,
                 events=None, trace_s: float = 2.0,
                 cooldown_s: float = 300.0, max_captures: int = 8) -> None:
        self.catalog = catalog
        self.runtime_stats = runtime_stats
        self.profiler = profiler
        self.flightrec = flightrec
        self.events = events
        self.trace_s = float(trace_s)
        self.cooldown_s = float(cooldown_s)
        self._captures: deque = deque(maxlen=max_captures)
        self._lock = threading.Lock()
        self._last_mono: float = 0.0
        self._seq = 0
        self._unsub: Optional[Callable[[], None]] = None
        # every capture's bounded-trace stop timer not yet joined
        self._stop_timers: List[threading.Timer] = []
        if flightrec is not None:
            flightrec.capture_provider = self.links

    # -- wiring ------------------------------------------------------------

    def attach(self, bus) -> None:
        """Subscribe to the event bus (re-attach replaces)."""
        self.detach()
        if bus is None:
            return
        unsub = bus.subscribe(self.on_event)
        self.events = bus
        with self._lock:
            self._unsub = unsub

    def detach(self) -> None:
        with self._lock:
            unsub, self._unsub = self._unsub, None
        if unsub is not None:
            unsub()

    def on_event(self, ev) -> None:
        from ..runtime.events import SLO_ALERT_FIRING

        if getattr(ev, "stage", None) != SLO_ALERT_FIRING:
            return
        detail = getattr(ev, "detail", None) or {}
        self.trigger(objective=str(detail.get("objective", "")),
                     reason="slo_alert")

    # -- capture -----------------------------------------------------------

    def trigger(self, objective: str = "", reason: str = "manual"
                ) -> Optional[Dict[str, Any]]:
        """One capture now (cooldown permitting); the capture record, or
        None when the cooldown suppressed it."""
        now = time.monotonic()
        with self._lock:
            if self._last_mono and now - self._last_mono < self.cooldown_s:
                return None
            self._last_mono = now
            self._seq += 1
            seq = self._seq
        cap: Dict[str, Any] = {
            "id": f"slocap-{seq}",
            "at_unix": time.time(),
            "objective": objective,
            "reason": reason,
            "trace_s": self.trace_s,
        }
        # the catalog's rows at the burn, not minutes later
        if self.catalog is not None:
            try:
                snap = self.catalog.catalog(
                    runtime_stats=self.runtime_stats)
                cap["catalog_size"] = snap.get("catalog_size", 0)
                cap["programs"] = snap.get("programs", [])[:64]
                cap["device"] = snap.get("device", {})
            except Exception as exc:
                cap["catalog_error"] = str(exc)[:200]
        # one bounded trace; a trace already running (an operator's, or a
        # previous burn's) is respected, never clobbered
        if self.profiler is not None and self.trace_s > 0.0:
            try:
                started = self.profiler.start()
            except Exception as exc:
                started = {"started": False, "error": str(exc)[:200]}
            if started.get("started"):
                cap["trace_dir"] = started.get("dir", "")
                timer = threading.Timer(self.trace_s, self._stop_trace)
                timer.daemon = True
                timer.name = "slo-capture-stop"
                with self._lock:
                    self._stop_timers = [t for t in self._stop_timers
                                         if t.is_alive()] + [timer]
                timer.start()
            else:
                cap["trace_skipped"] = started.get(
                    "error", "profiler busy")
        self._captures.append(cap)
        if self.events is not None:
            try:
                from ..runtime.events import SLO_CAPTURE

                self.events.emit(
                    SLO_CAPTURE, id=cap["id"], objective=objective,
                    trace_dir=cap.get("trace_dir", ""),
                    catalog_size=cap.get("catalog_size", 0))
            except Exception:
                pass
        return cap

    def _stop_trace(self) -> None:
        try:
            if self.profiler is not None:
                self.profiler.stop()
        except Exception:
            pass

    def join(self, timeout: float = 5.0) -> None:
        """Wait, within ``timeout`` in all, for every in-flight bounded
        trace to stop: each capture's stop timer, not only the last."""
        with self._lock:
            timers, self._stop_timers = self._stop_timers, []
        deadline = time.monotonic() + timeout
        for timer in timers:
            timer.join(max(0.0, deadline - time.monotonic()))

    # -- reading -----------------------------------------------------------

    def links(self) -> List[Dict[str, Any]]:
        """Cross-link rows for the flight recorder: capture id, time,
        objective, trace dir."""
        return [{"id": c["id"], "at_unix": c["at_unix"],
                 "objective": c.get("objective", ""),
                 "reason": c.get("reason", ""),
                 "trace_dir": c.get("trace_dir", ""),
                 "catalog_size": c.get("catalog_size", 0)}
                for c in list(self._captures)]

    def report(self) -> List[Dict[str, Any]]:
        return [dict(c) for c in self._captures]


# process-global default (single-engine/dev posture, same pattern as
# runtimestats.default_runtime_stats)
default_program_stats = ProgramCatalog()
