"""Dual-path selection: the traditional path (trunk groups and per-task
forwards) against the stacked multi-task LoRA bank's one pass, chosen by
performance history.

The port's copy of ``semantic_router_tpu.engine.pathing``, with the same
records, strategies and reasons, so both packages choose alike over one
record sequence.  ``DualPathChooser`` keeps a history of (path, tasks,
batch, latency, confidence) records and picks per call against
``ProcessingRequirements``: the strategies ``adaptive``, ``latency``,
``confidence`` and the pinned ``traditional`` / ``stacked``; EMAs over the
records of the same power-of-two batch bucket; ``min_history`` records a
path before history decides; before that, a live ``cost_prior`` (the
runtime-stats step EWMAs, ``resilience.costmodel.make_path_cost_prior``)
or the static rule (two or more tasks stack, one never does).

On the card both paths are CUDA graphs: the traditional path is one
trunk-group step (or one step per task), the stacked one the bank's
step, which shares its trunk forward across every task.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence

TRADITIONAL = "traditional"
STACKED = "stacked"


@dataclass
class PerformanceRecord:
    path: str
    tasks: tuple
    batch_size: int
    latency_s: float
    confidence: float
    ok: bool = True
    at: float = field(default_factory=time.time)


@dataclass
class PathMetrics:
    avg_latency_s: float = 0.0
    avg_confidence: float = 0.0
    success_rate: float = 1.0
    total: int = 0


@dataclass
class ProcessingRequirements:
    """What the caller needs from this classify call
    (routing.rs ProcessingRequirements)."""

    tasks: Sequence[str] = ()
    batch_size: int = 1
    confidence_threshold: float = 0.0
    max_latency_ms: float = 0.0
    priority: str = "balanced"  # latency | quality | balanced


@dataclass
class PathSelection:
    selected_path: str
    confidence: float
    reasoning: str
    expected: PathMetrics


class PerformanceHistory:
    def __init__(self, max_size: int = 512) -> None:
        self._records: Deque[PerformanceRecord] = deque(maxlen=max_size)
        self._lock = threading.Lock()

    def add(self, rec: PerformanceRecord) -> None:
        with self._lock:
            self._records.append(rec)

    def metrics(self, path: str,
                batch_size: Optional[int] = None) -> PathMetrics:
        """Aggregate over matching records; batch_size matching is loose
        (same power-of-two bucket) because latency scales with the padded
        batch, not the exact size."""
        def bucket(n: int) -> int:
            b = 1
            while b < n:
                b <<= 1
            return b

        with self._lock:
            recs = [r for r in self._records if r.path == path
                    and (batch_size is None
                         or bucket(r.batch_size) == bucket(batch_size))]
        if not recs:
            return PathMetrics()
        n = len(recs)
        return PathMetrics(
            avg_latency_s=sum(r.latency_s for r in recs) / n,
            avg_confidence=sum(r.confidence for r in recs) / n,
            success_rate=sum(1 for r in recs if r.ok) / n,
            total=n)


class DualPathChooser:
    """Pick the execution path for a multi-task classify call.

    ``cost_prior`` (optional callable → {"stacked": s, "traditional":
    s}) feeds the runtime-stats warm-execute EWMAs
    (resilience.costmodel.make_path_cost_prior) into the cold-start
    decision: before this chooser has enough of its OWN records, the
    device-step sampler usually already knows what each path's programs
    cost — the engine's batch runners record every step regardless of
    who submitted it.  History still overrides the prior once
    ``min_history`` records accumulate per path."""

    def __init__(self, strategy: str = "adaptive",
                 min_history: int = 8, cost_prior=None) -> None:
        if strategy not in ("adaptive", "latency", "confidence",
                            "traditional", "stacked"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.strategy = strategy
        self.min_history = min_history
        self.history = PerformanceHistory()
        self.cost_prior = cost_prior

    def _prior_estimates(self):
        """(traditional_s, stacked_s) from the live cost prior, or None
        unless BOTH paths have telemetry (a one-sided prior would just
        re-encode which path ran first).  Never raises into choose()."""
        if self.cost_prior is None:
            return None
        try:
            prior = self.cost_prior() or {}
        except Exception:
            return None
        if "traditional" in prior and "stacked" in prior:
            return float(prior["traditional"]), float(prior["stacked"])
        return None

    def record(self, path: str, tasks: Sequence[str], batch_size: int,
               latency_s: float, confidence: float, ok: bool = True
               ) -> None:
        self.history.add(PerformanceRecord(
            path=path, tasks=tuple(tasks), batch_size=batch_size,
            latency_s=latency_s, confidence=confidence, ok=ok))

    def choose(self, req: ProcessingRequirements) -> PathSelection:
        # pinned strategies: operator override, no learning
        if self.strategy in (TRADITIONAL, STACKED):
            return PathSelection(self.strategy, 1.0,
                                 f"strategy pinned to {self.strategy}",
                                 self.history.metrics(self.strategy))
        trad = self.history.metrics(TRADITIONAL, req.batch_size)
        stack = self.history.metrics(STACKED, req.batch_size)
        n_tasks = max(len(req.tasks), 1)

        if trad.total < self.min_history or stack.total < self.min_history:
            # cold start: before own-history converges, a LIVE cost
            # prior from the device-step EWMAs beats the static rule —
            # the sampler has usually seen both paths' programs execute
            # even when this chooser hasn't recorded them
            prior = self._prior_estimates()
            if prior is not None:
                t_est, s_est = prior
                path = STACKED if s_est <= t_est else TRADITIONAL
                if n_tasks < 2:
                    path = TRADITIONAL  # one task never stacks
                return PathSelection(
                    path, 0.6,
                    f"cold start, step-EWMA prior: stacked "
                    f"{s_est * 1e3:.2f}ms vs traditional "
                    f"{t_est * 1e3:.2f}ms → {path}",
                    stack if path == STACKED else trad)
            # no telemetry either: fused pass amortizes the shared trunk
            # across tasks; a single task gains nothing from stacking
            path = STACKED if n_tasks >= 2 else TRADITIONAL
            return PathSelection(
                path, 0.5,
                f"cold start ({trad.total}+{stack.total} records): "
                f"{n_tasks} task(s) → {path}",
                stack if path == STACKED else trad)

        # reliability first: a path that fails does not get chosen
        if trad.success_rate < 0.5 or stack.success_rate < 0.5:
            path = TRADITIONAL if trad.success_rate >= stack.success_rate \
                else STACKED
            return PathSelection(path, 0.9, "reliability override",
                                 trad if path == TRADITIONAL else stack)

        prefer_conf = (self.strategy == "confidence"
                       or (self.strategy == "adaptive"
                           and req.priority == "quality")
                       or req.confidence_threshold > 0)
        if prefer_conf and abs(trad.avg_confidence
                               - stack.avg_confidence) > 0.02:
            if req.confidence_threshold > 0:
                # a bar is set: meet it first; latency breaks ties when
                # both (or neither) clear it
                only_trad = trad.avg_confidence >= \
                    req.confidence_threshold > stack.avg_confidence
                only_stack = stack.avg_confidence >= \
                    req.confidence_threshold > trad.avg_confidence
                if only_trad or only_stack:
                    path = TRADITIONAL if only_trad else STACKED
                    m = trad if only_trad else stack
                    return PathSelection(
                        path, 0.8,
                        f"only {path} meets confidence "
                        f">={req.confidence_threshold:.2f}", m)
            else:
                # no explicit bar, but the caller asked for quality:
                # higher historical confidence wins outright
                path = TRADITIONAL if trad.avg_confidence > \
                    stack.avg_confidence else STACKED
                m = trad if path == TRADITIONAL else stack
                return PathSelection(
                    path, 0.8,
                    f"{path} higher historical confidence "
                    f"({trad.avg_confidence:.2f} vs "
                    f"{stack.avg_confidence:.2f})", m)

        faster = TRADITIONAL if trad.avg_latency_s <= stack.avg_latency_s \
            else STACKED
        m = trad if faster == TRADITIONAL else stack
        margin = abs(trad.avg_latency_s - stack.avg_latency_s) / max(
            trad.avg_latency_s, stack.avg_latency_s, 1e-9)
        return PathSelection(
            faster, min(0.5 + margin, 0.95),
            f"history: {faster} faster by {margin:.0%} at "
            f"b={req.batch_size}", m)
