"""Live per-request cost estimates from the runtime-stats EWMAs.

The port's copy of ``semantic_router_tpu.resilience.costmodel``.  The
runtime-stats sampler keeps a warm execute EWMA per engine step program
(``observability/runtimestats.py``): the engine's own measurement of what
one device step costs right now.  This module turns those into

- the per-request device cost (``request_cost_s``): device-seconds one
  request's learned-signal fan-out consumes — the unit the L3 admission
  token buckets spend and refill in;
- the per-path prior (``path_priors``): the expected step cost of the
  ``stacked`` bank pass against the ``traditional`` (fused / per-task)
  path;
- the L3 admission charge (``admission_cost_s``): the per-request cost
  divided by the priority class's measured-value weight, which the
  routing flywheel installs (``set_value_weights``).

Reads are snapshot-cached (``ttl_s``) so the admission hot path never
walks the program registry per request; with no telemetry yet every
estimate falls back to the configured default.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

# variant → path: "stacked" is the multi-task LoRA bank pass; "fused" /
# "fused_detailed" (trunk groups) and "split" (per-task) together are the
# traditional path
_STACKED_VARIANTS = ("stacked",)
_TRADITIONAL_VARIANTS = ("fused", "fused_detailed", "split")

DEFAULT_REQUEST_COST_S = 0.005  # pre-telemetry guess: 5ms of device time


class CostModel:
    """Cost estimates over one RuntimeStats instance's program registry.

    Thread-safe; ``ttl_s`` bounds how often the (locked, O(programs))
    snapshot walk runs — every read between refreshes is a dict lookup.
    """

    def __init__(self, runtime_stats=None, ttl_s: float = 1.0,
                 default_request_cost_s: float = DEFAULT_REQUEST_COST_S
                 ) -> None:
        self.runtime_stats = runtime_stats
        self.ttl_s = ttl_s
        self.default_request_cost_s = default_request_cost_s
        self._lock = threading.Lock()
        self._cached_at = float("-inf")
        self._programs: List[Dict[str, Any]] = []
        # measured-value admission weights (the flywheel's
        # update_admission_weights): priority class → weight.  Empty =
        # every class pays the same per-request cost; a weight of 2.0
        # halves the charged cost (high measured value admits more), 0.5
        # doubles it.
        self.value_weights: Dict[str, float] = {}

    # -- snapshot ----------------------------------------------------------

    def _snapshot(self) -> List[Dict[str, Any]]:
        now = time.monotonic()
        with self._lock:
            if now - self._cached_at < self.ttl_s:
                return self._programs
        rs = self.runtime_stats
        progs: List[Dict[str, Any]] = []
        if rs is not None:
            try:
                progs = rs.programs()
            except Exception:
                progs = []
        with self._lock:
            self._programs = progs
            self._cached_at = now
        return progs

    def refresh(self) -> None:
        """Force the next read to re-snapshot (tests / tick alignment)."""
        with self._lock:
            self._cached_at = float("-inf")

    # -- estimates ---------------------------------------------------------

    def cost_per_row_s(self) -> Optional[float]:
        """Warm device-seconds per REAL batch row, blended over every
        program with warm executes; None before any telemetry."""
        total_s = rows = 0.0
        for p in self._snapshot():
            if p.get("executes", 0) and p.get("rows_real", 0):
                total_s += float(p["execute_s_total"])
                rows += float(p["rows_real"])
        if rows <= 0:
            return None
        return total_s / rows

    def request_cost_s(self, n_signals: int = 1) -> float:
        """Estimated device-seconds for one request activating
        ``n_signals`` learned families (each is one batch row; the fused
        bank collapses rows, so this is an upper bound — admission
        control WANTS the conservative side)."""
        per_row = self.cost_per_row_s()
        if per_row is None:
            return self.default_request_cost_s
        return per_row * max(1, int(n_signals))

    def set_value_weights(self, weights: Dict[str, float],
                          floor: float = 0.05) -> None:
        """Install per-priority-class value weights (the flywheel's
        per-decision value estimates rolled up by live traffic share).
        Weights are floored so a pathological estimate can never make a
        class's admission cost unbounded."""
        with self._lock:
            self.value_weights = {
                str(k): max(float(v), floor) for k, v in
                (weights or {}).items()}

    def value_weight(self, key: str) -> float:
        with self._lock:
            return self.value_weights.get(key, 1.0)

    def admission_cost_s(self, n_signals: int = 1,
                         key: str = "") -> float:
        """The device-seconds the L3 bucket charges one request:
        ``request_cost_s`` divided by the class's measured-value weight
        — high-value traffic is charged less per request, so under the
        same bucket refill the ladder sheds by measured value, not just
        class rank.  No weights installed = exactly request_cost_s."""
        cost = self.request_cost_s(n_signals)
        if not self.value_weights or not key:
            return cost
        return cost / self.value_weight(key)

    def variant_ewma_s(self, variants) -> Optional[float]:
        """Execute-weighted mean of warm EWMAs across the given variants;
        None when none of them has executed warm yet."""
        weighted = weight = 0.0
        for p in self._snapshot():
            if p.get("variant") in variants and p.get("executes", 0):
                w = float(p["executes"])
                weighted += float(p["execute_ewma_s"]) * w
                weight += w
        if weight <= 0:
            return None
        return weighted / weight

    def path_priors(self) -> Dict[str, float]:
        """{'stacked': s, 'traditional': s} — only the paths with live
        telemetry appear, so a chooser can require both before trusting
        the prior."""
        out: Dict[str, float] = {}
        stacked = self.variant_ewma_s(_STACKED_VARIANTS)
        trad = self.variant_ewma_s(_TRADITIONAL_VARIANTS)
        if stacked is not None:
            out["stacked"] = stacked
        if trad is not None:
            out["traditional"] = trad
        return out

    def report(self) -> Dict[str, Any]:
        per_row = self.cost_per_row_s()
        return {
            "cost_per_row_s": round(per_row, 9) if per_row else None,
            "request_cost_s": round(self.request_cost_s(), 9),
            "default_request_cost_s": self.default_request_cost_s,
            "path_priors": {k: round(v, 9)
                            for k, v in self.path_priors().items()},
            "value_weights": dict(self.value_weights),
            "programs_seen": len(self._snapshot()),
        }


def make_path_cost_prior(cost_model: CostModel):
    """A ``cost_prior`` callable for a dual-path chooser: the live
    {'stacked', 'traditional'} step-cost estimates (partial or empty
    until both sides have telemetry).  Never raises."""

    def prior() -> Dict[str, float]:
        try:
            return cost_model.path_priors()
        except Exception:
            return {}

    return prior
