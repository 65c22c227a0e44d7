"""Decision-aware early-exit signal cascade (docs/CASCADE.md).

Stops computing classifier forwards the routing decision provably
cannot use: a planner (planner.py) turns the decision config's rule
trees into per-family relevance sets, a three-valued fold (tristate.py)
evaluates those trees over partially-resolved signals, and the wave
dispatcher (dispatcher.py) submits learned forwards cheap→expensive,
cancelling or never submitting any forward whose outcome can no longer
change the selected decision.  Default off = byte-identical routing.

The port's copy of ``semantic_router_tpu.engine.cascade``: host logic
only; the forwards it submits run through the engine's fused bank (K1,
K2 and, on a wide bank, K3) as the full fan-out's do.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .dispatcher import (
    NEUTRAL_SKIP_REASONS,
    Assessment,
    CascadeEvaluator,
    assess,
    certain_winner,
)
from .planner import (
    PLANNER_VERSION,
    CascadePlan,
    CascadePlanError,
    build_plan,
    plan_order,
)
from .tristate import FALSE, TRUE, UNKNOWN, TriResult, tri_eval_node

__all__ = [
    "PLANNER_VERSION",
    "NEUTRAL_SKIP_REASONS",
    "Assessment",
    "CascadeEvaluator",
    "CascadePlan",
    "CascadePlanError",
    "TriResult",
    "TRUE",
    "FALSE",
    "UNKNOWN",
    "assess",
    "build_plan",
    "certain_winner",
    "normalize_cascade",
    "plan_order",
    "tri_eval_node",
]


def normalize_cascade(d: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Normalized ``engine.cascade`` block.

    - ``enabled``: route through the cascade evaluator (default False =
      full fan-out, byte-identical routing).
    - ``wave_size``: learned families submitted per cost-ordered wave
      (default 2; min 1).
    - ``max_waves``: hard wave budget, 0 = unlimited (default).  Waves
      past the budget are truncated — a quality trade, not a proof.
    - ``brownout_max_waves``: wave budget under L2 brownout (default 1)
      — degraded requests run one cascade wave instead of dropping
      whole learned families.
    - ``cost_default_ms``: assumed per-forward cost before runtimestats
      has a warm EWMA for a family (default 5.0).
    - ``value_blend``: weight of flywheel per-decision value estimates
      in the cheap→expensive ordering (default 0.25; 0 = pure cost).
    """
    d = dict(d or {})

    def _int(key: str, default: int, lo: int) -> int:
        try:
            return max(lo, int(d.get(key, default)))
        except (TypeError, ValueError):
            return default

    def _float(key: str, default: float, lo: float) -> float:
        try:
            return max(lo, float(d.get(key, default)))
        except (TypeError, ValueError):
            return default

    return {
        "enabled": bool(d.get("enabled", False)),
        "wave_size": _int("wave_size", 2, lo=1),
        "max_waves": _int("max_waves", 0, lo=0),
        "brownout_max_waves": _int("brownout_max_waves", 1, lo=1),
        "cost_default_ms": _float("cost_default_ms", 5.0, lo=0.0),
        "value_blend": _float("value_blend", 0.25, lo=0.0),
    }
