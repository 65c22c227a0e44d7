"""Sequence-packed continuous batching for the classifier bank.

The port's copy of ``semantic_router_tpu.engine.packing``: a length-aware
packer that bin-packs short prompts into shared device rows under a
block-diagonal attention mask (``packer``), a continuous-admission batch
composer that lets new arrivals join the next in-flight step
(``scheduler``), and an online shape auto-tuner driven by the
runtimestats token-fill series (``autotuner``).  The engine
(engine.classify) wires them behind the ``engine.packing`` knob block;
``enabled: false`` restores the fixed-row batching.  Only a fused trunk
group on ``dense`` attention packs (``use_flash_attention: false`` on the
card, as on the reference's chip).
"""

from __future__ import annotations

from typing import Any, Dict

from .autotuner import ShapeAutoTuner
from .packer import PackedBatch, RowPlan, Segment, pack_items, plan_take
from .scheduler import PackingBatcher

__all__ = [
    "PackedBatch", "PackingBatcher", "RowPlan", "Segment",
    "ShapeAutoTuner", "normalize_packing", "pack_items", "plan_take",
]


def normalize_packing(d: Dict[str, Any]) -> Dict[str, Any]:
    """The ONE interpretation point for the ``engine.packing`` block:
    bootstrap knob application, the engine constructor and tests all read
    this normalized shape.  Malformed values fall back to defaults."""
    d = dict(d or {})

    def _bool(key: str, default: bool) -> bool:
        return bool(d.get(key, default))

    def _int(key: str, default: int, lo: int = 0) -> int:
        try:
            return max(lo, int(d.get(key, default)))
        except (TypeError, ValueError):
            return default

    def _float(key: str, default: float, src=None) -> float:
        try:
            return float((src or d).get(key, default))
        except (TypeError, ValueError):
            return default

    at = d.get("autotune") if isinstance(d.get("autotune"), dict) else {}
    return {
        "enabled": _bool("enabled", True),
        # fewest unique segments that justify a packed step: 1-segment
        # batches (incl. the fused-dedup single-row case) stay on the
        # unpacked path bit-identically
        "min_segments": _int("min_segments", 2, lo=2),
        "max_segments_per_row": _int("max_segments_per_row", 8, lo=1),
        # 0 → 2× max_batch_size (scheduler default)
        "max_items_per_step": _int("max_items_per_step", 0),
        "max_inflight_steps": _int("max_inflight_steps", 2, lo=1),
        "starvation_steps": _int("starvation_steps", 4),
        "autotune": {
            "enabled": bool(at.get("enabled", True)),
            "interval_s": max(0.5, _float("interval_s", 30.0, at)),
            "target_fill": min(1.0, max(0.1,
                                        _float("target_fill", 0.85, at))),
            "min_samples": max(1, int(at.get("min_samples", 50) or 50)),
            "max_segments_cap": max(1, int(at.get("max_segments_cap", 32)
                                           or 32)),
        },
    }
