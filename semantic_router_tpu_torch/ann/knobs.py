"""The ``ann`` config block's one interpretation point.

The port's copy of ``semantic_router_tpu.ann.knobs``: the same defaults
and clamps, so ``RouterConfig.ann_config()`` normalizes to the same dict
in both packages.  ``enabled: false`` (the default) normalizes to a block
under which ``apply_ann_knobs`` constructs nothing.  The ``mesh``
sub-block is normalized as ``engine.mesh`` is; an enabled one is refused
at load (``config.schema.refuse_unported``), since this port serves the
single-device bank only.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

# device-bank storage modes: f32 is the parity oracle; bf16 / int8 must
# clear the calibrated recall gate before a view publishes quantized
BANK_MODES = ("f32", "bf16", "int8")


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def normalize_mesh(d: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The ``mesh`` sub-block, normalized as the reference's
    ``engine.mesh`` is: enabled, ``dp`` (0 = every device ``tp`` leaves)
    and ``tp``."""
    d = dict(d or {})

    def _int(key: str, default: int, lo: int) -> int:
        try:
            return max(lo, int(d.get(key, default)))
        except (TypeError, ValueError):
            return default

    return {"enabled": bool(d.get("enabled", False)),
            "dp": _int("dp", 0, lo=0), "tp": _int("tp", 1, lo=1)}


def normalize_ann(d: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Raw ``ann:`` block → fully-defaulted knob dict."""
    d = dict(d or {})

    def _num(key: str, default: float, lo: float, hi: float) -> float:
        try:
            v = float(d.get(key, default))
        except (TypeError, ValueError):
            v = default
        return min(max(v, lo), hi)

    def _int(key: str, default: int, lo: int) -> int:
        try:
            v = int(d.get(key, default))
        except (TypeError, ValueError):
            v = default
        return max(v, lo)

    mode = str(d.get("quant", "f32")).lower()
    if mode not in BANK_MODES:
        mode = "f32"
    min_cap = _pow2_ceil(_int("min_capacity", 1024, 16))
    max_cap = _pow2_ceil(_int("max_capacity", 1 << 20, 16))
    if max_cap < min_cap:
        max_cap = min_cap

    raw_batch = d.get("batch", {}) or {}
    batch = {
        "enabled": bool(raw_batch.get("enabled", False)),
        "max_batch": max(1, int(raw_batch.get("max_batch", 32) or 32)),
        "max_wait_ms": max(0.0, float(raw_batch.get("max_wait_ms", 0.5)
                                      or 0.0)),
    }
    raw_share = d.get("share", {}) or {}
    share = {
        "cache": bool(raw_share.get("cache", True)),
        "vectorstore": bool(raw_share.get("vectorstore", True)),
    }
    return {
        "enabled": bool(d.get("enabled", False)),
        "dim": _int("dim", 0, 0),  # 0 = infer from the first add
        "min_capacity": min_cap,
        "max_capacity": max_cap,
        "quant": mode,
        "recall_floor": _num("recall_floor", 0.99, 0.0, 1.0),
        "calibration_queries": _int("calibration_queries", 64, 4),
        "top_k": _int("top_k", 8, 1),
        "promote_ewma": _num("promote_ewma", 0.2, 0.01, 1.0),
        "promote_min_hits": _num("promote_min_hits", 0.0, 0.0, 1e9),
        "compact_interval_s": _num("compact_interval_s", 2.0, 0.05, 3600),
        "tombstone_ratio": _num("tombstone_ratio", 0.25, 0.01, 1.0),
        "evict_watermark": _num("evict_watermark", 0.9, 0.1, 1.0),
        "sync_interval_s": _num("sync_interval_s", 2.0, 0.05, 3600),
        "batch": batch,
        "mesh": normalize_mesh(d.get("mesh", {}) or {}),
        "share": share,
    }
