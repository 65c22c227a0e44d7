"""Kernel and quantization knob interpretation: the ONE interpretation
point for the ``engine.kernels`` and ``engine.quant`` blocks.  Malformed
values fall back to defaults; every default is OFF."""

from __future__ import annotations

from typing import Any, Dict

from ..models.quant import QUANT_MODES


def normalize_quant(d: Dict[str, Any]) -> Dict[str, Any]:
    """Normalized ``engine.quant`` block.

    - ``mode``: off | bf16 | int8 (default off: the float32 trunk as
      registered, untouched).
    - ``groups``: trunk-group selectors (gid or member task names); empty
      = every fused trunk group serves quantized.
    - ``parity``: the calibration the parity tests hold a quantized trunk
      to: max absolute logit deviation from the float32 logits, minimum
      top-class agreement, and the float32 top-2 margin below which a
      flipped argmax is a tie, not a disagreement.
    """
    d = dict(d or {})
    mode = str(d.get("mode", "off") or "off").lower()
    if mode not in QUANT_MODES:
        mode = "off"
    try:
        groups = [str(g) for g in (d.get("groups") or [])]
    except TypeError:
        groups = []
    par = d.get("parity") if isinstance(d.get("parity"), dict) else {}

    def _f(key: str, default: float, lo: float, hi: float) -> float:
        try:
            return min(hi, max(lo, float(par.get(key, default))))
        except (TypeError, ValueError):
            return default

    return {
        "mode": mode,
        "groups": groups,
        "parity": {
            "max_logit_diff": _f("max_logit_diff", 0.5, 0.0, 1e9),
            "min_top_agree": _f("min_top_agree", 0.999, 0.0, 1.0),
            "margin_floor": _f("margin_floor", 0.05, 0.0, 1e9),
        },
    }


def quant_selects(quant: Dict[str, Any], gid: str, members: Any) -> str:
    """The serving mode one trunk group gets under a normalized quant
    block: ``mode`` when the group matches the ``groups`` selector (empty
    = all; entries match the gid or any member task), else off."""
    mode = quant["mode"]
    if mode == "off":
        return "off"
    sel = quant["groups"]
    if not sel:
        return mode
    names = {gid, *list(members or [])}
    return mode if names.intersection(sel) else "off"



def normalize_kernels(d: Dict[str, Any]) -> Dict[str, Any]:
    """Normalized ``engine.kernels`` block.

    - ``epilogue.enabled``: fuse the head-bank dense+bias+activation into
      one kernel launch (ops.epilogue: the hand-written CUDA kernel on the
      GPU, its plain PyTorch version on the host — parity ≤1e-4).
    - ``bgmv.enabled`` + ``bgmv.min_tasks``: per-item gathered head
      application for banks at least ``min_tasks`` heads wide — work
      scales with (row, task) pairs instead of rows × tasks; narrower
      banks keep the all-heads matmul, which is cheaper there.
    """
    d = dict(d or {})

    def _block(name: str) -> Dict[str, Any]:
        b = d.get(name)
        return b if isinstance(b, dict) else {}

    ep = _block("epilogue")
    bg = _block("bgmv")
    try:
        min_tasks = max(1, int(bg.get("min_tasks", 8)))
    except (TypeError, ValueError):
        min_tasks = 8
    return {
        "epilogue": {"enabled": bool(ep.get("enabled", False))},
        "bgmv": {"enabled": bool(bg.get("enabled", False)),
                 "min_tasks": min_tasks},
    }
