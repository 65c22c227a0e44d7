"""Kernel knob interpretation: the ONE interpretation point for the
``engine.kernels`` block.  Malformed values fall back to defaults; every
default is OFF."""

from __future__ import annotations

from typing import Any, Dict


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
