"""Rotary position embeddings with optional YaRN long-context scaling.

Tables are computed on the host in float64 numpy and cast to float32,
exactly as the JAX reference computes them (and as HF forces float32 for
its cos/sin tables), then moved to the model's device once per
(sequence length, device) and cached on the ``RopeSpec``.
"""

from __future__ import annotations

import math
import threading
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def default_inv_freq(head_dim: int, base: float) -> np.ndarray:
    return 1.0 / base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)


def yarn_inv_freq(
    head_dim: int,
    base: float,
    factor: float,
    original_max_position_embeddings: int,
    beta_fast: float = 32.0,
    beta_slow: float = 1.0,
    attention_factor: Optional[float] = None,
    mscale: Optional[float] = None,
    mscale_all_dim: Optional[float] = None,
    truncate: bool = True,
) -> Tuple[np.ndarray, float]:
    """YaRN NTK-by-parts inverse frequencies + attention scaling factor
    (the published formula, as HF ``_compute_yarn_parameters``)."""

    def get_mscale(scale: float, m: float = 1.0) -> float:
        if scale <= 1.0:
            return 1.0
        return 0.1 * m * math.log(scale) + 1.0

    if attention_factor is None:
        if mscale and mscale_all_dim:
            attention_factor = float(
                get_mscale(factor, mscale) / get_mscale(factor, mscale_all_dim))
        else:
            attention_factor = get_mscale(factor)

    def find_correction_dim(num_rotations: float) -> float:
        return (head_dim * math.log(
            original_max_position_embeddings / (num_rotations * 2 * math.pi))
        ) / (2 * math.log(base))

    low = find_correction_dim(beta_fast)
    high = find_correction_dim(beta_slow)
    if truncate:
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, head_dim - 1)
    if low == high:
        high += 0.001

    pos_freqs = base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    inv_freq_extrapolation = 1.0 / pos_freqs
    inv_freq_interpolation = 1.0 / (factor * pos_freqs)
    ramp = np.clip(
        (np.arange(head_dim // 2, dtype=np.float64) - low) / (high - low), 0, 1)
    extrapolation_factor = 1.0 - ramp
    inv_freq = (inv_freq_interpolation * (1.0 - extrapolation_factor)
                + inv_freq_extrapolation * extrapolation_factor)
    return inv_freq, float(attention_factor)


def rope_tables(inv_freq: np.ndarray, seq_len: int,
                attention_scaling: float = 1.0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """float32 cos/sin tables of shape [seq_len, head_dim] (freqs duplicated
    across both halves, the rotate-half convention), computed in float64."""
    positions = np.arange(seq_len, dtype=np.float64)
    freqs = np.outer(positions, np.asarray(inv_freq, np.float64))  # [S, D/2]
    emb = np.concatenate([freqs, freqs], axis=-1)  # [S, D]
    cos = (np.cos(emb) * attention_scaling).astype(np.float32)
    sin = (np.sin(emb) * attention_scaling).astype(np.float32)
    return cos, sin


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply RoPE. q/k: [..., S, D]; cos/sin: [S, D] broadcast over the
    leading dims.  Rotation runs in float32 and casts back."""
    orig_dtype = q.dtype
    cos = cos.float()
    sin = sin.float()
    qf = q.float()
    kf = k.float()
    q_out = qf * cos + rotate_half(qf) * sin
    k_out = kf * cos + rotate_half(kf) * sin
    return q_out.to(orig_dtype), k_out.to(orig_dtype)


@lru_cache(maxsize=256)
def _cached_spec(head_dim: int, base: float,
                 yarn_key: Optional[Tuple[Tuple[str, object], ...]]
                 ) -> Tuple[Tuple[float, ...], float]:
    if yarn_key is not None:
        yarn = dict(yarn_key)
        inv_freq, scaling = yarn_inv_freq(
            head_dim, base,
            factor=float(yarn["factor"]),
            original_max_position_embeddings=int(
                yarn.get("original_max_position_embeddings",
                         yarn.get("original_max_positions", 8192))),
            beta_fast=float(yarn.get("beta_fast", 32.0)),
            beta_slow=float(yarn.get("beta_slow", 1.0)),
            attention_factor=yarn.get("attention_factor"),
            mscale=yarn.get("mscale"),
            mscale_all_dim=yarn.get("mscale_all_dim"),
            truncate=bool(yarn.get("truncate", True)),
        )
        return tuple(inv_freq.tolist()), scaling
    return tuple(default_inv_freq(head_dim, base).tolist()), 1.0


class RopeSpec:
    """Precomputed RoPE spec for one attention flavour (global or local).

    ``tables(S, device)`` returns float32 cos/sin tensors on ``device``,
    built once per (S, device) for this spec."""

    def __init__(self, head_dim: int, base: float,
                 yarn: Optional[dict] = None) -> None:
        yarn_key = tuple(sorted(yarn.items())) if yarn else None
        inv_freq_key, self.attention_scaling = _cached_spec(
            head_dim, float(base), yarn_key)
        self.inv_freq = np.asarray(inv_freq_key, dtype=np.float64)
        self._tables: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._lock = threading.Lock()

    def tables(self, seq_len: int, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (int(seq_len), str(device))
        hit = self._tables.get(key)
        if hit is None:
            cos, sin = rope_tables(self.inv_freq, int(seq_len),
                                   self.attention_scaling)
            hit = (torch.from_numpy(cos).to(device),
                   torch.from_numpy(sin).to(device))
            with self._lock:
                hit = self._tables.setdefault(key, hit)
        return hit
