"""2D-Matryoshka helpers: dimension truncation x layer early exit.

An embedding model trained 2D-Matryoshka trades quality for speed along
two axes: exit at an earlier layer (``ModernBertModel(exit_layer=...)``)
and/or keep only the first dims of the pooled vector.  Truncation is a
slice and a re-normalization, free at serving time.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def truncate_normalize(emb: torch.Tensor,
                       dim: Optional[int] = None) -> torch.Tensor:
    """Slice to the first ``dim`` features and re-L2-normalize, in float32
    (a zero vector stays zero: the norm is floored at 1e-9)."""
    if dim is not None and dim < emb.shape[-1]:
        emb = emb[..., :dim]
    embf = emb.float()
    norm = torch.linalg.vector_norm(embf, dim=-1, keepdim=True)
    return embf / norm.clamp_min(1e-9)


def matryoshka_views(emb: np.ndarray, dims: Sequence[int]) -> dict:
    """Every configured dim view of one embedding batch (host numpy)."""
    out = {}
    for d in dims:
        v = emb[..., :d]
        n = np.linalg.norm(v, axis=-1, keepdims=True)
        out[d] = v / np.maximum(n, 1e-9)
    return out
