"""Attention primitives: dense SDPA, sliding-window masks, chunked SDPA,
pooling, and the sequence-packing masks and per-segment pools.

Masks are additive biases: 0 where attention is allowed and a large
finite negative where it is not — finite so that fully masked rows (the
padding rows of a padded batch) stay NaN-free.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9  # finite: keeps fully-masked (padding) rows NaN-free


def padding_bias(attention_mask: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, S] {0,1} mask → [B, 1, 1, S] additive key bias."""
    bias = (1.0 - attention_mask.to(dtype)) * NEG_INF
    return bias[:, None, None, :]


def sliding_window_bias(seq_len: int, window: int,
                        dtype: torch.dtype = torch.float32,
                        device: Optional[torch.device] = None
                        ) -> torch.Tensor:
    """[1, 1, S, S] additive bias allowing |i-j| <= window//2 (ModernBERT
    local attention: ``local_attention`` is the full window width)."""
    idx = torch.arange(seq_len, device=device)
    dist = (idx[:, None] - idx[None, :]).abs()
    allowed = dist <= (window // 2)
    zero = torch.zeros((), dtype=dtype, device=device)
    neg = torch.full((), NEG_INF, dtype=dtype, device=device)
    return torch.where(allowed, zero, neg)[None, None, :, :]


def block_diagonal_bias(segment_ids: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, S] int segment ids (-1 = padding) → [B, 1, S, S] additive bias
    allowing attention only WITHIN a segment: each packed prompt attends
    exactly as if it sat alone in its row.  Padding keys (segment -1) are
    masked even against padding queries, so a packed row is numerically
    independent of what shares it."""
    same = segment_ids[:, :, None] == segment_ids[:, None, :]
    allowed = same & (segment_ids >= 0)[:, None, :]
    zero = torch.zeros((), dtype=dtype, device=segment_ids.device)
    neg = torch.full((), NEG_INF, dtype=dtype, device=segment_ids.device)
    return torch.where(allowed, zero, neg)[:, None, :, :]


def packed_window_bias(position_ids: torch.Tensor, window: int,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, S] per-segment position ids → [B, 1, S, S] sliding-window bias on
    SEGMENT-LOCAL positions: inside one segment positions are contiguous,
    so |p_i - p_j| is the unpacked |i - j|.  Combine with
    ``block_diagonal_bias``: the position test alone would let a window
    straddle two segments whose local positions align."""
    dist = (position_ids[:, :, None] - position_ids[:, None, :]).abs()
    allowed = dist <= (window // 2)
    zero = torch.zeros((), dtype=dtype, device=position_ids.device)
    neg = torch.full((), NEG_INF, dtype=dtype, device=position_ids.device)
    return torch.where(allowed, zero, neg)[:, None, :, :]


def causal_bias(seq_len: int, dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """[1, 1, S, S] additive bias masking keys after the query."""
    return torch.triu(torch.full((seq_len, seq_len), NEG_INF, dtype=dtype,
                                 device=device), diagonal=1)[None, None]


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         bias: Optional[torch.Tensor] = None,
         scale: Optional[float] = None) -> torch.Tensor:
    """Dense scaled-dot-product attention.

    q/k/v: [B, H, S, D]; bias broadcastable to [B, H, S, S].  Softmax in
    float32 whatever the input dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def chunked_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 key_padding_mask: Optional[torch.Tensor] = None,
                 window: int = 0,
                 block_size: int = 512,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Attention streamed over query blocks: peak live score memory is
    [B, H, block, S] instead of [B, H, S, S].  Same semantics as ``sdpa``
    with the padding and window biases:

    - ``key_padding_mask``: [B, S] with 1 = real token.
    - ``window``: 0 for global attention, else the full window width
      (keys with |i-j| > window//2 are masked)."""
    B, H, S, D = q.shape
    if scale is None:
        scale = D ** -0.5
    if key_padding_mask is not None:
        key_bias = (1.0 - key_padding_mask.float()) * NEG_INF
    else:
        key_bias = torch.zeros((B, S), dtype=torch.float32, device=q.device)
    key_idx = torch.arange(S, device=q.device)
    outs = []
    for start in range(0, S, block_size):
        qb = q[:, :, start:start + block_size]
        scores = torch.einsum("bhqd,bhkd->bhqk", qb, k).float() * scale
        scores = scores + key_bias[:, None, None, :]
        if window > 0:
            q_pos = torch.arange(start, start + qb.shape[2], device=q.device)
            dist = (q_pos[:, None] - key_idx[None, :]).abs()
            scores = scores + torch.where(
                dist <= window // 2, 0.0, NEG_INF)[None, None]
        probs = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v))
    return torch.cat(outs, dim=2)


def mean_pool(hidden: torch.Tensor,
              attention_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean pooling: [B, S, D] × [B, S] → [B, D]."""
    mask = attention_mask.to(hidden.dtype)[..., None]
    summed = (hidden * mask).sum(dim=1)
    counts = mask.sum(dim=1).clamp_min(1e-9)
    return summed / counts


def cls_pool(hidden: torch.Tensor) -> torch.Tensor:
    return hidden[:, 0]


def packed_cls_pool(hidden: torch.Tensor, seg_row: torch.Tensor,
                    seg_start: torch.Tensor) -> torch.Tensor:
    """Per-segment CLS pooling over packed rows: each segment's first
    token, hidden [R, S, D] × seg_row / seg_start [K] → [K, D].  Padding
    segments point at (0, 0); their rows are dropped at demux."""
    return hidden[seg_row.long(), seg_start.long()]


def packed_mean_pool(hidden: torch.Tensor, segment_ids: torch.Tensor,
                     n_segments: int) -> torch.Tensor:
    """Per-segment masked mean over packed rows: hidden [R, S, D] ×
    segment_ids [R, S] (global segment index, -1 = padding) → [K, D], as
    one [K, R·S] selection matmul."""
    flat = hidden.reshape(-1, hidden.shape[-1])
    seg = segment_ids.reshape(-1)
    sel = (seg[None, :] == torch.arange(n_segments, device=seg.device)
           [:, None]).to(hidden.dtype)
    counts = sel.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return (sel @ flat) / counts
