"""Flash attention: the hand-written CUDA kernel and its plain version.

``flash_attention`` is the entry point every ModernBERT attention layer
calls with ``attention_impl="flash"``.  On a CUDA tensor it launches
``csrc/flash_attention.cu`` (the port of the TPU kernel
``semantic_router_tpu.ops.flash_attention.flash_attention_pallas``); on a
CPU tensor it runs ``flash_attention_reference``, dense SDPA with the
summed biases.  There is no fallback: a CUDA tensor the kernel does not
take raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._cuda import (
    DTYPE_BF16,
    DTYPE_F32,
    CudaKernel,
    check_launch,
    counting_costs,
    nbytes,
    note_cost,
    plain_region,
)
from .attention import causal_bias, padding_bias, sdpa, sliding_window_bias

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int

FLASH_ATTENTION = CudaKernel(
    "flash_attention", "srt_flash_attention",
    [_P, _P, _P, _P, _P,
     _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
     _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P])

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: DTYPE_F32, torch.bfloat16: DTYPE_BF16}
BLOCK_Q, BLOCK_K = 64, 32  # query rows, keys per tile (csrc: BQ, BK)


def real_tiles(key_padding_mask: Optional[torch.Tensor], B: int, S: int,
               tile: int) -> torch.Tensor:
    """[B, ceil(S / tile)] bool, on the CPU: the tiles of ``tile`` tokens
    that hold a real token."""
    n = -(-S // tile)
    if key_padding_mask is None:
        return torch.ones(B, n, dtype=torch.bool)
    m = torch.zeros(B, n * tile, dtype=torch.bool)
    m[:, :S] = key_padding_mask.bool().cpu()
    return m.view(B, n, tile).any(-1)


def flash_tile_pairs(key_padding_mask: Optional[torch.Tensor], B: int,
                     S: int, window: int = 0, causal: bool = False) -> dict:
    """(Q tile, K tile) pairs per head: ``computed`` by the kernel's rule
    (a Q tile with no real query does no work; a K tile with no real key
    is skipped), ``clipped`` by the window/causal clip alone, and
    ``total`` without either."""
    real_q = real_tiles(key_padding_mask, B, S, BLOCK_Q)
    real_k = real_tiles(key_padding_mask, B, S, BLOCK_K)
    nq, nk = real_q.shape[1], real_k.shape[1]
    computed = clipped = 0
    half = window // 2
    for qt in range(nq):
        q0, q_last = qt * BLOCK_Q, min(qt * BLOCK_Q + BLOCK_Q, S) - 1
        k_lo, k_hi = 0, S - 1
        if window > 0:
            k_lo, k_hi = max(q0 - half, 0), min(q_last + half, S - 1)
        if causal:
            k_hi = min(k_hi, q_last)
        lo, hi = k_lo // BLOCK_K, k_hi // BLOCK_K
        clipped += B * (hi - lo + 1)
        visits = real_k[:, lo:hi + 1].sum(-1)
        computed += int((visits * real_q[:, qt]).sum())
    return {"computed": computed, "clipped": clipped, "total": B * nq * nk}


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              key_padding_mask: Optional[torch.Tensor] = None,
                              window: int = 0, causal: bool = False,
                              scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's plain version: dense SDPA over the summed additive
    biases (padding + window + causal).  Padding query rows may differ
    from the kernel's (the kernel writes zeros for a 64-row tile with no
    real query); real rows agree to float32 rounding."""
    S = q.shape[2]
    bias = None
    if key_padding_mask is not None:
        bias = padding_bias(key_padding_mask)
    if window > 0:
        wb = sliding_window_bias(S, window, device=q.device)
        bias = wb if bias is None else bias + wb
    if causal:
        cb = causal_bias(S, device=q.device)
        bias = cb if bias is None else bias + cb
    return sdpa(q, k, v, bias=bias, scale=scale)


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         key_padding_mask: Optional[torch.Tensor] = None) -> tuple:
    """(FLOPs, bytes) of one call, the same for the kernel and its plain
    version: the two [S, S] products of every head, 4·B·H·S·S·D (a
    shape count, like a compiled program's cost model: the kernel's
    skipped tiles and the window are not subtracted), and q, k, v, the
    mask and the output each moved once."""
    B, H, S, D = q.shape
    return (4.0 * B * H * S * S * D,
            float(nbytes(q, k, v, key_padding_mask) + nbytes(q)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor] = None,
                    window: int = 0, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v: [B, H, S, D] (any strides with D contiguous);
    key_padding_mask: [B, S] (1 = real token); ``window``: ModernBERT-style
    full window width (0 = global).  Returns [B, H, S, D] in q's dtype,
    laid out as [B, S, H, D] in memory so the caller's head merge is a
    view."""
    if counting_costs():
        note_cost(FLASH_ATTENTION, *cost(q, k, v, key_padding_mask))
    if q.device.type == "cpu":
        with plain_region():
            return flash_attention_reference(q, k, v, key_padding_mask,
                                             window=window, causal=causal,
                                             scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, H, S, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q/k/v shapes differ "
                         f"({tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)})")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes float32 or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} head dim is not "
                             f"contiguous (strides {t.stride()})")
    mask_ptr = None
    if key_padding_mask is not None:
        if key_padding_mask.shape != (B, S) \
                or key_padding_mask.device != q.device:
            raise ValueError(
                f"flash_attention: key_padding_mask must be [B, S] = "
                f"{(B, S)} on {q.device}, got "
                f"{tuple(key_padding_mask.shape)} on "
                f"{key_padding_mask.device}")
        if key_padding_mask.dtype != torch.int32 \
                or not key_padding_mask.is_contiguous():
            key_padding_mask = key_padding_mask.to(torch.int32).contiguous()
        mask_ptr = key_padding_mask.data_ptr()
    if scale is None:
        scale = D ** -0.5
    out = torch.empty((B, S, H, D), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    fn = FLASH_ATTENTION.function()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
            out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            B, H, S, D, int(window), int(bool(causal)), float(scale),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(FLASH_ATTENTION, rc, q.dtype)
    return out
