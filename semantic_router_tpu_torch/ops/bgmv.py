"""BGMV: the per-pair gathered matmul of wide head banks.

``bgmv(x, w, idx)`` computes ``y[p] = x[p] @ w[idx[p]]`` for x [P, D],
w [T, D, H] and idx [P] → [P, H]: each (row, task) pair of a batch
computes only its own task's head, so work scales with pairs instead of
rows × tasks (the S-LoRA / Punica serving shape).  On a CUDA device it
launches ``csrc/bgmv.cu`` (the port of the TPU kernel
``semantic_router_tpu.ops.bgmv.bgmv_pallas``); on the CPU it runs
``bgmv_reference`` (gather, then batched matvec).  There is no fallback:
a CUDA tensor the kernel does not take raises.

An index outside [0, T) never reads out of bounds: the kernel returns
that pair's row as NaN (the plain version raises in ``index_select``).
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda import DTYPE_BF16, DTYPE_F32, CudaKernel, check_launch

_P = ctypes.c_void_p
_I = ctypes.c_int

BGMV = CudaKernel("bgmv", "srt_bgmv",
                  [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P])

# csrc/bgmv.cu's limits: the block's x rows live in shared memory, and
# one pair per block must fit the grid's y extent
MAX_D = 4096
MAX_P = 65535
_DTYPES = {torch.float32: DTYPE_F32, torch.bfloat16: DTYPE_BF16}


def bgmv_reference(x: torch.Tensor, w: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: gather each pair's slab, then a
    batched matvec."""
    return torch.einsum("pd,pdh->ph", x, w.index_select(0, idx))


def bgmv(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [P, D] × w [T, D, H] gathered by idx [P] → [P, H] in x's dtype
    (float32 accumulation on the GPU)."""
    if x.device.type == "cpu":
        return bgmv_reference(x, w, idx)
    if x.device.type != "cuda":
        raise ValueError(f"bgmv: unsupported device {x.device}")
    if x.dim() != 2 or w.dim() != 3 or idx.dim() != 1 \
            or w.shape[1] != x.shape[1] or idx.shape[0] != x.shape[0]:
        raise ValueError(f"bgmv: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"idx {tuple(idx.shape)} are not [P, D], [T, D, H], "
                         f"[P]")
    P, D = x.shape
    T, _, H = w.shape
    if P == 0 or T == 0 or H == 0:
        raise ValueError(f"bgmv: empty operand (P={P}, T={T}, H={H})")
    if D > MAX_D or P > MAX_P:
        raise ValueError(f"bgmv: D={D} > {MAX_D} or P={P} > {MAX_P}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"bgmv: x {x.dtype}, w {w.dtype}; the kernel takes "
                         f"float32 or bfloat16, one dtype for both")
    if idx.dtype != torch.int32:
        raise ValueError(f"bgmv: idx is {idx.dtype}; the kernel takes int32")
    for name, t in (("x", x), ("w", w), ("idx", idx)):
        if t.device != x.device:
            raise ValueError(f"bgmv: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"bgmv: {name} is not contiguous")
    out = torch.empty((P, H), dtype=x.dtype, device=x.device)
    rc = BGMV.function()(
        x.data_ptr(), w.data_ptr(), idx.data_ptr(), out.data_ptr(), P, D, H,
        T, _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(BGMV, rc)
    return out
