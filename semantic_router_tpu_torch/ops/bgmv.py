"""BGMV: the per-pair gathered matmul of wide head banks.

``bgmv(x, w, idx)`` computes ``y[p] = x[p] @ w[idx[p]]`` for x [P, D],
w [T, D, H] and idx [P] → [P, H]: each (row, task) pair of a batch
computes only its own task's head, so work scales with pairs instead of
rows × tasks (the S-LoRA / Punica serving shape).  On a CUDA device it
launches ``csrc/bgmv.cu`` (the port of the TPU kernel
``semantic_router_tpu.ops.bgmv.bgmv_pallas``), a task-grouped segmented
GEMM that groups the pairs by task on the device and reads each task's
weight tile once for up to 16 of its pairs; ``bgmv_segments`` is its
grouping rule in Python.  On the CPU it runs ``bgmv_reference`` (gather,
then batched matvec).  There is no fallback: a CUDA tensor the kernel
does not take raises.

An index outside [0, T) never reads out of bounds: the kernel returns
that pair's row as NaN (the plain version raises in ``index_select``).
"""

from __future__ import annotations

import ctypes

import numpy as np
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

_P = ctypes.c_void_p
_I = ctypes.c_int

BGMV = CudaKernel("bgmv", "srt_bgmv",
                  [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P])

# csrc/bgmv.cu's limits and grouping constants
MAX_D = 4096
MAX_P = 65535
CHUNK = 16               # pairs of one task a work unit applies a W tile to
PAIRS_PER_LAUNCH = 2048  # one launch counts this many pairs in shared memory
TASKS_PER_LAUNCH = 1024  # ... over this many tasks; larger calls loop
_DTYPES = {torch.float32: DTYPE_F32, torch.bfloat16: DTYPE_BF16}


def bgmv_reference(x: torch.Tensor, w: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: gather each pair's slab, then a
    batched matvec."""
    return torch.einsum("pd,pdh->ph", x, w.index_select(0, idx))


def bgmv_segments(idx, T: int, H: int = 0, element_size: int = 4) -> dict:
    """The kernel's grouping rule.  Each launch takes up to
    ``PAIRS_PER_LAUNCH`` pairs and ``TASKS_PER_LAUNCH`` tasks; in it the
    pairs of each task, in ascending pair order, form one segment, cut
    into work units of ``CHUNK`` pairs, numbered task by task.  A work
    item is (unit, column tile), a tile being a 128-byte band of W's
    columns (32 float32 or 64 bfloat16); item i is unit i // column_tiles,
    and block b of the launch's C takes items b, b + C, ...  Pairs whose
    index lies outside [0, T) form no segment: the first task window of
    their slice gathers them into units that write NaN rows.

    Returns ``perm`` (in-range pairs by task, stable), ``offsets`` ([T+1]:
    task t owns perm[offsets[t]:offsets[t+1]]), ``segments`` (tasks with a
    pair), ``units`` ((task, pairs) in launch and unit order),
    ``nan_units`` (pairs of each NaN unit), ``nan_pairs`` and
    ``grid_units`` (per launch, the most units its pairs can form: C is
    that many items, or as many blocks as the card holds at once if
    fewer).  With H (operands of ``element_size`` bytes) also
    ``column_tiles``, ``items`` and ``item_bound``."""
    idx = np.asarray(idx.cpu() if isinstance(idx, torch.Tensor) else idx,
                     np.int64).reshape(-1)
    P = idx.size
    ok = (idx >= 0) & (idx < T)
    counts = np.bincount(idx[ok], minlength=T)
    perm = np.argsort(np.where(ok, idx, T), kind="stable")[:int(ok.sum())]
    units, nan_units, grid_units = [], [], []
    for p0 in range(0, P, PAIRS_PER_LAUNCH):
        part = idx[p0:p0 + PAIRS_PER_LAUNCH]
        n = part.size
        for t_lo in range(0, T, TASKS_PER_LAUNCH):
            nbins = min(TASKS_PER_LAUNCH, T - t_lo)
            bad = t_lo == 0
            key = np.where((part >= t_lo) & (part < t_lo + nbins),
                           part - t_lo, -1)
            if bad:
                key[(part < 0) | (part >= T)] = nbins
            grid_units.append((n + (CHUNK - 1) * min(nbins + bad, n))
                              // CHUNK)
            for b in range(nbins + bad):
                pairs = (np.flatnonzero(key == b) + p0).tolist()
                for c in range(0, len(pairs), CHUNK):
                    chunk = tuple(pairs[c:c + CHUNK])
                    if b == nbins:
                        nan_units.append(chunk)
                    else:
                        units.append((t_lo + b, chunk))
    out = {"perm": perm, "offsets": np.concatenate([[0], np.cumsum(counts)]),
           "segments": int(np.count_nonzero(counts)), "units": units,
           "nan_units": nan_units, "nan_pairs": np.flatnonzero(~ok),
           "grid_units": grid_units}
    if H:
        tiles = -(-H // (128 // element_size))
        out.update(column_tiles=tiles,
                   items=(len(units) + len(nan_units)) * tiles,
                   item_bound=sum(grid_units) * tiles)
    return out


def cost(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor) -> tuple:
    """(FLOPs, bytes) of one call, the same for the kernel and its plain
    version: one [D] x [D, H] product per pair, 2·P·D·H, and x, the bank,
    the indices and the [P, H] output each moved once."""
    P, D = x.shape
    H = w.shape[-1]
    return (2.0 * P * D * H,
            float(nbytes(x, w, idx) + P * H * x.element_size()))


def bgmv(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [P, D] × w [T, D, H] gathered by idx [P] → [P, H] in x's dtype
    (float32 accumulation on the GPU)."""
    if counting_costs():
        note_cost(BGMV, *cost(x, w, idx))
    if x.device.type == "cpu":
        with plain_region():
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
    check_launch(BGMV, rc, x.dtype)
    return out
