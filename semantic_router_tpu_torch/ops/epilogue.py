"""Head-bank epilogue: the hand-written CUDA kernel and its plain version.

``head_epilogue`` computes ``act(x @ W[t] + b[t] + delta[:, t])`` for
every task t of a stacked head bank in one launch of
``csrc/head_epilogue.cu`` (the port of the TPU kernel
``semantic_router_tpu.ops.epilogue.head_epilogue_pallas``) when ``x`` lies
on a CUDA device, and ``head_epilogue_reference`` (einsum → bias → delta
→ act) when it lies on the CPU.  There is no fallback: a CUDA tensor the
kernel does not take raises.
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

_P = ctypes.c_void_p
_I = ctypes.c_int

HEAD_EPILOGUE = CudaKernel(
    "head_epilogue", "srt_head_epilogue",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])

# the activation names ModernBERT's classifier_activation accepts, with
# the kernel's enum codes (csrc/head_epilogue.cu)
ACTIVATIONS = {
    "identity": 0,
    "gelu": 1, "gelu_python": 1,
    "gelu_new": 2, "gelu_pytorch_tanh": 2,
    "relu": 3,
    "silu": 4, "swish": 4,
}
_DTYPES = {torch.float32: DTYPE_F32, torch.bfloat16: DTYPE_BF16}


def activation(name: str):
    """Activation by its HF name, as a tensor function (the plain
    versions of the kernel's enum)."""
    code = ACTIVATIONS.get(name)
    if code is None:
        raise ValueError(f"unknown activation {name!r}")
    return {
        0: lambda h: h,
        1: lambda h: torch.nn.functional.gelu(h),
        2: lambda h: torch.nn.functional.gelu(h, approximate="tanh"),
        3: torch.relu,
        4: torch.nn.functional.silu,
    }[code]


def head_epilogue_reference(x: torch.Tensor, kernel: torch.Tensor,
                            bias: Optional[torch.Tensor],
                            delta: Optional[torch.Tensor],
                            act: str) -> torch.Tensor:
    """The kernel's plain version: einsum → bias → delta → activation."""
    h = torch.einsum("bd,tdh->bth", x, kernel)
    if bias is not None:
        h = h + bias[None]
    if delta is not None:
        h = h + delta
    return activation(act)(h)


def cost(x: torch.Tensor, kernel: torch.Tensor,
         bias: Optional[torch.Tensor] = None,
         delta: Optional[torch.Tensor] = None) -> tuple:
    """(FLOPs, bytes) of one call, the same for the kernel and its plain
    version: the [rows, D] x [D, H] product of every task,
    2·rows·D·H·T, and x, the kernel, bias, delta and the [rows, T, H]
    output each moved once."""
    rows, D = x.shape
    T, _, H = kernel.shape
    return (2.0 * rows * D * H * T,
            float(nbytes(x, kernel, bias, delta)
                  + rows * T * H * x.element_size()))


def head_epilogue(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  delta: Optional[torch.Tensor] = None,
                  act: str = "identity") -> torch.Tensor:
    """x [rows, D] × kernel [T, D, H] (+ bias [T, H]) (+ delta
    [rows, T, H]) → act(x@W + b + delta) [rows, T, H] in x's dtype."""
    if counting_costs():
        note_cost(HEAD_EPILOGUE, *cost(x, kernel, bias, delta))
    if x.device.type == "cpu":
        with plain_region():
            return head_epilogue_reference(x, kernel, bias, delta, act)
    if x.device.type != "cuda":
        raise ValueError(f"head_epilogue: unsupported device {x.device}")
    if act not in ACTIVATIONS:
        raise ValueError(f"head_epilogue: unknown activation {act!r}")
    if x.dim() != 2 or kernel.dim() != 3 or kernel.shape[1] != x.shape[1]:
        raise ValueError(f"head_epilogue: x {tuple(x.shape)} and kernel "
                         f"{tuple(kernel.shape)} are not [rows, D] and "
                         f"[T, D, H]")
    rows, D = x.shape
    T, _, H = kernel.shape
    if x.dtype not in _DTYPES:
        raise ValueError(f"head_epilogue: dtype {x.dtype}; the kernel takes "
                         f"float32 or bfloat16")
    named = [("x", x, (rows, D)), ("kernel", kernel, (T, D, H))]
    if bias is not None:
        named.append(("bias", bias, (T, H)))
    if delta is not None:
        named.append(("delta", delta, (rows, T, H)))
    for name, t, shape in named:
        if tuple(t.shape) != shape:
            raise ValueError(f"head_epilogue: {name} shape "
                             f"{tuple(t.shape)} != {shape}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"head_epilogue: {name} is {t.dtype} on "
                             f"{t.device}, x is {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"head_epilogue: {name} is not contiguous")
    out = torch.empty((rows, T, H), dtype=x.dtype, device=x.device)
    fn = HEAD_EPILOGUE.function()
    rc = fn(x.data_ptr(), kernel.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            delta.data_ptr() if delta is not None else None,
            out.data_ptr(), rows, D, H, T, ACTIVATIONS[act],
            _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(HEAD_EPILOGUE, rc, x.dtype)
    return out
