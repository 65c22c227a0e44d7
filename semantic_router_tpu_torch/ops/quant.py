"""Per-channel symmetric int8 weight quantization and the dequantizing
matmul.

The port of ``semantic_router_tpu.ops.quant``:

- ``quantize_per_channel``: w [..., D, F] → (q int8 [..., D, F],
  scale f32 [..., F]), symmetric over 127 levels per output channel, so
  ``dequantize(quantize(w)) - w`` is at most scale/2 per element;
- ``dequant_matmul``: x @ (q × scale) (+ bias) as a product of x and q in
  the compute dtype (bf16), the per-channel scale applied after the
  product in float32, then the bias in float32, then a cast to x's dtype.

The product is a library GEMM (cuBLAS on the card), not a port kernel:
no TPU kernel computes it.  One difference from the reference: there the
bf16 product accumulates in float32 and stays float32 until the scale
(``preferred_element_type``); ``torch.matmul`` of two bf16 tensors
accumulates in float32 but rounds its output to bf16 before the scale is
applied.  ``tests/test_torch_quant.py`` measures that extra rounding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

INT8_LEVELS = 127.0  # symmetric: [-127, 127]; -128 stays unused


def quantize_per_channel(w: torch.Tensor, eps: float = 1e-12
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a dense kernel
    [..., D, F] (F = output features, the last axis).  Returns
    (q int8, scale float32 [..., F])."""
    w32 = w.to(torch.float32)
    absmax = w32.abs().amax(dim=-2)
    scale = torch.clamp(absmax / INT8_LEVELS, min=eps)
    q = torch.clamp(torch.round(w32 / scale.unsqueeze(-2)),
                    -INT8_LEVELS, INT8_LEVELS).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Explicit dequantize: q × scale, in float32, cast to ``dtype``."""
    return (q.to(torch.float32) * scale.unsqueeze(-2)).to(dtype)


def dequant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   compute_dtype: torch.dtype = torch.bfloat16
                   ) -> torch.Tensor:
    """``x @ (q × scale) (+ bias)``: x and q cast to ``compute_dtype``
    (int8 → bf16 is exact), their product, the scale and the bias in
    float32, the result in x's dtype."""
    y = torch.matmul(x.to(compute_dtype), q.to(compute_dtype))
    y = y.to(torch.float32) * scale
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)
