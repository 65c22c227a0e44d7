"""The quantized ModernBERT trunk serving modes.

The port of ``semantic_router_tpu.models.quant``, over the port's trunk
module (``ModernBertModel``) instead of a Flax parameter tree:

- ``bf16``: a trunk with compute dtype bfloat16 that shares every
  parameter of the float32 trunk (each op casts its float32 parameters),
  so flipping back to ``off`` serves the original module untouched;
- ``int8``: the same bf16 trunk with every dense projection (Wqkv, Wo,
  Wi) swapped through the trunk's ``dense_factory`` seam for
  ``QuantDense``: per-output-channel int8 weights and float32 scales,
  quantized once when the mode is applied, and a dequantizing matmul with
  bf16 activations.  Embeddings and LayerNorms stay float32, shared.

Serving trunks are built on the meta device and then handed the source
trunk's parameters (the same tensors) and the quantized buffers, so no
weight is copied besides the int8 ones.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ..ops.quant import dequant_matmul, quantize_per_channel
from .modernbert import ModernBertModel

QUANT_MODES = ("off", "bf16", "int8")


class QuantDense(nn.Module):
    """Dense projection over a pre-quantized kernel: buffers ``kernel_q``
    (int8 [in, out]) and ``scale`` (float32 [out]), plus an optional
    float32 ``bias``.  The product runs in ``compute_dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = compute_dtype
        self.register_buffer("kernel_q", torch.zeros(
            in_features, out_features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features)
                             if bias else None)

    def forward(self, x: torch.Tensor,
                task_index: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``task_index``: taken and ignored — a quantized trunk carries
        no per-task adapters."""
        return dequant_matmul(x.to(self.compute_dtype), self.kernel_q,
                              self.scale, bias=self.bias,
                              compute_dtype=self.compute_dtype)


def _is_dense_weight(name: str, t: torch.Tensor) -> bool:
    """A trunk projection's weight: every 2-D weight but the embedding
    table."""
    return name.endswith(".weight") and t.dim() == 2 \
        and not name.startswith("embeddings.")


def quantize_trunk_params(trunk: ModernBertModel) -> Dict[str, torch.Tensor]:
    """The trunk's state for ``QuantDense`` serving: each dense
    ``{prefix}.weight`` [out, in] becomes ``{prefix}.kernel_q`` (int8
    [in, out]) and ``{prefix}.scale``; a dense bias, the embeddings and
    the LayerNorms pass through as they are."""
    out: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for name, t in trunk.state_dict().items():
            if _is_dense_weight(name, t):
                prefix = name[:-len(".weight")]
                q, scale = quantize_per_channel(t.t())
                out[f"{prefix}.kernel_q"] = q
                out[f"{prefix}.scale"] = scale
            else:
                out[name] = t
    return out


def _attach(module: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Hand a meta-built module the tensors of ``state`` by name: a
    parameter keeps the very tensor it is given (shared with its
    source), a buffer takes it as its value."""
    for name, t in state.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        if leaf in owner._parameters:
            owner._parameters[leaf] = t if isinstance(t, nn.Parameter) \
                else nn.Parameter(t, requires_grad=False)
        elif leaf in owner._buffers:
            owner._buffers[leaf] = t
        else:
            raise KeyError(f"serving trunk has no tensor {name!r}")
    left = [n for n, t in list(module.named_parameters())
            + list(module.named_buffers()) if t.is_meta]
    if left:
        raise KeyError(f"serving trunk tensors left unset: {left}")


def build_quant_trunk(trunk: ModernBertModel, mode: str,
                      state: Optional[Dict[str, torch.Tensor]] = None
                      ) -> ModernBertModel:
    """The serving trunk for one trunk group at ``mode``: ``off`` is the
    trunk itself; ``bf16`` a bf16-compute trunk over the same parameters;
    ``int8`` that trunk with ``QuantDense`` projections over
    ``quantize_trunk_params(trunk)`` (or the given ``state``)."""
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {mode!r} "
                         f"(expected one of {QUANT_MODES})")
    if mode == "off":
        return trunk
    cfg = dataclasses.replace(trunk.config, dtype=torch.bfloat16)
    factory = None
    if mode == "int8":
        def factory(d_in: int, d_out: int, bias: bool) -> QuantDense:
            return QuantDense(d_in, d_out, bias)

    with torch.device("meta"):
        serving = ModernBertModel(cfg, dense_factory=factory)
    params = dict(trunk.named_parameters())
    if mode == "int8":
        params = {n: params.get(n, t)
                  for n, t in (state or quantize_trunk_params(trunk)).items()}
    _attach(serving, params)
    return serving.eval()
