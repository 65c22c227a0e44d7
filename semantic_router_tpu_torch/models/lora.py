"""The stacked head bank of the fused classifier bank.

The port of the head-bank half of ``semantic_router_tpu.models.lora``:
every member task's prediction head (dense → act → LayerNorm →
classifier, with an optional rank-r LoRA delta on the dense) stacks into
one bank of [T, ...] arrays, and one batched application fans the shared
trunk's features out through all of them.  Arrays keep the JAX layout
(``dense_kernel`` [T, D, H], ``cls_kernel`` [T, H, L]) so the bank and the
epilogue kernel take the same operands on both sides.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn


def _np(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.detach().cpu().numpy()


def head_bank_entry(module: nn.Module) -> Optional[Dict[str, Any]]:
    """The stackable prediction head of a plain ModernBERT sequence or
    token classifier, as host arrays {dense_kernel [D, H], dense_bias?,
    lora_A?, lora_B?, scale, norm_scale, norm_bias?, cls_kernel [H, L],
    cls_bias, kind}; None when the module is not bank-fusable."""
    from .modernbert import (
        ModernBertForSequenceClassification,
        ModernBertForTokenClassification,
    )

    if not isinstance(module, (ModernBertForSequenceClassification,
                               ModernBertForTokenClassification)):
        return None
    head, cls = module.head, module.classifier
    return {
        "dense_kernel": _np(head.dense.weight).T,
        "dense_bias": _np(head.dense.bias),
        "lora_A": None,
        "lora_B": None,
        "scale": 0.0,
        "norm_scale": _np(head.norm.weight),
        "norm_bias": _np(head.norm.bias),
        "cls_kernel": _np(cls.weight).T,
        "cls_bias": _np(cls.bias),
        "kind": "token"
        if isinstance(module, ModernBertForTokenClassification)
        else "sequence",
    }


def stack_head_bank(entries: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Stack per-task head entries into one bank of [T, ...] host arrays.
    Label columns zero-pad to the widest member (padded logits are sliced
    away before softmax); LoRA ranks zero-pad to the widest adapter, and
    non-LoRA members get all-zero A/B rows — an exact no-op delta.  The
    bank keeps the members' own dtype."""
    D, H = np.shape(entries[0]["dense_kernel"])
    dt = np.asarray(entries[0]["dense_kernel"]).dtype
    l_max = max(int(np.shape(e["cls_kernel"])[1]) for e in entries)
    r_max = max([int(np.shape(e["lora_A"])[1])
                 for e in entries if e["lora_A"] is not None] or [1])

    def stacked(key, pad_to=None, axis=None):
        rows = []
        for e in entries:
            a = np.asarray(e[key], dtype=dt)
            if pad_to is not None and a.shape[axis] < pad_to:
                widths = [(0, 0)] * a.ndim
                widths[axis] = (0, pad_to - a.shape[axis])
                a = np.pad(a, widths)
            rows.append(a)
        return np.stack(rows)

    bank: Dict[str, Any] = {
        "dense_kernel": stacked("dense_kernel"),             # [T, D, H]
        "norm_scale": stacked("norm_scale"),                 # [T, H]
        "cls_kernel": stacked("cls_kernel", l_max, 1),       # [T, H, L]
        "cls_bias": stacked("cls_bias", l_max, 0),           # [T, L]
        "scale": np.asarray([e["scale"] for e in entries], dt),
    }
    if entries[0]["dense_bias"] is not None:
        bank["dense_bias"] = stacked("dense_bias")           # [T, H]
    if entries[0]["norm_bias"] is not None:
        bank["norm_bias"] = stacked("norm_bias")             # [T, H]
    if any(e["lora_A"] is not None for e in entries):
        bank["lora_A"] = np.stack([
            np.pad(np.asarray(e["lora_A"], dt),
                   ((0, 0), (0, r_max - e["lora_A"].shape[1])))
            if e["lora_A"] is not None else np.zeros((D, r_max), dt)
            for e in entries])                               # [T, D, r]
        bank["lora_B"] = np.stack([
            np.pad(np.asarray(e["lora_B"], dt),
                   ((0, r_max - e["lora_B"].shape[0]), (0, 0)))
            if e["lora_B"] is not None else np.zeros((r_max, H), dt)
            for e in entries])                               # [T, r, H]
    return bank


def bank_to_device(bank: Dict[str, np.ndarray], device: torch.device
                   ) -> Dict[str, torch.Tensor]:
    """Commit a host bank to ``device`` once (contiguous tensors)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in bank.items()}


def apply_head_bank(bank: Dict[str, torch.Tensor], pooled: torch.Tensor,
                    activation: str, norm_eps: float,
                    epilogue: bool = False) -> torch.Tensor:
    """Fan features [B, D] out through EVERY stacked head → logits
    [B, T, L_max].  ``activation`` names the heads' classifier activation.

    ``epilogue=True`` routes dense + bias + LoRA delta + activation through
    ops.epilogue (one kernel launch on the GPU); the rank-r LoRA delta's
    skinny matmuls stay einsums feeding it.  The head LayerNorm is computed
    by hand with rsqrt on both paths."""
    from ..ops.epilogue import activation as act_fn, head_epilogue

    if epilogue:
        # the kernel reads row-major operands: a CLS-pooled view and an
        # einsum result may be strided
        pooled = pooled.contiguous()
        delta = None
        if "lora_A" in bank:
            low = torch.einsum("bd,tdr->btr", pooled, bank["lora_A"])
            delta = (bank["scale"][None, :, None] * torch.einsum(
                "btr,trh->bth", low, bank["lora_B"])).contiguous()
        h = head_epilogue(pooled, bank["dense_kernel"],
                          bank.get("dense_bias"), delta, activation)
    else:
        h = torch.einsum("bd,tdh->bth", pooled, bank["dense_kernel"])
        if "dense_bias" in bank:
            h = h + bank["dense_bias"][None]
        if "lora_A" in bank:
            low = torch.einsum("bd,tdr->btr", pooled, bank["lora_A"])
            h = h + bank["scale"][None, :, None] * torch.einsum(
                "btr,trh->bth", low, bank["lora_B"])
        h = act_fn(activation)(h)
    mu = h.mean(dim=-1, keepdim=True)
    var = ((h - mu) ** 2).mean(dim=-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + norm_eps)
    h = h * bank["norm_scale"][None]
    if "norm_bias" in bank:
        h = h + bank["norm_bias"][None]
    return torch.einsum("bth,thl->btl", h, bank["cls_kernel"]) \
        + bank["cls_bias"][None]
