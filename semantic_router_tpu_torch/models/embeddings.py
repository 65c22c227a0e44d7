"""mmBERT (ModernBERT) embedding model with 2D-Matryoshka serving.

The port of ``semantic_router_tpu.models.embeddings``: the ModernBERT
trunk (``model``), mean or CLS pooling, optional bias-free bottleneck
layers (``dense_0``, ``dense_1``, ...), then ``truncate_normalize``.
``exit_layer`` skips the top layers (with ``attention_impl="flash"`` the
trunk launches the flash-attention kernel once per layer that runs);
``output_dim`` keeps the first dims of the pooled vector.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.attention import cls_pool, mean_pool
from ..ops.matryoshka import truncate_normalize
from .modernbert import ModernBertConfig, ModernBertModel


class MmBertEmbeddingModel(nn.Module):
    """ModernBERT trunk → pool → (optional bottleneck) → L2 normalize:
    [B, S] ids → [B, dim] float32 unit rows."""

    def __init__(self, cfg: ModernBertConfig, pooling: str = "mean",
                 bottleneck_dims: Sequence[int] = ()) -> None:
        super().__init__()
        if pooling not in ("mean", "cls"):
            raise ValueError(f"pooling {pooling!r} not in ('mean', 'cls')")
        self.config = cfg
        self.pooling = pooling
        self.model = ModernBertModel(cfg)
        self.bottleneck_dims = tuple(int(d) for d in bottleneck_dims)
        width = cfg.hidden_size
        for i, dim in enumerate(self.bottleneck_dims):
            self.add_module(f"dense_{i}", nn.Linear(width, dim, bias=False))
            width = dim

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                exit_layer: Optional[int] = None,
                output_dim: Optional[int] = None) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        hidden = self.model(input_ids, attention_mask, exit_layer=exit_layer)
        pooled = cls_pool(hidden) if self.pooling == "cls" \
            else mean_pool(hidden, attention_mask)
        for i in range(len(self.bottleneck_dims)):
            pooled = getattr(self, f"dense_{i}")(pooled)
        return truncate_normalize(pooled, output_dim)
