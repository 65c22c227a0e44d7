"""Gemma3 text encoder and the Gemma embedding model.

The port of ``semantic_router_tpu.models.gemma`` (the reference's Gemma
embedding stack: gemma_embedding.rs, gemma3_model.rs and the dense
bottleneck of dense_layers.rs).  The Gemma3 text architecture:

- RMSNorm with a zero-initialized weight applied as ``x * (1 + w)``,
  normed in float32;
- embeddings scaled by sqrt(hidden_size), the factor rounded to the
  model's dtype first (as the published implementation does);
- sandwich norms: input / post-attention and pre / post-feedforward;
- GQA with a per-head RMSNorm on q and k, queries scaled by
  ``query_pre_attn_scalar ** -0.5``;
- sliding and full attention layers (``layer_types``, else every
  ``sliding_pattern``-th layer full), with their own rope bases
  (``rope_local_base_freq`` local, ``rope_theta`` global) and optional
  linear rope scaling on the full layers; the sliding window admits
  ``|i - j| < window`` bidirectionally, ``0 <= i - j < window`` when
  causal;
- a GeGLU MLP with the tanh GELU.

``GemmaEmbeddingModel`` is the trunk → masked mean pool → a bias-free
dense bottleneck stack → L2 normalize.  Attention is the plain
``ops.attention.sdpa`` (the JAX package computes it with its plain
``sdpa`` too: no Pallas kernel reaches this model).  Submodule names
follow the JAX tree's (``model.layers.i.self_attn.q_proj``, ``dense_0``),
so ``models.convert.lora_params_from_flax`` carries its params across.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.attention import NEG_INF, mean_pool, sdpa
from ..ops.rope import RopeSpec, apply_rotary


@dataclasses.dataclass(frozen=True)
class GemmaConfig:
    vocab_size: int = 262208
    hidden_size: int = 768
    intermediate_size: int = 1152
    num_hidden_layers: int = 12
    num_attention_heads: int = 4
    num_key_value_heads: int = 1
    head_dim: int = 256
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    rope_local_base_freq: float = 10000.0
    rope_scaling_factor: float = 1.0  # linear scaling on the full layers
    sliding_window: int = 512
    layer_types: Tuple[str, ...] = ()  # sliding_attention | full_attention
    sliding_pattern: int = 6  # without layer_types: every Nth layer full
    query_pre_attn_scalar: float = 256.0
    max_position_embeddings: int = 131072
    attention_bias: bool = False
    causal: bool = True

    def layer_type(self, i: int) -> str:
        if self.layer_types:
            return self.layer_types[i]
        return ("full_attention" if (i + 1) % self.sliding_pattern == 0
                else "sliding_attention")

    @classmethod
    def from_hf(cls, hf: Any) -> "GemmaConfig":
        """From an HF config (a ``config.json`` dict or an object with its
        fields as attributes), reading the fields the JAX package's
        ``from_hf`` reads: ``causal`` and ``attention_bias`` keep their
        defaults whatever the config says."""
        if isinstance(hf, Mapping):
            g = lambda k, d=None: hf.get(k, d)
        else:
            g = lambda k, d=None: getattr(hf, k, d)
        rs = g("rope_scaling") or {}
        return cls(
            vocab_size=g("vocab_size"),
            hidden_size=g("hidden_size"),
            intermediate_size=g("intermediate_size"),
            num_hidden_layers=g("num_hidden_layers"),
            num_attention_heads=g("num_attention_heads"),
            num_key_value_heads=g("num_key_value_heads"),
            head_dim=g("head_dim", 256),
            rms_norm_eps=g("rms_norm_eps", 1e-6),
            rope_theta=g("rope_theta", 1e6),
            rope_local_base_freq=g("rope_local_base_freq", 1e4),
            rope_scaling_factor=float(rs.get("factor", 1.0)) if rs else 1.0,
            sliding_window=g("sliding_window", 512),
            layer_types=tuple(g("layer_types") or ()),
            query_pre_attn_scalar=float(g("query_pre_attn_scalar", 256.0)),
            max_position_embeddings=g("max_position_embeddings", 131072),
        )


class GemmaRMSNorm(nn.Module):
    """x · rsqrt(mean(x²) + eps) · (1 + w) in float32, then the input's
    dtype."""

    def __init__(self, dim: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        out = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True)
                               + self.eps)
        return (out * (1.0 + self.weight.float())).to(x.dtype)


class GemmaAttention(nn.Module):
    def __init__(self, cfg: GemmaConfig, layer_id: int) -> None:
        super().__init__()
        self.config = cfg
        H, KV, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                    cfg.head_dim)
        bias = cfg.attention_bias
        self.q_proj = nn.Linear(cfg.hidden_size, H * D, bias=bias)
        self.k_proj = nn.Linear(cfg.hidden_size, KV * D, bias=bias)
        self.v_proj = nn.Linear(cfg.hidden_size, KV * D, bias=bias)
        self.o_proj = nn.Linear(H * D, cfg.hidden_size, bias=bias)
        self.q_norm = GemmaRMSNorm(D, cfg.rms_norm_eps)
        self.k_norm = GemmaRMSNorm(D, cfg.rms_norm_eps)
        self.sliding = cfg.layer_type(layer_id) == "sliding_attention"
        if self.sliding:
            self.rope = RopeSpec(D, cfg.rope_local_base_freq)
        else:
            self.rope = RopeSpec(D, cfg.rope_theta,
                                 linear_factor=cfg.rope_scaling_factor)

    def forward(self, x: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        B, S, _ = x.shape
        H, KV, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                    cfg.head_dim)
        q = self.q_norm(self.q_proj(x).reshape(B, S, H, D)).transpose(1, 2)
        k = self.k_norm(self.k_proj(x).reshape(B, S, KV, D)).transpose(1, 2)
        v = self.v_proj(x).reshape(B, S, KV, D).transpose(1, 2)
        cos, sin = self.rope.tables(S, x.device)
        q, k = apply_rotary(q, k, cos, sin)
        if KV != H:  # GQA: query head h reads key/value head h // rep
            k = k.repeat_interleave(H // KV, dim=1)
            v = v.repeat_interleave(H // KV, dim=1)
        bias = (1.0 - attention_mask.float())[:, None, None, :] * NEG_INF
        idx = torch.arange(S, device=x.device)
        dist = idx[:, None] - idx[None, :]
        zero = torch.zeros((), device=x.device)
        neg = torch.full((), NEG_INF, device=x.device)
        if cfg.causal:
            bias = bias + torch.where(dist >= 0, zero, neg)[None, None]
        if self.sliding:
            in_window = (dist >= 0) & (dist < cfg.sliding_window) \
                if cfg.causal else dist.abs() < cfg.sliding_window
            bias = bias + torch.where(in_window, zero, neg)[None, None]
        out = sdpa(q, k, v, bias=bias,
                   scale=cfg.query_pre_attn_scalar ** -0.5)
        return self.o_proj(out.transpose(1, 2).reshape(B, S, H * D))


class GemmaMLP(nn.Module):
    def __init__(self, cfg: GemmaConfig) -> None:
        super().__init__()
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                   bias=False)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                 bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                   bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = F.gelu(self.gate_proj(x), approximate="tanh")
        return self.down_proj(act * self.up_proj(x))


class GemmaDecoderLayer(nn.Module):
    def __init__(self, cfg: GemmaConfig, layer_id: int) -> None:
        super().__init__()
        eps = cfg.rms_norm_eps
        self.input_layernorm = GemmaRMSNorm(cfg.hidden_size, eps)
        self.self_attn = GemmaAttention(cfg, layer_id)
        self.post_attention_layernorm = GemmaRMSNorm(cfg.hidden_size, eps)
        self.pre_feedforward_layernorm = GemmaRMSNorm(cfg.hidden_size, eps)
        self.mlp = GemmaMLP(cfg)
        self.post_feedforward_layernorm = GemmaRMSNorm(cfg.hidden_size, eps)

    def forward(self, x: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        h = self.self_attn(self.input_layernorm(x), attention_mask)
        x = x + self.post_attention_layernorm(h)
        h = self.mlp(self.pre_feedforward_layernorm(x))
        return x + self.post_feedforward_layernorm(h)


class GemmaModel(nn.Module):
    """Embeddings × sqrt(hidden) → decoder layers → final norm."""

    def __init__(self, cfg: GemmaConfig) -> None:
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(GemmaDecoderLayer(cfg, i)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = GemmaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        x = self.embed_tokens(input_ids)
        # the factor is rounded to the model's dtype before the product
        x = x * torch.tensor(self.config.hidden_size ** 0.5, dtype=x.dtype,
                             device=x.device)
        for layer in self.layers:
            x = layer(x, attention_mask)
        return self.norm(x)


class GemmaEmbeddingModel(nn.Module):
    """Trunk → mean pool → bias-free dense bottleneck (``dense_0``,
    ``dense_1``, ... of ``bottleneck_dims``) → L2 normalize in float32:
    unit embeddings [B, bottleneck_dims[-1] or hidden]."""

    def __init__(self, cfg: GemmaConfig,
                 bottleneck_dims: Sequence[int] = ()) -> None:
        super().__init__()
        self.config = cfg
        self.model = GemmaModel(cfg)
        self.bottleneck_dims = tuple(bottleneck_dims)
        width = cfg.hidden_size
        for i, dim in enumerate(self.bottleneck_dims):
            self.add_module(f"dense_{i}", nn.Linear(width, dim, bias=False))
            width = dim

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        hidden = self.model(input_ids, attention_mask)
        pooled = mean_pool(hidden, attention_mask)
        for i in range(len(self.bottleneck_dims)):
            pooled = getattr(self, f"dense_{i}")(pooled)
        out = pooled.float()
        norm = out.norm(dim=-1, keepdim=True).clamp_min(1e-9)
        return (out / norm).to(hidden.dtype)
