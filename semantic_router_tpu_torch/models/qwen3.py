"""Qwen3 decoder: the full-forward causal LM and the embedding model.

The port of ``semantic_router_tpu.models.qwen3`` (Qwen3Config, RMSNorm,
GQA attention with per-head q/k RMSNorm and RoPE, SwiGLU MLP, a tied or
separate LM head).  Submodules carry HF's names (``model.layers.0.
self_attn.q_proj.weight``, ...), so an HF Qwen3 state dict loads as it
is.  ``Qwen3ForCausalLM`` recomputes every position on every call: it is
the oracle the KV-cached decoder (``models.generate``) is held against.
``Qwen3EmbeddingModel`` is the Qwen3-Embedding recipe: the trunk, the
hidden state of the last real token (``last_token_pool``), L2-normalized
in float32; Matryoshka truncation happens after it
(``ops/matryoshka.py``), so one forward serves every output width.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.attention import NEG_INF, sdpa
from ..ops.rope import RopeSpec, apply_rotary


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    vocab_size: int = 151936
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    attention_bias: bool = False
    tie_word_embeddings: bool = True
    rope_scaling: Optional[dict] = None

    @classmethod
    def from_hf(cls, hf: Any) -> "Qwen3Config":
        """From an HF config: a ``config.json`` dict or an object with
        its fields as attributes."""
        if isinstance(hf, Mapping):
            g = lambda k, d=None: hf.get(k, d)
        else:
            g = lambda k, d=None: getattr(hf, k, d)
        return cls(
            vocab_size=g("vocab_size"),
            hidden_size=g("hidden_size"),
            intermediate_size=g("intermediate_size"),
            num_hidden_layers=g("num_hidden_layers"),
            num_attention_heads=g("num_attention_heads"),
            num_key_value_heads=g("num_key_value_heads"),
            head_dim=g("head_dim")
            or g("hidden_size") // g("num_attention_heads"),
            rms_norm_eps=g("rms_norm_eps", 1e-6),
            rope_theta=g("rope_theta", 1e6),
            attention_bias=g("attention_bias", False),
            tie_word_embeddings=g("tie_word_embeddings", True),
            rope_scaling=g("rope_scaling", None),
        )

    def rope(self) -> RopeSpec:
        """The RoPE spec: YaRN when ``rope_scaling`` names it."""
        rs = self.rope_scaling
        yarn = dict(rs) if rs and rs.get("rope_type", rs.get("type")) \
            == "yarn" else None
        return RopeSpec(self.head_dim, self.rope_theta, yarn=yarn)


class RMSNorm(nn.Module):
    """x · rsqrt(mean(x²) + eps) · weight, computed in float32."""

    def __init__(self, dim: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps)
                * self.weight.float()).to(x.dtype)


class Qwen3Attention(nn.Module):
    def __init__(self, cfg: Qwen3Config, rope: RopeSpec) -> None:
        super().__init__()
        self.config = cfg
        self.rope = rope
        H, KV, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                    cfg.head_dim)
        bias = cfg.attention_bias
        self.q_proj = nn.Linear(cfg.hidden_size, H * D, bias=bias)
        self.k_proj = nn.Linear(cfg.hidden_size, KV * D, bias=bias)
        self.v_proj = nn.Linear(cfg.hidden_size, KV * D, bias=bias)
        self.o_proj = nn.Linear(H * D, cfg.hidden_size, bias=bias)
        self.q_norm = RMSNorm(D, cfg.rms_norm_eps)
        self.k_norm = RMSNorm(D, cfg.rms_norm_eps)

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
        causal = torch.triu(torch.full((S, S), NEG_INF, device=x.device),
                            diagonal=1)
        out = sdpa(q, k, v, bias=bias + causal[None, None])
        return self.o_proj(out.transpose(1, 2).reshape(B, S, H * D))


class Qwen3MLP(nn.Module):
    def __init__(self, cfg: Qwen3Config) -> None:
        super().__init__()
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                   bias=False)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                 bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                   bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Qwen3DecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen3Config, rope: RopeSpec) -> None:
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = Qwen3Attention(cfg, rope)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.mlp = Qwen3MLP(cfg)

    def forward(self, x: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), attention_mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class Qwen3Model(nn.Module):
    """Decoder trunk → final-norm hidden states."""

    def __init__(self, cfg: Qwen3Config) -> None:
        super().__init__()
        self.config = cfg
        rope = cfg.rope()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(Qwen3DecoderLayer(cfg, rope)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, attention_mask)
        return self.norm(x)


def last_token_pool(hidden: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
    """The hidden state at each row's last real (unpadded) token:
    [B, S, D] × [B, S] → [B, D] (a row with no real token gives
    position 0)."""
    idx = (attention_mask.sum(dim=1) - 1).clamp_min(0).long()
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]


class Qwen3EmbeddingModel(nn.Module):
    """Trunk → last-token pool → L2 normalize (float32, then the trunk's
    dtype): unit embeddings [B, hidden]."""

    def __init__(self, cfg: Qwen3Config) -> None:
        super().__init__()
        self.config = cfg
        self.model = Qwen3Model(cfg)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        hidden = self.model(input_ids, attention_mask)
        pooled = last_token_pool(hidden, attention_mask).float()
        norm = pooled.norm(dim=-1, keepdim=True).clamp_min(1e-9)
        return (pooled / norm).to(hidden.dtype)


class Qwen3ForCausalLM(nn.Module):
    """Trunk + LM head (tied to the embeddings unless the config says
    otherwise): logits [B, S, vocab] at every position."""

    def __init__(self, cfg: Qwen3Config) -> None:
        super().__init__()
        self.config = cfg
        self.model = Qwen3Model(cfg)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias=False)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        hidden = self.model(input_ids, attention_mask)
        if self.config.tie_word_embeddings:
            return hidden @ self.model.embed_tokens.weight.T
        return self.lm_head(hidden)
