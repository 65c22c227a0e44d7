"""DeBERTa-v3: disentangled attention with log-bucketed relative positions.

The port of ``semantic_router_tpu.models.deberta`` (HF ``DebertaV2``
semantics, microsoft/deberta-v3-*): c2c + c2p + p2c attention, shared
attention keys, layer-normed relative embeddings, no absolute position
bias by default.  Submodules carry HF's names, so an HF state dict loads
as it is; ``convert.deberta_params_from_flax`` carries the JAX tree.

- The relative-position bucket table is host numpy, computed exactly as
  the JAX package computes it (the buckets are bit-equal), and moved to
  the model's device once per (sequence length, device): the per-task
  step's first, eager run makes it, so a captured step reads a device
  tensor that already exists.
- The c2p / p2c gathers are ``torch.gather`` over the bucket axis of
  [B, N, S, 2K] scores.
- Scores and softmax run in float32; masked pairs take the finite
  ``NEG_INF``, so a padded query row (every key masked) stays NaN-free.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

NEG_INF = -1e30


@dataclass
class DebertaV3Config:
    vocab_size: int = 128100
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 512
    relative_attention: bool = True
    position_buckets: int = 256
    max_relative_positions: int = -1
    pos_att_type: Tuple[str, ...] = ("p2c", "c2p")
    share_att_key: bool = True
    norm_rel_ebd: str = "layer_norm"
    position_biased_input: bool = False
    layer_norm_eps: float = 1e-7
    pooler_hidden_act: str = "gelu"
    num_labels: int = 2

    @property
    def max_rel(self) -> int:
        return self.max_relative_positions \
            if self.max_relative_positions > 0 \
            else self.max_position_embeddings

    @property
    def att_span(self) -> int:
        return self.position_buckets if self.position_buckets > 0 \
            else self.max_rel

    @classmethod
    def from_hf(cls, hf: Any) -> "DebertaV3Config":
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
            max_position_embeddings=g("max_position_embeddings", 512),
            relative_attention=g("relative_attention", False),
            position_buckets=g("position_buckets", -1),
            max_relative_positions=g("max_relative_positions", -1),
            pos_att_type=tuple(g("pos_att_type") or ()),
            share_att_key=g("share_att_key", False),
            norm_rel_ebd=g("norm_rel_ebd", "none"),
            position_biased_input=g("position_biased_input", True),
            layer_norm_eps=g("layer_norm_eps", 1e-7),
            pooler_hidden_act=g("pooler_hidden_act", "gelu"),
            num_labels=len(g("id2label", {}) or {}) or 2,
        )


def make_log_bucket_position(rel_pos: np.ndarray, bucket_size: int,
                             max_position: int) -> np.ndarray:
    """Log-bucketed relative positions (modeling_deberta_v2.py:58): exact
    inside ±bucket/2, logarithmic buckets outside."""
    sign = np.sign(rel_pos)
    mid = bucket_size // 2
    abs_pos = np.where((rel_pos < mid) & (rel_pos > -mid),
                       mid - 1, np.abs(rel_pos))
    with np.errstate(divide="ignore", invalid="ignore"):
        log_pos = np.ceil(
            np.log(abs_pos / mid)
            / np.log((max_position - 1) / mid) * (mid - 1)) + mid
    return np.where(abs_pos <= mid, rel_pos.astype(np.float64),
                    log_pos * sign).astype(np.int64)


def build_relative_position(seq_len: int, bucket_size: int = -1,
                            max_position: int = -1) -> np.ndarray:
    """[S, S] relative position ids q_pos - k_pos, bucketed when
    configured.  Host numpy: a constant per length."""
    ids = np.arange(seq_len, dtype=np.int64)
    rel = ids[:, None] - ids[None, :]
    if bucket_size > 0 and max_position > 0:
        rel = make_log_bucket_position(rel, bucket_size, max_position)
    return rel


class DisentangledSelfAttention(nn.Module):
    """c2c + c2p + p2c attention (modeling_deberta_v2.py:141 semantics)."""

    def __init__(self, cfg: DebertaV3Config) -> None:
        super().__init__()
        self.config = cfg
        H = cfg.hidden_size
        self.query_proj = nn.Linear(H, H)
        self.key_proj = nn.Linear(H, H)
        self.value_proj = nn.Linear(H, H)
        if cfg.relative_attention and not cfg.share_att_key:
            if "c2p" in cfg.pos_att_type:
                self.pos_key_proj = nn.Linear(H, H)
            if "p2c" in cfg.pos_att_type:
                self.pos_query_proj = nn.Linear(H, H, bias=False)

    def forward(self, x: torch.Tensor, ext_mask: torch.Tensor,
                rel_embeddings: Optional[torch.Tensor],
                rel_pos: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.config
        B, S, _ = x.shape
        N = cfg.num_attention_heads
        D = cfg.hidden_size // N

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(B, S, N, D).transpose(1, 2)

        q = heads(self.query_proj(x)).float()
        k = heads(self.key_proj(x)).float()
        v = heads(self.value_proj(x)).float()
        scale_factor = 1 + ("c2p" in cfg.pos_att_type) \
            + ("p2c" in cfg.pos_att_type)
        scale = math.sqrt(D * scale_factor)
        scores = torch.matmul(q, k.transpose(-1, -2)) / scale

        if cfg.relative_attention and rel_embeddings is not None:
            K = cfg.att_span
            rel_emb = rel_embeddings[:K * 2].to(x.dtype)      # [2K, H]
            if cfg.share_att_key:
                pos_key = self.key_proj(rel_emb)
                pos_query = self.query_proj(rel_emb)
            else:
                pos_key = self.pos_key_proj(rel_emb) \
                    if "c2p" in cfg.pos_att_type else None
                pos_query = self.pos_query_proj(rel_emb) \
                    if "p2c" in cfg.pos_att_type else None
            if "c2p" in cfg.pos_att_type:
                pk = pos_key.reshape(2 * K, N, D).transpose(0, 1).float()
                c2p = torch.matmul(q, pk.transpose(-1, -2))    # [B,N,S,2K]
                idx = torch.clamp(rel_pos + K, 0, 2 * K - 1)
                scores = scores + torch.gather(
                    c2p, -1, idx.expand(B, N, S, S)) / scale
            if "p2c" in cfg.pos_att_type:
                pq = pos_query.reshape(2 * K, N, D).transpose(0, 1).float()
                p2c = torch.matmul(k, pq.transpose(-1, -2))    # [B,N,S,2K]
                idx = torch.clamp(-rel_pos + K, 0, 2 * K - 1)
                gathered = torch.gather(p2c, -1, idx.expand(B, N, S, S))
                scores = scores + gathered.transpose(-1, -2) / scale

        scores = scores.masked_fill(~ext_mask, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.matmul(probs, v).to(x.dtype)
        return out.transpose(1, 2).reshape(B, S, N * D)


class _SelfOutput(nn.Module):
    def __init__(self, cfg: DebertaV3Config, n_in: int) -> None:
        super().__init__()
        self.dense = nn.Linear(n_in, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size,
                                      eps=cfg.layer_norm_eps)

    def forward(self, hidden, residual):
        return self.LayerNorm(self.dense(hidden) + residual)


class _Attention(nn.Module):
    def __init__(self, cfg: DebertaV3Config) -> None:
        super().__init__()
        self.self = DisentangledSelfAttention(cfg)
        self.output = _SelfOutput(cfg, cfg.hidden_size)


class _Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int) -> None:
        super().__init__()
        self.dense = nn.Linear(n_in, n_out)


class DebertaLayer(nn.Module):
    def __init__(self, cfg: DebertaV3Config) -> None:
        super().__init__()
        self.attention = _Attention(cfg)
        self.intermediate = _Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = _SelfOutput(cfg, cfg.intermediate_size)

    def forward(self, x, ext_mask, rel_embeddings, rel_pos):
        attn = self.attention.self(x, ext_mask, rel_embeddings, rel_pos)
        x = self.attention.output(attn, x)
        inter = F.gelu(self.intermediate.dense(x).float()).to(x.dtype)
        return self.output(inter, x)


class _Embeddings(nn.Module):
    def __init__(self, cfg: DebertaV3Config) -> None:
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        if cfg.position_biased_input:
            self.position_embeddings = nn.Embedding(
                cfg.max_position_embeddings, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class _Encoder(nn.Module):
    def __init__(self, cfg: DebertaV3Config) -> None:
        super().__init__()
        self.layer = nn.ModuleList(DebertaLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))
        if cfg.relative_attention:
            self.rel_embeddings = nn.Embedding(cfg.att_span * 2,
                                               cfg.hidden_size)
            if "layer_norm" in cfg.norm_rel_ebd:
                self.LayerNorm = nn.LayerNorm(cfg.hidden_size,
                                              eps=cfg.layer_norm_eps)


class DebertaV3Model(nn.Module):
    """Embeddings + relative-attention encoder → hidden states."""

    def __init__(self, cfg: DebertaV3Config) -> None:
        super().__init__()
        self.config = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self._rel_pos: Dict[tuple, torch.Tensor] = {}
        self._rel_lock = threading.Lock()

    def relative_positions(self, seq_len: int,
                           device: torch.device) -> torch.Tensor:
        """The [S, S] bucket ids on ``device``, made once per (S, device)
        and kept: a captured step reads this tensor's address."""
        key = (int(seq_len), str(device))
        hit = self._rel_pos.get(key)
        if hit is None:
            cfg = self.config
            hit = torch.from_numpy(build_relative_position(
                seq_len, cfg.position_buckets, cfg.max_rel)).to(device)
            with self._rel_lock:
                hit = self._rel_pos.setdefault(key, hit)
        return hit

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        cfg = self.config
        B, S = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        emb = self.embeddings
        x = emb.word_embeddings(input_ids)
        if cfg.position_biased_input:
            x = x + emb.position_embeddings.weight[None, :S]
        x = emb.LayerNorm(x)
        # HF zeroes padded embeddings before the encoder
        x = x * attention_mask[..., None].to(x.dtype)
        m = attention_mask.bool()
        ext_mask = m[:, None, :, None] & m[:, None, None, :]  # [B,1,S,S]
        rel_embeddings = rel_pos = None
        if cfg.relative_attention:
            enc = self.encoder
            rel_embeddings = enc.rel_embeddings.weight
            if "layer_norm" in cfg.norm_rel_ebd:
                rel_embeddings = F.layer_norm(
                    rel_embeddings.float(), (cfg.hidden_size,),
                    enc.LayerNorm.weight.float(), enc.LayerNorm.bias.float(),
                    cfg.layer_norm_eps)
            rel_pos = self.relative_positions(S, input_ids.device)
        for layer in self.encoder.layer:
            x = layer(x, ext_mask, rel_embeddings, rel_pos)
        return x


class _Pooler(nn.Module):
    def __init__(self, cfg: DebertaV3Config) -> None:
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)


class DebertaV3ForSequenceClassification(nn.Module):
    """ContextPooler ([CLS] → dense → act) + classifier
    (DebertaV2ForSequenceClassification semantics)."""

    def __init__(self, cfg: DebertaV3Config) -> None:
        super().__init__()
        self.config = cfg
        self.deberta = DebertaV3Model(cfg)
        self.pooler = _Pooler(cfg)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels)

    def forward(self, input_ids, attention_mask=None):
        hidden = self.deberta(input_ids, attention_mask)
        pooled = self.pooler.dense(hidden[:, 0]).float()
        if self.config.pooler_hidden_act == "gelu":
            # HF ACT2FN["gelu"] is the exact erf form
            pooled = F.gelu(pooled)
        else:
            pooled = torch.tanh(pooled)
        return self.classifier(pooled.to(hidden.dtype))


class DebertaV3ForTokenClassification(nn.Module):
    def __init__(self, cfg: DebertaV3Config) -> None:
        super().__init__()
        self.config = cfg
        self.deberta = DebertaV3Model(cfg)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels)

    def forward(self, input_ids, attention_mask=None):
        return self.classifier(self.deberta(input_ids, attention_mask))
