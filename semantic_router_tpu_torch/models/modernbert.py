"""ModernBERT encoder family in PyTorch.

The port of ``semantic_router_tpu.models.modernbert``.  Parameter names
are HuggingFace's (``embeddings.tok_embeddings.weight``,
``layers.{i}.attn.Wqkv.weight``, ``head.dense.weight``, ...), so an HF
ModernBERT state dict loads 1:1.  Architecture:

- token embeddings + LayerNorm (no bias, eps 1e-5; positions via RoPE);
- pre-LN layers; layer 0's attention norm is the identity;
- fused Wqkv reshaped as (B, S, 3, H, D); every
  ``global_attn_every_n_layers``-th layer attends globally with
  ``global_rope_theta`` (YaRN when ``rope_scaling`` says so), the others
  within a sliding window of ``local_attention`` with ``local_rope_theta``;
- GeGLU MLP, final LayerNorm; classification heads: dense → act → norm →
  linear.

``attention_impl``: ``dense`` (SDPA + biases), ``chunked`` (query-block
streaming) or ``flash`` (the hand-written CUDA kernel on the GPU,
ops.flash_attention).

``position_ids`` / ``segment_ids`` ([B, S]) select the sequence-packed
forward (engine.packing): several prompts share each row, RoPE rotates by
segment-local position (the cos / sin tables gathered by position id) and
attention is block-diagonal over segments (``block_diagonal_bias``, plus
``packed_window_bias`` on the local layers), so each segment computes
what it would alone in a padded row.  Only ``dense`` attention packs; any
other impl raises.  The two biases are built once per forward and shared
by the layers.

``dtype`` is the compute dtype, with Flax's semantics: parameters stay
float32 and are cast per op (dense inputs, kernels and biases to
``dtype``; the embedding lookup cast to ``dtype``), LayerNorm statistics
and normalization run in float32 with the output cast to ``dtype``, RoPE
rotates in float32 and attention's softmax is float32 whatever the
input.  ``dense_factory(in_features, out_features, bias)`` builds every
trunk projection (Wqkv, Wo, Wi): the seam the int8 serving trunk
(models.quant) and the LoRA trunks (models.lora: ``LoRADense``
projections) use.  ``task_index`` threads through every projection as
the JAX ``_make_dense`` threads it: a one-element int64 tensor on the
device that a ``LoRADense`` reads by a gather (so switching adapters
changes no shape and no captured step); ``Dense`` and ``QuantDense``
take it and ignore it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (
    block_diagonal_bias,
    chunked_sdpa,
    cls_pool,
    mean_pool,
    packed_window_bias,
    padding_bias,
    sdpa,
    sliding_window_bias,
)
from ..ops.epilogue import activation
from ..ops.rope import RopeSpec, apply_rotary

ATTENTION_IMPLS = ("dense", "chunked", "flash")


@dataclasses.dataclass(frozen=True)
class ModernBertConfig:
    vocab_size: int = 50368
    hidden_size: int = 768
    intermediate_size: int = 1152
    num_hidden_layers: int = 22
    num_attention_heads: int = 12
    max_position_embeddings: int = 8192
    norm_eps: float = 1e-5
    norm_bias: bool = False
    pad_token_id: int = 50283
    global_rope_theta: float = 160000.0
    local_rope_theta: Optional[float] = 10000.0
    global_attn_every_n_layers: int = 3
    local_attention: int = 128  # full window width
    attention_bias: bool = False
    mlp_bias: bool = False
    hidden_activation: str = "gelu"
    classifier_pooling: str = "cls"  # cls | mean
    classifier_bias: bool = False
    classifier_activation: str = "gelu"
    num_labels: int = 2
    rope_scaling: Optional[Dict[str, Any]] = None  # {"rope_type": "yarn", ...}
    attention_impl: str = "dense"  # dense | chunked | flash
    chunk_block_size: int = 512
    dtype: torch.dtype = torch.float32  # compute dtype

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def is_global_layer(self, layer_id: int) -> bool:
        return layer_id % self.global_attn_every_n_layers == 0

    @classmethod
    def from_hf(cls, hf_config, **overrides) -> "ModernBertConfig":
        """Build from an HF ModernBERT config: an object with attributes
        (``transformers.ModernBertConfig``) or a ``config.json`` dict."""
        def g(key, default=None):
            if isinstance(hf_config, dict):
                return hf_config.get(key, default)
            return getattr(hf_config, key, default)

        kw = dict(
            vocab_size=g("vocab_size"),
            hidden_size=g("hidden_size"),
            intermediate_size=g("intermediate_size"),
            num_hidden_layers=g("num_hidden_layers"),
            num_attention_heads=g("num_attention_heads"),
            max_position_embeddings=g("max_position_embeddings", 8192),
            norm_eps=g("norm_eps", 1e-5),
            norm_bias=g("norm_bias", False),
            pad_token_id=g("pad_token_id", 0),
            global_rope_theta=g("global_rope_theta", 160000.0),
            local_rope_theta=g("local_rope_theta", 10000.0),
            global_attn_every_n_layers=g("global_attn_every_n_layers", 3),
            local_attention=g("local_attention", 128),
            attention_bias=g("attention_bias", False),
            mlp_bias=g("mlp_bias", False),
            hidden_activation=g("hidden_activation", "gelu"),
            classifier_pooling=g("classifier_pooling", "cls"),
            classifier_bias=g("classifier_bias", False),
            classifier_activation=g("classifier_activation", "gelu"),
            num_labels=len(g("id2label") or {}) or 2,
            rope_scaling=g("rope_scaling", None),
        )
        kw.update(overrides)
        return cls(**kw)


def _yarn_dict(cfg: ModernBertConfig) -> Optional[dict]:
    rs = cfg.rope_scaling
    if rs and rs.get("rope_type", rs.get("type")) == "yarn":
        return dict(rs)
    return None


class LayerNorm(nn.LayerNorm):
    """LayerNorm with a compute dtype: below float32 the input is
    normalized in float32 (statistics and affine) and the output cast to
    ``compute_dtype``."""

    def __init__(self, cfg: ModernBertConfig) -> None:
        super().__init__(cfg.hidden_size, eps=cfg.norm_eps, bias=cfg.norm_bias)
        self.compute_dtype = cfg.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


class Dense(nn.Linear):
    """Linear with a compute dtype: below float32 the input, weight and
    bias are cast to ``compute_dtype`` for the product."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor,
                task_index: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``task_index``: taken and ignored (the trunk's projection
        seam passes it to every dense)."""
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


def _dense_factory(cfg: ModernBertConfig, dense_factory=None):
    if dense_factory is not None:
        return dense_factory
    return lambda d_in, d_out, bias: Dense(d_in, d_out, bias, cfg.dtype)


class ModernBertEmbeddings(nn.Module):
    def __init__(self, cfg: ModernBertConfig) -> None:
        super().__init__()
        self.tok_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.norm = LayerNorm(cfg)
        self.compute_dtype = cfg.dtype

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.norm(self.tok_embeddings(input_ids)
                         .to(self.compute_dtype))


class ModernBertMLP(nn.Module):
    """GeGLU: Wi → split(input, gate) → act(input) * gate → Wo."""

    def __init__(self, cfg: ModernBertConfig, dense_factory=None) -> None:
        super().__init__()
        dense = _dense_factory(cfg, dense_factory)
        self.Wi = dense(cfg.hidden_size, 2 * cfg.intermediate_size,
                        cfg.mlp_bias)
        self.Wo = dense(cfg.intermediate_size, cfg.hidden_size, cfg.mlp_bias)
        self.act = activation(cfg.hidden_activation)

    def forward(self, x: torch.Tensor,
                task_index: Optional[torch.Tensor] = None) -> torch.Tensor:
        inp, gate = self.Wi(x, task_index).chunk(2, dim=-1)
        return self.Wo(self.act(inp) * gate, task_index)


class ModernBertAttention(nn.Module):
    def __init__(self, cfg: ModernBertConfig, layer_id: int,
                 dense_factory=None) -> None:
        super().__init__()
        if cfg.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {cfg.attention_impl!r} not in "
                             f"{ATTENTION_IMPLS}")
        self.cfg = cfg
        dense = _dense_factory(cfg, dense_factory)
        self.Wqkv = dense(cfg.hidden_size, 3 * cfg.hidden_size,
                          cfg.attention_bias)
        self.Wo = dense(cfg.hidden_size, cfg.hidden_size, cfg.attention_bias)
        D = cfg.head_dim
        if cfg.is_global_layer(layer_id):
            self.rope = RopeSpec(D, cfg.global_rope_theta,
                                 yarn=_yarn_dict(cfg))
            self.window = 0
        else:
            theta = (cfg.local_rope_theta if cfg.local_rope_theta is not None
                     else cfg.global_rope_theta)
            self.rope = RopeSpec(D, theta)
            self.window = cfg.local_attention

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor,
                task_index: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                packed_biases: Optional[Dict[int, torch.Tensor]] = None
                ) -> torch.Tensor:
        """``packed_biases``: {window: bias} the model built once for the
        packed forward (built here from the planes when None)."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, D = cfg.num_attention_heads, cfg.head_dim
        qkv = self.Wqkv(x, task_index).view(B, S, 3, H, D)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))  # [B, H, S, D]
        cos, sin = self.rope.tables(S, x.device)
        if position_ids is not None:
            # RoPE by segment-local position: the same float32 tables,
            # gathered per token ([B, 1, S, D])
            pos = position_ids.long()
            cos, sin = cos[pos][:, None], sin[pos][:, None]
        q, k = apply_rotary(q, k, cos, sin)
        if segment_ids is not None:
            if packed_biases is None:
                packed_biases = packed_attention_biases(cfg, position_ids,
                                                        segment_ids)
            out = sdpa(q, k, v, bias=packed_biases[self.window])
        elif cfg.attention_impl == "flash":
            from ..ops.flash_attention import flash_attention

            out = flash_attention(q, k, v, key_padding_mask=attention_mask,
                                  window=self.window)
        elif cfg.attention_impl == "chunked":
            out = chunked_sdpa(q, k, v, key_padding_mask=attention_mask,
                               window=self.window,
                               block_size=cfg.chunk_block_size)
        else:
            bias = padding_bias(attention_mask)
            if self.window > 0:
                bias = bias + sliding_window_bias(S, self.window,
                                                  device=x.device)
            out = sdpa(q, k, v, bias=bias)
        out = out.transpose(1, 2).reshape(B, S, cfg.hidden_size)
        return self.Wo(out, task_index)


class ModernBertEncoderLayer(nn.Module):
    def __init__(self, cfg: ModernBertConfig, layer_id: int,
                 dense_factory=None) -> None:
        super().__init__()
        # layer 0: identity — the embedding norm already applied
        self.attn_norm = nn.Identity() if layer_id == 0 else LayerNorm(cfg)
        self.attn = ModernBertAttention(cfg, layer_id, dense_factory)
        self.mlp_norm = LayerNorm(cfg)
        self.mlp = ModernBertMLP(cfg, dense_factory)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor,
                task_index: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                packed_biases: Optional[Dict[int, torch.Tensor]] = None
                ) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), attention_mask, task_index,
                          position_ids, segment_ids, packed_biases)
        return x + self.mlp(self.mlp_norm(x), task_index)


def packed_attention_biases(cfg: ModernBertConfig,
                            position_ids: Optional[torch.Tensor],
                            segment_ids: torch.Tensor
                            ) -> Dict[int, torch.Tensor]:
    """{window: additive bias} of a packed forward: 0 (global layers) →
    ``block_diagonal_bias``; ``local_attention`` → that plus
    ``packed_window_bias`` on segment-local positions.  Raises under any
    ``attention_impl`` but ``dense``, as the reference does."""
    if cfg.attention_impl != "dense":
        raise ValueError(f"sequence packing requires attention_impl='dense' "
                         f"(got {cfg.attention_impl!r})")
    if position_ids is None:
        raise ValueError("sequence packing needs position_ids with "
                         "segment_ids")
    block = block_diagonal_bias(segment_ids)
    biases = {0: block}
    if cfg.local_attention > 0:
        biases[cfg.local_attention] = block + packed_window_bias(
            position_ids, cfg.local_attention)
    return biases


class ModernBertModel(nn.Module):
    """Encoder trunk → final-norm hidden states [B, S, hidden] in the
    compute dtype."""

    def __init__(self, cfg: ModernBertConfig, dense_factory=None) -> None:
        super().__init__()
        self.config = cfg
        self.embeddings = ModernBertEmbeddings(cfg)
        self.layers = nn.ModuleList(
            ModernBertEncoderLayer(cfg, i, dense_factory)
            for i in range(cfg.num_hidden_layers))
        self.final_norm = LayerNorm(cfg)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                exit_layer: Optional[int] = None,
                task_index: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``exit_layer``: the Matryoshka layer early exit — only the first
        ``exit_layer`` layers run, and the final norm applies to the last
        of them (None runs every layer).  ``task_index``: the adapter a
        LoRA trunk's projections select (None: adapter 0, as the JAX
        ``_make_dense`` has it); plain and quantized trunks ignore it.
        ``position_ids`` / ``segment_ids``: the packed forward (module
        docstring); its attention biases are built here, once."""
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        biases = None
        if segment_ids is not None:
            biases = packed_attention_biases(self.config, position_ids,
                                             segment_ids)
        x = self.embeddings(input_ids)
        for layer in self.layers[:self.layers_run(exit_layer)]:
            x = layer(x, attention_mask, task_index, position_ids,
                      segment_ids, biases)
        return self.final_norm(x)

    def layers_run(self, exit_layer: Optional[int] = None) -> int:
        """How many layers a forward at ``exit_layer`` runs."""
        n = len(self.layers)
        return n if exit_layer is None else max(0, min(int(exit_layer), n))


class ModernBertPredictionHead(nn.Module):
    def __init__(self, cfg: ModernBertConfig) -> None:
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size,
                           cfg.classifier_bias, cfg.dtype)
        self.act = activation(cfg.classifier_activation)
        self.norm = LayerNorm(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.act(self.dense(x)))


class ModernBertForSequenceClassification(nn.Module):
    """Sequence classifier (intent/domain, jailbreak, fact-check, ...)."""

    def __init__(self, cfg: ModernBertConfig,
                 model: Optional[ModernBertModel] = None) -> None:
        """``model``: an existing trunk to share (the fused classifier
        bank groups tasks whose trunk is one object)."""
        super().__init__()
        self.config = cfg
        self.model = model if model is not None else ModernBertModel(cfg)
        self.head = ModernBertPredictionHead(cfg)
        self.classifier = Dense(cfg.hidden_size, cfg.num_labels, True,
                                cfg.dtype)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        hidden = self.model(input_ids, attention_mask)
        pooled = mean_pool(hidden, attention_mask) \
            if self.config.classifier_pooling == "mean" else cls_pool(hidden)
        return self.classifier(self.head(pooled))


class ModernBertForTokenClassification(nn.Module):
    """Token classifier (PII spans): per-token logits [B, S, num_labels]."""

    def __init__(self, cfg: ModernBertConfig,
                 model: Optional[ModernBertModel] = None) -> None:
        super().__init__()
        self.config = cfg
        self.model = model if model is not None else ModernBertModel(cfg)
        self.head = ModernBertPredictionHead(cfg)
        self.classifier = Dense(cfg.hidden_size, cfg.num_labels, True,
                                cfg.dtype)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        hidden = self.model(input_ids, attention_mask)
        return self.classifier(self.head(hidden))
