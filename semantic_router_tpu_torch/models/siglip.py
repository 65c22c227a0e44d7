"""SigLIP: a shared text/image embedding space.

The port of ``semantic_router_tpu.models.siglip`` (HF ``SiglipModel``
semantics, google/siglip-*): pre-LN ViT towers with tanh-GELU MLPs, the
text tower pooled at its last position and passed through a head dense,
the vision tower pooled by an attention probe (the MAP head), and unit
embeddings whose dot product, scaled and biased, is the SigLIP logit.
Submodules carry the JAX package's names (``text_model.layers.0.
self_attn.q_proj``, ``vision_model.head.attn_q``), so each has its
counterpart by name; ``convert.siglip_params_from_flax`` carries the JAX
tree and ``convert.siglip_state_from_hf`` an HF checkpoint.

- Attention is non-causal with an optional key-padding mask; scores and
  softmax run in float32, masked keys take the finite ``NEG_INF``.  It is
  a plain einsum softmax, as the reference's: no Pallas kernel, so no
  flash-attention launch either.
- The patch embed takes NHWC pixels, as the reference's strided conv
  does.  Its stride equals its kernel, so it is one GEMM over the
  flattened patches with the conv's OIHW weight.
- ``SiglipEmbedder`` serves both towers on its device.  Each (tower,
  batch) runs through an ``engine.graphs.StepGraphs`` step cache:
  captured as a CUDA graph at its first execution on the card and
  replayed after (eager on the CPU, or when a caller asks), as the JAX
  embedder jits per shape.  Texts pad to ``max_position_embeddings``
  with ``pad_id`` and run with no attention mask: the checkpoints were
  trained that way, and the pooled position is the last slot.
- ``decode_image_ref`` reads the wire forms of an OpenAI ``image_url``
  part (base64 or percent-encoded ``data:`` URIs, bare base64) and
  refuses ``http(s)`` URLs; it imports PIL when it is called.
  ``preprocess_image`` resizes by nearest pixel and maps to
  (x - 0.5) / 0.5.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..observability.profiler import TRACE_GATE
from ..utils.device import DeviceLike, resolve_device

NEG_INF = -1e30


@dataclass
class SiglipTowerConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    layer_norm_eps: float = 1e-6
    # text
    vocab_size: int = 32000
    max_position_embeddings: int = 64
    projection_size: int = 768
    # vision
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3

    @classmethod
    def from_hf(cls, hf: Any) -> "SiglipTowerConfig":
        """From an HF tower config (an object or a dict: a SigLIP
        ``config.json``'s ``text_config`` / ``vision_config``)."""
        get = hf.get if isinstance(hf, dict) \
            else (lambda k, d=None: getattr(hf, k, d))
        return cls(
            hidden_size=get("hidden_size"),
            intermediate_size=get("intermediate_size"),
            num_hidden_layers=get("num_hidden_layers"),
            num_attention_heads=get("num_attention_heads"),
            layer_norm_eps=get("layer_norm_eps", 1e-6),
            vocab_size=get("vocab_size", 32000),
            max_position_embeddings=get("max_position_embeddings", 64),
            projection_size=get("projection_size", get("hidden_size")),
            image_size=get("image_size", 224),
            patch_size=get("patch_size", 16),
            num_channels=get("num_channels", 3),
        )


def _heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, S, H] → [B, n, S, H / n]."""
    B, S, H = x.shape
    return x.reshape(B, S, n, H // n).transpose(1, 2)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: Optional[torch.Tensor], dtype: torch.dtype
            ) -> torch.Tensor:
    """Softmax attention over [B, N, S, D] heads in float32; ``mask``
    [B, T] marks the keys that count.  Returns [B, S, N * D]."""
    D = q.shape[-1]
    scores = torch.einsum("bnsd,bntd->bnst", q.float(),
                          k.float()) / math.sqrt(D)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :].bool(), scores,
                             torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnst,bntd->bnsd", probs, v.float()).to(dtype)
    B, N, S, _ = out.shape
    return out.transpose(1, 2).reshape(B, S, N * D)


class SiglipAttention(nn.Module):
    def __init__(self, cfg: SiglipTowerConfig) -> None:
        super().__init__()
        self.config = cfg
        H = cfg.hidden_size
        self.q_proj = nn.Linear(H, H)
        self.k_proj = nn.Linear(H, H)
        self.v_proj = nn.Linear(H, H)
        self.out_proj = nn.Linear(H, H)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        N = self.config.num_attention_heads
        out = _attend(_heads(self.q_proj(x), N), _heads(self.k_proj(x), N),
                      _heads(self.v_proj(x), N), mask, x.dtype)
        return self.out_proj(out)


class SiglipMLP(nn.Module):
    def __init__(self, cfg: SiglipTowerConfig) -> None:
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        # HF's hidden_act is gelu_pytorch_tanh
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        return self.fc2(h)


class SiglipEncoderLayer(nn.Module):
    def __init__(self, cfg: SiglipTowerConfig) -> None:
        super().__init__()
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(H, eps=eps)
        self.self_attn = SiglipAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(H, eps=eps)
        self.mlp = SiglipMLP(cfg)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class SiglipTextTower(nn.Module):
    """Token and position embeddings → encoder → final LayerNorm → the
    LAST position (padding included, as HF pools) → head dense."""

    def __init__(self, cfg: SiglipTowerConfig) -> None:
        super().__init__()
        self.config = cfg
        H = cfg.hidden_size
        self.token_embedding = nn.Embedding(cfg.vocab_size, H)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, H))
        self.layers = nn.ModuleList(SiglipEncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_layer_norm = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.head = nn.Linear(H, cfg.projection_size)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        S = input_ids.shape[1]
        x = self.token_embedding(input_ids) \
            + self.position_embedding[None, :S]
        for layer in self.layers:
            x = layer(x, attention_mask)
        x = self.final_layer_norm(x)
        return self.head(x[:, -1])


class SiglipMAPHead(nn.Module):
    """Multihead attention pooling: a learned probe attends over the
    patches, then out-proj, LayerNorm and a residual MLP."""

    def __init__(self, cfg: SiglipTowerConfig) -> None:
        super().__init__()
        self.config = cfg
        H = cfg.hidden_size
        self.probe = nn.Parameter(torch.zeros(1, 1, H))
        self.attn_q = nn.Linear(H, H)
        self.attn_k = nn.Linear(H, H)
        self.attn_v = nn.Linear(H, H)
        self.attn_out = nn.Linear(H, H)
        self.layernorm = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.mlp = SiglipMLP(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, H = x.shape
        N = self.config.num_attention_heads
        q = self.attn_q(self.probe.to(x.dtype).expand(B, 1, H))
        out = _attend(_heads(q, N), _heads(self.attn_k(x), N),
                      _heads(self.attn_v(x), N), None, x.dtype)
        out = self.attn_out(out)
        out = out + self.mlp(self.layernorm(out))
        return out[:, 0]


class SiglipVisionTower(nn.Module):
    """Patch embed over NHWC pixels + learned positions → encoder →
    post-LayerNorm → MAP pooling."""

    def __init__(self, cfg: SiglipTowerConfig) -> None:
        super().__init__()
        self.config = cfg
        H, P = cfg.hidden_size, cfg.patch_size
        self.patch_embedding = nn.Conv2d(cfg.num_channels, H, P, stride=P)
        self.position_embedding = nn.Parameter(
            torch.zeros((cfg.image_size // P) ** 2, H))
        self.layers = nn.ModuleList(SiglipEncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.post_layernorm = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.head = SiglipMAPHead(cfg)

    def patches(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """The strided, unpadded patch conv as one GEMM: NHWC pixels →
        [B, Hp * Wp, H], patches in row-major order."""
        P = self.config.patch_size
        x = pixel_values.to(self.patch_embedding.weight.dtype)
        B, Hi, Wi, C = x.shape
        Hp, Wp = Hi // P, Wi // P
        flat = x[:, :Hp * P, :Wp * P].reshape(B, Hp, P, Wp, P, C) \
            .permute(0, 1, 3, 5, 2, 4).reshape(B, Hp * Wp, C * P * P)
        w = self.patch_embedding.weight        # [H, C, P, P]
        return F.linear(flat, w.reshape(w.shape[0], -1),
                        self.patch_embedding.bias)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.patches(pixel_values)
        x = x + self.position_embedding[None, :x.shape[1]]
        for layer in self.layers:
            x = layer(x)
        return self.head(self.post_layernorm(x))


class SiglipModel(nn.Module):
    """Both towers; ``embed_text`` / ``embed_image`` return float32 unit
    embeddings in the shared space."""

    def __init__(self, text_config: SiglipTowerConfig,
                 vision_config: SiglipTowerConfig) -> None:
        super().__init__()
        self.text_config = text_config
        self.vision_config = vision_config
        self.text_model = SiglipTextTower(text_config)
        self.vision_model = SiglipVisionTower(vision_config)
        self.logit_scale = nn.Parameter(torch.zeros(()))
        self.logit_bias = nn.Parameter(torch.zeros(()))

    @staticmethod
    def _normalize(x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        return xf / torch.clamp(torch.linalg.vector_norm(
            xf, dim=-1, keepdim=True), min=1e-9)

    def embed_text(self, input_ids: torch.Tensor,
                   attention_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        return self._normalize(self.text_model(input_ids, attention_mask))

    def embed_image(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self._normalize(self.vision_model(pixel_values))

    def forward(self, input_ids: torch.Tensor, pixel_values: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(text embeddings, image embeddings, logits) with
        logits[i, j] = exp(scale) * <image_i, text_j> + bias."""
        t = self.embed_text(input_ids, attention_mask)
        v = self.embed_image(pixel_values)
        logits = (v @ t.T) * torch.exp(self.logit_scale.float()) \
            + self.logit_bias.float()
        return t, v, logits


class SiglipEmbedder:
    """Serves a ``SiglipModel`` on ``device`` (``cuda`` when None; raises
    without a GPU): texts and preprocessed images in, host float32 unit
    rows out.  ``graphs`` is the step cache the towers run through (an
    engine gives the embedder its own, under the engine's capture gate);
    ``last_graph`` says how the last tower step ran."""

    def __init__(self, text_config: SiglipTowerConfig,
                 vision_config: SiglipTowerConfig, model: SiglipModel,
                 tokenizer=None, pad_id: int = 1,
                 device: DeviceLike = None) -> None:
        from ..engine.graphs import CaptureGate, StepGraphs

        self.text_config = text_config
        self.vision_config = vision_config
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.pad_id = pad_id  # SiglipTextConfig.pad_token_id defaults to 1
        self.graphs = StepGraphs(self.device, CaptureGate(), "multimodal")
        self.last_graph = ""

    def _run(self, key: tuple, fn, x: torch.Tensor,
             eager: bool) -> np.ndarray:
        """One tower step on host ``x``: through the step cache, or, with
        ``eager``, op by op under the capture and trace gates."""
        if eager:
            with self.graphs.gate.shared(), TRACE_GATE.shared(), \
                    torch.inference_mode():
                out = fn(x.to(self.device)).float().cpu()
            self.last_graph = "eager"
        else:
            (out,), self.last_graph = self.graphs.run(
                key, lambda t: (fn(t),), [x])
        return out.numpy().astype(np.float32)

    def text_ids(self, texts: Sequence[str]) -> np.ndarray:
        """[n, max_position_embeddings] token ids, padded with ``pad_id``
        (no attention mask goes with them)."""
        if self.tokenizer is None:
            raise ValueError("no tokenizer configured for text embedding")
        S = self.text_config.max_position_embeddings
        ids = np.full((len(texts), S), self.pad_id, np.int64)
        for i, t in enumerate(texts):
            enc = self.tokenizer.encode(t, max_length=S)
            L = min(len(enc.ids), S)
            ids[i, :L] = enc.ids[:L]
        return ids

    def embed_text(self, texts: Sequence[str],
                   eager: bool = False) -> np.ndarray:
        ids = self.text_ids(texts)
        return self._run(("text", len(ids)), self.model.embed_text,
                         torch.from_numpy(ids), eager)

    def embed_image(self, images, eager: bool = False) -> np.ndarray:
        """images: [B, H, W, C] float array (already preprocessed)."""
        px = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        return self._run(("image", px.shape[0]), self.model.embed_image,
                         px, eager)

    def embed_image_refs(self, refs: Sequence[str]) -> np.ndarray:
        """Wire image references (data URIs, base64) → embeddings:
        decode, preprocess to the tower's resolution, embed."""
        imgs = np.stack([
            preprocess_image(decode_image_ref(r),
                             self.vision_config.image_size)
            for r in refs])
        return self.embed_image(imgs)


def decode_image_ref(ref: str) -> np.ndarray:
    """A wire image reference → a uint8 HWC array.

    Takes ``data:image/<fmt>;base64,<payload>`` URIs, non-base64
    ``data:`` URIs (percent-encoded bytes, RFC 2397) and bare base64.
    Remote ``http(s)`` URLs are refused: fetching a client-named URL from
    the routing path would be a server-side request forgery."""
    import base64
    import io

    if ref.startswith("http://") or ref.startswith("https://"):
        raise ValueError("remote image URLs are not fetched by the "
                         "router; send a data: URI")
    if ref.startswith("data:"):
        head, sep, payload = ref.partition(",")
        if not sep:
            raise ValueError("malformed data: URI (no comma before the "
                             "payload)")
        if "base64" in head:
            raw = base64.b64decode(payload, validate=False)
        else:
            from urllib.parse import unquote_to_bytes

            raw = unquote_to_bytes(payload)
    else:
        raw = base64.b64decode(ref, validate=False)
    from PIL import Image

    with Image.open(io.BytesIO(raw)) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def preprocess_image(img: np.ndarray, image_size: int,
                     mean: float = 0.5, std: float = 0.5) -> np.ndarray:
    """uint8 HWC image → float HWC at the tower's resolution: rescaled to
    [0, 1], then (x - mean) / std, resized by nearest pixel."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    ys = (np.arange(image_size) * (h / image_size)).astype(np.int64)
    xs = (np.arange(image_size) * (w / image_size)).astype(np.int64)
    resized = img[np.clip(ys, 0, h - 1)][:, np.clip(xs, 0, w - 1)]
    out = resized.astype(np.float32) / 255.0
    return (out - mean) / std
