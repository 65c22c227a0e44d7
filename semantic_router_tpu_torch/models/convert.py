"""Checkpoint conversion into the port's modules.

- HF ModernBERT, DeBERTa-v2/v3 and Qwen3 state dicts load 1:1: the port's
  parameter names are HF's (``hf_state_for`` keeps the keys a module
  has and drops what HF stores beside them: a tied ``lm_head``, buffers).
- ``params_from_flax`` carries weights from the JAX package's Flax trees
  (numpy arrays) into a state dict: Flax ``Dense`` kernels are [in, out],
  torch ``Linear`` weights [out, in]; bare LoRA parameters (``lora_A``,
  ``lora_B``) keep the Flax layout.  It reads ModernBERT trees and the
  Qwen3 trees (``Qwen3ForCausalLM``, ``Qwen3EmbeddingModel``,
  ``Qwen3Decoder`` with its LoRA leaves) and the Gemma trees
  (``GemmaModel``, ``GemmaEmbeddingModel``), whose Flax names follow
  HF's (``lora_params_from_flax`` holds such a tree to the module it
  loads into); ``deberta_params_from_flax`` maps the DeBERTa tree's own names
  (``deberta/layers_i/...``, ``pooler_dense``, ``encoder_LayerNorm``,
  ``rel_embeddings``) onto HF's.
- The LoRA modules (``MultiTaskLoRAClassifier``, the ``LoRAModernBert*``
  classifiers, ``LoRAMmBertEmbeddingModel``) keep the Flax names, so
  ``lora_params_from_flax`` is ``params_from_flax`` held to the module:
  every parameter the module has must come from the tree, and nothing
  else (a task-stacked ``lora_A`` [T, in, r] / ``lora_B`` [T, r, out]
  keeps its layout; the trunk's ``LoRADense`` kernels transpose).
- SigLIP: the port's names are the JAX tree's (``layers_i`` → ``layers.i``),
  so ``siglip_params_from_flax`` only transposes (Dense kernels; the patch
  conv's HWIO kernel → OIHW); ``siglip_state_from_hf`` maps an HF
  ``SiglipModel`` state dict onto them, splitting the MAP head's packed
  ``in_proj_weight`` / ``in_proj_bias`` into ``attn_q`` / ``attn_k`` /
  ``attn_v``, as the JAX package's ``siglip_params_from_state_dict`` does.
- ``read_safetensors`` is a numpy-only reader for machines without the
  ``safetensors`` package: an 8-byte little-endian header length, a JSON
  header {name: {dtype, shape, data_offsets}}, then the raw buffers.
"""

from __future__ import annotations

import json
import re
import struct
from typing import Any, Dict, Mapping

import numpy as np
import torch

_LAYER_RE = re.compile(r"^layers_(\d+)$")
_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "weight": "weight", "bias": "bias"}
# bare parameters, carried as they are (no transpose): LoRA adapters,
# ``lora_A`` / ``lora_B`` and Flax's suffixed ``lora_A<suffix>``
_RAW_PREFIXES = ("lora_A", "lora_B")


def params_from_flax(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ModernBERT, Qwen3 or Gemma param tree (``{"params": {...}}``
    or the inner tree, for ``ModernBertModel``,
    ``ModernBertFor*Classification``, ``ModernBertLoRAHeadClassifier``,
    ``Qwen3ForCausalLM``, ``Qwen3EmbeddingModel``, ``Qwen3Decoder``,
    ``GemmaModel`` or ``GemmaEmbeddingModel``) → a torch state dict with HF
    names (the LoRA head's own names: ``head_dense``, ``lora_A``, ...)."""
    tree = flax_params.get("params", flax_params)
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], path: list) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                m = _LAYER_RE.match(key)
                walk(val, path + ([f"layers.{m.group(1)}"] if m else [key]))
                continue
            if key not in _LEAF and not key.startswith(_RAW_PREFIXES):
                raise KeyError(f"unknown Flax leaf {'/'.join(path + [key])}")
            t = _host(val)
            out[".".join(path + [_LEAF.get(key, key)])] = \
                t.T.contiguous() if key == "kernel" else t

    walk(tree, [])
    return out


def lora_params_from_flax(module: torch.nn.Module,
                          flax_params: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """A Flax module's params (numpy) → ``module``'s state dict:
    ``params_from_flax`` checked against the module — a parameter the
    tree lacks, a leaf the module lacks, or a shape that differs raises,
    naming it.  The embedding models' trees (``Qwen3EmbeddingModel``
    and ``GemmaEmbeddingModel``, their trunk under ``model``, Gemma's
    bottleneck ``dense_i``; a bare ``GemmaModel``) carry the port's
    names, so this is their converter."""
    state = params_from_flax(flax_params)
    want = {k: v.shape for k, v in module.state_dict().items()}
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    if missing or extra:
        raise KeyError(f"Flax tree does not fit {type(module).__name__}: "
                       f"missing {missing[:8]}, unknown {extra[:8]}")
    bad = [k for k, v in state.items() if tuple(v.shape) != tuple(want[k])]
    if bad:
        raise ValueError(f"shape mismatch for {bad[:8]}")
    return state


def flax_adapter_key(name: str) -> str:
    """A port parameter name → the key the JAX package's ``save_adapters``
    writes for the same leaf: the ``/``-joined Flax path under ``params``
    (``model.layers.0.attn.Wqkv.lora_A`` →
    ``params/model/layers_0/attn/Wqkv/lora_A``)."""
    parts = name.split(".")
    out = []
    i = 0
    while i < len(parts):
        if parts[i] == "layers" and i + 1 < len(parts) \
                and parts[i + 1].isdigit():
            out.append(f"layers_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return "/".join(["params"] + out)


def port_adapter_name(key: str) -> str:
    """The inverse of ``flax_adapter_key``: an adapter file's key (with or
    without its leading ``params/``) → the port's parameter name."""
    parts = key.split("/")
    if parts and parts[0] == "params":
        parts = parts[1:]
    out = []
    for part in parts:
        m = _LAYER_RE.match(part)
        out += ["layers", m.group(1)] if m else [part]
    return ".".join(out)


def _host(val) -> torch.Tensor:
    arr = np.array(val)  # a writable host copy
    if arr.dtype.kind == "V":  # bfloat16 (ml_dtypes) → float32
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr))


# DeBERTa: Flax module path → HF module path (after ``deberta/``)
_DEBERTA_NAMES = {
    "word_embeddings": "embeddings.word_embeddings",
    "embeddings_LayerNorm": "embeddings.LayerNorm",
    "encoder_LayerNorm": "encoder.LayerNorm",
    "attention_self": "attention.self",
    "attention_output": "attention.output",
    "intermediate_dense": "intermediate.dense",
    "output_dense": "output.dense",
    "output_LayerNorm": "output.LayerNorm",
    "pooler_dense": "pooler.dense",
}
# DeBERTa's bare parameters → HF names
_DEBERTA_RAW = {"rel_embeddings": "encoder.rel_embeddings.weight",
                "position_embeddings": "embeddings.position_embeddings.weight"}


def deberta_params_from_flax(flax_params: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """Flax DeBERTa tree (``DebertaV3ForSequenceClassification``,
    ``DebertaV3ForTokenClassification`` or a bare ``DebertaV3Model``) →
    a torch state dict with HF names."""
    tree = flax_params.get("params", flax_params)
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], path: list) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                m = _LAYER_RE.match(key)
                name = f"encoder.layer.{m.group(1)}" if m \
                    else _DEBERTA_NAMES.get(key, key)
                walk(val, path + [name])
                continue
            if key in _DEBERTA_RAW:
                out[".".join(path + [_DEBERTA_RAW[key]])] = _host(val)
                continue
            if key not in _LEAF:
                raise KeyError(f"unknown Flax leaf {'/'.join(path + [key])}")
            t = _host(val)
            out[".".join(path + [_LEAF[key]])] = \
                t.T.contiguous() if key == "kernel" else t

    walk(tree, [])
    return out


# SigLIP's bare parameters, carried as they are
_SIGLIP_RAW = frozenset({"position_embedding", "probe", "logit_scale",
                         "logit_bias"})


def siglip_params_from_flax(flax_params: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """Flax ``SiglipModel`` params (numpy) → the port's ``SiglipModel``
    state dict."""
    tree = flax_params.get("params", flax_params)
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], path: list) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                m = _LAYER_RE.match(key)
                walk(val, path + ([f"layers.{m.group(1)}"] if m else [key]))
                continue
            t = _host(val).reshape(np.shape(val))  # keeps a 0-d scale
            if key in _SIGLIP_RAW:
                out[".".join(path + [key])] = t
                continue
            if key not in _LEAF:
                raise KeyError(f"unknown Flax leaf {'/'.join(path + [key])}")
            if key == "kernel":
                # a conv kernel is HWIO (torch: OIHW), a Dense one [in, out]
                t = t.permute(3, 2, 0, 1) if t.ndim == 4 else t.T
                t = t.contiguous()
            out[".".join(path + [_LEAF[key]])] = t

    walk(tree, [])
    return out


def siglip_state_from_hf(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An HF ``SiglipModel`` state dict (tensors or numpy arrays) → the
    port's ``SiglipModel`` state dict.  Buffers (``position_ids``) are
    dropped."""
    src = state_dict_from_hf(state)
    out: Dict[str, torch.Tensor] = {}
    for key, w in src.items():
        parts = key.split(".")
        if parts[0] in ("logit_scale", "logit_bias"):
            out[parts[0]] = w.reshape(())
            continue
        tower, rest = parts[0], parts[1:]
        if rest[0] == "embeddings":
            if rest[1] == "position_ids":
                continue
            if rest[1] == "position_embedding":
                out[f"{tower}.position_embedding"] = w
            else:  # token_embedding.weight, patch_embedding.weight/bias
                out[".".join([tower] + rest[1:])] = w
        elif rest[0] == "encoder":  # encoder.layers.i.* → layers.i.*
            out[".".join([tower] + rest[1:])] = w
        elif tower == "vision_model" and rest[:2] == ["head", "attention"]:
            leaf = rest[2]
            if leaf in ("in_proj_weight", "in_proj_bias"):
                n = w.shape[0] // 3
                kind = "weight" if leaf == "in_proj_weight" else "bias"
                for i, name in enumerate(("attn_q", "attn_k", "attn_v")):
                    out[f"{tower}.head.{name}.{kind}"] = \
                        w[i * n:(i + 1) * n].contiguous()
            else:  # out_proj.weight / out_proj.bias
                out[f"{tower}.head.attn_out.{rest[-1]}"] = w
        else:  # final_layer_norm, post_layernorm, head.*
            out[key] = w
    return out


def hf_state_for(module: torch.nn.Module, state: Mapping[str, Any]
                 ) -> Dict[str, torch.Tensor]:
    """The tensors of an HF state dict that ``module`` has, as torch
    tensors; keys it lacks (a tied ``lm_head``, position-id buffers, a
    masked-LM decoder) are dropped.  A parameter of the module the state
    lacks raises, naming it (LoRA adapter leaves are not an HF
    checkpoint's: ``with_lora_leaves`` adds them)."""
    want = dict(module.state_dict())
    out = {k: v for k, v in state_dict_from_hf(state).items() if k in want}
    missing = [k for k in want if k not in out
               and not k.endswith(("lora_A", "lora_B"))]
    if missing:
        raise ValueError(f"checkpoint lacks {len(missing)} tensors of "
                         f"{type(module).__name__}: {missing[:8]}")
    return out


def state_dict_from_hf(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An HF state dict (tensors or numpy arrays) as torch tensors under
    the port's names — HF's own."""
    return {k: v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(v))
            for k, v in state.items()}


_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file as a numpy array (bf16
    widened to float32)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        out: Dict[str, np.ndarray] = {}
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            start, end = meta["data_offsets"]
            f.seek(base + start)
            buf = f.read(end - start)
            shape = tuple(meta["shape"])
            if meta["dtype"] == "BF16":
                raw = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
                out[name] = raw.view(np.float32).reshape(shape)
            else:
                dt = np.dtype(_ST_DTYPES[meta["dtype"]]).newbyteorder("<")
                out[name] = np.frombuffer(buf, dtype=dt).reshape(shape).copy()
    return out


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as torch tensors: through the
    ``safetensors`` package where installed, else ``read_safetensors``."""
    try:
        from safetensors.torch import load_file
    except ImportError:
        return state_dict_from_hf(read_safetensors(path))
    return load_file(path)
