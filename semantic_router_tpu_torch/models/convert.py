"""Checkpoint conversion into the port's modules.

- HF ModernBERT state dicts load 1:1: the port's parameter names are HF's.
- ``params_from_flax`` carries weights from the JAX package's Flax trees
  (numpy arrays) into a state dict: Flax ``Dense`` kernels are [in, out],
  torch ``Linear`` weights [out, in]; bare LoRA parameters (``lora_A``,
  ``lora_B``) keep the Flax layout.
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
         "bias": "bias"}
# bare parameters, carried as they are (no transpose)
_RAW = frozenset({"lora_A", "lora_B"})


def params_from_flax(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ModernBERT param tree (``{"params": {...}}`` or the inner tree,
    for ``ModernBertModel``, ``ModernBertFor*Classification`` or
    ``ModernBertLoRAHeadClassifier``) → a torch state dict with HF names
    (the LoRA head's own names: ``head_dense``, ``lora_A``, ...)."""
    tree = flax_params.get("params", flax_params)
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], path: list) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                m = _LAYER_RE.match(key)
                walk(val, path + ([f"layers.{m.group(1)}"] if m else [key]))
                continue
            if key not in _LEAF and key not in _RAW:
                raise KeyError(f"unknown Flax leaf {'/'.join(path + [key])}")
            arr = np.array(val)  # a writable host copy
            if arr.dtype.kind == "V":  # bfloat16 (ml_dtypes) → float32
                arr = arr.astype(np.float32)
            if key == "kernel":
                arr = arr.T
            out[".".join(path + [_LEAF.get(key, key)])] = torch.from_numpy(
                np.ascontiguousarray(arr))

    walk(tree, [])
    return out


def state_dict_from_hf(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An HF ModernBERT state dict (tensors or numpy arrays) as torch
    tensors under the port's names — HF's own."""
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
