"""LoRA fine-tuning of a sequence classifier on one device (the port of
``semantic_router_tpu.training.finetune``).

- JSONL {text, label} datasets, and a seeded synthetic set;
- a shuffled, bucket-padded batch iterator (the JAX iterator's numpy
  permutation and ``pick_bucket``: the same batches for the same seed);
- the fine-tune of ``LoRAModernBertForSequenceClassification`` through
  ``training.loop.run_lora_training`` (base frozen, adapters trained with
  AdamW), on ``cuda`` unless the caller names another device;
- adapter files as npz under the JAX package's key names (the ``/``-joined
  Flax path ending in ``lora_*``), so either package loads the other's.

CLI: ``python -m semantic_router_tpu_torch.training.finetune --help``
(``--device cpu`` trains on the host).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..engine.batcher import pick_bucket
from ..utils.device import DeviceLike, resolve_device
from ..utils.tokenization import HashTokenizer, Tokenizer


@dataclass
class TrainConfig:
    labels: List[str]
    rank: int = 32
    alpha: float = 64.0
    learning_rate: float = 1e-4
    batch_size: int = 16
    num_steps: int = 100
    max_seq_len: int = 512
    seq_buckets: Tuple[int, ...] = (64, 128, 256, 512)
    mesh_shape: Dict[str, int] = field(default_factory=dict)
    seed: int = 0


def load_jsonl_dataset(path: str) -> List[Tuple[str, str]]:
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            out.append((str(row["text"]), str(row["label"])))
    return out


def synthetic_dataset(labels: Sequence[str], n_per_label: int = 32,
                      seed: int = 0) -> List[Tuple[str, str]]:
    """Deterministic label-correlated synthetic data."""
    rng = np.random.default_rng(seed)
    out = []
    for li, label in enumerate(labels):
        marker = f"topic{li}"
        for i in range(n_per_label):
            filler = " ".join(
                f"w{rng.integers(0, 50)}" for _ in range(rng.integers(4, 12)))
            out.append((f"{marker} {filler} {marker}", label))
    rng.shuffle(out)
    return out


def batch_iterator(data: Sequence[Tuple[str, str]], tokenizer: Tokenizer,
                   cfg: TrainConfig) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                                       np.ndarray]]:
    """Infinite shuffled batches, padded to the batch's seq bucket."""
    label_idx = {l: i for i, l in enumerate(cfg.labels)}
    rng = np.random.default_rng(cfg.seed)
    encs = [(tokenizer.encode(t, max_length=cfg.max_seq_len), label_idx[l])
            for t, l in data]
    if not encs:
        raise ValueError("empty training dataset")
    while len(encs) < cfg.batch_size:
        encs = encs + encs  # tiny dataset: repeat to fill a batch
    while True:
        order = rng.permutation(len(encs))
        for start in range(0, len(order) - cfg.batch_size + 1,
                           cfg.batch_size):
            batch = [encs[i] for i in order[start:start + cfg.batch_size]]
            max_len = max(len(e) for e, _ in batch)
            bucket = pick_bucket(max_len, list(cfg.seq_buckets))
            ids = np.zeros((cfg.batch_size, bucket), np.int32)
            mask = np.zeros((cfg.batch_size, bucket), np.int32)
            labels = np.zeros((cfg.batch_size,), np.int32)
            for i, (enc, y) in enumerate(batch):
                L = min(len(enc), bucket)
                ids[i, :L] = enc.ids[:L]
                mask[i, :L] = enc.attention_mask[:L]
                labels[i] = y
            yield ids, mask, labels


def default_model_config(tokenizer: Tokenizer, max_seq_len: int,
                         num_labels: int):
    """The JAX fine-tunes' default trunk: hidden 64, 4 layers, 4 heads,
    window 32."""
    from ..models.modernbert import ModernBertConfig

    return ModernBertConfig(
        vocab_size=tokenizer.vocab_size, hidden_size=64,
        intermediate_size=96, num_hidden_layers=4,
        num_attention_heads=4, max_position_embeddings=max_seq_len,
        local_attention=32, num_labels=num_labels)


def build_lora_module(module: nn.Module, seed: int,
                      base_params: Optional[Dict[str, torch.Tensor]],
                      device: DeviceLike) -> nn.Module:
    """``module`` with ``base_params`` (a state dict, as
    ``models.convert.lora_params_from_flax`` gives) or fresh weights from
    ``torch.Generator`` seed ``seed``, on ``device`` (``cuda`` when
    None)."""
    from ..models.lora import init_lora_weights

    dev = resolve_device(device)
    if base_params is not None:
        module.load_state_dict(base_params, strict=True)
    else:
        init_lora_weights(module, torch.Generator().manual_seed(seed))
    return module.to(dev)


def finetune_classifier(
    data: Sequence[Tuple[str, str]],
    cfg: TrainConfig,
    model_config=None,
    tokenizer: Optional[Tokenizer] = None,
    base_params: Optional[Dict[str, torch.Tensor]] = None,
    log_every: int = 20,
    device: DeviceLike = None,
) -> Tuple[nn.Module, List[Dict[str, float]]]:
    """Run the LoRA fine-tune; returns (the trained
    ``LoRAModernBertForSequenceClassification``, metric history)."""
    from ..models.lora import LoRAConfig, \
        LoRAModernBertForSequenceClassification
    from .loop import run_lora_training

    tokenizer = tokenizer or HashTokenizer()
    if model_config is None:
        model_config = default_model_config(tokenizer, cfg.max_seq_len,
                                            len(cfg.labels))
    lora = LoRAConfig(rank=cfg.rank, alpha=cfg.alpha, num_tasks=1)
    module = build_lora_module(
        LoRAModernBertForSequenceClassification(
            model_config, lora, num_labels=len(cfg.labels)),
        cfg.seed, base_params, device)
    return run_lora_training(
        lambda m, ids, mask: m(ids, mask),
        module, batch_iterator(data, tokenizer, cfg),
        cfg.num_steps, cfg.learning_rate, cfg.mesh_shape,
        log_every=log_every)


def save_adapters(module: nn.Module, path: str) -> None:
    """Persist ONLY the LoRA adapter tensors, under the JAX package's key
    names (the deployment artifact is base + adapters)."""
    from ..models.convert import flax_adapter_key

    flat = {flax_adapter_key(name): p.detach().cpu().numpy()
            for name, p in module.named_parameters()
            if name.rsplit(".", 1)[-1].startswith("lora_")}
    np.savez(path, **flat)


def load_adapters(module: nn.Module, path: str) -> nn.Module:
    """Copy saved adapters (either package's file) into ``module``'s
    parameters in place; returns the module.  A key that names no
    parameter of the module, or a shape that differs, raises."""
    from ..models.convert import port_adapter_name

    params = dict(module.named_parameters())
    with np.load(path) as blobs:
        with torch.no_grad():
            for key in blobs.files:
                name = port_adapter_name(key)
                if name not in params:
                    raise KeyError(f"adapter {key!r} names no parameter of "
                                   f"{type(module).__name__}")
                p = params[name]
                value = torch.from_numpy(np.asarray(blobs[key]))
                if tuple(value.shape) != tuple(p.shape):
                    raise ValueError(f"adapter {key!r}: shape "
                                     f"{tuple(value.shape)}, the module's "
                                     f"{tuple(p.shape)}")
                p.copy_(value.to(p.device, p.dtype))
    return module


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="LoRA fine-tune a router classifier")
    ap.add_argument("--data", help="JSONL with {text, label} rows")
    ap.add_argument("--labels", required=True,
                    help="comma-separated label set")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--alpha", type=float, default=64.0)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--out", default="adapters.npz")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs on the host)")
    args = ap.parse_args(argv)

    resolve_device(args.device)  # no GPU and no --device: fail before work
    labels = [l.strip() for l in args.labels.split(",")]
    cfg = TrainConfig(labels=labels, rank=args.rank, alpha=args.alpha,
                      learning_rate=args.lr, batch_size=args.batch_size,
                      num_steps=args.steps)
    data = load_jsonl_dataset(args.data) if args.data else \
        synthetic_dataset(labels)
    module, history = finetune_classifier(data, cfg, device=args.device)
    for h in history:
        print(json.dumps(h))
    save_adapters(module, args.out)
    print(f"saved adapters to {args.out}")


if __name__ == "__main__":
    main()
