"""Token-classification (PII) LoRA fine-tune on one device (the port of
``semantic_router_tpu.training.token_finetune``).

BIO span labels aligned to tokenizer offsets, a masked token-level
cross-entropy, adapters-only artifacts.  The sequence recipe's loop,
optimizer and step serve it; only the model (token head), batching
(per-token labels) and loss (``IGNORE_INDEX`` masking) differ.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..engine.batcher import pick_bucket
from ..utils.device import DeviceLike
from ..utils.tokenization import HashTokenizer, Tokenizer
from .datasets import TokenRow, align_bio, bio_labels

IGNORE_INDEX = -100


@dataclass
class TokenTrainConfig:
    entity_types: List[str]
    rank: int = 32
    alpha: float = 64.0
    learning_rate: float = 1e-4
    batch_size: int = 16
    num_steps: int = 100
    max_seq_len: int = 256
    seq_buckets: Tuple[int, ...] = (64, 128, 256)
    mesh_shape: Dict[str, int] = field(default_factory=dict)
    seed: int = 0

    @property
    def labels(self) -> List[str]:
        return bio_labels(self.entity_types)


def token_batch_iterator(rows: Sequence[TokenRow], tokenizer: Tokenizer,
                         cfg: TokenTrainConfig
                         ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]]:
    label_index = {l: i for i, l in enumerate(cfg.labels)}
    rng = np.random.default_rng(cfg.seed)
    encs = []
    for row in rows:
        enc = tokenizer.encode(row.text, max_length=cfg.max_seq_len)
        encs.append((enc, align_bio(row, enc.offsets, label_index)))
    if not encs:
        raise ValueError("empty token training dataset")
    while len(encs) < cfg.batch_size:
        encs = encs + encs
    while True:
        order = rng.permutation(len(encs))
        for start in range(0, len(order) - cfg.batch_size + 1,
                           cfg.batch_size):
            batch = [encs[i] for i in order[start:start + cfg.batch_size]]
            bucket = pick_bucket(max(len(e) for e, _ in batch),
                                 list(cfg.seq_buckets))
            ids = np.zeros((cfg.batch_size, bucket), np.int32)
            mask = np.zeros((cfg.batch_size, bucket), np.int32)
            labels = np.full((cfg.batch_size, bucket), IGNORE_INDEX,
                             np.int32)
            for i, (enc, lab) in enumerate(batch):
                L = min(len(enc), bucket)
                ids[i, :L] = enc.ids[:L]
                mask[i, :L] = enc.attention_mask[:L]
                labels[i, :L] = lab[:L]
            yield ids, mask, labels


def masked_token_cross_entropy(logits: torch.Tensor,
                               labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy over the positions not labelled
    ``IGNORE_INDEX`` (padding, specials); the denominator is clamped to at
    least 1, so a batch with no labelled token gives 0."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    losses = -logp.gather(-1, safe[..., None])[..., 0]
    denom = valid.sum().clamp(min=1)
    return (losses * valid).sum() / denom


def finetune_token_classifier(
    rows: Sequence[TokenRow],
    cfg: TokenTrainConfig,
    model_config=None,
    tokenizer: Optional[Tokenizer] = None,
    base_params: Optional[Dict[str, torch.Tensor]] = None,
    log_every: int = 20,
    device: DeviceLike = None,
) -> Tuple[nn.Module, List[Dict[str, float]]]:
    """LoRA token fine-tune; returns (the trained
    ``LoRAModernBertForTokenClassification``, history).  The history
    carries loss only: span quality comes from
    ``training.evaluate.evaluate_token`` on a held-out set."""
    from ..models.lora import (
        LoRAConfig,
        LoRAModernBertForTokenClassification,
    )
    from .finetune import build_lora_module, default_model_config
    from .loop import run_lora_training

    tokenizer = tokenizer or HashTokenizer()
    n_labels = len(cfg.labels)
    if model_config is None:
        model_config = default_model_config(tokenizer, cfg.max_seq_len,
                                            n_labels)
    lora = LoRAConfig(rank=cfg.rank, alpha=cfg.alpha, num_tasks=1)
    module = build_lora_module(
        LoRAModernBertForTokenClassification(model_config, lora,
                                             num_labels=n_labels),
        cfg.seed, base_params, device)
    return run_lora_training(
        lambda m, ids, mask: m(ids, mask),
        module, token_batch_iterator(rows, tokenizer, cfg),
        cfg.num_steps, cfg.learning_rate, cfg.mesh_shape,
        loss_fn=masked_token_cross_entropy, log_every=log_every,
        track_accuracy=False)
