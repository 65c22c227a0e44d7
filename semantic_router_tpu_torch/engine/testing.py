"""Model-free engine fixtures: tiny (or full-width) ModernBERT classifiers
and embedding models with weights from a numpy seed, or carried from a
JAX Flax tree, plus the deterministic HashTokenizer.  Real model code
paths (batching, padding, the fused bank, span decoding, Matryoshka
variants) with no checkpoint and no network."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config.schema import InferenceEngineConfig
from ..models.convert import params_from_flax
from ..models.embeddings import MmBertEmbeddingModel
from ..models.lora import LoRAConfig, ModernBertLoRAHeadClassifier
from ..models.modernbert import (
    ModernBertConfig,
    ModernBertForSequenceClassification,
    ModernBertForTokenClassification,
    ModernBertModel,
)
from ..utils.device import DeviceLike
from ..utils.tokenization import HashTokenizer
from .classify import InferenceEngine

DEFAULT_TASKS = [
    ("intent", "sequence", ["business", "law", "health",
                            "computer science", "other"]),
    ("jailbreak", "sequence", ["benign", "jailbreak"]),
    ("pii", "token", ["O", "B-EMAIL_ADDRESS", "I-EMAIL_ADDRESS",
                      "B-PHONE_NUMBER", "I-PHONE_NUMBER",
                      "B-PERSON", "I-PERSON"]),
]

SHARED_TRUNK_TASKS = [
    ("intent", ["business", "law", "health", "computer science", "other"]),
    ("fact_check", ["no_fact_check", "fact_check"]),
    ("user_feedback", ["none", "positive", "negative"]),
]

TINY = dict(
    vocab_size=1024,
    hidden_size=32,
    intermediate_size=48,
    num_hidden_layers=2,
    num_attention_heads=2,
    max_position_embeddings=2048,
    local_attention=8,
    pad_token_id=0,
)


def tiny_config(num_labels: int, **overrides) -> ModernBertConfig:
    return ModernBertConfig(**{**TINY, "num_labels": num_labels, **overrides})


def init_weights(module: nn.Module, seed: int, std: float = 0.02,
                 skip: str = "") -> None:
    """Deterministic numpy-seeded weights, in parameter-name order:
    normal(0, std) for matrices, ones for norm scales, zeros for biases.
    Parameters under the ``skip`` prefix (a shared trunk) stay as they
    are."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in sorted(module.named_parameters()):
            if skip and name.startswith(skip):
                continue
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                p.copy_(torch.from_numpy(
                    rng.standard_normal(tuple(p.shape), np.float32) * std))


def _classifier(kind: str, cfg: ModernBertConfig,
                trunk: Optional[ModernBertModel]) -> nn.Module:
    if kind == "embedding":
        return MmBertEmbeddingModel(cfg)
    cls = ModernBertForTokenClassification if kind == "token" \
        else ModernBertForSequenceClassification
    return cls(cfg, model=trunk)


def make_test_engine(tasks: Optional[Sequence[tuple]] = None,
                     engine_cfg: Optional[InferenceEngineConfig] = None,
                     seed: int = 0, device: DeviceLike = None,
                     flax_params: Optional[Mapping[str, Any]] = None,
                     **observability) -> InferenceEngine:
    """Engine with tiny classifiers (and embedding models), each on its
    own trunk.

    ``tasks``: (name, kind, labels) triples (default intent/jailbreak/pii;
    kind ``embedding`` builds an ``MmBertEmbeddingModel``);
    ``flax_params``: {task: Flax tree} carries the JAX engine's weights in
    through ``params_from_flax``; otherwise weights come from ``seed``.
    ``observability``: ``metrics`` / ``runtime_stats`` / ``program_stats``
    for the engine."""
    tasks = DEFAULT_TASKS if tasks is None else tasks
    cfg = engine_cfg or InferenceEngineConfig(
        max_batch_size=8, max_wait_ms=1.0, seq_len_buckets=[32, 128, 512])
    engine = InferenceEngine(cfg, device=device, **observability)
    tok = HashTokenizer(vocab_size=TINY["vocab_size"])
    for i, (name, kind, labels) in enumerate(tasks):
        module = _classifier(kind, tiny_config(len(labels)), None)
        if flax_params is not None:
            module.load_state_dict(params_from_flax(flax_params[name]))
        else:
            init_weights(module, seed * 1000 + i)
        engine.register_task(name, kind, module, tok, labels,
                             max_seq_len=512)
    return engine


def make_shared_trunk_engine(
    tasks: Optional[Sequence[tuple]] = None,
    lora_tasks: Sequence[str] = (),
    token_tasks: Optional[Sequence[tuple]] = None,
    engine_cfg: Optional[InferenceEngineConfig] = None,
    seed: int = 0,
    device: DeviceLike = None,
    model_config: Optional[Dict[str, Any]] = None,
    flax_params: Optional[Mapping[str, Any]] = None,
    tokenizer=None,
    max_seq_len: int = 512,
    lora: LoRAConfig = LoRAConfig(rank=4, alpha=8.0),
    fuse: Optional[bool] = None,
    **observability,
) -> InferenceEngine:
    """Engine whose tasks share ONE ModernBERT trunk — the fused
    classifier-bank shape.

    ``tasks``: (name, labels) sequence tasks; ``lora_tasks``: the member
    names built as ``ModernBertLoRAHeadClassifier`` with ``lora`` (rank
    4, alpha 8 by default) and a non-zero ``lora_B``, so the delta
    provably applies; ``token_tasks``: (name, labels) token tasks over
    the SAME trunk.  ``model_config``: the ModernBertConfig fields
    (default ``TINY``).  ``flax_params``: {task: Flax tree} from the JAX
    package — the trunk loads from the first task's tree (every task's
    trunk subtree is the same there), each head from its own; otherwise
    all weights come from ``seed``.  ``fuse``: forwarded to
    ``register_task`` (None → ``engine.fuse_trunks``); ``False`` serves
    every task on the per-task path over the one trunk.
    ``observability``: ``metrics`` / ``runtime_stats`` / ``program_stats``
    for the engine."""
    tasks = SHARED_TRUNK_TASKS if tasks is None else tasks
    cfg = engine_cfg or InferenceEngineConfig(
        max_batch_size=8, max_wait_ms=1.0, seq_len_buckets=[32, 128, 512])
    mfields = dict(TINY if model_config is None else model_config)
    engine = InferenceEngine(cfg, device=device, **observability)
    tok = tokenizer or HashTokenizer(vocab_size=mfields["vocab_size"])
    specs = [(n, "sequence", l) for n, l in tasks]
    specs += [(n, "token", l) for n, l in (token_tasks or [])]
    trunk = None
    for i, (name, kind, labels) in enumerate(specs):
        mcfg = ModernBertConfig(**{**mfields, "num_labels": len(labels)})
        if kind == "sequence" and name in lora_tasks:
            module = ModernBertLoRAHeadClassifier(mcfg, lora, len(labels),
                                                  model=trunk)
        else:
            module = _classifier(kind, mcfg, trunk)
        if flax_params is not None:
            sd = params_from_flax(flax_params[name])
            if trunk is not None:
                # the shared trunk already holds these weights: load the
                # rest of the module, every key of it
                missing, unexpected = module.load_state_dict(
                    {k: v for k, v in sd.items()
                     if not k.startswith("model.")}, strict=False)
                missing = [k for k in missing if not k.startswith("model.")]
                if missing or unexpected:
                    raise KeyError(f"task {name!r}: missing {missing}, "
                                   f"unexpected {unexpected}")
            else:
                module.load_state_dict(sd)
        else:
            init_weights(module, seed if trunk is None else seed * 1000 + i,
                         skip="" if trunk is None else "model.")
            if isinstance(module, ModernBertLoRAHeadClassifier):
                # a zero lora_B is an exact no-op delta
                rng = np.random.default_rng(seed * 1000 + 500 + i)
                B = rng.standard_normal(tuple(module.lora_B.shape),
                                        np.float32) * 0.3
                with torch.no_grad():
                    module.lora_B.copy_(torch.from_numpy(B))
        trunk = module.model
        engine.register_task(name, kind, module, tok, labels,
                             max_seq_len=max_seq_len, fuse=fuse)
    return engine


def make_embedding_engine(seed: int = 0,
                          engine_cfg: Optional[InferenceEngineConfig] = None,
                          device: DeviceLike = None,
                          flax_params: Optional[Mapping[str, Any]] = None
                          ) -> InferenceEngine:
    """Engine with the default trio plus a tiny embedding task."""
    return make_test_engine(
        tasks=DEFAULT_TASKS + [("embedding", "embedding", [])],
        engine_cfg=engine_cfg, seed=seed, device=device,
        flax_params=flax_params)
