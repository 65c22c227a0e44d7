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
from ..models.lora import (
    LoRAConfig,
    ModernBertLoRAHeadClassifier,
    MultiTaskLoRAClassifier,
)
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


def stack_lora_heads(heads: Dict[str, ModernBertLoRAHeadClassifier]
                     ) -> MultiTaskLoRAClassifier:
    """The ``MultiTaskLoRAClassifier`` that computes what a set of
    LoRA-head classifiers compute: one trunk object and one head dense
    shared by every member, the members' adapters stacked in the given
    order (``lora_A`` [T, D, r], ``lora_B`` [T, r, D]), each member's
    LayerNorm and classifier under its task name.  The bank rides the
    members' trunk (no copy).  Raises when the members do not share the
    trunk, the head dense or the adapter shape, or their classifier
    activation is not the bank's exact GELU."""
    names = list(heads)
    first = heads[names[0]]
    cfg, rank = first.config, first.lora.rank
    for name, h in heads.items():
        if h.model is not first.model:
            raise ValueError(f"{name!r} does not share the trunk")
        if h.lora.rank != rank or h.lora.alpha != first.lora.alpha:
            raise ValueError(f"{name!r}: adapter shape differs")
        if not torch.equal(h.head_dense.weight, first.head_dense.weight):
            raise ValueError(f"{name!r} does not share the head dense")
        if h.config.classifier_activation not in ("gelu", "gelu_python"):
            raise ValueError(f"{name!r}: classifier activation "
                             f"{h.config.classifier_activation!r} is not "
                             "the bank's exact GELU")
    bank = MultiTaskLoRAClassifier(
        cfg, LoRAConfig(rank=rank, alpha=first.lora.alpha,
                        num_tasks=len(names)),
        names, {n: h.classifier.out_features for n, h in heads.items()},
        {n: "sequence" for n in names}, model=first.model)
    with torch.no_grad():
        bank.head_dense.weight.copy_(first.head_dense.weight)
        if first.head_dense.bias is not None:
            bank.head_dense.bias.copy_(first.head_dense.bias)
        bank.head_lora.lora_A.copy_(torch.stack(
            [heads[n].lora_A for n in names]))
        bank.head_lora.lora_B.copy_(torch.stack(
            [heads[n].lora_B for n in names]))
        for n in names:
            getattr(bank, f"head_norm_{n}").load_state_dict(
                heads[n].head_norm.state_dict())
            getattr(bank, f"classifier_{n}").load_state_dict(
                heads[n].classifier.state_dict())
    return bank.to(first.head_dense.weight.device).eval()


DUAL_PATH_TASKS = [
    ("intent", ["business", "law", "health", "computer science", "other"]),
    ("jailbreak", ["benign", "jailbreak"]),
    ("fact_check", ["no_fact_check", "fact_check"]),
    ("user_feedback", ["satisfied", "need_clarification", "wrong_answer",
                       "want_different"]),
]


def make_dual_path_engine(
    tasks: Optional[Sequence[tuple]] = None,
    engine_cfg: Optional[InferenceEngineConfig] = None,
    seed: int = 0,
    device: DeviceLike = None,
    model_config: Optional[Dict[str, Any]] = None,
    strategy: str = "adaptive",
    max_seq_len: int = 512,
    lora: LoRAConfig = LoRAConfig(rank=4, alpha=8.0),
    trunk: Optional[ModernBertModel] = None,
    tokenizer=None,
    **observability,
) -> InferenceEngine:
    """An engine serving its sequence tasks on both paths of
    ``classify_multi``, from one set of weights: traditionally, as
    ``ModernBertLoRAHeadClassifier`` members of one trunk group (one
    trunk, one head dense, an adapter, a LayerNorm and a classifier per
    task), and as the ``MultiTaskLoRAClassifier`` bank stacked from those
    very modules (``stack_lora_heads``), under ``strategy``.  Both paths
    compute the same function.  ``tasks``: (name, labels) pairs (default
    ``DUAL_PATH_TASKS``); ``model_config``: the ModernBertConfig fields
    (default ``TINY``); weights from ``seed``, every ``lora_B`` non-zero.
    ``trunk``: an existing ``ModernBertModel`` the heads ride (its
    weights are kept; ``model_config`` must be its config's fields)."""
    tasks = DUAL_PATH_TASKS if tasks is None else tasks
    cfg = engine_cfg or InferenceEngineConfig(
        max_batch_size=16, max_wait_ms=1.0, seq_len_buckets=[32, 128, 512])
    mfields = dict(TINY if model_config is None else model_config)
    engine = InferenceEngine(cfg, device=device, **observability)
    tok = tokenizer or HashTokenizer(vocab_size=mfields["vocab_size"])
    heads: Dict[str, ModernBertLoRAHeadClassifier] = {}
    dense = None
    for i, (name, labels) in enumerate(tasks):
        mcfg = ModernBertConfig(**{**mfields, "num_labels": len(labels)})
        module = ModernBertLoRAHeadClassifier(mcfg, lora, len(labels),
                                              model=trunk)
        init_weights(module, seed if trunk is None else seed * 1000 + i,
                     skip="" if trunk is None else "model.")
        module = module.to(module.model.embeddings.tok_embeddings
                           .weight.device)
        rng = np.random.default_rng(seed * 1000 + 500 + i)
        with torch.no_grad():
            module.lora_B.copy_(torch.from_numpy(rng.standard_normal(
                tuple(module.lora_B.shape), np.float32) * 0.3))
            if dense is not None:
                module.head_dense.load_state_dict(dense.state_dict())
        trunk, dense = module.model, module.head_dense
        heads[name] = module
        engine.register_task(name, "sequence", module, tok, labels,
                             max_seq_len=max_seq_len)
    engine.register_stacked_bank(stack_lora_heads(heads), tok,
                                 max_seq_len=max_seq_len,
                                 strategy=strategy)
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
