"""The stacked head bank of the fused classifier bank, the LoRA-head
classifier that joins it, the task-stacked ``LoRADense`` of the generative
decoder and the LoRA trunks, and the stacked multi-task LoRA bank.

The port of ``semantic_router_tpu.models.lora``.  The head bank:
every member task's prediction head (dense → act → LayerNorm →
classifier, with an optional rank-r LoRA delta on the dense) stacks into
one bank of [T, ...] arrays.  ``apply_head_bank`` fans the shared trunk's
features out through every head; ``apply_head_bank_bgmv`` computes only
the (row, task) pairs a batch asked for, through the BGMV kernel.  Arrays
keep the JAX layout (``dense_kernel`` [T, D, H], ``cls_kernel`` [T, H, L])
so the bank and the kernels take the same operands on both sides.

The LoRA modules: ``LoRADelta`` (task-stacked low-rank deltas, every task
at once), ``MultiTaskLoRAClassifier`` (one frozen trunk, a shared head
dense with a task-stacked delta, per-task LayerNorm and classifier: the
engine's stacked bank, ``register_stacked_bank``), and the trunk-adapted
``LoRAModernBertForSequenceClassification``,
``LoRAModernBertForTokenClassification`` and ``LoRAMmBertEmbeddingModel``,
whose trunks are ``ModernBertModel`` with ``LoRADense`` projections
selected per call by ``task_index``.  Submodules and parameters keep the
Flax names (``head_dense``, ``head_lora.lora_A``, ``head_norm_<task>``,
``classifier_<task>``, ``model.layers.<i>.attn.Wqkv.lora_A``), so
``models.convert`` carries the JAX trees 1:1.  The LoRA deltas and the
stacked heads are torch products (the reference computes them outside
any Pallas kernel); the trunks' attention is the flash kernel on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """An adapter's rank and alpha, and the number of task-stacked
    adapters a ``LoRADense`` / ``LoRADelta`` carries.  The JAX class's
    ``adapt_attention`` / ``adapt_mlp`` are not carried: its LoRA trunks
    adapt every projection whatever they say, as these do."""

    rank: int = 8
    alpha: float = 16.0
    num_tasks: int = 1

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def merge_lora_into_base(base_kernel: np.ndarray, lora_A: np.ndarray,
                         lora_B: np.ndarray, scale: float) -> np.ndarray:
    """Merge one task's adapter into a dense kernel [in, out] (the
    "merged" deployment path)."""
    return base_kernel + scale * (lora_A @ lora_B)


class ModernBertLoRAHeadClassifier(nn.Module):
    """Single-task sequence classifier with a LoRA-adapted prediction
    head: frozen trunk → pool → (dense + scale·(x A) B) → act → norm →
    classifier.  Submodules keep the Flax names (``model``,
    ``head_dense``, ``lora_A`` [D, r], ``lora_B`` [r, H], ``head_norm``,
    ``classifier``), so ``params_from_flax`` carries the JAX module's tree
    1:1.  As a bank member its head stacks like any other, the delta
    included."""

    def __init__(self, cfg, lora: LoRAConfig, num_labels: int,
                 model: Optional[nn.Module] = None) -> None:
        """``model``: an existing trunk to share (the fused classifier
        bank groups tasks whose trunk is one object)."""
        from ..ops.epilogue import activation
        from .modernbert import ModernBertModel

        super().__init__()
        D = cfg.hidden_size
        self.config = cfg
        self.lora = lora
        self.model = model if model is not None else ModernBertModel(cfg)
        self.head_dense = nn.Linear(D, D, bias=cfg.classifier_bias)
        # Flax's init: A ~ normal(0.02), B = 0 (an exact no-op delta)
        self.lora_A = nn.Parameter(torch.randn(D, lora.rank) * 0.02)
        self.lora_B = nn.Parameter(torch.zeros(lora.rank, D))
        self.head_norm = nn.LayerNorm(D, eps=cfg.norm_eps,
                                      bias=cfg.norm_bias)
        self.classifier = nn.Linear(D, num_labels)
        self.act = activation(cfg.classifier_activation)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        from ..ops.attention import cls_pool, mean_pool

        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        hidden = self.model(input_ids, attention_mask)
        pooled = mean_pool(hidden, attention_mask) \
            if self.config.classifier_pooling == "mean" else cls_pool(hidden)
        h = self.head_dense(pooled) \
            + self.lora.scale * ((pooled @ self.lora_A) @ self.lora_B)
        return self.classifier(self.head_norm(self.act(h)))


class LoRADense(nn.Module):
    """A dense layer with a task-stacked LoRA delta, one task per call:
    ``x W^T + b + scale · (x A[t]) B[t]``.  ``weight`` [out, in] is the
    frozen base (torch layout); ``lora_A`` [T, in, r] and ``lora_B``
    [T, r, out] keep the Flax layout.  ``task_index`` is a one-element
    int64 tensor on the layer's device, read by a gather, so switching
    adapters changes no shape and no captured step.  With ``lora=None``
    the layer is a plain dense.  A fresh layer's adapters are zero (the
    identity); its weights come from a loader
    (``models.generate.with_lora_leaves`` draws A as Flax's init does)."""

    def __init__(self, in_features: int, out_features: int,
                 lora: Optional[LoRAConfig] = None,
                 bias: bool = False) -> None:
        super().__init__()
        self.lora = lora
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        if lora is not None:
            self.lora_A = nn.Parameter(torch.zeros(
                lora.num_tasks, in_features, lora.rank))
            self.lora_B = nn.Parameter(torch.zeros(
                lora.num_tasks, lora.rank, out_features))

    def forward(self, x: torch.Tensor,
                task_index: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``task_index`` None selects adapter 0 (the JAX ``_make_dense``
        default)."""
        y = nn.functional.linear(x, self.weight, self.bias)
        if self.lora is None:
            return y
        if task_index is None:
            a, b = self.lora_A[0], self.lora_B[0]
        else:
            a = self.lora_A.index_select(0, task_index.reshape(1))[0]
            b = self.lora_B.index_select(0, task_index.reshape(1))[0]
        return y + self.lora.scale * ((x @ a) @ b)


def _np(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.detach().cpu().numpy()


def head_bank_entry(module: nn.Module) -> Optional[Dict[str, Any]]:
    """The stackable prediction head of a ModernBERT sequence or token
    classifier or a LoRA-head classifier, as host arrays {dense_kernel
    [D, H], dense_bias?, lora_A?, lora_B?, scale, norm_scale, norm_bias?,
    cls_kernel [H, L], cls_bias, kind}; None when the module is not
    bank-fusable."""
    from .modernbert import (
        ModernBertForSequenceClassification,
        ModernBertForTokenClassification,
    )

    if isinstance(module, ModernBertLoRAHeadClassifier):
        return {
            "dense_kernel": _np(module.head_dense.weight).T,
            "dense_bias": _np(module.head_dense.bias),
            "lora_A": _np(module.lora_A),
            "lora_B": _np(module.lora_B),
            "scale": float(module.lora.scale),
            "norm_scale": _np(module.head_norm.weight),
            "norm_bias": _np(module.head_norm.bias),
            "cls_kernel": _np(module.classifier.weight).T,
            "cls_bias": _np(module.classifier.bias),
            "kind": "sequence",
        }
    if not isinstance(module, (ModernBertForSequenceClassification,
                               ModernBertForTokenClassification)):
        return None
    head, cls = module.head, module.classifier
    return {
        "dense_kernel": _np(head.dense.weight).T,
        "dense_bias": _np(head.dense.bias),
        "lora_A": None,
        "lora_B": None,
        "scale": 0.0,
        "norm_scale": _np(head.norm.weight),
        "norm_bias": _np(head.norm.bias),
        "cls_kernel": _np(cls.weight).T,
        "cls_bias": _np(cls.bias),
        "kind": "token"
        if isinstance(module, ModernBertForTokenClassification)
        else "sequence",
    }


def stack_head_bank(entries: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Stack per-task head entries into one bank of [T, ...] host arrays.
    Label columns zero-pad to the widest member (padded logits are sliced
    away before softmax); LoRA ranks zero-pad to the widest adapter, and
    non-LoRA members get all-zero A/B rows — an exact no-op delta.  The
    bank keeps the members' own dtype."""
    D, H = np.shape(entries[0]["dense_kernel"])
    dt = np.asarray(entries[0]["dense_kernel"]).dtype
    l_max = max(int(np.shape(e["cls_kernel"])[1]) for e in entries)
    r_max = max([int(np.shape(e["lora_A"])[1])
                 for e in entries if e["lora_A"] is not None] or [1])

    def stacked(key, pad_to=None, axis=None):
        rows = []
        for e in entries:
            a = np.asarray(e[key], dtype=dt)
            if pad_to is not None and a.shape[axis] < pad_to:
                widths = [(0, 0)] * a.ndim
                widths[axis] = (0, pad_to - a.shape[axis])
                a = np.pad(a, widths)
            rows.append(a)
        return np.stack(rows)

    bank: Dict[str, Any] = {
        "dense_kernel": stacked("dense_kernel"),             # [T, D, H]
        "norm_scale": stacked("norm_scale"),                 # [T, H]
        "cls_kernel": stacked("cls_kernel", l_max, 1),       # [T, H, L]
        "cls_bias": stacked("cls_bias", l_max, 0),           # [T, L]
        "scale": np.asarray([e["scale"] for e in entries], dt),
    }
    if entries[0]["dense_bias"] is not None:
        bank["dense_bias"] = stacked("dense_bias")           # [T, H]
    if entries[0]["norm_bias"] is not None:
        bank["norm_bias"] = stacked("norm_bias")             # [T, H]
    if any(e["lora_A"] is not None for e in entries):
        bank["lora_A"] = np.stack([
            np.pad(np.asarray(e["lora_A"], dt),
                   ((0, 0), (0, r_max - e["lora_A"].shape[1])))
            if e["lora_A"] is not None else np.zeros((D, r_max), dt)
            for e in entries])                               # [T, D, r]
        bank["lora_B"] = np.stack([
            np.pad(np.asarray(e["lora_B"], dt),
                   ((0, r_max - e["lora_B"].shape[0]), (0, 0)))
            if e["lora_B"] is not None else np.zeros((r_max, H), dt)
            for e in entries])                               # [T, r, H]
    return bank


def bank_to_device(bank: Dict[str, np.ndarray], device: torch.device
                   ) -> Dict[str, torch.Tensor]:
    """Commit a host bank to ``device`` once (contiguous tensors)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in bank.items()}


def apply_head_bank(bank: Dict[str, torch.Tensor], pooled: torch.Tensor,
                    activation: str, norm_eps: float,
                    epilogue: bool = False) -> torch.Tensor:
    """Fan features [B, D] out through EVERY stacked head → logits
    [B, T, L_max].  ``activation`` names the heads' classifier activation.

    ``epilogue=True`` routes dense + bias + LoRA delta + activation through
    ops.epilogue (one kernel launch on the GPU); the rank-r LoRA delta's
    skinny matmuls stay einsums feeding it.  The head LayerNorm is computed
    by hand with rsqrt on both paths."""
    from ..ops.epilogue import activation as act_fn, head_epilogue

    if epilogue:
        # the kernel reads row-major operands: a CLS-pooled view and an
        # einsum result may be strided
        pooled = pooled.contiguous()
        delta = None
        if "lora_A" in bank:
            low = torch.einsum("bd,tdr->btr", pooled, bank["lora_A"])
            delta = (bank["scale"][None, :, None] * torch.einsum(
                "btr,trh->bth", low, bank["lora_B"])).contiguous()
        h = head_epilogue(pooled, bank["dense_kernel"],
                          bank.get("dense_bias"), delta, activation)
    else:
        h = torch.einsum("bd,tdh->bth", pooled, bank["dense_kernel"])
        if "dense_bias" in bank:
            h = h + bank["dense_bias"][None]
        if "lora_A" in bank:
            low = torch.einsum("bd,tdr->btr", pooled, bank["lora_A"])
            h = h + bank["scale"][None, :, None] * torch.einsum(
                "btr,trh->bth", low, bank["lora_B"])
        h = act_fn(activation)(h)
    mu = h.mean(dim=-1, keepdim=True)
    var = ((h - mu) ** 2).mean(dim=-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + norm_eps)
    h = h * bank["norm_scale"][None]
    if "norm_bias" in bank:
        h = h + bank["norm_bias"][None]
    return torch.einsum("bth,thl->btl", h, bank["cls_kernel"]) \
        + bank["cls_bias"][None]


def apply_head_bank_bgmv(bank: Dict[str, torch.Tensor], pooled: torch.Tensor,
                         pair_rows: torch.Tensor, pair_tasks: torch.Tensor,
                         activation: str, norm_eps: float) -> torch.Tensor:
    """Per-pair gathered head application: pooled [N, D] and pairs [P]
    (int32 row and bank-row indices) → logits [P, L_max].  Each (row,
    task) pair computes only its task's head — the same math as
    ``apply_head_bank`` at (pair_rows, pair_tasks).

    The two full-width matmuls (head dense, classifier) go through the
    BGMV kernel (ops.bgmv); the rank-r LoRA delta stays gathered einsums,
    as the JAX package keeps it outside Pallas."""
    from ..ops.bgmv import bgmv
    from ..ops.epilogue import activation as act_fn

    x = pooled.index_select(0, pair_rows)                # [P, D]
    h = bgmv(x, bank["dense_kernel"], pair_tasks)        # [P, H]
    if "dense_bias" in bank:
        h = h + bank["dense_bias"].index_select(0, pair_tasks)
    if "lora_A" in bank:
        low = torch.einsum("pd,pdr->pr", x,
                           bank["lora_A"].index_select(0, pair_tasks))
        h = h + bank["scale"].index_select(0, pair_tasks)[:, None] \
            * torch.einsum("pr,prh->ph", low,
                           bank["lora_B"].index_select(0, pair_tasks))
    h = act_fn(activation)(h)
    mu = h.mean(dim=-1, keepdim=True)
    var = ((h - mu) ** 2).mean(dim=-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + norm_eps)
    h = h * bank["norm_scale"].index_select(0, pair_tasks)
    if "norm_bias" in bank:
        h = h + bank["norm_bias"].index_select(0, pair_tasks)
    return bgmv(h, bank["cls_kernel"], pair_tasks) \
        + bank["cls_bias"].index_select(0, pair_tasks)


# -- the LoRA modules ---------------------------------------------------------


class LoRADelta(nn.Module):
    """Task-stacked low-rank delta: x [B, S, D] (or task-stacked
    [T, B, S, D]) → delta [T, B, S, out] = scale · (x A[t]) B[t] for every
    task t.  ``lora_A`` [T, D, r] and ``lora_B`` [T, r, out] keep the Flax
    layout; a fresh delta draws A ~ normal(0.02) and zeroes B (the
    identity), as Flax's init does."""

    def __init__(self, in_features: int, features: int,
                 lora: LoRAConfig) -> None:
        super().__init__()
        self.lora = lora
        self.lora_A = nn.Parameter(torch.randn(
            lora.num_tasks, in_features, lora.rank) * 0.02)
        self.lora_B = nn.Parameter(torch.zeros(
            lora.num_tasks, lora.rank, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T = self.lora.num_tasks
        if x.dim() == 4 and x.shape[0] == T:  # already task-stacked
            h = torch.einsum("tbsd,tdr->tbsr", x, self.lora_A)
        else:
            h = torch.einsum("bsd,tdr->tbsr", x, self.lora_A)
        return self.lora.scale * torch.einsum("tbsr,tro->tbso", h,
                                              self.lora_B)


def _pool(cfg, hidden: torch.Tensor, mask: torch.Tensor,
          pooling: Optional[str] = None) -> torch.Tensor:
    from ..ops.attention import cls_pool, mean_pool

    how = pooling or cfg.classifier_pooling
    return mean_pool(hidden, mask) if how == "mean" else cls_pool(hidden)


class MultiTaskLoRAClassifier(nn.Module):
    """Shared frozen ModernBERT trunk + per-task LoRA'd prediction heads:
    ONE forward evaluates every task on the same batch.  The trunk runs
    once; ``head_dense`` and ALL tasks' ``head_lora`` deltas apply once
    per feature kind (pooled for sequence tasks, every token for token
    tasks), then per task an exact GELU, ``head_norm_<task>`` and
    ``classifier_<task>``.  Returns {task: logits} — [B, L] for a sequence
    task, [B, S, L] for a token task.

    ``model``: an existing trunk to share (the engine's stacked bank may
    ride the trunk a trunk group already holds on the card)."""

    def __init__(self, cfg, lora: LoRAConfig, task_names: List[str],
                 task_labels: Dict[str, int],
                 task_kinds: Optional[Dict[str, str]] = None,
                 model: Optional[nn.Module] = None) -> None:
        from .modernbert import Dense, LayerNorm, ModernBertModel

        super().__init__()
        D = cfg.hidden_size
        self.config = cfg
        self.lora = lora
        self.task_names = list(task_names)
        self.task_labels = dict(task_labels)
        self.task_kinds = dict(task_kinds or {})
        self.model = model if model is not None else ModernBertModel(cfg)
        self.head_dense = Dense(D, D, cfg.classifier_bias, cfg.dtype)
        self.head_lora = LoRADelta(D, D, lora)
        for task in self.task_names:
            self.add_module(f"head_norm_{task}", LayerNorm(cfg))
            self.add_module(f"classifier_{task}",
                            Dense(D, self.task_labels[task], True,
                                  cfg.dtype))

    def kind(self, task: str) -> str:
        return self.task_kinds.get(task, "sequence")

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        hidden = self.model(input_ids, attention_mask)
        kinds = {self.kind(t) for t in self.task_names}
        feats: Dict[str, torch.Tensor] = {}
        if "sequence" in kinds:
            xp = _pool(self.config, hidden, attention_mask)[:, None, :]
            feats["sequence"] = self.head_dense(xp) + self.head_lora(xp)
        if "token" in kinds:
            feats["token"] = self.head_dense(hidden) + self.head_lora(hidden)
        out: Dict[str, torch.Tensor] = {}
        for ti, task in enumerate(self.task_names):
            kind = self.kind(task)
            h = nn.functional.gelu(feats[kind][ti])
            h = getattr(self, f"head_norm_{task}")(h)
            logits = getattr(self, f"classifier_{task}")(h)
            out[task] = logits[:, 0, :] if kind == "sequence" else logits
        return out


def _task_tensor(task_index, like: torch.Tensor) -> Optional[torch.Tensor]:
    """``task_index`` as the one-element int64 tensor the trunk's
    ``LoRADense`` projections gather by (a Python int other than 0 is
    placed on ``like``'s device: outside a captured step only).  Adapter 0
    as a Python int is None, which every ``LoRADense`` reads as adapter 0
    with no host-to-device copy, so a captured step may take it."""
    if isinstance(task_index, torch.Tensor):
        return task_index.reshape(1)
    if int(task_index) == 0:
        return None
    return torch.tensor([int(task_index)], dtype=torch.long,
                        device=like.device)


def lora_trunk(cfg, lora: LoRAConfig) -> nn.Module:
    """A ``ModernBertModel`` whose every projection (Wqkv, Wo, Wi) is a
    ``LoRADense`` carrying ``lora.num_tasks`` adapters — the JAX
    ``dense_factory`` seam, in the Flax names."""
    from .modernbert import ModernBertModel

    def factory(d_in: int, d_out: int, bias: bool) -> LoRADense:
        layer = LoRADense(d_in, d_out, lora, bias=bias)
        nn.init.kaiming_uniform_(layer.weight, a=5 ** 0.5)
        return layer

    return ModernBertModel(cfg, dense_factory=factory)


class LoRAModernBertForSequenceClassification(nn.Module):
    """Trunk-adapted LoRA sequence classifier: every attention / MLP
    projection carries a task-stacked adapter selected by ``task_index``
    at call time; one set of base weights, T adapters, a switch that
    changes no shape (and so no captured step)."""

    def __init__(self, cfg, lora: LoRAConfig, num_labels: int) -> None:
        from .modernbert import Dense, ModernBertPredictionHead

        super().__init__()
        self.config = cfg
        self.lora = lora
        self.model = lora_trunk(cfg, lora)
        self.head = ModernBertPredictionHead(cfg)
        self.classifier = Dense(cfg.hidden_size, num_labels, True,
                                cfg.dtype)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                task_index=0) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        hidden = self.model(input_ids, attention_mask,
                            task_index=_task_tensor(task_index, input_ids))
        return self.classifier(self.head(
            _pool(self.config, hidden, attention_mask)))


class LoRAModernBertForTokenClassification(nn.Module):
    """Token-level sibling of the LoRA sequence classifier: the same
    adapted trunk, a per-token head → [B, S, num_labels]."""

    def __init__(self, cfg, lora: LoRAConfig, num_labels: int) -> None:
        from .modernbert import Dense, ModernBertPredictionHead

        super().__init__()
        self.config = cfg
        self.lora = lora
        self.model = lora_trunk(cfg, lora)
        self.head = ModernBertPredictionHead(cfg)
        self.classifier = Dense(cfg.hidden_size, num_labels, True,
                                cfg.dtype)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                task_index=0) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        hidden = self.model(input_ids, attention_mask,
                            task_index=_task_tensor(task_index, input_ids))
        return self.classifier(self.head(hidden))


class LoRAMmBertEmbeddingModel(nn.Module):
    """LoRA-adapted embedding trunk: every trunk projection carries a
    task-stacked adapter; pool → L2-normalize like
    ``MmBertEmbeddingModel``.  The trained artifact is the adapter stack
    (``lora_param_filter``)."""

    def __init__(self, cfg, lora: LoRAConfig, pooling: str = "mean") -> None:
        super().__init__()
        if pooling not in ("mean", "cls"):
            raise ValueError(f"pooling {pooling!r} not in ('mean', 'cls')")
        self.config = cfg
        self.lora = lora
        self.pooling = pooling
        self.model = lora_trunk(cfg, lora)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                task_index=0) -> torch.Tensor:
        from ..ops.matryoshka import truncate_normalize

        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        hidden = self.model(input_ids, attention_mask,
                            task_index=_task_tensor(task_index, input_ids))
        pooled = _pool(self.config, hidden, attention_mask, self.pooling)
        return truncate_normalize(pooled, None).to(self.config.dtype)


def lora_param_filter(name: str, _param=None) -> bool:
    """The trainable-parameter predicate of a LoRA fine-tune: True for
    adapter parameters only (a dotted name with a ``lora_*`` component,
    as ``model.layers.0.attn.Wqkv.lora_A``); the base stays frozen."""
    return any(part.startswith("lora_") for part in name.split("."))



def init_lora_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Fresh weights for a LoRA module from ``generator``, in parameter-name
    order: ``lora_A`` ~ normal(0, 0.02) and ``lora_B`` = 0 (Flax's adapter
    init: every adapter starts as the identity, and only ``lora_A``'s
    product with a moved ``lora_B`` trains it), biases 0, 1-D scales 1,
    every other matrix normal(0, 1/sqrt(fan_in)) over its last axis (Flax's
    ``lecun_normal`` and embedding init, untruncated).  The draws are the
    port's own: they do not reproduce a Flax ``init`` bit for bit."""
    with torch.no_grad():
        for name, p in sorted(module.named_parameters()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith("lora_B"):
                p.zero_()
            elif leaf.startswith("lora_A"):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
            elif leaf == "bias":
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator)
                        * p.shape[-1] ** -0.5)


def _merged_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s state dict with adapter 0 of every ``LoRADense`` (a
    fine-tune trains one) folded into its base (``weight + scale · (A
    B)^T``, the reference's merged deployment path) and the adapter leaves
    dropped: the state of the plain module of the same architecture."""
    out: Dict[str, torch.Tensor] = {}
    for name, sub in module.named_modules():
        if isinstance(sub, LoRADense) and sub.lora is not None:
            a = sub.lora_A[0].detach()
            b = sub.lora_B[0].detach()
            prefix = f"{name}." if name else ""
            out[prefix + "weight"] = (sub.weight.detach()
                                      + sub.lora.scale * (a @ b).T)
    for name, t in module.state_dict().items():
        if name not in out and not lora_param_filter(name):
            out[name] = t.detach()
    return out


def merged_module(module: nn.Module) -> nn.Module:
    """The plain serving module of a trained trunk-adapted LoRA module
    (``LoRAModernBertForSequenceClassification`` →
    ``ModernBertForSequenceClassification``, the token classifier →
    ``ModernBertForTokenClassification``, ``LoRAMmBertEmbeddingModel`` →
    ``MmBertEmbeddingModel``) with its adapter merged into the base, on
    ``module``'s device, frozen, in eval mode.  A plain classifier joins
    the engine's fused classifier bank, so the served model runs the flash
    kernel in its trunk (``attention_impl="flash"``) and the head epilogue
    kernel in its head."""
    from .embeddings import MmBertEmbeddingModel
    from .modernbert import (
        ModernBertForSequenceClassification,
        ModernBertForTokenClassification,
    )

    if not isinstance(module, (LoRAModernBertForSequenceClassification,
                               LoRAModernBertForTokenClassification,
                               LoRAMmBertEmbeddingModel)):
        raise TypeError(f"no plain module for {type(module).__name__}")
    cfg = dataclasses.replace(module.config, attention_impl="flash")
    if isinstance(module, LoRAModernBertForSequenceClassification):
        plain = ModernBertForSequenceClassification(dataclasses.replace(
            cfg, num_labels=module.classifier.out_features))
    elif isinstance(module, LoRAModernBertForTokenClassification):
        plain = ModernBertForTokenClassification(dataclasses.replace(
            cfg, num_labels=module.classifier.out_features))
    else:
        plain = MmBertEmbeddingModel(cfg, pooling=module.pooling)
    device = next(module.parameters()).device
    plain.load_state_dict(_merged_state(module), strict=True)
    return plain.to(device).requires_grad_(False).eval()
