"""The inference engine: the fused classifier bank and the embedding
tasks behind the batcher.

The port of the unpacked fused path and the embedding path of
``semantic_router_tpu.engine.classify``:

- tasks register a ModernBERT sequence or token classifier + tokenizer +
  label set; tasks whose trunk is ONE module object (and whose tokenizer,
  max_seq_len, pad id and config agree) form a ``TrunkGroup``;
- requests flow through the DynamicBatcher keyed by (trunk group, seq
  bucket): one trunk forward per batch serves sequences of every member
  task, and the members' heads apply as one stacked head bank
  (models.lora.apply_head_bank), whose logits demux back to each item's
  own task and label set with a host softmax over the true label width;
- identical encodings in a batch share one trunk row; rows pad to a power
  of two and sequences to the bucket edge;
- ``engine.kernels.epilogue`` routes the head dense through the epilogue
  kernel; ``attention_impl="flash"`` on the trunk runs the flash kernel;
  ``engine.kernels.bgmv`` swaps a wide sequence bank (at least
  ``min_tasks`` heads) for the per-(row, task) gather of the BGMV kernel,
  so each row computes only the heads its items asked for;
- ``engine.quant`` (mode off | bf16 | int8, a group selector) gives each
  trunk group a serving trunk (models.quant.build_quant_trunk): ``bf16``
  computes the trunk in bfloat16 over the float32 parameters (flash
  attention takes bf16), ``int8`` also swaps Wqkv / Wo / Wi for int8
  per-channel weights quantized once, when the mode is applied; the
  pooled features (or every token's) enter the float32 head bank, as
  the reference's dtype promotion has it; ``off`` serves the registered
  trunk untouched;
- embedding tasks (``MmBertEmbeddingModel``) are never fused: each batches
  on its own under the key (task, bucket, exit_layer, output_dim), so the
  2D-Matryoshka variants never share a forward; rows pad to a power of
  two, one forward returns host float32 unit rows; they stay float32
  under any ``engine.quant``.

Packing, meshes and the observability hooks of the JAX engine are later
slices (ROADMAP.md).
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config.schema import InferenceEngineConfig
from ..models.embeddings import MmBertEmbeddingModel
from ..models.quant import build_quant_trunk
from ..models.lora import (
    apply_head_bank,
    apply_head_bank_bgmv,
    bank_to_device,
    head_bank_entry,
    stack_head_bank,
)
from ..ops.attention import cls_pool, mean_pool
from ..utils.device import DeviceLike, resolve_device
from ..utils.tokenization import Encoding, Tokenizer, decode_entity_spans
from .batcher import BatchItem, DynamicBatcher, pick_bucket, pow2_batch
from .kernels import normalize_kernels, normalize_quant, quant_selects

# batch-group key prefix for fused trunk groups
TRUNK_KEY = "__trunk__"


def _tokenizer_fingerprint(tok) -> Hashable:
    """Content identity for a tokenizer: HashTokenizer is described by its
    vocab size, file-backed tokenizers by their path; anything else keeps
    object identity."""
    name = type(tok).__name__
    vocab = getattr(tok, "vocab_size", None)
    if name == "HashTokenizer":
        return (name, vocab)
    path = getattr(tok, "path", "")
    if path:
        return (name, path, vocab)
    return (name, id(tok))


@dataclass
class ClassResult:
    label: str
    index: int
    confidence: float
    probs: Dict[str, float] = field(default_factory=dict)
    latency_s: float = 0.0
    # the classifier never saw the input's tail (clipped at max_seq_len or
    # at the largest bucket)
    truncated: bool = False


@dataclass
class EntitySpan:
    type: str
    start: int
    end: int
    text: str
    score: float


@dataclass
class TokenClassResult:
    entities: List[EntitySpan] = field(default_factory=list)
    latency_s: float = 0.0
    truncated: bool = False


@dataclass
class _Task:
    name: str
    kind: str  # "sequence" | "token" | "embedding"
    labels: List[str]
    tokenizer: Tokenizer
    module: nn.Module
    max_seq_len: int
    pad_id: int = 0


@dataclass
class _Payload:
    text: str
    encoding: Encoding
    threshold: float = 0.5
    # member tasks this item needs logits for: one task → the future
    # resolves that task's result; several → a {task: result} dict
    tasks: tuple = ()
    submit_t: float = field(default_factory=time.perf_counter)


@dataclass
class TrunkGroup:
    """Tasks sharing one trunk: the fused classifier-bank unit."""

    gid: str
    config: Any                # ModernBertConfig shared by every member
    trunk: nn.Module           # the shared ModernBertModel
    tokenizer: Tokenizer
    max_seq_len: int
    pad_id: int
    members: List[str] = field(default_factory=list)
    entries: List[dict] = field(default_factory=list)
    # atomic demux snapshot {trunk, quant, bank, tok_bank, row_of, widths,
    # tok_row_of, tok_widths}: a runner reads ONE consistent view, so a
    # concurrent re-registration or quant flip never pairs new row
    # indices (or a new serving trunk) with old ones
    demux: Any = None

    def forward(self, ids: torch.Tensor, mask: torch.Tensor, flavor: str,
                demux: dict, epilogue: bool,
                pair_rows: Optional[torch.Tensor] = None,
                pair_tasks: Optional[torch.Tensor] = None):
        """One trunk forward feeding the head banks the flavor needs:
        ``seq`` → [B, T, L] logits, ``tok`` → [B, S, T, L], ``both`` →
        both.  With (pair_rows, pair_tasks) the sequence bank runs per
        pair (BGMV) and ``seq`` is [P, L].  The serving trunk (and its
        compute dtype) is the snapshot's; the heads take float32.  Returns
        (seq_logits or None, tok_logits or None)."""
        cfg = self.config
        hidden = demux["trunk"](ids, mask)
        seq = tok = None
        if flavor in ("seq", "both"):
            pooled = mean_pool(hidden, mask) \
                if cfg.classifier_pooling == "mean" else cls_pool(hidden)
            pooled = pooled.float()
            if pair_rows is not None:
                seq = apply_head_bank_bgmv(
                    demux["bank"], pooled, pair_rows, pair_tasks,
                    cfg.classifier_activation, cfg.norm_eps)
            else:
                seq = apply_head_bank(demux["bank"], pooled,
                                      cfg.classifier_activation,
                                      cfg.norm_eps, epilogue=epilogue)
        if flavor in ("tok", "both"):
            B, S, H = hidden.shape
            flat = apply_head_bank(demux["tok_bank"],
                                   hidden.reshape(B * S, H).float(),
                                   cfg.classifier_activation, cfg.norm_eps,
                                   epilogue=epilogue)
            tok = flat.reshape(B, S, flat.shape[-2], flat.shape[-1])
        return seq, tok


class InferenceEngine:
    """Owner of the served classifier tasks + the batching shim.

    ``device``: where the models run — ``cuda`` when None (raises without
    a GPU), or the caller's explicit choice such as ``"cpu"``."""

    def __init__(self, cfg: Optional[InferenceEngineConfig] = None,
                 device: DeviceLike = None) -> None:
        self.cfg = cfg or InferenceEngineConfig()
        self.device = resolve_device(device)
        self._tasks: Dict[str, _Task] = {}
        self._lock = threading.Lock()
        self._kernels = normalize_kernels(self.cfg.kernels)
        self._quant = normalize_quant(self.cfg.quant)
        self._kernel_rebuilds = 0
        self._trunk_groups: Dict[tuple, TrunkGroup] = {}
        self._task_group: Dict[str, TrunkGroup] = {}
        self._groups_by_gid: Dict[str, TrunkGroup] = {}
        self._next_gid = 0  # monotonic: eviction never recycles a gid
        self._shapes: Dict[str, set] = {}
        # step accounting: one record per trunk forward (bounded)
        self._steps: collections.deque = collections.deque(maxlen=4096)
        self.trunk_forwards = 0
        self.fused_dedup_rows = 0
        self.batcher = DynamicBatcher(
            self._run_batch,
            max_batch_size=self.cfg.max_batch_size,
            max_wait_ms=self.cfg.max_wait_ms,
            name="torch-engine-batcher",
            dispatch_workers=self.cfg.dispatch_workers)

    # -- registration ------------------------------------------------------

    def register_task(self, name: str, kind: str, module: nn.Module,
                      tokenizer: Tokenizer, labels: List[str],
                      max_seq_len: int = 0, pad_id: int = 0) -> None:
        """Register a ModernBERT sequence or token classifier, or an
        ``MmBertEmbeddingModel`` (kind ``embedding``).  The module moves to
        the engine's device; classifiers whose ``module.model`` is one
        trunk object share a trunk group and its forward."""
        if kind not in ("sequence", "token", "embedding"):
            raise ValueError(f"unknown task kind {kind!r}")
        if kind == "embedding":
            if not isinstance(module, MmBertEmbeddingModel):
                raise ValueError(f"task {name!r}: an embedding task takes an "
                                 f"MmBertEmbeddingModel, got "
                                 f"{type(module).__name__}")
            module = module.to(self.device).eval()
            with self._lock:
                # re-registration under a new kind leaves no fused member
                self._evict_locked(name)
                self._tasks[name] = _Task(
                    name, kind, list(labels), tokenizer, module,
                    max_seq_len or self.cfg.seq_len_buckets[-1], pad_id)
            return
        entry = head_bank_entry(module)
        if entry is None:
            raise ValueError(f"task {name!r}: {type(module).__name__} is not "
                             f"a bank-fusable ModernBERT classifier")
        if entry["kind"] != kind:
            raise ValueError(f"task {name!r}: kind {kind!r} but the module "
                             f"is a {entry['kind']} classifier")
        module = module.to(self.device).eval()
        max_len = max_seq_len or self.cfg.seq_len_buckets[-1]
        with self._lock:
            self._tasks[name] = _Task(name, kind, list(labels), tokenizer,
                                      module, max_len, pad_id)
        self._join_trunk_group(name, module, tokenizer, entry, max_len,
                               pad_id)

    def _trunk_key(self, module, tokenizer, max_seq_len: int,
                   pad_id: int) -> tuple:
        """Grouping key: the trunk module's identity, a content-equivalent
        tokenizer, and compatible shape discipline (label width is per
        head, never part of the trunk identity)."""
        cfg_key = repr(replace(module.config, num_labels=0))
        return (id(module.model), _tokenizer_fingerprint(tokenizer),
                int(max_seq_len), int(pad_id), cfg_key)

    def _evict_locked(self, name: str) -> None:
        """Remove a task from its trunk group (caller holds self._lock):
        re-registration REPLACES the member."""
        g = self._task_group.pop(name, None)
        if g is None:
            return
        idx = g.members.index(name)
        g.members.pop(idx)
        g.entries.pop(idx)
        if g.members:
            self._rebuild_bank(g)
        else:
            self._groups_by_gid.pop(g.gid, None)
            for k, v in list(self._trunk_groups.items()):
                if v is g:
                    del self._trunk_groups[k]

    def _join_trunk_group(self, name: str, module, tokenizer, entry: dict,
                          max_len: int, pad_id: int) -> None:
        tkey = self._trunk_key(module, tokenizer, max_len, pad_id)
        with self._lock:
            self._evict_locked(name)
            g = self._trunk_groups.get(tkey)
            if g is None:
                g = TrunkGroup(
                    gid=f"trunk{self._next_gid}", config=module.config,
                    trunk=module.model, tokenizer=tokenizer,
                    max_seq_len=max_len, pad_id=pad_id)
                self._trunk_groups[tkey] = g
                self._groups_by_gid[g.gid] = g
                self._next_gid += 1
            g.members.append(name)
            g.entries.append(entry)
            self._rebuild_bank(g)
            self._task_group[name] = g

    def _serving_trunk(self, g: TrunkGroup) -> tuple:
        """(quant mode, serving trunk) the group gets under the live quant
        block: the current one when its mode is unchanged, else a new
        one (caller holds self._lock)."""
        mode = quant_selects(self._quant, g.gid, g.members)
        if g.demux is not None and g.demux["quant"] == mode:
            return mode, g.demux["trunk"]
        return mode, build_quant_trunk(g.trunk, mode)

    def _rebuild_bank(self, g: TrunkGroup) -> None:
        """Re-stack the sequence and token head banks after a membership
        change and publish them, with the group's serving trunk, as one
        demux snapshot."""
        seq_idx = [i for i, e in enumerate(g.entries)
                   if e["kind"] == "sequence"]
        tok_idx = [i for i, e in enumerate(g.entries) if e["kind"] == "token"]

        def stack(idxs: List[int]):
            if not idxs:
                return None
            return bank_to_device(
                stack_head_bank([g.entries[i] for i in idxs]), self.device)

        def width(i: int) -> int:
            return int(np.shape(g.entries[i]["cls_kernel"])[1])

        mode, trunk = self._serving_trunk(g)
        g.demux = {
            "trunk": trunk,
            "quant": mode,
            "bank": stack(seq_idx),
            "tok_bank": stack(tok_idx),
            "row_of": {g.members[i]: r for r, i in enumerate(seq_idx)},
            "widths": [width(i) for i in seq_idx],
            "tok_row_of": {g.members[i]: r for r, i in enumerate(tok_idx)},
            "tok_widths": [width(i) for i in tok_idx],
        }

    # -- kernel knobs ------------------------------------------------------

    def configure_kernels(self, knobs: Optional[Dict[str, Any]]) -> None:
        """Apply an ``engine.kernels`` block (boot or reload).  The next
        batch serves under it; in-flight batches finish under the knobs
        they read."""
        kk = normalize_kernels(knobs)
        with self._lock:
            if kk != self._kernels:
                self._kernel_rebuilds += 1
            self._kernels = kk

    def configure_quant(self, knobs: Optional[Dict[str, Any]]) -> None:
        """Apply an ``engine.quant`` block (boot or reload): each trunk
        group whose mode changes gets a new serving trunk (the int8
        weights quantize here, once) in a new demux snapshot; the others
        keep theirs.  In-flight batches finish on the snapshot they
        read."""
        qk = normalize_quant(knobs)
        with self._lock:
            self._quant = qk
            for g in list(self._groups_by_gid.values()):
                mode = quant_selects(qk, g.gid, g.members)
                if mode != g.demux["quant"]:
                    g.demux = dict(g.demux, quant=mode,
                                   trunk=build_quant_trunk(g.trunk, mode))
                    self._kernel_rebuilds += 1

    def _serving_meta(self, demux: dict) -> Dict[str, Any]:
        """The knob snapshot one batch serves under, for the group whose
        demux snapshot it read: its quant mode, epilogue fusion, and
        whether the BGMV gather engages (sequence bank at least
        min_tasks heads wide)."""
        kk = self._kernels  # one read: a concurrent flip swaps the dict
        return {"quant": demux["quant"],
                "epilogue": bool(kk["epilogue"]["enabled"]),
                "bgmv": bool(kk["bgmv"]["enabled"]
                             and len(demux["widths"])
                             >= kk["bgmv"]["min_tasks"])}

    def kernels_report(self) -> Dict[str, Any]:
        """The live knob blocks, per-group serving meta (the quant mode
        included), and how many knob changes and serving-trunk rebuilds
        this engine applied."""
        return {
            "quant": {"mode": self._quant["mode"],
                      "groups": list(self._quant["groups"]),
                      "parity": dict(self._quant["parity"])},
            "kernels": {k: dict(v) for k, v in self._kernels.items()},
            "rebuilds": self._kernel_rebuilds,
            "groups": {g.gid: self._serving_meta(g.demux)
                       for g in list(self._groups_by_gid.values())},
            "device": str(self.device),
        }

    def trunk_group_info(self) -> Dict[str, List[str]]:
        """gid → member task names."""
        with self._lock:
            return {g.gid: list(g.members)
                    for g in self._groups_by_gid.values()}

    def trunk_group(self, task: str) -> Optional[TrunkGroup]:
        return self._task_group.get(task)

    # -- task metadata -----------------------------------------------------

    def has_task(self, name: str) -> bool:
        return name in self._tasks

    def task_kind(self, name: str) -> str:
        t = self._tasks.get(name)
        return t.kind if t is not None else ""

    def tasks(self) -> List[str]:
        return list(self._tasks)

    def _common_trunk_group(self, tasks: Sequence[str]
                            ) -> Optional[TrunkGroup]:
        if not tasks:
            return None
        g = self._task_group.get(tasks[0])
        if g is None:
            return None
        return g if all(self._task_group.get(t) is g for t in tasks) \
            else None

    def fused_covers(self, tasks: Sequence[str]) -> bool:
        """True when one fused execution serves every listed sequence task
        — the dispatcher's prefetch gate."""
        tasks = list(tasks)
        if not tasks or any(self.task_kind(t) != "sequence" for t in tasks):
            return False
        return self._common_trunk_group(tasks) is not None

    # -- public inference --------------------------------------------------

    def classify(self, task: str, text: str, timeout: float = 30.0,
                 enc_cache=None) -> ClassResult:
        return self.classify_batch(task, [text], timeout=timeout,
                                   enc_cache=enc_cache)[0]

    def classify_batch(self, task: str, texts: Sequence[str],
                       timeout: float = 30.0,
                       enc_cache=None) -> List[ClassResult]:
        futures = [self.classify_async(task, t, enc_cache=enc_cache)
                   for t in texts]
        return [f.result(timeout=timeout) for f in futures]

    def classify_async(self, task: str, text: str, enc_cache=None):
        """Submit one sequence classification; returns its Future (a
        cancelled future is dropped before its batch runs)."""
        t = self._require(task, kind="sequence")
        g = self._task_group[task]
        enc = self._encode(g, text, enc_cache)
        bucket = pick_bucket(len(enc), self.cfg.seq_len_buckets)
        return self.batcher.submit((TRUNK_KEY, g.gid, bucket),
                                   _Payload(text, enc, tasks=(t.name,)))

    def classify_multi(self, tasks: Sequence[str], texts: Sequence[str],
                       timeout: float = 30.0,
                       enc_cache=None) -> Dict[str, List[ClassResult]]:
        """Classify the same texts under several sequence tasks.  Tasks of
        one trunk group ride ONE item per text (tokenized once, one trunk
        row, heads demuxed); otherwise each task classifies on its own."""
        tasks = list(tasks)
        for t in tasks:
            self._require(t, kind="sequence")
        g = self._common_trunk_group(tasks)
        if g is None:
            return {t: self.classify_batch(t, texts, timeout=timeout,
                                           enc_cache=enc_cache)
                    for t in tasks}
        deadline = time.perf_counter() + timeout
        by_bucket: Dict[int, List[tuple]] = {}
        for ti, text in enumerate(texts):
            enc = self._encode(g, text, enc_cache)
            bucket = pick_bucket(len(enc), self.cfg.seq_len_buckets)
            by_bucket.setdefault(bucket, []).append(
                (ti, _Payload(text, enc, tasks=tuple(tasks))))
        futs: List[tuple] = []
        for bucket, entries in by_bucket.items():
            fs = self.batcher.submit_many((TRUNK_KEY, g.gid, bucket),
                                          [p for _, p in entries])
            futs.extend(zip((ti for ti, _ in entries), fs))
        results: List[Any] = [None] * len(texts)
        for ti, f in futs:
            res = f.result(timeout=max(0.05, deadline - time.perf_counter()))
            results[ti] = res if isinstance(res, dict) else {tasks[0]: res}
        return {t: [results[i][t] for i in range(len(texts))] for t in tasks}

    def token_classify(self, task: str, text: str, threshold: float = 0.5,
                       timeout: float = 30.0,
                       enc_cache=None) -> TokenClassResult:
        t = self._require(task, kind="token")
        g = self._task_group[task]
        enc = self._encode(g, text, enc_cache)
        bucket = pick_bucket(len(enc), self.cfg.seq_len_buckets)
        fut = self.batcher.submit(
            (TRUNK_KEY, g.gid, bucket),
            _Payload(text, enc, threshold, tasks=(t.name,)))
        return fut.result(timeout=timeout)

    def embed(self, task: str, texts: Sequence[str],
              exit_layer: Optional[int] = None,
              output_dim: Optional[int] = None,
              timeout: float = 30.0) -> np.ndarray:
        """Batch-embed texts → [n, dim] float32 unit rows.  ``exit_layer``
        / ``output_dim`` select the 2D-Matryoshka variant."""
        if not texts:
            return np.zeros((0, 0), dtype=np.float32)
        futures = self.embed_async(task, texts, exit_layer, output_dim)
        return np.stack([f.result(timeout=timeout) for f in futures])

    def embed_async(self, task: str, texts: Sequence[str],
                    exit_layer: Optional[int] = None,
                    output_dim: Optional[int] = None) -> list:
        """One Future per text.  The variant is part of the batch key:
        different variants never share a forward."""
        t = self._require(task, kind="embedding")
        futures = []
        for text in texts:
            enc = self._encode(t, text)
            bucket = pick_bucket(len(enc), self.cfg.seq_len_buckets)
            futures.append(self.batcher.submit(
                (task, bucket, exit_layer, output_dim),
                _Payload(text, enc, tasks=(task,))))
        return futures

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run every group's flavors once per bucket at batch 1, off the
        batcher: loads the kernels (building them on first use) and the
        library handles before live traffic arrives.  A BGMV group warms
        its sequence flavors at the 1-pair shape; an embedding task warms
        every configured Matryoshka variant."""
        def inputs(b: int, pad_id: int):
            ids = torch.full((1, b), pad_id, dtype=torch.long)
            ids[:, 0] = 1
            return (ids.to(self.device),
                    torch.ones((1, b), dtype=torch.int32, device=self.device))

        with torch.inference_mode():
            for t in list(self._tasks.values()):
                if t.kind != "embedding":
                    continue
                for b in buckets or self.cfg.seq_len_buckets:
                    if b > t.max_seq_len:
                        continue
                    ids, mask = inputs(b, t.pad_id)
                    for el, od in self._matryoshka_variants():
                        t.module(ids, mask, exit_layer=el, output_dim=od)
            for g in list(self._groups_by_gid.values()):
                demux = g.demux
                meta = self._serving_meta(demux)
                pair = torch.zeros(1, dtype=torch.int32, device=self.device)
                flavors = [f for f, need in
                           (("seq", demux["bank"] is not None),
                            ("tok", demux["tok_bank"] is not None),
                            ("both", demux["bank"] is not None
                             and demux["tok_bank"] is not None)) if need]
                for b in buckets or self.cfg.seq_len_buckets:
                    if b > g.max_seq_len:
                        continue
                    ids, mask = inputs(b, g.pad_id)
                    for flavor in flavors:
                        pairs = (pair, pair) if meta["bgmv"] \
                            and flavor != "tok" else ()
                        g.forward(ids, mask, flavor, demux, meta["epilogue"],
                                  *pairs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def steps(self) -> List[dict]:
        """Recent trunk-forward step records (oldest first)."""
        with self._lock:
            return list(self._steps)

    def shape_census(self) -> Dict[str, list]:
        """Distinct (padded_batch, bucket) device shapes per trunk group."""
        with self._lock:
            return {k: sorted(v) for k, v in self._shapes.items()}

    def _matryoshka_variants(self) -> List[tuple]:
        """(exit_layer, output_dim) pairs an embedding task serves: the
        full model plus every configured 2D-Matryoshka combination."""
        layers = [int(el) for el in self.cfg.matryoshka_layers or []]
        dims = [int(od) for od in self.cfg.matryoshka_dims or []]
        return ([(None, None)] + [(el, None) for el in layers]
                + [(None, od) for od in dims]
                + [(el, od) for el in layers for od in dims])

    def shutdown(self) -> None:
        self.batcher.shutdown()

    # -- internals ---------------------------------------------------------

    def _require(self, task: str, kind: Optional[str] = None) -> _Task:
        t = self._tasks.get(task)
        if t is None:
            raise KeyError(f"task {task!r} not registered "
                           f"(known: {sorted(self._tasks)})")
        if kind is not None and t.kind != kind:
            right = {"token": "token_classify", "sequence": "classify",
                     "embedding": "embed"}
            raise TypeError(f"task {task!r} is a {t.kind} task; use "
                            f"{right[t.kind]}()")
        return t

    @staticmethod
    def _encode(g: TrunkGroup, text: str, enc_cache=None) -> Encoding:
        if enc_cache is None:
            return g.tokenizer.encode(text, max_length=g.max_seq_len)
        return enc_cache.get_or_encode(g.tokenizer, text, g.max_seq_len)

    @staticmethod
    def _stack_items(items: List[BatchItem], bucket: int, padded_n: int,
                     pad_id: int):
        """Pad item encodings into one (padded_n, bucket) host batch.
        Returns (ids, mask, clipped): an encoding longer than the bucket
        clips at its edge and is flagged, never silently."""
        ids = np.full((padded_n, bucket), pad_id, dtype=np.int64)
        mask = np.zeros((padded_n, bucket), dtype=np.int32)
        clipped = [False] * len(items)
        for i, item in enumerate(items):
            enc: Encoding = item.payload.encoding
            L = min(len(enc), bucket)
            clipped[i] = len(enc) > bucket
            ids[i, :L] = enc.ids[:L]
            mask[i, :L] = enc.attention_mask[:L]
        return ids, mask, clipped

    def _run_batch(self, group_key: Hashable,
                   items: List[BatchItem]) -> Sequence[Any]:
        if group_key[0] == TRUNK_KEY:
            _, gid, bucket = group_key
            return self._run_fused_batch(gid, bucket, items)
        return self._run_embed_batch(*group_key, items)

    def _run_embed_batch(self, task: str, bucket: int,
                         exit_layer: Optional[int],
                         output_dim: Optional[int],
                         items: List[BatchItem]) -> Sequence[Any]:
        """One embedding forward: rows padded to a power of two, stacked to
        the bucket edge; host float32 rows out, one per item."""
        t = self._require(task, kind="embedding")
        n = len(items)
        padded_n = pow2_batch(n, self.cfg.max_batch_size)
        ids, mask, _ = self._stack_items(items, bucket, padded_n, t.pad_id)
        with self._lock:
            self._shapes.setdefault(f"task:{task}", set()).add(
                (padded_n, bucket))
        t0 = time.perf_counter()
        with torch.inference_mode():
            emb = t.module(torch.from_numpy(ids).to(self.device),
                           torch.from_numpy(mask).to(self.device),
                           exit_layer=exit_layer, output_dim=output_dim)
            emb = emb.float().cpu().numpy()
        seconds = time.perf_counter() - t0
        with self._lock:
            self.trunk_forwards += 1
            self._steps.append({
                "group": f"task:{task}", "bucket": bucket, "flavor": "embed",
                "rows": n, "padded_rows": padded_n, "exit_layer": exit_layer,
                "output_dim": output_dim,
                "layers": t.module.model.layers_run(exit_layer),
                "seconds": seconds})
        return [emb[i] for i in range(n)]

    def _run_fused_batch(self, gid: str, bucket: int,
                         items: List[BatchItem]) -> Sequence[Any]:
        """One trunk forward for a batch MIXING member tasks: dedup
        identical encodings, pick the flavor the batch needs, run, demux."""
        g = self._groups_by_gid[gid]
        demux = g.demux
        # identical token sequences ride ONE trunk row: the trunk output
        # depends only on ids+mask; per-item task mixes differ at demux.
        # The clip flag is part of the key so truncation accounting never
        # cross-attributes.
        urow: List[int] = []
        uniq: List[BatchItem] = []
        index: Dict[bytes, int] = {}
        for item in items:
            enc = item.payload.encoding
            L = min(len(enc), bucket)
            key = (np.asarray(enc.ids[:L], np.int64).tobytes() + b"|"
                   + np.asarray(enc.attention_mask[:L], np.int64).tobytes()
                   + (b"|c" if len(enc) > bucket else b"|f"))
            at = index.get(key)
            if at is None:
                at = index[key] = len(uniq)
                uniq.append(item)
            urow.append(at)
        if len(uniq) < len(items):
            with self._lock:
                self.fused_dedup_rows += len(items) - len(uniq)
        # a batch with no token items never pays the per-token head matmul
        kinds = {self._tasks[t].kind for item in items
                 for t in item.payload.tasks if t in self._tasks}
        need_tok = "token" in kinds
        need_seq = "sequence" in kinds or not need_tok
        flavor = "both" if (need_tok and need_seq) \
            else ("tok" if need_tok else "seq")
        return self._run_fused_unpacked(g, bucket, items, urow, uniq,
                                        demux, flavor)

    def _run_fused_unpacked(self, g: TrunkGroup, bucket: int,
                            items: List[BatchItem], urow: List[int],
                            uniq: List[BatchItem], demux: dict,
                            flavor: str) -> Sequence[Any]:
        """The fixed-row fused path: one trunk row per unique encoding,
        padded to the bucket edge."""
        padded_n = pow2_batch(len(uniq), self.cfg.max_batch_size)
        ids, mask, clipped = self._stack_items(uniq, bucket, padded_n,
                                               g.pad_id)
        meta = self._serving_meta(demux)
        use_bgmv = meta["bgmv"] and flavor in ("seq", "both")
        pair_index: Dict[tuple, int] = {}
        pairs: tuple = ()
        if use_bgmv:
            pr, pt, pair_index = self._bgmv_pairs(items, urow, demux)
            pairs = (pr, pt)
        with self._lock:
            self._shapes.setdefault(f"trunk:{g.gid}", set()).add(
                (padded_n, bucket))
        t0 = time.perf_counter()
        with torch.inference_mode():
            ids_t = torch.from_numpy(ids).to(self.device)
            mask_t = torch.from_numpy(mask).to(self.device)
            pairs_t = [torch.from_numpy(a).to(self.device) for a in pairs]
            seq_t, tok_t = g.forward(ids_t, mask_t, flavor, demux,
                                     meta["epilogue"], *pairs_t)
            seq_logits = seq_t.float().cpu().numpy() \
                if seq_t is not None else None
            tok_logits = tok_t.float().cpu().numpy() \
                if tok_t is not None else None
        seconds = time.perf_counter() - t0
        with self._lock:
            self.trunk_forwards += 1
            self._steps.append({
                "group": g.gid, "bucket": bucket, "flavor": flavor,
                "rows": len(uniq), "padded_rows": padded_n,
                "quant": meta["quant"],
                "epilogue": meta["epilogue"], "bgmv": use_bgmv,
                "pairs": len(pair_index),
                "padded_pairs": len(pairs[0]) if pairs else 0,
                "seconds": seconds})

        now = time.perf_counter()
        out: List[Any] = []
        for i, item in enumerate(items):
            enc = item.payload.encoding
            L = min(len(enc), bucket)
            latency = now - item.payload.submit_t
            trunc = enc.truncated or clipped[urow[i]]
            per_task: Dict[str, Any] = {}
            for task in item.payload.tasks:
                if self._tasks[task].kind == "token":
                    row = demux["tok_row_of"][task]
                    width = demux["tok_widths"][row]
                    probs = _softmax(tok_logits[urow[i], :L, row, :width])
                    per_task[task] = self._demux_tok(task, probs, item, enc,
                                                     L, latency, trunc)
                else:
                    row = demux["row_of"][task]
                    width = demux["widths"][row]
                    # the BGMV path demuxes by PAIR: same logits, gathered
                    # on the device
                    src = seq_logits[pair_index[(urow[i], row)], :width] \
                        if use_bgmv else seq_logits[urow[i], row, :width]
                    p = _softmax(src[None])[0]
                    per_task[task] = self._demux_seq(task, p, latency, trunc)
            out.append(per_task[item.payload.tasks[0]]
                       if len(item.payload.tasks) == 1 else per_task)
        return out

    def _bgmv_pairs(self, items: List[BatchItem], urow: List[int],
                    demux: dict):
        """(pair_rows, pair_tasks, pair_index) for the BGMV path: one pair
        per distinct (trunk row, bank row) a sequence task of this batch
        needs, in first-appearance order — deduped items share pairs as
        they share trunk rows.  The pair axis pads to a power of two with
        dummy pairs (row 0, task 0) that demux to nothing."""
        pair_index: Dict[tuple, int] = {}
        for i, item in enumerate(items):
            for task in item.payload.tasks:
                t = self._tasks.get(task)
                if t is None or t.kind == "token":
                    continue
                key = (urow[i], demux["row_of"][task])
                if key not in pair_index:
                    pair_index[key] = len(pair_index)
        n = max(1, len(pair_index))
        p_pad = 1 << (n - 1).bit_length()
        pr = np.zeros(p_pad, np.int32)
        pt = np.zeros(p_pad, np.int32)
        for (u, row), p in pair_index.items():
            pr[p] = u
            pt[p] = row
        return pr, pt, pair_index

    def _demux_seq(self, task: str, p: np.ndarray, latency_s: float,
                   truncated: bool) -> ClassResult:
        """Decode one item's softmaxed sequence logits with ITS label set
        (a label list narrower than the head names classes by index)."""
        idx = int(p.argmax())
        labels = self._tasks[task].labels
        return ClassResult(
            label=labels[idx] if idx < len(labels) else str(idx),
            index=idx,
            confidence=float(p[idx]),
            probs={(labels[j] if j < len(labels) else str(j)): float(p[j])
                   for j in range(p.shape[-1])},
            latency_s=latency_s,
            truncated=truncated,
        )

    def _demux_tok(self, task: str, tok_probs: np.ndarray, item,
                   enc: Encoding, L: int, latency_s: float,
                   truncated: bool) -> TokenClassResult:
        """Decode one item's per-token probabilities into entity spans
        with exact char offsets."""
        t = self._tasks[task]
        pred = tok_probs.argmax(-1)
        labels = [t.labels[j] if j < len(t.labels) else str(j) for j in pred]
        scores = [float(tok_probs[k, j]) for k, j in enumerate(pred)]
        spans = decode_entity_spans(item.payload.text, enc.offsets[:L],
                                    labels, scores,
                                    threshold=item.payload.threshold)
        return TokenClassResult(entities=[EntitySpan(**s) for s in spans],
                                latency_s=latency_s, truncated=truncated)


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)
