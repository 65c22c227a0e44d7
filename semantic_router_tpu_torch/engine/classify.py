"""The inference engine: the fused classifier bank, the per-task path and
the embedding tasks behind the batcher, every step a CUDA graph on the
card.

The port of ``semantic_router_tpu.engine.classify``:

- tasks register a ModernBERT sequence or token classifier (or a LoRA-head
  classifier) + tokenizer + label set; classifiers whose trunk tensors
  hold the SAME CONTENT (blake2b digests, memoized per tensor), and whose
  tokenizer, max_seq_len, pad id and config agree, form a ``TrunkGroup``:
  two checkpoint files with one frozen trunk fuse.  A module that joins
  an existing group is served through the group's trunk (its own trunk is
  never copied to the device);
- a module the bank cannot stack, a task registered with ``fuse=False``,
  and every task under ``engine.fuse_trunks: false`` serve per task: each
  batches on its own under (task, bucket) through the module's own
  float32 forward, whatever ``engine.quant`` says;
- fused requests flow through the DynamicBatcher keyed by (trunk group,
  seq bucket): one trunk forward per batch serves sequences of every
  member task, and the members' heads apply as one stacked head bank
  (models.lora.apply_head_bank), whose logits demux back to each item's
  own task and label set with a host softmax over the true label width;
- identical encodings in a fused batch share one trunk row; rows pad to a
  power of two and sequences to the bucket edge;
- sequence packing (``engine.packing``, on by default as the reference's):
  the batcher is always a ``PackingBatcher`` (engine.packing.scheduler),
  whose hooks compose length-aware, continuously admitted steps for a
  fused group on ``dense`` attention (and delegate to the fixed-row
  batching otherwise, or under ``enabled: false``).  A fused batch of at
  least ``min_segments`` unique encodings packs when the first-fit plan
  needs fewer padded rows than one row per encoding (or when the take
  holds more encodings than ``max_batch_size``): the encodings bin-pack
  into shared rows (engine.packing.packer) under a block-diagonal mask
  with per-segment RoPE positions, the sequence heads pool PER SEGMENT
  ([K_pad, D]; a BGMV pair indexes a segment) and the token heads read
  each segment's span.  A packed step is keyed on (bucket, padded rows,
  K_pad, pairs, epilogue, bgmv), catalogued as
  ``packed:<flavor>:<K_pad>[:p<pairs>]`` and recorded under the
  runtimestats variant ``packed`` with its token fill; the shape
  auto-tuner (engine.packing.autotuner, its thread the bootstrap's)
  retunes segment caps and demotes buckets from those series.
  ``warmup`` also runs each packed flavor at 1 row and K_pad 2, and
  ``warmup_packed_hot`` re-runs the packed shapes a snapshot change
  dropped (its census carried over as warm hints);
- ``classify_windowed`` classifies a text past ``max_seq_len`` as stride
  windows (utils.tokenization.encode_windows) on the per-task path and
  combines their probabilities by content share;
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
  under any ``engine.quant``;
- a classifier with no stackable head (DeBERTa-v3 sequence and token
  classifiers) serves on the per-task path;
- ``generative`` tasks (``register_generative``: a Qwen3 guard or
  multi-LoRA generative classifier behind a ``GreedyGenerator``) bypass
  the batcher: ``generate`` runs one generation at a time under
  ``_generative_lock``, its adapter selected by name, its prefill and
  decode steps in the task's step cache under the engine's capture gate;
  ``guard_classify`` parses the guard's verdict;
- the stacked multi-task LoRA bank (``register_stacked_bank``: a
  ``MultiTaskLoRAClassifier`` whose sequence tasks are also registered
  traditionally) is the second execution path of ``classify_multi``: one
  trunk pass serves every task, as a step captured once per (padded rows,
  bucket) in the bank's own step cache; ``engine.pathing``'s
  ``DualPathChooser`` picks per call between it and the traditional path
  (trunk group or per-task), learning from the outcome of each, and a
  stacked pass that fails or outlives its half of the deadline fails open
  to the traditional path;
- ``multimodal`` tasks (``register_multimodal``: a SigLIP
  ``SiglipEmbedder``) bypass the batcher too: ``embed_multimodal``
  embeds texts and images into the shared space, each tower step in the
  task's step cache under the engine's capture gate;
- every step runs through a compiled-step cache (engine.graphs): on the
  card the first execution of a (group, variant, bucket, rows, ...) key
  is captured as a CUDA graph and later ones replay it, as the JAX
  engine compiles a shape once; a group's cache lives in its demux
  snapshot, so a bank rebuild, a quant flip or a kernels flip starts the
  group on an empty one.  ``warmup`` captures every bucket at batch 1;
- observability, as the JAX engine's: every step is one
  ``runtimestats.record_step`` (``steps()`` is a view of that record), a
  step key's first execution is counted into the program catalog
  (``programstats``: FLOPs and bytes), the step feeds the canonical
  series (trunk forwards, kernel steps, truncated inputs, bucket
  overflows, dedup rows, tokenizations), and a batch carrying a request
  trace opens a ``batch.execute`` step span with the requests'
  ``batch.wait`` / ``batch.tokenize`` / ``batch.ride`` spans
  (observability.batchtrace).  A sampled trace's plain fused step (seq
  flavor, quant off, no epilogue, no BGMV) runs as two fenced eager
  calls, trunk then heads, under the variant ``fused_detailed``.

The serving mesh of the JAX engine is not ported (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import hashlib
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
import threading
import time
import weakref
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence

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
from ..observability import batchtrace
from ..observability.profiler import trace_span
from ..ops.attention import (
    cls_pool,
    mean_pool,
    packed_cls_pool,
    packed_mean_pool,
)
from ..utils.device import DeviceLike, resolve_device
from ..utils.tokenization import (
    Encoding,
    Tokenizer,
    decode_entity_spans,
    encode_windows,
)
from .batcher import BatchItem, pick_bucket, pow2_batch
from .graphs import (
    CaptureGate,
    SnapshotRetired,
    StepGraphs,
    on_first_execution,
)
from .kernels import normalize_kernels, normalize_quant, quant_selects
from .packing import (
    PackingBatcher,
    RowPlan,
    ShapeAutoTuner,
    normalize_packing,
    pack_items,
)
from .pathing import (
    STACKED,
    TRADITIONAL,
    DualPathChooser,
    PathMetrics,
    PathSelection,
    ProcessingRequirements,
)

# batch-group key prefix for fused trunk groups
TRUNK_KEY = "__trunk__"

# content digests of trunk tensors, memoized by (id, version) with a
# weakref guard: a recycled id recomputes instead of serving a stale
# digest, and an in-place write bumps the tensor's version.  K tasks
# registered over the SAME trunk hash each tensor once.
_LEAF_DIGESTS: Dict[tuple, tuple] = {}
_LEAF_DIGESTS_LOCK = threading.Lock()


def _leaf_digest(t: torch.Tensor) -> str:
    """Content address of one tensor: blake2b over dtype, shape and
    bytes.  Registration-time only, never on the hot path."""
    key = (id(t), t._version)
    with _LEAF_DIGESTS_LOCK:
        hit = _LEAF_DIGESTS.get(key)
    if hit is not None:
        ref, digest = hit
        if ref() is t:
            return digest
    x = t.detach().contiguous().cpu()
    h = hashlib.blake2b(digest_size=16)
    h.update(str(x.dtype).encode())
    h.update(str(tuple(x.shape)).encode())
    h.update(x.reshape(-1).view(torch.uint8).numpy().data)
    digest = h.hexdigest()
    with _LEAF_DIGESTS_LOCK:
        _LEAF_DIGESTS[key] = (weakref.ref(t), digest)
        if len(_LEAF_DIGESTS) > 4096:
            # sweep entries whose tensors died (re-registrations would
            # otherwise grow the memo by one stale tuple per tensor)
            for k in [k for k, (r, _d) in _LEAF_DIGESTS.items()
                      if r() is None]:
                del _LEAF_DIGESTS[k]
    return digest


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
    # "sequence" | "token" | "embedding" | "generative" | "multimodal"
    kind: str
    labels: List[str]
    tokenizer: Tokenizer
    module: nn.Module
    max_seq_len: int
    pad_id: int = 0
    # the per-task, embedding and generation steps' compiled-step cache
    graphs: Optional[StepGraphs] = None
    # generative kind: the GreedyGenerator, and adapter name → LoRA row;
    # multimodal kind: the SiglipEmbedder
    generator: Any = None
    adapter_index: Dict[str, int] = field(default_factory=dict)


@dataclass
class _Payload:
    text: str
    encoding: Encoding
    threshold: float = 0.5
    # member tasks this item needs logits for: one task → the future
    # resolves that task's result; several → a {task: result} dict
    tasks: tuple = ()
    submit_t: float = field(default_factory=time.perf_counter)
    # host tokenization cost for batch tracing (a batch.tokenize span
    # per traced request): seconds spent encoding, and whether the
    # request's EncodingCache already held the encoding
    tok_s: float = 0.0
    tok_cached: bool = False


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
    # tok_row_of, tok_widths, graphs}: a runner reads ONE consistent view,
    # so a concurrent re-registration or quant flip never pairs new row
    # indices (or a new serving trunk, or graphs captured over the old
    # tensors) with old ones
    demux: Any = None
    # packed shapes (bucket, K_pad, padded rows, flavor, pairs) a replaced
    # snapshot had run, for warmup_packed_hot to run again
    warm_hints: Any = None

    def forward(self, ids: torch.Tensor, mask: torch.Tensor, flavor: str,
                demux: dict, epilogue: bool,
                pair_rows: Optional[torch.Tensor] = None,
                pair_tasks: Optional[torch.Tensor] = None,
                packing: Optional[tuple] = None):
        """One trunk forward feeding the head banks the flavor needs:
        ``seq`` → [B, T, L] logits, ``tok`` → [B, S, T, L], ``both`` →
        both.  With (pair_rows, pair_tasks) the sequence bank runs per
        pair (BGMV) and ``seq`` is [P, L].  ``packing``: (position_ids,
        segment_ids, seg_row, seg_start) of a packed step — the trunk runs
        packed and the sequence heads take one pooled row per segment
        (``seq`` is [K_pad, T, L], or [P, L] with pairs over segments).
        The serving trunk (and its compute dtype) is the snapshot's; the
        heads take float32.  Returns (seq_logits or None, tok_logits or
        None)."""
        cfg = self.config
        if packing is None:
            hidden = demux["trunk"](ids, mask)
        else:
            hidden = demux["trunk"](ids, mask, position_ids=packing[0],
                                    segment_ids=packing[1])
        seq = tok = None
        if flavor in ("seq", "both"):
            pooled = self.pool(hidden, mask) if packing is None \
                else self.packed_pool(hidden, *packing[1:])
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

    def pool(self, hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The sequence heads' float32 features: mean or CLS pooling."""
        pooled = mean_pool(hidden, mask) \
            if self.config.classifier_pooling == "mean" else cls_pool(hidden)
        return pooled.float()

    def packed_pool(self, hidden: torch.Tensor, segment_ids: torch.Tensor,
                    seg_row: torch.Tensor,
                    seg_start: torch.Tensor) -> torch.Tensor:
        """Per-segment float32 features of a packed step: [K_pad, D]."""
        pooled = packed_mean_pool(hidden, segment_ids, seg_row.shape[0]) \
            if self.config.classifier_pooling == "mean" \
            else packed_cls_pool(hidden, seg_row, seg_start)
        return pooled.float()

    def heads(self, demux: dict, pooled: torch.Tensor) -> torch.Tensor:
        """The sequence head bank over pooled features, plain einsums (the
        detailed step's second call)."""
        cfg = self.config
        return apply_head_bank(demux["bank"], pooled,
                               cfg.classifier_activation, cfg.norm_eps)


@dataclass
class StackedBank:
    """The registered multi-task LoRA bank: the second execution path of
    its sequence tasks."""

    module: nn.Module          # MultiTaskLoRAClassifier on the device
    tokenizer: Tokenizer
    tasks: List[str]           # the bank's sequence tasks, in bank order
    max_seq_len: int
    pad_id: int
    graphs: StepGraphs         # the stacked steps' compiled-step cache


class InferenceEngine:
    """Owner of the served classifier tasks + the batching shim.

    ``device``: where the models run — ``cuda`` when None (raises without
    a GPU), or the caller's explicit choice such as ``"cpu"``.
    ``metrics`` (a MetricSeries), ``runtime_stats`` and ``program_stats``
    bind the engine's observability (None: the process defaults)."""

    def __init__(self, cfg: Optional[InferenceEngineConfig] = None,
                 device: DeviceLike = None, metrics=None,
                 runtime_stats=None, program_stats=None) -> None:
        self.cfg = cfg or InferenceEngineConfig()
        self.device = resolve_device(device)
        self._metrics = metrics
        if runtime_stats is None:
            from ..observability.runtimestats import default_runtime_stats

            runtime_stats = default_runtime_stats
        self._runtime_stats = runtime_stats
        if program_stats is None:
            from ..observability.programstats import default_program_stats

            program_stats = default_program_stats
        self._program_stats = program_stats
        program_stats.device = self.device.type
        self._tasks: Dict[str, _Task] = {}
        self._lock = threading.Lock()
        self._kernels = normalize_kernels(self.cfg.kernels)
        self._quant = normalize_quant(self.cfg.quant)
        self._kernel_rebuilds = 0
        self._trunk_groups: Dict[tuple, TrunkGroup] = {}
        self._task_group: Dict[str, TrunkGroup] = {}
        self._groups_by_gid: Dict[str, TrunkGroup] = {}
        self._next_gid = 0  # monotonic: eviction never recycles a gid
        # distinct device batch shapes executed per batch group
        # (shape_census())
        self._shapes: Dict[str, set] = {}
        # step caches a change of snapshots replaced, retired once the
        # change releases the lock (_changing)
        self._stale: List[StepGraphs] = []
        # changes that retired a replaced snapshot (``_changing``)
        self._retirements = 0
        # replays share the gate, a capture holds it alone
        self._gate = CaptureGate()
        # one generation runs at a time (its decode steps saturate the
        # card; concurrency comes from the classify batcher)
        self._generative_lock = threading.Lock()
        self.trunk_forwards = 0
        self.fused_dedup_rows = 0
        # the dual path: the stacked bank, its one-worker pool, the
        # chooser and the last call's selection (register_stacked_bank)
        self._stacked: Optional[StackedBank] = None
        self._stacked_pool: Optional[ThreadPoolExecutor] = None
        self.path_chooser: Optional[DualPathChooser] = None
        self.last_path_selection: Optional[PathSelection] = None
        # sequence packing: the batcher is ALWAYS the packing scheduler;
        # with packing off every hook delegates to the fixed-row base
        # class, so the knob flips without swapping a live batcher
        self._packing = normalize_packing(self.cfg.packing)
        self._autotuner: Optional[ShapeAutoTuner] = None
        self.batcher = PackingBatcher(
            self._run_batch,
            bucket_of=self._packing_bucket_of,
            segment_cap_of=self._packing_segment_cap_of,
            max_batch_size=self.cfg.max_batch_size,
            max_wait_ms=self.cfg.max_wait_ms,
            name="torch-engine-batcher",
            dispatch_workers=self.cfg.dispatch_workers,
            metrics=metrics,
            enabled=self._packing["enabled"],
            max_segments_per_row=self._packing["max_segments_per_row"],
            max_items_per_step=self._packing["max_items_per_step"],
            max_inflight_steps=self._packing["max_inflight_steps"],
            starvation_steps=self._packing["starvation_steps"])
        # the shape auto-tuner exists per engine; its polling thread is
        # the bootstrap's to start (apply_packing_knobs)
        at = self._packing["autotune"]
        self._autotuner = ShapeAutoTuner(
            runtime_stats, self.batcher,
            target_fill=at["target_fill"], min_samples=at["min_samples"],
            segments_floor=self._packing["max_segments_per_row"],
            max_segments_cap=at["max_segments_cap"],
            interval_s=at["interval_s"])
        # the sampler's queue-depth and graph-pool rows
        self._queue_provider = self.batcher.queue_depths
        self._memory_provider = lambda: {"graph_pool_bytes": sum(
            r["pool_bytes"] for r in self.graph_report().values())}
        runtime_stats.register_provider(self.batcher.name,
                                        self._queue_provider)
        runtime_stats.register_memory_provider(f"engine:{id(self):x}",
                                               self._memory_provider)

    # -- registration ------------------------------------------------------

    def register_task(self, name: str, kind: str, module: nn.Module,
                      tokenizer: Tokenizer, labels: List[str],
                      max_seq_len: int = 0, pad_id: int = 0,
                      fuse: Optional[bool] = None) -> None:
        """Register a sequence or token classifier (``module(ids, mask)`` →
        logits), or an ``MmBertEmbeddingModel`` (kind ``embedding``).  The
        module moves to the engine's device.

        ``fuse``: join the fused classifier bank when the module's head
        stacks and its trunk's content + tokenizer match another task's
        (None → ``engine.fuse_trunks``).  A module that joins a group
        whose trunk is another object of equal content has its ``model``
        set to the group's trunk, so one device copy serves both.  Any
        other classifier serves per task; re-registering a fused member
        that way leaves the group."""
        if kind not in ("sequence", "token", "embedding"):
            raise ValueError(f"unknown task kind {kind!r}")
        if kind == "embedding" and not isinstance(module,
                                                  MmBertEmbeddingModel):
            raise ValueError(f"task {name!r}: an embedding task takes an "
                             f"MmBertEmbeddingModel, got "
                             f"{type(module).__name__}")
        max_len = max_seq_len or self.cfg.seq_len_buckets[-1]
        entry = tkey = None
        want_fuse = self.cfg.fuse_trunks if fuse is None else bool(fuse)
        if kind != "embedding":
            entry = head_bank_entry(module)
            if entry is not None and entry["kind"] != kind:
                raise ValueError(f"task {name!r}: kind {kind!r} but the "
                                 f"module is a {entry['kind']} classifier")
            if want_fuse and entry is not None:
                # hashed on the caller's tensors, before the device move
                tkey = self._trunk_fingerprint(module, tokenizer, max_len,
                                               pad_id)
        if tkey is not None:
            with self._lock:
                g = self._trunk_groups.get(tkey)
                if g is not None and module.model is not g.trunk:
                    module.model = g.trunk
        module = module.to(self.device).eval()
        task = _Task(name, kind, list(labels), tokenizer, module, max_len,
                     pad_id, graphs=StepGraphs(self.device, self._gate,
                                               f"task:{name}"))
        with self._changing():
            old = self._tasks.get(name)
            self._tasks[name] = task
            if old is not None:
                self._stale.append(old.graphs)
        if tkey is not None:
            self._join_trunk_group(tkey, name, module, tokenizer, entry,
                                   max_len, pad_id)
        else:
            # re-registration as non-fusable (fuse=False, a new kind, a
            # module the bank cannot stack) leaves no stale fused member
            with self._changing():
                self._evict_locked(name)

    def register_generative(self, name: str, generator,
                            labels: Optional[List[str]] = None,
                            adapter_index: Optional[Dict[str, int]] = None
                            ) -> None:
        """Register a KV-cached greedy generator
        (``models.generate.GreedyGenerator`` on this engine's device) as a
        ``generative`` task.  ``adapter_index`` maps adapter names to LoRA
        rows, so a request selects its adapter by name.  The generator's
        prefill and decode steps join the engine's step caches, under its
        capture gate; generative tasks are never batched, fused or
        warmed."""
        if generator.device != self.device:
            raise ValueError(f"task {name!r}: the generator runs on "
                             f"{generator.device}, the engine on "
                             f"{self.device}")
        generator.graphs = StepGraphs(self.device, self._gate,
                                      f"task:{name}")
        task = _Task(name, "generative", list(labels or []),
                     generator.tokenizer, generator.model, 0,
                     graphs=generator.graphs, generator=generator,
                     adapter_index=dict(adapter_index or {}))
        with self._changing():
            old = self._tasks.get(name)
            self._tasks[name] = task
            if old is not None:
                self._stale.append(old.graphs)
            self._evict_locked(name)

    def register_multimodal(self, name: str, embedder) -> None:
        """Register a shared text/image embedding space
        (``models.siglip.SiglipEmbedder`` on this engine's device) as a
        ``multimodal`` task.  Its tower steps join the engine's step
        caches, under its capture gate; multimodal tasks are never
        batched, fused or warmed."""
        device = getattr(embedder, "device", self.device)
        if device != self.device:
            raise ValueError(f"task {name!r}: the embedder runs on "
                             f"{device}, the engine on {self.device}")
        graphs = StepGraphs(self.device, self._gate, f"task:{name}")
        if hasattr(embedder, "graphs"):
            embedder.graphs = graphs
        task = _Task(name, "multimodal", [],
                     getattr(embedder, "tokenizer", None),
                     getattr(embedder, "model", None), 0, graphs=graphs,
                     generator=embedder)
        with self._changing():
            old = self._tasks.get(name)
            self._tasks[name] = task
            if old is not None:
                self._stale.append(old.graphs)
            self._evict_locked(name)

    def embed_multimodal(self, task: str, texts: Optional[Sequence[str]] = None,
                         images=None,
                         image_refs: Optional[Sequence[str]] = None
                         ) -> Dict[str, np.ndarray]:
        """Embed texts and/or images into the task's shared space:
        {"text": [n, d], "image": [m, d]}, only the keys asked for.
        ``images`` are preprocessed float arrays [m, H, W, C] and win
        over ``image_refs`` (wire references, data URIs or base64,
        decoded on the host).  Cross-modal similarity is the dot
        product."""
        t = self._require(task, kind="multimodal")
        out: Dict[str, np.ndarray] = {}
        if texts:
            out["text"] = t.generator.embed_text(list(texts))
        if images is not None and len(images):
            out["image"] = t.generator.embed_image(images)
        elif image_refs:
            out["image"] = t.generator.embed_image_refs(list(image_refs))
        return out

    def generate(self, task: str, prompts: Sequence[str],
                 max_new_tokens: int = 64, adapter: str = "",
                 stop_strings: Sequence[str] = ()) -> List[Any]:
        """Greedy generation on a generative task; ``adapter`` selects the
        LoRA row by name (an unknown name raises ``KeyError``: a silent
        row-0 fallback would run the wrong policy)."""
        t = self._require(task, kind="generative")
        if adapter:
            if adapter not in t.adapter_index:
                raise KeyError(
                    f"unknown adapter {adapter!r} for task {task!r} "
                    f"(known: {sorted(t.adapter_index)})")
            task_index = t.adapter_index[adapter]
        else:
            task_index = 0
        with self._generative_lock:
            return t.generator.generate(list(prompts),
                                        max_new_tokens=max_new_tokens,
                                        task_index=task_index,
                                        stop_strings=stop_strings)

    def guard_classify(self, task: str, text: str, role: str = "user",
                       adapter: str = "", max_new_tokens: int = 32):
        """Qwen3Guard-style safety classification: structured-output
        generation + regex parse.  Returns a ``GuardVerdict``; parse
        failures fail closed to Controversial."""
        from ..models.generate import build_guard_prompt, parse_guard_output

        out = self.generate(task, [build_guard_prompt(text, role=role)],
                            max_new_tokens=max_new_tokens, adapter=adapter)
        return parse_guard_output(out[0].text)

    @contextlib.contextmanager
    def _changing(self):
        """Hold the engine lock for a change of snapshots, then retire the
        step caches the change replaced (``self._stale``) after releasing
        it.  The new snapshot is live before the old one retires, so a
        batch that raises ``SnapshotRetired`` on the old one finds the new
        one when it runs again; and a retire's wait for running replays
        and captures holds no lock a batch takes."""
        try:
            with self._lock:
                yield
        finally:
            with self._lock:
                stale, self._stale = self._stale, []
                if stale:
                    self._retirements += 1
            for cache in stale:
                cache.retire()

    @staticmethod
    def _trunk_fingerprint(module, tokenizer, max_seq_len: int,
                           pad_id: int) -> Optional[tuple]:
        """Grouping key: the trunk's tensors by CONTENT (parameters and
        buffers in name order), a content-equivalent tokenizer, and
        compatible shape discipline (label width is per head, never part
        of the trunk identity).  None when the module has no trunk."""
        trunk = getattr(module, "model", None)
        cfg = getattr(module, "config", None)
        if trunk is None or cfg is None:
            return None
        tensors = list(trunk.named_parameters()) + list(trunk.named_buffers())
        leaf_key = tuple((n, _leaf_digest(t)) for n, t in tensors)
        cfg_key = repr(replace(cfg, num_labels=0))
        return (leaf_key, _tokenizer_fingerprint(tokenizer),
                int(max_seq_len), int(pad_id), cfg_key)

    def _evict_locked(self, name: str) -> None:
        """Remove a task from its trunk group (caller is ``_changing``):
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
            self._stale.append(g.demux["graphs"])

    def _join_trunk_group(self, tkey: tuple, name: str, module, tokenizer,
                          entry: dict, max_len: int, pad_id: int) -> None:
        with self._changing():
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
        self._publish(g, {
            "trunk": trunk,
            "quant": mode,
            "bank": stack(seq_idx),
            "tok_bank": stack(tok_idx),
            "row_of": {g.members[i]: r for r, i in enumerate(seq_idx)},
            "widths": [width(i) for i in seq_idx],
            "tok_row_of": {g.members[i]: r for r, i in enumerate(tok_idx)},
            "tok_widths": [width(i) for i in tok_idx],
        })

    def _publish(self, g: TrunkGroup, demux: dict) -> None:
        """Swap in a demux snapshot with an empty step cache; the old
        snapshot's graphs retire when the change ends (caller is
        ``_changing``): a graph holds the addresses of the bank and trunk
        tensors it was captured with."""
        demux["graphs"] = StepGraphs(self.device, self._gate,
                                     f"trunk:{g.gid}")
        old, g.demux = g.demux, demux
        if old is not None:
            self._stale.append(old["graphs"])
            # the packed shapes the old snapshot ran stay hot: merged
            # into the hints warmup_packed_hot runs on the new one
            rows = _parse_census_keys(old["graphs"].keys())
            if rows:
                g.warm_hints = sorted(set(rows) | set(g.warm_hints or ()))

    # -- kernel knobs ------------------------------------------------------

    def configure_kernels(self, knobs: Optional[Dict[str, Any]]) -> None:
        """Apply an ``engine.kernels`` block (boot or reload).  The next
        batch serves under it; a change gives every trunk group a new
        snapshot with an empty step cache (an in-flight batch on the old
        one runs again on the new one)."""
        kk = normalize_kernels(knobs)
        with self._changing():
            changed, self._kernels = kk != self._kernels, kk
            if changed:
                self._kernel_rebuilds += 1
                # graphs were captured under the old toggles.  The toggles
                # change first: a batch reads its snapshot, then the
                # toggles, so a new snapshot never serves the old ones
                for g in list(self._groups_by_gid.values()):
                    self._publish(g, dict(g.demux))

    def configure_quant(self, knobs: Optional[Dict[str, Any]]) -> None:
        """Apply an ``engine.quant`` block (boot or reload): each trunk
        group whose mode changes gets a new serving trunk (the int8
        weights quantize here, once) in a new demux snapshot, with an
        empty step cache; the others keep theirs.  An in-flight batch on a
        retired snapshot runs again on the new one."""
        qk = normalize_quant(knobs)
        with self._lock:
            todo = [(g, quant_selects(qk, g.gid, g.members))
                    for g in self._groups_by_gid.values()]
        # the new serving trunks are built before the change, holding the
        # capture gate shared: an int8 trunk quantizes on the card, and a
        # reload runs under traffic, whose steps may be capturing
        with self.device_work():
            built = {g.gid: (mode, build_quant_trunk(g.trunk, mode))
                     for g, mode in todo if mode != g.demux["quant"]}
        with self._changing():
            self._quant = qk
            for g in list(self._groups_by_gid.values()):
                mode = quant_selects(qk, g.gid, g.members)
                if mode != g.demux["quant"]:
                    ready = built.get(g.gid)
                    trunk = ready[1] if ready and ready[0] == mode \
                        else build_quant_trunk(g.trunk, mode)
                    self._publish(g, dict(g.demux, quant=mode, trunk=trunk))
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

    # -- sequence packing --------------------------------------------------

    def _packing_bucket_of(self, key: Hashable) -> Optional[int]:
        """The packing scheduler's eligibility callback: the row length of
        a group the fused runner can PACK (a fused trunk group on dense
        attention whose bucket the auto-tuner has not demoted), else
        None (the scheduler then keeps the fixed-row batching)."""
        if not (isinstance(key, tuple) and len(key) == 3
                and key[0] == TRUNK_KEY):
            return None
        g = self._groups_by_gid.get(key[1])
        if g is None or g.config.attention_impl != "dense":
            return None
        tuner = self._autotuner
        if tuner is not None and tuner.blocked(f"trunk:{key[1]}", key[2]):
            return None
        return int(key[2])

    def _packing_segment_cap_of(self, key: Hashable) -> int:
        """Per-group segment cap, the tuner's policy over the config
        default: the ONE value the scheduler's take and the runner's pack
        both use, so a planned step always re-plans identically."""
        base = self._packing["max_segments_per_row"]
        tuner = self._autotuner
        if tuner is None or not (isinstance(key, tuple) and len(key) == 3):
            return base
        pol = tuner.policy(f"trunk:{key[1]}")
        try:
            return max(1, int(pol.get("max_segments_per_row", base)))
        except (TypeError, ValueError):
            return base

    def configure_packing(self, knobs: Optional[Dict[str, Any]]) -> None:
        """Apply an ``engine.packing`` block (boot or reload): retunes the
        live scheduler and auto-tuner in place, no batcher swap.  Turning
        packing off drops the packed steps from every live step cache
        (their shapes kept as warm hints, so turning it on again warms
        them through ``warmup_packed_hot``) and retires their runtimestats
        and catalog rows."""
        pk = normalize_packing(knobs)
        was_enabled = bool(self._packing.get("enabled"))
        self._packing = pk
        if was_enabled and not pk["enabled"]:
            for g in list(self._groups_by_gid.values()):
                cache = g.demux["graphs"]
                rows = _parse_census_keys(cache.keys())
                cache.evict(lambda k: str(k[1]).startswith("packed:"))
                if rows:
                    g.warm_hints = sorted(set(rows)
                                          | set(g.warm_hints or ()))
            for store in (self._runtime_stats, self._program_stats):
                store.retire(variant_prefix="packed")
        self.batcher.configure(pk)
        at = pk["autotune"]
        tuner = self._autotuner
        tuner.target_fill = at["target_fill"]
        tuner.min_samples = at["min_samples"]
        tuner.max_segments_cap = at["max_segments_cap"]
        tuner.interval_s = max(0.5, at["interval_s"])
        # per-group caps grow from the (possibly retuned) config default
        tuner.segments_floor = pk["max_segments_per_row"]

    def packing_report(self) -> Dict[str, Any]:
        """The live knobs, the scheduler's state and the auto-tuner's
        policy (GET /debug/runtime's ``packing`` block)."""
        b = self.batcher
        return {
            "knobs": {k: (dict(v) if isinstance(v, dict) else v)
                      for k, v in self._packing.items()},
            "scheduler": {
                "enabled": b.enabled,
                "max_segments_per_row": b.max_segments_per_row,
                "max_items_per_step": b._item_budget(),
                "max_inflight_steps": b.max_inflight_steps,
                "starvation_steps": b.starvation_steps,
            },
            "autotuner": self._autotuner.report(),
        }

    def device_work(self):
        """A context for work a caller launches on the engine's device
        outside the engine's steps (a selector's fit): it holds the
        capture gate shared, so no CUDA graph capture runs meanwhile."""
        return self._gate.shared()

    # -- task metadata -----------------------------------------------------

    def has_task(self, name: str) -> bool:
        return name in self._tasks

    def task_kind(self, name: str) -> str:
        t = self._tasks.get(name)
        return t.kind if t is not None else ""

    def task_labels(self, name: str) -> List[str]:
        return list(self._tasks[name].labels)

    def tasks(self) -> List[str]:
        return list(self._tasks)

    def task_info(self, name: str) -> Dict[str, Any]:
        """Serving metadata: kind, max_seq_len, attention impl and, for a
        fused member, its trunk group."""
        t = self._tasks.get(name)
        if t is None:
            return {}
        impl = getattr(getattr(t.module, "config", None),
                       "attention_impl", None)
        info: Dict[str, Any] = {"task": name, "kind": t.kind,
                                "max_seq_len": t.max_seq_len}
        if impl:
            info["attention_impl"] = impl
        g = self._task_group.get(name)
        if g is not None:
            info["trunk_group"] = g.gid
        return info

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
        — the dispatcher's prefetch gate.  A trunk group always
        qualifies; the stacked bank only when the dual-path chooser would
        pick it now (claiming coverage while the chooser serves
        traditional would turn the prefetch into serial per-task
        forwards).  A concurrent record can still flip classify_multi's
        own choice after this check: the prefetch's timeout bounds that,
        and its results are read from the memo all the same."""
        tasks = list(tasks)
        if not tasks or any(self.task_kind(t) != "sequence" for t in tasks):
            return False
        if self._common_trunk_group(tasks) is not None:
            return True
        stacked = self._stacked
        if stacked is None or any(t not in stacked.tasks for t in tasks):
            return False
        sel = self.path_chooser.choose(
            ProcessingRequirements(tasks=tasks, batch_size=1))
        return sel.selected_path == STACKED

    def register_stacked_bank(self, module: nn.Module, tokenizer: Tokenizer,
                              max_seq_len: int = 0, pad_id: int = 0,
                              strategy: str = "adaptive") -> None:
        """Register a ``MultiTaskLoRAClassifier`` as the SECOND execution
        path of its sequence tasks: one trunk pass serves every task.
        Each of them must also be registered traditionally
        (``register_task``): both paths can serve, the chooser picks.
        ``strategy``: adaptive | latency | confidence | traditional |
        stacked (the last two pin the path).  The module moves to the
        engine's device; its steps capture in a cache of their own, which
        a re-registration retires with the old bank, and the old bank's
        one-worker pool retires with it.  The chooser's cost prior reads
        the runtime-stats step EWMAs (resilience.costmodel)."""
        from ..resilience.costmodel import CostModel, make_path_cost_prior

        kinds = getattr(module, "task_kinds", {}) or {}
        seq_tasks = [t for t in module.task_names
                     if kinds.get(t, "sequence") == "sequence"]
        for t in seq_tasks:
            if not self.has_task(t):
                raise ValueError(
                    f"stacked bank task {t!r} has no traditional "
                    "registration — register_task it first (dual-path "
                    "needs both)")
        module = module.to(self.device).eval()
        bank = StackedBank(
            module=module, tokenizer=tokenizer, tasks=seq_tasks,
            max_seq_len=max_seq_len or self.cfg.seq_len_buckets[-1],
            pad_id=pad_id,
            graphs=StepGraphs(self.device, self._gate, "stacked"))
        with self._changing():
            old, self._stacked = self._stacked, bank
            if old is not None:
                self._stale.append(old.graphs)
        # one worker: classify_multi waits on it with the caller's
        # budget; an abandoned run (a first capture) keeps going and
        # leaves its graph for the next attempt
        old_pool, self._stacked_pool = self._stacked_pool, \
            ThreadPoolExecutor(max_workers=1,
                               thread_name_prefix="stacked-bank")
        if old_pool is not None:
            old_pool.shutdown(wait=False)
        self.path_chooser = DualPathChooser(
            strategy=strategy,
            cost_prior=make_path_cost_prior(CostModel(self._runtime_stats)))
        self.last_path_selection = None

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
        cancelled future is dropped before its batch runs).  A fused
        member batches under its trunk group, any other task under
        (task, bucket)."""
        return self._submit(self._require(task, kind="sequence"), text,
                            enc_cache)

    def _submit(self, t: _Task, text: str, enc_cache=None,
                threshold: float = 0.5):
        g = self._task_group.get(t.name)
        # counted per task, as the reference does for one task's call
        enc, tok_s, cached = self._encode(g or t, text, enc_cache, t.name,
                                          (t.name,))
        bucket = pick_bucket(len(enc), self.cfg.seq_len_buckets)
        key = (TRUNK_KEY, g.gid, bucket) if g is not None \
            else (t.name, bucket)
        return self.batcher.submit(
            key, _Payload(text, enc, threshold, tasks=(t.name,),
                          tok_s=tok_s, tok_cached=cached))

    def classify_multi(self, tasks: Sequence[str], texts: Sequence[str],
                       timeout: float = 30.0, requirements=None,
                       enc_cache=None) -> Dict[str, List[ClassResult]]:
        """Classify the same texts under several sequence tasks.  With a
        stacked bank covering every task, the dual-path chooser decides
        between its one pass and the traditional path, learning from the
        outcome of each call; otherwise tasks of one trunk group ride ONE
        item per text (tokenized once, one trunk row, heads demuxed), and
        any other mix classifies task by task.  One deadline covers the
        whole call: a stacked attempt gets half of it (all of it when the
        strategy pins ``stacked``), and on a timeout or an error the call
        fails open to the traditional path with what is left.  The
        selection is left in ``last_path_selection``."""
        tasks = list(tasks)
        for t in tasks:
            self._require(t, kind="sequence")
        stacked = self._stacked
        chooser = self.path_chooser
        eligible = stacked is not None and len(tasks) > 0 and \
            all(t in stacked.tasks for t in tasks)
        req = requirements or ProcessingRequirements(
            tasks=tasks, batch_size=len(texts))
        if eligible:
            sel = chooser.choose(req)
        else:
            sel = PathSelection(TRADITIONAL, 1.0,
                                "no stacked bank covers these tasks",
                                PathMetrics())
        self.last_path_selection = sel
        deadline = time.perf_counter() + timeout

        def remaining() -> float:
            return max(0.05, deadline - time.perf_counter())

        if sel.selected_path == STACKED:
            t0 = time.perf_counter()
            budget = timeout if chooser.strategy == STACKED \
                else timeout / 2
            try:
                out = self._stacked_pool.submit(
                    self._stacked_run, tasks, texts,
                    enc_cache).result(budget)
            except FutureTimeout:
                chooser.record(STACKED, tasks, len(texts), budget, 0.0,
                               ok=True)
                self.last_path_selection = PathSelection(
                    TRADITIONAL, 1.0,
                    f"stacked pass exceeded {budget:g}s budget — serving "
                    "traditional", PathMetrics())
            except Exception:
                chooser.record(STACKED, tasks, len(texts),
                               time.perf_counter() - t0, 0.0, ok=False)
                self.last_path_selection = PathSelection(
                    TRADITIONAL, 1.0,
                    "stacked pass failed — fail-open to traditional",
                    PathMetrics())
            else:
                chooser.record(STACKED, tasks, len(texts),
                               time.perf_counter() - t0,
                               _mean_confidence(out, texts))
                return out

        t0 = time.perf_counter()
        group = self._common_trunk_group(tasks)
        if group is not None:
            out = self._fused_multi(group, tasks, texts, remaining(),
                                    enc_cache)
        else:
            out = {t: self.classify_batch(t, texts, timeout=remaining(),
                                          enc_cache=enc_cache)
                   for t in tasks}
        if eligible:
            chooser.record(TRADITIONAL, tasks, len(texts),
                           time.perf_counter() - t0,
                           _mean_confidence(out, texts))
        return out

    def _fused_multi(self, g: TrunkGroup, tasks: List[str],
                     texts: Sequence[str], timeout: float,
                     enc_cache=None) -> Dict[str, List[ClassResult]]:
        """The trunk-group fan-out: each text is ONE batch item carrying
        every requested task, submitted per bucket as one submit_many."""
        deadline = time.perf_counter() + timeout
        by_bucket: Dict[int, List[tuple]] = {}
        for ti, text in enumerate(texts):
            enc, tok_s, cached = self._encode(g, text, enc_cache, g.gid,
                                              tasks)
            bucket = pick_bucket(len(enc), self.cfg.seq_len_buckets)
            by_bucket.setdefault(bucket, []).append(
                (ti, _Payload(text, enc, tasks=tuple(tasks), tok_s=tok_s,
                              tok_cached=cached)))
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

    def _stacked_run(self, tasks: Sequence[str], texts: Sequence[str],
                     enc_cache=None) -> Dict[str, List[ClassResult]]:
        """One stacked pass: tokenize once, pad to (pow2 rows, bucket), run
        the bank's step (captured once per shape, replayed after), decode
        each requested task with ITS registered label set, width-tolerant
        as the traditional path decodes."""
        st = self._stacked
        n = len(texts)
        encs = [self._encode(st, text, enc_cache, "stacked",
                             ("stacked",))[0] for text in texts]
        bucket = pick_bucket(max((len(e) for e in encs), default=1),
                             self.cfg.seq_len_buckets)
        padded_n = pow2_batch(n, self.cfg.max_batch_size)
        ids = np.full((padded_n, bucket), st.pad_id, dtype=np.int64)
        mask = np.zeros((padded_n, bucket), dtype=np.int32)
        for i, enc in enumerate(encs):
            L = min(len(enc), bucket)
            ids[i, :L] = enc.ids[:L]
            mask[i, :L] = enc.attention_mask[:L]
        module, order = st.module, list(st.tasks)

        def step(ids, mask):
            logits = module(ids, mask)
            return tuple(logits[t] for t in order)

        self._note_shape("stacked", (padded_n, bucket))
        t0 = time.perf_counter()
        first: list = []
        with trace_span("engine.classify_multi.stacked",
                        cuda=self.device.type == "cuda"):
            outs, how = self._execute(
                st.graphs, "stacked", "stacked", (bucket, padded_n), step,
                [torch.from_numpy(ids), torch.from_numpy(mask)],
                (bucket, padded_n, "stacked", "stacked", None), first)
        secs = time.perf_counter() - t0
        self._record_step("stacked", bucket, "stacked", n, padded_n, secs,
                          bool(first), {
                              "group": "stacked", "bucket": bucket,
                              "flavor": "stacked", "rows": n,
                              "padded_rows": padded_n,
                              "layers": module.model.layers_run(),
                              "seconds": secs, "graph": how})
        self._series().trunk_forwards.inc(group="stacked", path="stacked")
        logits_by_task = dict(zip(order, (o.numpy() for o in outs)))
        out: Dict[str, List[ClassResult]] = {}
        for task in tasks:
            probs = _softmax(logits_by_task[task][:n])
            out[task] = [self._demux_seq(task, probs[i], 0.0,
                                         encs[i].truncated)
                         for i in range(n)]
        return out

    def classify_windowed(self, task: str, text: str, stride: int = 64,
                          timeout: float = 30.0) -> ClassResult:
        """Whole-input classification for texts past ``max_seq_len``:
        stride windows (utils.tokenization.encode_windows, every window a
        CLS/SEP-framed input) classified on the per-task path (a fused
        member's windows bypass its group), their probabilities combined
        by each window's share of the tokens.  The result covers the
        whole text, so it is never marked truncated.  A text that fits
        one window is ``classify``'s."""
        t = self._require(task, kind="sequence")
        windows = encode_windows(t.tokenizer, text, t.max_seq_len,
                                 stride=stride)
        if len(windows) == 1:
            return self.classify(task, text, timeout=timeout)
        futures = []
        for enc in windows:
            bucket = pick_bucket(len(enc), self.cfg.seq_len_buckets)
            futures.append(self.batcher.submit(
                (task, bucket), _Payload(text, enc, tasks=(task,))))
        results = [f.result(timeout=timeout) for f in futures]
        weights = np.asarray([len(w) for w in windows], np.float64)
        weights = weights / weights.sum()
        labels = list(results[0].probs)
        combined = {
            lab: float(sum(w * r.probs.get(lab, 0.0)
                           for w, r in zip(weights, results)))
            for lab in labels}
        best = max(combined, key=combined.get)
        return ClassResult(
            label=best,
            index=t.labels.index(best) if best in t.labels else -1,
            confidence=combined[best],
            probs=combined,
            latency_s=max(r.latency_s for r in results),
            truncated=False,
        )

    def token_classify(self, task: str, text: str, threshold: float = 0.5,
                       timeout: float = 30.0,
                       enc_cache=None) -> TokenClassResult:
        fut = self._submit(self._require(task, kind="token"), text,
                           enc_cache, threshold)
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
            enc, tok_s, cached = self._encode(t, text, None, task, (task,))
            bucket = pick_bucket(len(enc), self.cfg.seq_len_buckets)
            futures.append(self.batcher.submit(
                (task, bucket, exit_layer, output_dim),
                _Payload(text, enc, tasks=(task,), tok_s=tok_s,
                         tok_cached=cached)))
        return futures

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Capture, off the batcher, every step the engine serves at batch
        1 for every bucket its tasks take: each fused flavor a trunk group
        serves (a BGMV group's sequence flavors with one pair), every
        per-task task, every configured Matryoshka variant of an embedding
        task.  Other row counts capture on first use.  On the CPU the same
        steps run eagerly.  A step that fails to capture raises."""
        def inputs(b: int, pad_id: int) -> List[torch.Tensor]:
            ids = torch.full((1, b), pad_id, dtype=torch.long)
            ids[:, 0] = 1
            return [ids, torch.ones((1, b), dtype=torch.int32)]

        buckets = list(buckets or self.cfg.seq_len_buckets)
        for t in list(self._tasks.values()):
            if t.name in self._task_group or t.kind in ("generative",
                                                        "multimodal"):
                # a fused member's steps are its group's; a decode step
                # and a tower step key on the shapes a call brings
                continue
            for b in buckets:
                if b > t.max_seq_len:
                    continue
                if t.kind == "embedding":
                    for el, od in self._matryoshka_variants():
                        self._embed_step(t, b, 1, el, od,
                                         inputs(b, t.pad_id))
                else:
                    self._task_step(t, b, 1, inputs(b, t.pad_id))
        for g in list(self._groups_by_gid.values()):
            demux = g.demux
            meta = self._serving_meta(demux)
            flavors = [f for f, need in
                       (("seq", demux["bank"] is not None),
                        ("tok", demux["tok_bank"] is not None),
                        ("both", demux["bank"] is not None
                         and demux["tok_bank"] is not None)) if need]
            pairs = [torch.zeros(1, dtype=torch.int32)] * 2
            for b in buckets:
                if b > g.max_seq_len:
                    continue
                for flavor in flavors:
                    use_bgmv = meta["bgmv"] and flavor != "tok"
                    self._fused_step(g, demux, flavor, b, 1, meta, use_bgmv,
                                     inputs(b, g.pad_id)
                                     + (pairs if use_bgmv else []))
                # the packed entry shape every packed bucket hits first
                self._warm_packed_shape(g, b, k_pad=2, padded_rows=1)
        self._sync()

    def _warm_packed_shape(self, g: TrunkGroup, bucket: int, k_pad: int,
                           padded_rows: int, pair_pad: int = 0,
                           flavors: Optional[Sequence[str]] = None) -> bool:
        """Run one packed (padded_rows, bucket, K_pad) shape off the
        batcher, per flavor, through the live snapshot's step cache
        (captured on the card, eager on the CPU), so the first real packed
        step of the shape replays.  Two segments of half the bucket each,
        laid out by ``pack_items``.  False (nothing run) while packing is
        off or the group cannot pack; a capture that fails raises."""
        if not self._packing["enabled"] \
                or g.config.attention_impl != "dense":
            return False
        demux = g.demux
        meta = self._serving_meta(demux)
        k_eff = max(2, int(k_pad))
        half = max(1, bucket // 2)
        pb = pack_items([_WarmEncoding(half), _WarmEncoding(bucket - half)],
                        bucket, g.pad_id, max_rows=1, max_segments_per_row=2,
                        pad_rows_to=padded_rows, pad_segments_to=k_eff)
        planes = _packed_inputs(pb)
        pp = int(pair_pad) or 2
        pairs = [torch.zeros(pp, dtype=torch.int32)] * 2
        need = {"seq": demux["bank"] is not None,
                "tok": demux["tok_bank"] is not None,
                "both": demux["bank"] is not None
                and demux["tok_bank"] is not None}
        for flavor in flavors or ("seq", "tok", "both"):
            if not need.get(flavor):
                continue
            use_bgmv = meta["bgmv"] and flavor != "tok"
            self._packed_step(g, demux, flavor, bucket, padded_rows, k_eff,
                              meta, use_bgmv,
                              planes + (pairs if use_bgmv else []))
        return True

    def packed_shape_census(self) -> Dict[str, list]:
        """gid → the packed shapes (bucket, K_pad, padded rows, flavor,
        pairs) the group's live step cache has run."""
        return {g.gid: _parse_census_keys(g.demux["graphs"].keys())
                for g in list(self._groups_by_gid.values())}

    def warmup_packed_hot(self) -> int:
        """Run every packed shape the census and the warm hints (shapes a
        replaced snapshot had run) name on the live snapshots, so the
        first packed step after a boot, a retune or a kernel or quant
        flip replays.  Hints that cannot run now (packing off) stay.
        Returns the number of shapes run."""
        n = 0
        for g in list(self._groups_by_gid.values()):
            rows = set(_parse_census_keys(g.demux["graphs"].keys()))
            rows.update(tuple(r) for r in (g.warm_hints or ()))
            remaining = set()
            for row in sorted(rows):
                bucket, k_pad, padded_rows, flavor, pair_pad = row
                if self._warm_packed_shape(g, bucket, k_pad, padded_rows,
                                           pair_pad=pair_pad,
                                           flavors=(flavor,)):
                    n += 1
                else:
                    remaining.add(row)
            g.warm_hints = sorted(remaining) if remaining else None
        if n:
            self._sync()
        return n

    def _sync(self) -> None:
        """Wait for the card, holding the capture gate shared: CUDA fails
        a capture running on another thread when the device is
        synchronized meanwhile (a reload's warmup runs under traffic)."""
        if self.device.type == "cuda":
            with self._gate.shared():
                torch.cuda.synchronize(self.device)

    def steps(self) -> List[dict]:
        """Recent step records (oldest first), a view of this engine's
        ``runtimestats.record_step`` log; ``graph`` says whether the step
        was ``captured``, ``replayed`` or run ``eager`` (the CPU, and a
        sampled trace's detailed step)."""
        return self._runtime_stats.steps(self)

    def shape_census(self) -> Dict[str, list]:
        """Distinct (padded_batch, bucket) device shapes per batch group."""
        with self._lock:
            return {k: sorted(v) for k, v in self._shapes.items()}

    def graph_report(self) -> Dict[str, Dict[str, Any]]:
        """Per live step cache (a trunk group's snapshot, a task's): graphs
        captured, their capture seconds, and the bytes the card reserved
        while they captured."""
        with self._lock:
            caches = self._live_caches()
        return {c.name: {"graphs": c.captured(),
                         "capture_s": c.capture_seconds(),
                         "pool_bytes": c.pool_bytes()} for c in caches}

    def _live_caches(self) -> List[StepGraphs]:
        """Every live step cache (caller holds self._lock)."""
        return ([g.demux["graphs"] for g in self._groups_by_gid.values()]
                + [t.graphs for t in self._tasks.values()]
                + ([self._stacked.graphs] if self._stacked is not None
                   else []))

    def _matryoshka_variants(self) -> List[tuple]:
        """(exit_layer, output_dim) pairs an embedding task serves: the
        full model plus every configured 2D-Matryoshka combination."""
        layers = [int(el) for el in self.cfg.matryoshka_layers or []]
        dims = [int(od) for od in self.cfg.matryoshka_dims or []]
        return ([(None, None)] + [(el, None) for el in layers]
                + [(None, od) for od in dims]
                + [(el, od) for el in layers for od in dims])

    def shutdown(self) -> None:
        """Stop the batcher, the shape auto-tuner's thread and the stacked
        bank's pool and drop every captured graph (their pools return to
        the card)."""
        self._autotuner.stop()
        self.batcher.shutdown()
        if self._stacked_pool is not None:
            self._stacked_pool.shutdown(wait=False)
        rs = self._runtime_stats
        rs.unregister_provider(self.batcher.name, self._queue_provider)
        rs.unregister_memory_provider(f"engine:{id(self):x}",
                                      self._memory_provider)
        rs.drop_steps(self)
        with self._lock:
            caches = self._live_caches()
        for c in caches:
            c.retire()

    # -- internals ---------------------------------------------------------

    def _require(self, task: str, kind: Optional[str] = None) -> _Task:
        t = self._tasks.get(task)
        if t is None:
            raise KeyError(f"task {task!r} not registered "
                           f"(known: {sorted(self._tasks)})")
        if kind is not None and t.kind != kind:
            right = {"token": "token_classify", "sequence": "classify",
                     "embedding": "embed", "generative": "generate",
                     "multimodal": "embed_multimodal"}
            raise TypeError(f"task {task!r} is a {t.kind} task; use "
                            f"{right[t.kind]}()")
        return t

    def _series(self):
        if self._metrics is not None:
            return self._metrics
        from ..observability.metrics import default_series

        return default_series

    def _encode(self, owner, text: str, enc_cache, tok_tag: str,
                trunc_tags: Sequence[str]) -> tuple:
        """Encode with a trunk group's or a task's tokenizer and
        max_seq_len (or reuse the request's shared Encoding).  Counts the
        tokenizations actually run under ``tok_tag`` and each clipped
        input per task of ``trunc_tags``.  Returns (encoding, seconds
        spent encoding, whether the request's cache held it)."""
        t0 = time.perf_counter()
        missed = []

        def on_miss():
            missed.append(True)
            self._series().tokenizations.inc(task=tok_tag)

        if enc_cache is None:
            enc = owner.tokenizer.encode(text, max_length=owner.max_seq_len)
            on_miss()
        else:
            enc = enc_cache.get_or_encode(owner.tokenizer, text,
                                          owner.max_seq_len, on_miss=on_miss)
        tok_s = time.perf_counter() - t0
        if enc.truncated:
            s = self._series()
            for tag in trunc_tags:
                s.truncated_inputs.inc(task=tag)
        return enc, tok_s, not missed

    def _stack_items(self, items: List[BatchItem], bucket: int,
                     padded_n: int, pad_id: int, tag: Optional[str] = None):
        """Pad item encodings into one (padded_n, bucket) host batch.
        Returns (ids, mask, clipped): an encoding longer than the bucket
        clips at its edge, is flagged and counted
        (``llm_batcher_bucket_overflow_total`` under ``tag``; with no tag
        the caller counts per task), never silently."""
        ids = np.full((padded_n, bucket), pad_id, dtype=np.int64)
        mask = np.zeros((padded_n, bucket), dtype=np.int32)
        clipped = [False] * len(items)
        for i, item in enumerate(items):
            enc: Encoding = item.payload.encoding
            L = min(len(enc), bucket)
            clipped[i] = len(enc) > bucket
            ids[i, :L] = enc.ids[:L]
            mask[i, :L] = enc.attention_mask[:L]
        n_clipped = sum(clipped)
        if n_clipped and tag is not None:
            self._series().bucket_overflows.inc(n_clipped, task=tag)
        return ids, mask, clipped

    # -- the compiled-step census and the steps ----------------------------

    def _note_shape(self, group: str, shape: tuple) -> bool:
        """Record a device shape; True the first time the group runs it."""
        shape = tuple(shape)
        with self._lock:
            seen = self._shapes.setdefault(group, set())
            fresh = shape not in seen
            seen.add(shape)
        return fresh

    def _step_fresh(self, group: str, variant: str, shape: tuple) -> bool:
        """True while (group, variant, *shape) has not executed on a live
        step cache: its next execution is a graph capture on the card (the
        fused flavors, the per-task ``split`` and the ``embed`` steps are
        distinct graphs; shape_census stays variant-free).  The census is
        the caches' own, so a retired snapshot's keys leave with it."""
        key = (group, variant, *shape)
        with self._lock:
            caches = self._live_caches()
        return not any(key in c.keys() for c in caches)

    def _execute(self, cache: StepGraphs, group: str, variant: str,
                 shape: tuple, fn: Callable, inputs: Sequence[torch.Tensor],
                 program: tuple, first: Optional[list] = None) -> tuple:
        """One step through ``cache`` under the key (group, variant,
        *shape).  ``program`` is (bucket, padded rows, catalog variant,
        measured variant, serving meta or None): the key's first
        execution is counted into the program catalog under it, and
        marked in ``first`` (a list) when given.  Returns (host outputs,
        how)."""
        def on_first(cost, info) -> None:
            if first is not None:
                first.append(True)
            self._note_program(group, program, cost, info)

        with on_first_execution(on_first):
            return cache.run((group, variant, *shape), fn, inputs)

    def _note_program(self, group: str, program: tuple, cost,
                      info: Dict[str, Any]) -> None:
        """Register a fresh step's count with the program catalog
        (observability.programstats) under the reference's key (group,
        bucket, variant, quant, kernels, mesh)."""
        bucket, padded_n, variant, measured, meta = program
        meta = meta or {}
        kernels = "+".join(k for k in ("epilogue", "bgmv")
                           if meta.get(k)) or "off"
        self._program_stats.note_compile(
            group, bucket, variant, (padded_n, bucket),
            cost, measured_variant=measured,
            quant=str(meta.get("quant") or "off"), kernels=kernels,
            argument_bytes=info["argument_bytes"],
            output_bytes=info["output_bytes"],
            temp_bytes=info["temp_bytes"], capture_s=info["capture_s"])

    def _fused_step(self, g: TrunkGroup, demux: dict, flavor: str,
                    bucket: int, padded_n: int, meta: dict, use_bgmv: bool,
                    inputs: Sequence[torch.Tensor],
                    first: Optional[list] = None) -> tuple:
        """A trunk group's step: keyed on the flavor, the shape, the padded
        pair count and the kernel toggles, which the batch read from the
        live knobs (the quant mode is the snapshot's own, and every
        snapshot has its own cache).  Its catalog variant is the
        reference's ``fused:<flavor>[:p<pairs>]``."""
        pairs = len(inputs[2]) if use_bgmv else 0
        shape = (bucket, padded_n, pairs, meta["epilogue"], use_bgmv)

        def step(ids, mask, *pairs):
            return g.forward(ids, mask, flavor, demux, meta["epilogue"],
                             *pairs)

        variant = f"fused:{flavor}" + (f":p{pairs}" if use_bgmv else "")
        with trace_span(f"engine.classify.fused.{g.gid}",
                        cuda=self.device.type == "cuda"):
            return self._execute(
                demux["graphs"], f"trunk:{g.gid}", flavor, shape, step,
                inputs, (bucket, padded_n, variant, "fused",
                         dict(meta, bgmv=use_bgmv)), first)

    def _packed_step(self, g: TrunkGroup, demux: dict, flavor: str,
                     bucket: int, padded_rows: int, k_pad: int, meta: dict,
                     use_bgmv: bool, inputs: Sequence[torch.Tensor],
                     first: Optional[list] = None) -> tuple:
        """A trunk group's packed step: ``inputs`` are ids, mask,
        position_ids, segment_ids, seg_row, seg_start (and the pairs).
        Keyed on (bucket, padded rows, K_pad, pairs, epilogue, bgmv); its
        catalog variant is the reference's
        ``packed:<flavor>:<K_pad>[:p<pairs>]``."""
        pairs = len(inputs[6]) if use_bgmv else 0
        shape = (bucket, padded_rows, k_pad, pairs, meta["epilogue"],
                 use_bgmv)

        def step(ids, mask, pos, seg, seg_row, seg_start, *pairs):
            return g.forward(ids, mask, flavor, demux, meta["epilogue"],
                             *pairs, packing=(pos, seg, seg_row, seg_start))

        variant = f"packed:{flavor}:{k_pad}" + (f":p{pairs}" if use_bgmv
                                                 else "")
        with trace_span(f"engine.classify.packed.{g.gid}",
                        cuda=self.device.type == "cuda"):
            return self._execute(
                demux["graphs"], f"trunk:{g.gid}", f"packed:{flavor}", shape,
                step, inputs, (bucket, padded_rows, variant, "packed",
                               dict(meta, bgmv=use_bgmv)), first)

    def _task_step(self, t: _Task, bucket: int, padded_n: int,
                   inputs: Sequence[torch.Tensor],
                   first: Optional[list] = None) -> tuple:
        """A per-task step: the module's own float32 forward."""
        with trace_span(f"engine.classify.{t.name}",
                        cuda=self.device.type == "cuda"):
            return self._execute(
                t.graphs, f"task:{t.name}", "split", (bucket, padded_n),
                lambda ids, mask: (t.module(ids, mask),), inputs,
                (bucket, padded_n, "split", "split", None), first)

    @staticmethod
    def _split_variant(exit_layer: Optional[int],
                       output_dim: Optional[int]) -> str:
        """The runtimestats / catalog variant of an embedding step: the
        reference's ``split``, with the 2D-Matryoshka variant named."""
        return "split" + (f":exit{exit_layer}" if exit_layer else "") \
            + (f":dim{output_dim}" if output_dim else "")

    def _embed_step(self, t: _Task, bucket: int, padded_n: int,
                    exit_layer: Optional[int], output_dim: Optional[int],
                    inputs: Sequence[torch.Tensor],
                    first: Optional[list] = None) -> tuple:
        """An embedding step at one 2D-Matryoshka variant."""
        variant = self._split_variant(exit_layer, output_dim)
        with trace_span(f"engine.embed.{t.name}",
                        cuda=self.device.type == "cuda"):
            return self._execute(
                t.graphs, f"task:{t.name}", "embed",
                (bucket, padded_n, exit_layer, output_dim),
                lambda ids, mask: (t.module(ids, mask, exit_layer=exit_layer,
                                            output_dim=output_dim),),
                inputs, (bucket, padded_n, variant, variant, None), first)

    def _record_step(self, group: str, bucket: int, variant: str,
                     rows: int, padded_rows: int, seconds: float,
                     compiled: bool, detail: Dict[str, Any],
                     tokens_real: int = 0, tokens_padded: int = 0,
                     segments: Optional[int] = None) -> None:
        """The step's one record: a runtimestats sample (a bounded deque
        append) carrying ``detail``, the record ``steps()`` shows, and one
        ``llm_classifier_batch_size`` observation of its real rows (the
        reference declares the series; the port feeds it per step).
        ``segments``: a packed step's segment count (else the real rows
        of a step with token counts)."""
        with self._lock:
            self.trunk_forwards += 1
        self._series().batch_size.observe(rows)
        self._runtime_stats.record_step(
            group, bucket, variant, rows, padded_rows, seconds,
            compiled=compiled, tokens_real=tokens_real,
            tokens_padded=tokens_padded,
            segments=segments if segments is not None
            else (rows if tokens_padded else 0),
            detail=detail, source=self)

    def _count_kernel_step(self, gid: str, meta: dict,
                           used_bgmv: bool) -> None:
        """llm_engine_kernel_steps_total: device steps served through each
        tuned-kernel path."""
        m = self._series()
        if meta["quant"] != "off":
            m.kernel_steps.inc(group=gid, kernel=f"quant_{meta['quant']}")
        if meta["epilogue"]:
            m.kernel_steps.inc(group=gid, kernel="epilogue")
        if used_bgmv:
            m.kernel_steps.inc(group=gid, kernel="bgmv")

    # -- the batch runners -------------------------------------------------

    def _run_batch(self, group_key: Hashable,
                   items: List[BatchItem]) -> Sequence[Any]:
        while True:
            seen = self._retirements
            try:
                return self._dispatch(group_key, items)
            except SnapshotRetired:
                # a rebuild or a flip retired the snapshot this batch
                # read: it runs again on the live one, for as long as
                # flips land while it runs.  A cache retired with no
                # change (shutdown) raises.
                if self._retirements == seen:
                    raise

    def _dispatch(self, group_key: Hashable,
                  items: List[BatchItem]) -> Sequence[Any]:
        if group_key[0] == TRUNK_KEY:
            _, gid, bucket = group_key
            return self._run_fused_batch(gid, bucket, items)
        if self._require(group_key[0]).kind == "embedding":
            return self._run_embed_batch(*group_key, items)
        return self._run_task_batch(*group_key, items)

    def _run_task_batch(self, task: str, bucket: int,
                        items: List[BatchItem]) -> Sequence[Any]:
        """One per-task forward of the task's own module (float32, whatever
        its group's quant mode): rows padded to a power of two, logits
        demuxed with the task's label set."""
        t = self._require(task)
        n = len(items)
        padded_n = pow2_batch(n, self.cfg.max_batch_size)
        # opened before stacking: batch.wait ends where queue wait ends
        step = batchtrace.start_step(
            items, group=f"task:{task}", bucket=bucket,
            max_batch=self.cfg.max_batch_size, padded_rows=padded_n,
            kind=t.kind)
        try:
            with batchtrace.stage(step, "stack"):
                ids, mask, clipped = self._stack_items(items, bucket,
                                                       padded_n, t.pad_id,
                                                       tag=task)
            self._note_shape(f"task:{task}", (padded_n, bucket))
            t0 = time.perf_counter()
            first: list = []
            with batchtrace.stage(step, "trunk_forward"):
                (logits,), how = self._task_step(
                    t, bucket, padded_n, [torch.from_numpy(ids),
                                          torch.from_numpy(mask)], first)
            model = getattr(t.module, "model", None)
            secs = time.perf_counter() - t0
            self._record_step(f"task:{task}", bucket, "split", n, padded_n,
                              secs, bool(first), {
                                  "group": f"task:{task}", "bucket": bucket,
                                  "flavor": "split", "rows": n,
                                  "padded_rows": padded_n,
                                  "layers": model.layers_run()
                                  if model is not None else None,
                                  "seconds": secs, "graph": how})
            self._series().trunk_forwards.inc(group=task,
                                              path="traditional")
            with batchtrace.stage(step, "demux"):
                logits = logits.numpy()
                now = time.perf_counter()
                out: List[Any] = []
                for i, item in enumerate(items):
                    enc = item.payload.encoding
                    latency = now - item.payload.submit_t
                    trunc = enc.truncated or clipped[i]
                    if t.kind == "sequence":
                        p = _softmax(logits[i][None])[0]
                        out.append(self._demux_seq(task, p, latency, trunc))
                    else:
                        L = min(len(enc), bucket)
                        out.append(self._demux_tok(
                            task, _softmax(logits[i, :L]), item, enc, L,
                            latency, trunc))
            return out
        finally:
            # a failing batch is exactly one a trace must explain
            if step is not None:
                step.finish()

    def _run_embed_batch(self, task: str, bucket: int,
                         exit_layer: Optional[int],
                         output_dim: Optional[int],
                         items: List[BatchItem]) -> Sequence[Any]:
        """One embedding forward: rows padded to a power of two, stacked to
        the bucket edge; host float32 rows out, one per item."""
        t = self._require(task, kind="embedding")
        n = len(items)
        padded_n = pow2_batch(n, self.cfg.max_batch_size)
        step = batchtrace.start_step(
            items, group=f"task:{task}", bucket=bucket,
            max_batch=self.cfg.max_batch_size, padded_rows=padded_n,
            kind=t.kind)
        try:
            with batchtrace.stage(step, "stack"):
                ids, mask, _ = self._stack_items(items, bucket, padded_n,
                                                 t.pad_id, tag=task)
            self._note_shape(f"task:{task}", (padded_n, bucket))
            t0 = time.perf_counter()
            first: list = []
            with batchtrace.stage(step, "trunk_forward"):
                (emb,), how = self._embed_step(
                    t, bucket, padded_n, exit_layer, output_dim,
                    [torch.from_numpy(ids), torch.from_numpy(mask)], first)
            secs = time.perf_counter() - t0
            self._record_step(
                f"task:{task}", bucket,
                self._split_variant(exit_layer, output_dim), n, padded_n,
                secs, bool(first), {
                    "group": f"task:{task}", "bucket": bucket,
                    "flavor": "embed", "rows": n, "padded_rows": padded_n,
                    "exit_layer": exit_layer, "output_dim": output_dim,
                    "layers": t.module.model.layers_run(exit_layer),
                    "seconds": secs, "graph": how})
            self._series().trunk_forwards.inc(group=task,
                                              path="traditional")
            emb = emb.numpy()
            return [emb[i] for i in range(n)]
        finally:
            if step is not None:
                step.finish()

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
            self._series().fused_dedup_rows.inc(len(items) - len(uniq))
        # a batch with no token items never pays the per-token head matmul
        kinds = {self._tasks[t].kind for item in items
                 for t in item.payload.tasks if t in self._tasks}
        need_tok = "token" in kinds
        need_seq = "sequence" in kinds or not need_tok
        flavor = "both" if (need_tok and need_seq) \
            else ("tok" if need_tok else "seq")

        # packed vs unpacked: pack when the first-fit plan strictly needs
        # fewer padded rows (or the scheduler took more encodings than a
        # step has rows); a batch of one unique encoding (the dedup
        # hot-prompt case included) stays on the unpacked path
        pk = self._packing
        n_rows = len(uniq)
        row_cap = self.cfg.max_batch_size
        max_segs = self._packing_segment_cap_of((TRUNK_KEY, gid, bucket))
        plan_rows = 0
        if pk["enabled"] and g.config.attention_impl == "dense" \
                and n_rows >= pk["min_segments"]:
            must_pack = n_rows > row_cap
            if must_pack or not self._autotuner.blocked(f"trunk:{gid}",
                                                        bucket):
                plan = RowPlan(bucket, row_cap, max_segs)
                fits = all(plan.add(min(len(it.payload.encoding), bucket))
                           is not None for it in uniq)
                if fits and (must_pack
                             or pow2_batch(plan.rows_used, row_cap)
                             < pow2_batch(n_rows, row_cap)):
                    plan_rows = plan.rows_used
        if not plan_rows and n_rows > row_cap:
            # the scheduler over-took but the plan no longer fits (a
            # reload lowered the knobs meanwhile): serve in halves
            mid = max(1, len(items) // 2)
            return (list(self._run_fused_batch(gid, bucket, items[:mid]))
                    + list(self._run_fused_batch(gid, bucket, items[mid:])))
        if plan_rows:
            return self._run_fused_packed(g, bucket, items, urow, uniq,
                                          demux, flavor, max_segs, plan_rows)
        return self._run_fused_unpacked(g, bucket, items, urow, uniq,
                                        demux, flavor)

    def _run_fused_unpacked(self, g: TrunkGroup, bucket: int,
                            items: List[BatchItem], urow: List[int],
                            uniq: List[BatchItem], demux: dict,
                            flavor: str) -> Sequence[Any]:
        """The fixed-row fused path: one trunk row per unique encoding,
        padded to the bucket edge."""
        padded_n = pow2_batch(len(uniq), self.cfg.max_batch_size)
        meta = self._serving_meta(demux)
        use_bgmv = meta["bgmv"] and flavor in ("seq", "both")
        step = batchtrace.start_step(
            items, group=f"trunk:{g.gid}", bucket=bucket,
            max_batch=self.cfg.max_batch_size, padded_rows=padded_n,
            kind="fused")
        try:
            # the detailed (fenced two-call) step only describes the plain
            # step: with a kernel or quant knob live it would time math the
            # serving step does not run
            detailed = step is not None and step.detailed \
                and flavor == "seq" and meta["quant"] == "off" \
                and not meta["epilogue"] and not use_bgmv
            pair_index: Dict[tuple, int] = {}
            pairs: tuple = ()
            with batchtrace.stage(step, "stack"):
                ids, mask, clipped = self._stack_items(uniq, bucket,
                                                       padded_n, g.pad_id)
                for i, item in enumerate(items):
                    if clipped[urow[i]]:
                        for task in item.payload.tasks:
                            self._series().bucket_overflows.inc(task=task)
                if use_bgmv:
                    pr, pt, pair_index = self._bgmv_pairs(items, urow, demux)
                    pairs = (pr, pt)
                host = [torch.from_numpy(a) for a in (ids, mask, *pairs)]
                if detailed:
                    host = [x.to(self.device) for x in host]
            self._note_shape(f"trunk:{g.gid}", (padded_n, bucket))
            tokens_real = sum(min(len(it.payload.encoding), bucket)
                              for it in uniq)
            t0 = time.perf_counter()
            first: list = []
            if detailed:
                seq_t, tok_t = self._fused_detailed(g, demux, step, *host)
                how, variant = "eager", "fused_detailed"
            else:
                (seq_t, tok_t), how = self._fused_step(
                    g, demux, flavor, bucket, padded_n, meta, use_bgmv,
                    host, first)
                variant = "fused"
            seq_logits = seq_t.numpy() if seq_t is not None else None
            tok_logits = tok_t.numpy() if tok_t is not None else None
            secs = time.perf_counter() - t0
            self._record_step(
                f"trunk:{g.gid}", bucket, variant, len(uniq), padded_n,
                secs, bool(first), {
                    "group": g.gid, "bucket": bucket, "flavor": flavor,
                    "rows": len(uniq), "padded_rows": padded_n,
                    "quant": meta["quant"],
                    "epilogue": meta["epilogue"], "bgmv": use_bgmv,
                    "pairs": len(pair_index),
                    "padded_pairs": len(pairs[0]) if pairs else 0,
                    "seconds": secs, "graph": how},
                tokens_real=tokens_real, tokens_padded=padded_n * bucket)
            self._series().trunk_forwards.inc(group=g.gid, path="fused")
            self._count_kernel_step(g.gid, meta, use_bgmv)

            with batchtrace.stage(step, "demux"):
                spans = [(u, 0, min(len(it.payload.encoding), bucket))
                         for u, it in enumerate(uniq)]
                return self._demux_fused(items, urow, demux, seq_logits,
                                         tok_logits, use_bgmv, pair_index,
                                         spans, clipped)
        finally:
            if step is not None:
                step.finish()

    def _run_fused_packed(self, g: TrunkGroup, bucket: int,
                          items: List[BatchItem], urow: List[int],
                          uniq: List[BatchItem], demux: dict, flavor: str,
                          max_segs: int, plan_rows: int) -> Sequence[Any]:
        """The sequence-packed fused path: the unique encodings bin-pack
        into shared rows (segment k is unique encoding k) under a
        block-diagonal mask with per-segment RoPE positions; sequence
        heads pool per segment, token heads read each segment's span of
        the per-token logits."""
        n_seg = len(uniq)
        padded_rows = pow2_batch(plan_rows, self.cfg.max_batch_size)
        # the segment axis pads to a power of two, like the row axis
        k_pad = 1 << max(0, n_seg - 1).bit_length()
        meta = self._serving_meta(demux)
        use_bgmv = meta["bgmv"] and flavor in ("seq", "both")
        step = batchtrace.start_step(
            items, group=f"trunk:{g.gid}", bucket=bucket,
            max_batch=self.cfg.max_batch_size, padded_rows=padded_rows,
            kind="fused")
        try:
            pair_index: Dict[tuple, int] = {}
            pairs: list = []
            with batchtrace.stage(step, "stack"):
                pb = pack_items([it.payload.encoding for it in uniq], bucket,
                                g.pad_id, max_rows=self.cfg.max_batch_size,
                                max_segments_per_row=max_segs,
                                pad_rows_to=padded_rows,
                                pad_segments_to=k_pad)
                for i, item in enumerate(items):
                    if pb.segments[urow[i]].clipped:
                        for task in item.payload.tasks:
                            self._series().bucket_overflows.inc(task=task)
                if use_bgmv:
                    # packed pairs index SEGMENTS: the pool emits one row
                    # per segment, and urow is the segment index
                    pr, pt, pair_index = self._bgmv_pairs(items, urow, demux)
                    pairs = [torch.from_numpy(pr), torch.from_numpy(pt)]
                host = _packed_inputs(pb) + pairs
            token_fill = pb.tokens_real / max(1, padded_rows * bucket)
            if step is not None:
                # how packed this step ran, beside the batch attributes
                step.attrs["packing.packed"] = True
                step.attrs["packing.segments"] = n_seg
                step.attrs["packing.rows"] = pb.rows_used
                step.attrs["packing.token_fill"] = round(token_fill, 4)
            self._note_shape(f"trunk:{g.gid}", (padded_rows, bucket))
            t0 = time.perf_counter()
            first: list = []
            with batchtrace.stage(step, "trunk_forward"):
                (seq_t, tok_t), how = self._packed_step(
                    g, demux, flavor, bucket, padded_rows, k_pad, meta,
                    use_bgmv, host, first)
            seq_logits = seq_t.numpy() if seq_t is not None else None
            tok_logits = tok_t.numpy() if tok_t is not None else None
            secs = time.perf_counter() - t0
            self._record_step(
                f"trunk:{g.gid}", bucket, "packed", pb.rows_used,
                padded_rows, secs, bool(first), {
                    "group": g.gid, "bucket": bucket, "flavor": flavor,
                    "variant": f"packed:{flavor}:{k_pad}"
                    + (f":p{len(pairs[0])}" if use_bgmv else ""),
                    "rows": pb.rows_used, "padded_rows": padded_rows,
                    "segments": n_seg, "k_pad": k_pad,
                    "tokens_real": pb.tokens_real,
                    "token_fill": token_fill,
                    "quant": meta["quant"],
                    "epilogue": meta["epilogue"], "bgmv": use_bgmv,
                    "pairs": len(pair_index),
                    "padded_pairs": len(pairs[0]) if pairs else 0,
                    "seconds": secs, "graph": how},
                tokens_real=pb.tokens_real,
                tokens_padded=padded_rows * bucket, segments=n_seg)
            # a packed step IS a fused trunk forward; packing has its own
            # counter and the runtimestats "packed" variant
            self._series().trunk_forwards.inc(group=g.gid, path="fused")
            self._series().packed_steps.inc(group=g.gid)
            self._count_kernel_step(g.gid, meta, use_bgmv)

            with batchtrace.stage(step, "demux"):
                return self._demux_fused(
                    items, urow, demux, seq_logits, tok_logits, use_bgmv,
                    pair_index, [(sg.row, sg.start, sg.length)
                                 for sg in pb.segments],
                    [sg.clipped for sg in pb.segments])
        finally:
            if step is not None:
                step.finish()

    def _demux_fused(self, items: List[BatchItem], urow: List[int],
                     demux: dict, seq_logits, tok_logits, use_bgmv: bool,
                     pair_index: Dict[tuple, int], spans: List[tuple],
                     clipped: List[bool]) -> List[Any]:
        """Each item's results from one fused step, decoded with its own
        tasks' label sets.  Unique encoding u (``urow``) has its tokens at
        ``tok_logits[row, start:start + length]`` for ``spans[u]`` = (row,
        start, length) and its pooled row u in ``seq_logits`` [U, T, L],
        or its (u, bank row) pairs under BGMV (same logits, gathered on
        the device); ``clipped[u]``: cut at the bucket edge."""
        now = time.perf_counter()
        out: List[Any] = []
        for i, item in enumerate(items):
            u = urow[i]
            enc = item.payload.encoding
            at, start, length = spans[u]
            latency = now - item.payload.submit_t
            trunc = enc.truncated or clipped[u]
            per_task: Dict[str, Any] = {}
            for task in item.payload.tasks:
                if self._tasks[task].kind == "token":
                    row = demux["tok_row_of"][task]
                    width = demux["tok_widths"][row]
                    probs = _softmax(
                        tok_logits[at, start:start + length, row, :width])
                    per_task[task] = self._demux_tok(
                        task, probs, item, enc, length, latency, trunc)
                else:
                    row = demux["row_of"][task]
                    width = demux["widths"][row]
                    src = seq_logits[pair_index[(u, row)], :width] \
                        if use_bgmv else seq_logits[u, row, :width]
                    p = _softmax(src[None])[0]
                    per_task[task] = self._demux_seq(task, p, latency, trunc)
            out.append(per_task[item.payload.tasks[0]]
                       if len(item.payload.tasks) == 1 else per_task)
        return out

    def _fused_detailed(self, g: TrunkGroup, demux: dict,
                        step: "batchtrace.BatchStep", ids: torch.Tensor,
                        mask: torch.Tensor) -> tuple:
        """A sampled trace's seq step as two fenced eager calls — the
        trunk with pooling (``trunk_forward``), then the head bank
        (``head_matmul``) — the fused step's math in its order.  It never
        captures, and holds the capture gate shared so no capture runs
        meanwhile.  Returns (host seq logits, None)."""
        with self._gate.shared(), torch.inference_mode(), \
                trace_span(f"engine.classify.detailed.{g.gid}",
                           cuda=self.device.type == "cuda"):
            with step.stage("trunk_forward"):
                pooled = g.pool(demux["trunk"](ids, mask), mask)
                step.fence(pooled)
            with step.stage("head_matmul"):
                logits = g.heads(demux, pooled)
                step.fence(logits)
            return logits.float().cpu(), None

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


def _mean_confidence(out: Dict[str, List[ClassResult]],
                     texts: Sequence[str]) -> float:
    """The mean top-class confidence of a classify_multi outcome (the
    chooser's record)."""
    return float(np.mean([r.confidence for rs in out.values()
                          for r in rs])) if texts else 0.0


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


class _WarmEncoding:
    """An n-token all-real encoding for the packed warmup (``pack_items``
    lays it out as it lays out real ones)."""

    def __init__(self, n: int) -> None:
        self.ids = np.ones(n, np.int64)
        self.attention_mask = np.ones(n, np.int32)

    def __len__(self) -> int:
        return len(self.ids)


def _packed_inputs(pb) -> List[torch.Tensor]:
    """A ``PackedBatch``'s host tensors in the packed step's order: ids
    (int64), mask, position_ids, segment_ids, seg_row, seg_start."""
    return [torch.from_numpy(pb.ids.astype(np.int64))] + [
        torch.from_numpy(a) for a in (pb.mask, pb.position_ids,
                                      pb.segment_ids, pb.seg_row,
                                      pb.seg_start)]


def _parse_census_keys(keys) -> List[tuple]:
    """(bucket, K_pad, padded rows, flavor, pairs) of every packed step
    key (group, ``packed:<flavor>``, bucket, padded rows, K_pad, pairs,
    epilogue, bgmv) among ``keys``."""
    out = set()
    for k in keys:
        if len(k) == 8 and str(k[1]).startswith("packed:"):
            out.add((int(k[2]), int(k[4]), int(k[3]),
                     k[1].split(":", 1)[1], int(k[5])))
    return sorted(out)
