"""Runtime bootstrap: config → engine → router → HTTP server.

Model loading: ``classifier_models`` maps task name → {checkpoint,
tokenizer, kind, labels, max_seq_len, architecture, adapters, lora,
eos_token_ids}.  A checkpoint is a local directory holding HF
``config.json`` + ``model.safetensors`` (or the safetensors file itself,
beside its config.json); there is no download step.  The architecture is
read as the reference reads it: the spec's ``architecture``, else the
config's ``model_type`` (else its ``architectures``).

- ModernBERT (kinds sequence, token, embedding): classifier tasks whose
  specs name the same checkpoint share one trunk module, and so one fused
  trunk group; ``kind: embedding`` loads an ``MmBertEmbeddingModel`` of
  its own.  As the reference's converter does, only the trunk keys (and a
  classifier's ``head.*`` / ``classifier.*``) are read: a masked-LM
  checkpoint's decoder and an embedding checkpoint's bottleneck
  ``dense_i`` are dropped.
- DeBERTa-v2/v3 (``deberta``, ``deberta-v2``, ``deberta-v3``; kinds
  sequence and token): a ``DebertaV3For*Classification`` on the engine's
  per-task path.
- ``kind: generative``: a Qwen3 causal LM behind a ``GreedyGenerator``;
  ``adapters`` names its LoRA rows (``lora: {rank, alpha}``, default 8 /
  16; each adapter starts as the identity) and ``eos_token_ids`` (an int
  or a list; else the config's ``eos_token_id``) ends a row.

- ``kind: multimodal``: a SigLIP ``SiglipModel`` (the shared text/image
  space the image-modality embedding rules read) behind a
  ``SiglipEmbedder``: per-tower configs from the config's
  ``text_config`` / ``vision_config``, the tokenizer from the checkpoint
  directory, the HF tensors through ``convert.siglip_state_from_hf``.

Absent checkpoints leave their task unloaded (its signal fails open).
Any other architecture (Gemma3, a SigLIP checkpoint under a classifier
kind) is refused by name.
``engine.quant`` applies at boot (to ModernBERT trunk groups only).

The observability sinks come from a ``RuntimeRegistry``
(``runtime/registry.py``; the process defaults unless the caller passes
one): ``apply_observability_knobs`` applies the config's
``observability`` block to them, and binds and starts the SLO monitor
and the degradation controller (``resilience``) on the registry's event
bus.  ``build_router`` attaches the decision-aware signal cascade when
``engine.cascade`` enables it (``apply_cascade_knobs``) and the upstream
health plane when ``resilience.upstream`` does (``apply_upstream_knobs``);
a config reload calls both again.  ``warm_engine`` warms the engine and
emits ``engine_ready`` (or ``engine_failed``) on the bus, which the
controller reads.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional, Tuple

from ..config.schema import InferenceEngineConfig, RouterConfig
from ..utils.device import DeviceLike, resolve_device

log = logging.getLogger(__name__)

# dense SDPA is O(S^2) memory: above this length the CPU path streams
LONG_SEQ_DENSE_LIMIT = 4096


def select_attention_impl(engine_cfg: InferenceEngineConfig,
                          max_seq_len: int, device: DeviceLike) -> str:
    """``use_flash_attention`` on a CUDA device → 'flash' (the hand-written
    kernel); long context elsewhere → 'chunked'; else 'dense'."""
    dev = resolve_device(device)
    if engine_cfg.use_flash_attention and dev.type == "cuda":
        return "flash"
    if max_seq_len and max_seq_len > LONG_SEQ_DENSE_LIMIT:
        return "chunked"
    return "dense"


TRUNK_PREFIXES = ("embeddings.", "layers.", "final_norm.")


def modernbert_state(state: Dict[str, object], kind: str) -> Dict[str, object]:
    """The keys a ModernBERT task of ``kind`` reads from a checkpoint: the
    trunk under ``model.`` (a bare trunk's keys gain the prefix), plus
    ``head.*`` and ``classifier.*`` for a classifier.  Everything else —
    a masked-LM ``decoder.*`` and ``head.*`` on an embedding task, a
    bottleneck ``dense_i`` — is dropped."""
    prefixed = any(k.startswith("model.") for k in state)
    out = {}
    for k, v in state.items():
        if prefixed and k.startswith("model."):
            out[k] = v
        elif not prefixed and k.startswith(TRUNK_PREFIXES):
            out["model." + k] = v
        elif kind != "embedding" and k.startswith(("head.", "classifier.")):
            out[k] = v
    return out


def _checkpoint_files(path: str) -> Tuple[str, str]:
    """(config.json, model.safetensors) of a checkpoint dir or file."""
    if os.path.isdir(path):
        return (os.path.join(path, "config.json"),
                os.path.join(path, "model.safetensors"))
    return os.path.join(os.path.dirname(path), "config.json"), path


def checkpoint_architecture(spec: Dict[str, object], hf_cfg: Dict) -> str:
    """The architecture a checkpoint declares, read as the reference
    reads it: the spec's ``architecture``, else the config's
    ``model_type``, else its ``architectures``; ``modernbert`` when none
    says."""
    arch = spec.get("architecture") or hf_cfg.get("model_type") \
        or next(iter(hf_cfg.get("architectures") or []), "") \
        or "modernbert"
    return str(arch)


def _family(name: str) -> str:
    """The model family an architecture name belongs to (``deberta-v3``
    and ``DebertaV2ForTokenClassification`` are both ``deberta``)."""
    n = name.lower().replace("-", "").replace("_", "")
    return next((f for f in ("modernbert", "deberta", "qwen3", "siglip")
                 if f in n), n)


def _refuse_foreign(task: str, path: str, names, family: str,
                    serves: str) -> None:
    """Refuse, by its name, a checkpoint that declares an architecture
    outside ``family``."""
    foreign = [n for n in names if _family(n) != family]
    if foreign:
        raise ValueError(f"task {task!r}: checkpoint {path!r} is a "
                         f"{foreign[0]!r} model ({', '.join(names)}); this "
                         f"port serves {serves}")


def _meta_load(build, state_of):
    """A module built on the meta device (no weights allocated), then
    given the tensors ``state_of(module)`` returns (checked strictly)."""
    import torch

    with torch.device("meta"):
        module = build()
    module.load_state_dict(state_of(module), assign=True)
    return module


def build_engine(cfg: RouterConfig, device: DeviceLike = None,
                 registry=None):
    """Engine from ``cfg.classifier_models`` (ModernBERT sequence, token and
    embedding kinds, DeBERTa-v2/v3 sequence and token classifiers, Qwen3
    generative tasks, SigLIP multimodal tasks) on ``device`` (``cuda``
    when None), its observability bound to ``registry``'s sinks (the
    process defaults when None).  None when no models are configured — the router then
    routes on defaults."""
    specs = cfg.classifier_models or {}
    if not specs:
        return None
    from ..engine.classify import InferenceEngine
    from ..models.convert import load_safetensors
    from ..models.embeddings import MmBertEmbeddingModel
    from ..models.modernbert import (
        ModernBertConfig,
        ModernBertForSequenceClassification,
        ModernBertForTokenClassification,
    )
    from ..utils.tokenization import HFTokenizer

    dev = resolve_device(device)
    obs = {}
    if registry is not None:
        obs = {"metrics": registry.metric_series(),
               "runtime_stats": registry.runtimestats,
               "program_stats": registry.programstats}
    engine = InferenceEngine(cfg.engine, device=dev, **obs)
    trunks: Dict[str, object] = {}   # checkpoint path → shared trunk module
    tokenizers: Dict[str, HFTokenizer] = {}
    buckets = cfg.engine.seq_len_buckets or [512]

    def tokenizer_for(tok_dir: str) -> HFTokenizer:
        """One tokenizer per directory, loaded once a task's architecture
        passed its checks (a refused checkpoint reads none)."""
        if tok_dir not in tokenizers:
            tokenizers[tok_dir] = HFTokenizer.from_pretrained_dir(tok_dir)
        return tokenizers[tok_dir]

    for task, spec in specs.items():
        path = spec.get("checkpoint", "")
        kind = spec.get("kind", "sequence")
        if kind not in ("sequence", "token", "embedding", "generative",
                        "multimodal"):
            raise ValueError(f"task {task!r}: kind {kind!r} is not served by "
                             f"this port yet (sequence, token, embedding, "
                             f"generative and multimodal only)")
        if not path or not os.path.exists(path):
            log.warning("model missing: task=%s path=%s", task, path)
            continue
        cfg_path, weights_path = _checkpoint_files(path)
        with open(cfg_path) as f:
            hf_cfg = json.load(f)
        arch = checkpoint_architecture(spec, hf_cfg)
        names = [arch] + [str(a) for a in hf_cfg.get("architectures") or []]
        id2label = hf_cfg.get("id2label", {})
        labels = spec.get("labels") or \
            [id2label.get(str(i), str(i)) for i in range(len(id2label))]
        tok_dir = spec.get("tokenizer") or os.path.dirname(cfg_path)
        if kind == "generative":
            # served as Qwen3, as the reference serves it, unless the
            # checkpoint declares another architecture
            declared = spec.get("architecture") or hf_cfg.get("model_type") \
                or hf_cfg.get("architectures")
            _refuse_foreign(task, path, names if declared else [], "qwen3",
                            "Qwen3 generative checkpoints only")
            generator, adapters = _generative(spec, hf_cfg, weights_path,
                                              tokenizer_for(tok_dir), dev)
            engine.register_generative(task, generator, labels=labels,
                                       adapter_index=adapters)
            log.info("model loaded: task=%s kind=generative", task)
            continue
        if kind == "multimodal":
            # SigLIP: its config nests a config per tower
            _refuse_foreign(task, path, names, "siglip",
                            "SigLIP multimodal checkpoints only")
            engine.register_multimodal(task, _siglip(
                hf_cfg, weights_path, tokenizer_for(tok_dir), dev))
            log.info("model loaded: task=%s kind=multimodal "
                     "architecture=siglip", task)
            continue
        if _family(arch) == "deberta" and kind in ("sequence", "token"):
            _refuse_foreign(task, path, names, "deberta",
                            "a DeBERTa architecture from DeBERTa "
                            "checkpoints only")
            engine.register_task(
                task, kind, _deberta(kind, hf_cfg, labels, weights_path),
                tokenizer_for(tok_dir), labels,
                max_seq_len=int(spec.get("max_seq_len", 0)),
                pad_id=int(hf_cfg.get("pad_token_id", 0) or 0))
            log.info("model loaded: task=%s kind=%s architecture=deberta-v3",
                     task, kind)
            continue
        _refuse_foreign(task, path, names, "modernbert",
                        "ModernBERT checkpoints, DeBERTa-v2/v3 sequence "
                        "and token classifiers and Qwen3 generative "
                        "checkpoints only")
        max_seq = min(int(spec.get("max_seq_len", 0))
                      or int(hf_cfg.get("max_position_embeddings", 8192)),
                      max(buckets))
        mcfg = ModernBertConfig.from_hf(
            hf_cfg, num_labels=max(len(labels), 2),
            attention_impl=select_attention_impl(cfg.engine, max_seq, dev))
        state = modernbert_state(load_safetensors(weights_path), kind)
        if kind == "embedding":
            module = MmBertEmbeddingModel(mcfg)
            module.load_state_dict(state)
        else:
            cls = ModernBertForTokenClassification if kind == "token" \
                else ModernBertForSequenceClassification
            module = cls(mcfg, model=trunks.get(path))
            if path in trunks:
                # the trunk is shared and loaded: this task brings its head
                state = {k: v for k, v in state.items()
                         if not k.startswith("model.")}
                missing, unexpected = module.load_state_dict(state,
                                                             strict=False)
                missing = [k for k in missing if not k.startswith("model.")]
                if missing or unexpected:
                    raise ValueError(f"task {task!r}: checkpoint keys "
                                     f"missing {missing}, unexpected "
                                     f"{unexpected}")
            else:
                module.load_state_dict(state)
                trunks[path] = module.model
        engine.register_task(task, kind, module, tokenizer_for(tok_dir),
                             labels, max_seq_len=max_seq,
                             pad_id=int(hf_cfg.get("pad_token_id", 0)))
        log.info("model loaded: task=%s kind=%s attention=%s", task, kind,
                 mcfg.attention_impl)
    apply_quant_knobs(cfg, engine)
    return engine


def _deberta(kind: str, hf_cfg: Dict, labels, weights_path: str):
    """A DeBERTa-v2/v3 sequence or token classifier from an HF checkpoint
    (``config.json`` fields through ``DebertaV3Config.from_hf``, HF tensor
    names as they are)."""
    import dataclasses

    from ..models.convert import hf_state_for, load_safetensors
    from ..models.deberta import (
        DebertaV3Config,
        DebertaV3ForSequenceClassification,
        DebertaV3ForTokenClassification,
    )

    dcfg = dataclasses.replace(DebertaV3Config.from_hf(hf_cfg),
                               num_labels=max(len(labels), 2))
    cls = DebertaV3ForTokenClassification if kind == "token" \
        else DebertaV3ForSequenceClassification
    state = load_safetensors(weights_path)
    return _meta_load(lambda: cls(dcfg), lambda m: hf_state_for(m, state))


def _generative(spec: Dict, hf_cfg: Dict, weights_path: str, tokenizer,
                dev) -> tuple:
    """(GreedyGenerator, adapter index) of a Qwen3 generative task: LoRA
    rows for the spec's ``adapters`` (identity adapters, A drawn from a
    generator seeded 0), EOS from ``eos_token_ids`` or the config."""
    import torch

    from ..models.convert import hf_state_for, load_safetensors
    from ..models.generate import GreedyGenerator, Qwen3Decoder, \
        with_lora_leaves
    from ..models.lora import LoRAConfig
    from ..models.qwen3 import Qwen3Config

    qcfg = Qwen3Config.from_hf(dict(
        hf_cfg, num_key_value_heads=hf_cfg.get(
            "num_key_value_heads", hf_cfg["num_attention_heads"])))
    adapters = {name: i for i, name in
                enumerate(spec.get("adapters", []) or [])}
    lora_spec = spec.get("lora") or {}
    lora = LoRAConfig(rank=int(lora_spec.get("rank", 8)),
                      alpha=float(lora_spec.get("alpha", 16.0)),
                      num_tasks=max(1, len(adapters))) if adapters else None
    state = load_safetensors(weights_path)
    if lora is not None:
        state = with_lora_leaves(qcfg, lora, state,
                                 torch.Generator().manual_seed(0))
    model = _meta_load(lambda: Qwen3Decoder(qcfg, lora),
                       lambda m: hf_state_for(m, state))
    eos_raw = spec.get("eos_token_ids") or hf_cfg.get("eos_token_id", 0)
    # HF configs carry an int or a list (the Qwen family uses a list)
    eos = list(eos_raw) if isinstance(eos_raw, (list, tuple)) else [eos_raw]
    return GreedyGenerator(qcfg, model, tokenizer, eos_token_ids=eos,
                           device=dev), adapters


def _siglip(hf_cfg: Dict, weights_path: str, tokenizer, dev):
    """A ``SiglipEmbedder`` over an HF SigLIP checkpoint (pad id 1, as
    the reference's embedder pads)."""
    from ..models.convert import load_safetensors, siglip_state_from_hf
    from ..models.siglip import SiglipEmbedder, SiglipModel, \
        SiglipTowerConfig

    text = SiglipTowerConfig.from_hf(hf_cfg["text_config"])
    vision = SiglipTowerConfig.from_hf(hf_cfg["vision_config"])
    state = siglip_state_from_hf(load_safetensors(weights_path))
    model = _meta_load(lambda: SiglipModel(text, vision), lambda m: state)
    return SiglipEmbedder(text, vision, model, tokenizer=tokenizer,
                          device=dev)


def apply_quant_knobs(cfg: RouterConfig, engine) -> None:
    """Apply ``engine.quant`` to a live engine (boot, or a config reload):
    each affected trunk group rebuilds its serving trunk at the selected
    mode.  A malformed block normalizes to off."""
    if engine is None:
        return
    engine.configure_quant(cfg.engine.quant)
    log.info("quant configured: mode=%s groups=%s",
             cfg.engine.quant_config()["mode"],
             {gid: m["quant"] for gid, m in
              engine.kernels_report()["groups"].items()})


def build_router(cfg: RouterConfig, engine=None, registry=None):
    """The Router over ``engine``, its observability and degradation
    controller bound to ``registry``'s sinks (the process defaults when
    None), its cascade attached as ``engine.cascade`` says (in
    ``registry``'s ``cascade`` slot) and its upstream plane as
    ``resilience.upstream`` says (``upstreams``), with its memory store: SQLite at ``memory.path`` under
    ``memory.backend: sqlite``, else in-process; both embed on the
    engine's ``EMBEDDING_TASK`` when it serves one."""
    from ..memory import InMemoryMemoryStore, SQLiteMemoryStore
    from ..router.pipeline import EMBEDDING_TASK, Router

    obs = {}
    if registry is not None:
        obs = {"metrics": registry.metric_series(),
               "tracer": registry.tracer, "flightrec": registry.flightrec,
               "explain": registry.explain}
    if registry is not None:
        obs["resilience"] = registry.get("resilience")
    router = Router(cfg, engine=engine, **obs)
    if registry is None:
        from .registry import RuntimeRegistry

        registry = RuntimeRegistry.with_defaults()
    apply_cascade_knobs(cfg, registry, router)
    apply_upstream_knobs(cfg, registry, router)
    embed_fn = None
    if engine is not None and engine.has_task(EMBEDDING_TASK):
        embed_fn = lambda text: engine.embed(EMBEDDING_TASK, [text])[0]
    mem_cfg = cfg.memory or {}
    if mem_cfg.get("backend", "") == "sqlite" and mem_cfg.get("path"):
        router.memory_store = SQLiteMemoryStore(mem_cfg["path"], embed_fn)
    else:
        router.memory_store = InMemoryMemoryStore(embed_fn)
    return router


def apply_cascade_knobs(cfg: RouterConfig, registry, router) -> None:
    """Attach, reconfigure or detach the decision-aware signal cascade
    (``engine/cascade``) on ``router``: enabled, the registry's evaluator
    (made once, so a reload keeps its counters) takes the normalized
    knobs and the router reads it; disabled, both let it go and the
    router fans out in full.  A malformed block never stops the server:
    it is logged and leaves the cascade as it was."""
    try:
        ck = cfg.engine.cascade_config()
        if not ck["enabled"]:
            if registry.get("cascade") is not None:
                registry.swap(cascade=None)
                log.info("cascade detached")
            if router is not None:
                router.cascade = None
            return
        from ..engine.cascade import CascadeEvaluator

        casc = registry.get("cascade")
        if casc is None:
            casc = CascadeEvaluator(
                metrics=registry.metric_series(),
                runtime_stats=registry.get("runtimestats"))
            registry.swap(cascade=casc)
            log.info("cascade attached")
        casc.runtime_stats = registry.get("runtimestats")
        casc.configure(ck)
        if router is not None:
            router.cascade = casc
    except Exception:
        log.warning("cascade config invalid", exc_info=True)


def apply_upstream_knobs(cfg: RouterConfig, registry, router) -> None:
    """Attach, reconfigure or detach the upstream health plane
    (``resilience/upstream.py``): enabled, the registry's plane (made
    once, so a reload keeps its breakers) takes the normalized block and
    reads the ladder's level through the registry's controller; disabled,
    nothing is built and the router forwards with plain endpoint
    failover.  A malformed block never stops the server."""
    try:
        up_cfg = cfg.upstream_config()
        if not up_cfg["enabled"]:
            if registry.get("upstreams") is not None:
                registry.swap(upstreams=None)
                log.info("upstream plane detached")
            if router is not None:
                router.upstream_health = None
            return
        from ..resilience.upstream import UpstreamHealth

        up = registry.get("upstreams")
        if up is None:
            up = UpstreamHealth(registry.metrics)
            registry.swap(upstreams=up)
            log.info("upstream plane attached")
        up.bind(events=registry.get("events"),
                resilience=registry.get("resilience"))
        up.configure(up_cfg)
        if router is not None:
            router.upstream_health = up
    except Exception:
        log.warning("upstream config invalid", exc_info=True)


def apply_resilience_knobs(cfg: RouterConfig, registry) -> None:
    """The SLO monitor and the degradation ladder on ``registry``: the
    monitor takes ``observability.slo`` (malformed objectives land in its
    ``config_errors``) and emits its alert transitions on the registry's
    event bus; the controller binds that bus, the monitor, the
    runtime-stats pressure providers, the tracer and the decision
    explainer (its L1 knob effects), takes the ``resilience`` block, and
    re-sheds the sampling knobs the observability block just restored.
    Each runs its loop when enabled and is stopped when not; ``stop`` on
    both (``registry.slo.stop()``, ``registry.resilience.stop()``) ends
    the threads.  A malformed block never stops the server."""
    slo = registry.get("slo")
    if slo is not None:
        try:
            slo.event_bus = registry.get("events")
            slo.configure(cfg.slo_config())
            if slo.enabled:
                slo.start(slo.evaluation_interval_s)
            else:
                slo.stop()
            if slo.config_errors:
                log.warning("SLO objectives invalid: %s",
                            slo.config_errors[:5])
        except Exception:
            log.warning("SLO config invalid", exc_info=True)
    res = registry.get("resilience")
    if res is not None:
        try:
            res.bind(events=registry.get("events"), slo=slo,
                     runtimestats=registry.get("runtimestats"),
                     tracer=registry.tracer,
                     explain=registry.get("explain"))
            res.configure(cfg.resilience_config())
            res.resync_knob_effects()
            if res.enabled:
                res.start(res.interval_s)
            else:
                res.stop()
        except Exception:
            log.warning("resilience config invalid", exc_info=True)


def warm_engine(engine, registry) -> None:
    """Warm ``engine`` (every served step captured at batch 1) and emit
    ``engine_ready`` on the registry's event bus, or ``engine_failed``
    and raise: the degradation controller jumps to fail-static on a
    failed engine and comes back on a ready one."""
    from .events import ENGINE_FAILED, ENGINE_READY

    bus = registry.get("events")
    try:
        engine.warmup()
    except Exception as exc:
        if bus is not None:
            bus.emit(ENGINE_FAILED, during="warmup",
                     error=f"{type(exc).__name__}: {exc}"[:200])
        raise
    if bus is not None:
        bus.emit(ENGINE_READY, tasks=sorted(engine.tasks()))


def apply_observability_knobs(cfg: RouterConfig, registry) -> None:
    """Apply the ``observability`` block (the config's accessors are the
    one interpretation point) to a registry's sinks: batch-trace sampling
    on the tracer, OpenMetrics exemplars on the metrics registry,
    flight-recorder retention (and its tail-based sampling hook on the
    tracer), the runtime-stats sampler (started, or stopped), the
    program catalog's switch and its SLO-burn capture (one bounded
    ``torch.profiler`` trace and a catalog snapshot per firing alert, on
    the registry's event bus), the decision-record knobs with their
    SQLite mirror, and then the SLO monitor and the degradation ladder
    (``apply_resilience_knobs``).  The accessors already fall back to the
    defaults on a malformed value; the runtime-stats sampler it starts
    is stopped by ``registry.runtimestats.stop()``."""
    registry.tracer.sample_rate = cfg.tracing_sample_rate()
    # unconditional: a reload must be able to turn exemplars OFF
    registry.metrics.enable_exemplars(cfg.metrics_exemplars_enabled())
    fr = registry.get("flightrec")
    if fr is not None:
        fr_cfg = cfg.flight_recorder_config()
        if fr_cfg:
            fr.configure(**fr_cfg)
        if fr.on_retain is None:
            fr.on_retain = registry.tracer.force_sample
    rs = registry.get("runtimestats")
    if rs is not None:
        rs_cfg = cfg.runtime_stats_config()
        rs.enabled = rs_cfg["enabled"]
        if rs_cfg["enabled"]:
            rs.start(rs_cfg["interval_s"])
        else:
            rs.stop()
    ps = registry.get("programstats")
    if ps is not None:
        ps_cfg = cfg.programstats_config()
        ps.enabled = ps_cfg["enabled"]
        cap_cfg = ps_cfg["slo_capture"]
        ctl = getattr(ps, "slo_capture", None)
        if ps_cfg["enabled"] and cap_cfg["enabled"]:
            if ctl is None:
                from ..observability.programstats import \
                    SLOCaptureController

                ctl = ps.slo_capture = SLOCaptureController(catalog=ps)
            # rebound every apply: a reload may have swapped any slot
            ctl.runtime_stats = registry.get("runtimestats")
            ctl.profiler = registry.get("profiler")
            ctl.flightrec = registry.get("flightrec")
            ctl.trace_s = cap_cfg["trace_s"]
            ctl.cooldown_s = cap_cfg["cooldown_s"]
            if ctl.flightrec is not None:
                ctl.flightrec.capture_provider = ctl.links
            ctl.attach(registry.get("events"))
        elif ctl is not None:
            ctl.detach()
    explain = registry.get("explain")
    if explain is not None:
        ex_cfg = cfg.decision_explain_config()
        explain.configure(ex_cfg)
        durable = ex_cfg.get("durable") or {}
        if durable.get("backend") == "sqlite" and durable.get("path"):
            cur = explain.durable_store
            if cur is None or cur.path != durable["path"]:
                from ..observability.explain_store import \
                    SQLiteDecisionStore

                explain.attach_durable(SQLiteDecisionStore(
                    durable["path"],
                    max_records=int(durable.get("max_records", 100_000))))
        elif explain.durable_store is not None:
            explain.attach_durable(None)
    apply_resilience_knobs(cfg, registry)


def serve(config: str, backend: str, host: str = "127.0.0.1",
          port: int = 8801, device: DeviceLike = None,
          status_path: Optional[str] = None, block: bool = True):
    """Load the config, build engine + router over the process-default
    observability sinks (configured by ``apply_observability_knobs``),
    and serve ``POST /v1/chat/completions``, the Classification API,
    ``/metrics`` and ``/debug/*`` until interrupted.  The engine warms
    (captures every served step at batch 1) before the server accepts a
    request; a warmup failure raises.

    A ``StartupTracker`` (written to ``status_path`` when given) follows
    the boot through ``loading_config``, ``loading_models``, ``warming``
    and ``ready``, or ``failed`` with the error; the server's
    ``GET /startup-status`` serves it.  With ``block=False`` the server
    starts in the background and (server, tracker) is returned; the
    caller then does what the blocking path does when it ends (stop the
    server, shut the router and engine down, stop the registry's
    sampler, SLO monitor and controller)."""
    from ..config.loader import load_config
    from ..router.server import RouterServer
    from .registry import RuntimeRegistry
    from .startup import StartupTracker

    tracker = StartupTracker(path=status_path)
    registry = RuntimeRegistry.with_defaults()
    engine = None
    try:
        tracker.advance("loading_config", config)
        cfg = load_config(config)
        apply_observability_knobs(cfg, registry)
        tracker.advance("loading_models",
                        f"{len(cfg.classifier_models or {})} configured")
        engine = build_engine(cfg, device=device, registry=registry)
        tracker.advance("warming")
        if engine is not None:
            warm_engine(engine, registry)
        router = build_router(cfg, engine, registry=registry)
        server = RouterServer(router, backend, host=host, port=port,
                              registry=registry)
        server.startup = tracker
    except Exception as exc:
        # a readiness monitor must see failed, not a boot that never ends
        tracker.fail(f"{type(exc).__name__}: {exc}")
        if engine is not None:
            engine.shutdown()
        raise
    tracker.advance("ready")
    log.info("serving on %s → %s", server.url, backend)
    if not block:
        return server.start(), tracker
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.httpd.server_close()
        router.shutdown()
        if engine is not None:
            engine.shutdown()
        registry.runtimestats.stop()
        registry.slo.stop()
        registry.resilience.stop()
