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
``engine.cascade`` enables it (``apply_cascade_knobs``), the shared
state plane when ``stateplane`` does (``apply_stateplane_knobs``: the
plane in the registry's ``stateplane`` slot, the plane-shared semantic
cache, the fleet-aggregated ladder and the fleet-wide decision mirror)
and the upstream health plane when ``resilience.upstream`` does
(``apply_upstream_knobs``); a config reload calls them again.
``warm_engine`` warms the engine and
emits ``engine_ready`` (or ``engine_failed``) on the bus, which the
controller reads.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional, Tuple

from ..config.schema import InferenceEngineConfig, RouterConfig
from ..observability.logging import component_event
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
    apply_packing_knobs(cfg, engine)
    apply_kernel_knobs(cfg, engine)
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


def apply_packing_knobs(cfg: RouterConfig, engine) -> None:
    """Apply ``engine.packing`` to a live engine (boot, before the quant
    knobs, or a config reload): retunes the packing scheduler in place,
    starts the shape auto-tuner's thread when packing and its autotune
    are on (stops it otherwise; ``engine.shutdown()`` stops it too), and
    runs the packed shapes the engine's census names, so the first
    packed step after it replays.  A malformed block normalizes to the
    defaults."""
    if engine is None:
        return
    pk = cfg.engine.packing_config()
    engine.configure_packing(cfg.engine.packing)
    tuner = engine._autotuner
    if pk["enabled"] and pk["autotune"]["enabled"]:
        tuner.start(pk["autotune"]["interval_s"])
    else:
        tuner.stop()
    warmed = engine.warmup_packed_hot() if pk["enabled"] else 0
    component_event("bootstrap", "packing_configured",
                    enabled=pk["enabled"],
                    autotune=pk["autotune"]["enabled"],
                    warmed_shapes=warmed)


def apply_kernel_knobs(cfg: RouterConfig, engine) -> None:
    """Apply ``engine.quant`` and ``engine.kernels`` to a live engine
    (boot, or a config reload): each trunk group whose quant mode changes
    rebuilds its serving trunk, a changed kernels block (epilogue fusion,
    the BGMV gather and its ``min_tasks``) gives every group a new
    snapshot, and the packed shapes the replaced snapshots had run are run
    again on the new ones (``warmup_packed_hot``), so the first packed
    step after the flip replays.  In-flight batches finish on the
    snapshots they read or run again on the new ones.  A malformed block
    normalizes to its defaults; a kernel that fails to launch raises."""
    if engine is None:
        return
    engine.configure_quant(cfg.engine.quant)
    engine.configure_kernels(cfg.engine.kernels)
    warmed = engine.warmup_packed_hot()
    kk = cfg.engine.kernels_config()
    component_event("bootstrap", "kernels_configured",
                    quant=cfg.engine.quant_config()["mode"],
                    epilogue=kk["epilogue"]["enabled"],
                    bgmv=kk["bgmv"]["enabled"], warmed_shapes=warmed)


def build_router(cfg: RouterConfig, engine=None, registry=None,
                 carry_from=None):
    """The Router over ``engine``, its observability and degradation
    controller bound to ``registry``'s sinks (the process defaults when
    None), its cascade attached as ``engine.cascade`` says (in
    ``registry``'s ``cascade`` slot), the shared state plane as
    ``stateplane`` says (``stateplane``) and its upstream plane as
    ``resilience.upstream`` says (``upstreams``), with its memory store
    (``_memory_store``) and its vector stores (a ``VectorStoreManager``
    on ``vectorstore.backend``, ``memory`` promoted to ``stateplane``
    under the plane's ``share.vectorstore``), both embedding on the
    engine's ``EMBEDDING_TASK`` when it serves one, and the on-device
    ANN plane as ``ann`` says (``apply_ann_knobs``, in the ``ann``
    slot), router replay (``_attach_replay``) and the routing flywheel as
    ``flywheel`` says (``apply_flywheel_knobs``, in the ``flywheel``
    slot; before the cascade, whose order reads its values).  ``carry_from`` (the
    router a config reload replaces) hands on its semantic cache, its
    state plane, its memory store, its vector stores, its response hooks
    and its replay store."""
    from ..router.pipeline import EMBEDDING_TASK, Router
    from ..vectorstore import VectorStoreManager

    obs = {}
    if registry is not None:
        obs = {"metrics": registry.metric_series(),
               "tracer": registry.tracer, "flightrec": registry.flightrec,
               "explain": registry.explain}
    if registry is not None:
        obs["resilience"] = registry.get("resilience")
    router = Router(cfg, engine=engine, **obs)
    if carry_from is not None and carry_from.cache is not None:
        router.cache = carry_from.cache
    if registry is None:
        from .registry import RuntimeRegistry

        registry = RuntimeRegistry.with_defaults()
    apply_flywheel_knobs(cfg, registry, router)
    apply_cascade_knobs(cfg, registry, router)
    apply_stateplane_knobs(cfg, registry, router, carry_from=carry_from)
    apply_upstream_knobs(cfg, registry, router)
    embed_fn = None
    if engine is not None and engine.has_task(EMBEDDING_TASK):
        embed_fn = lambda text: engine.embed(EMBEDDING_TASK, [text])[0]
    if carry_from is not None:
        router.memory_store = carry_from.memory_store
        router.vectorstores = carry_from.vectorstores
        router.response_hooks = list(carry_from.response_hooks)
        router.replay_store = carry_from.replay_store
    else:
        _attach_replay(cfg, router)
        router.memory_store = _memory_store(
            cfg, embed_fn, getattr(router, "_remote_embedder", None))
        vs_cfg = cfg.vectorstore or {}
        vs_backend = vs_cfg.get("backend", "memory")
        sp_cfg = cfg.stateplane_config()
        if router.stateplane is not None \
                and sp_cfg["share"]["vectorstore"] \
                and vs_backend == "memory":
            vs_backend = "stateplane"
        store_registry = _vectorstore_registry(vs_cfg)
        router.vectorstores = VectorStoreManager(
            embed_fn, backend=vs_backend, base_path=vs_cfg.get("path"),
            backend_config=vs_cfg.get("backend_config"),
            registry=store_registry, stateplane=router.stateplane)
        if store_registry is not None:
            attached = router.vectorstores.load_from_registry()
            if attached:
                component_event("bootstrap", "vectorstore_registry_attach",
                                stores=attached)
    apply_ann_knobs(cfg, registry, router)
    return router


def _attach_replay(cfg: RouterConfig, router) -> None:
    """Router replay, on unless ``router_replay.enabled`` is false (the
    reference's default): the store — a SQLite file (``backend: sqlite``
    with a ``path``), a Postgres table (``backend: postgres``), else the
    in-memory ring, appended to the JSONL file at ``path`` when given —
    as ``router.replay_store``, and its ``ReplayRecorder`` on
    ``router.response_hooks``."""
    from ..replay import ReplayRecorder, ReplayStore

    rc = cfg.router_replay or {}
    if not rc.get("enabled", True):
        return
    if rc.get("backend") == "sqlite" and rc.get("path"):
        from ..replay.sqlite_store import SQLiteReplayStore

        store = SQLiteReplayStore(
            rc["path"], max_records=int(rc.get("max_records", 100_000)))
    elif rc.get("backend") == "postgres":
        from ..replay.postgres_store import PostgresReplayStore

        store = PostgresReplayStore(
            host=rc.get("host", "127.0.0.1"),
            port=int(rc.get("port", 5432)),
            user=rc.get("user", "postgres"),
            database=rc.get("database", "postgres"),
            password=str(rc.get("password", "")),
            max_records=int(rc.get("max_records", 100_000)))
    else:
        store = ReplayStore(max_records=int(rc.get("max_records", 10_000)),
                            path=rc.get("path"))
    router.replay_store = store
    router.response_hooks.append(ReplayRecorder(
        store,
        capture_request_body=bool(rc.get("capture_request_body", False)),
        capture_response_body=bool(rc.get("capture_response_body", False))))


def attach_otlp(server, cfg: RouterConfig) -> None:
    """OTLP export when ``observability.tracing.otlp_endpoint`` names a
    collector: the server registry's finished spans to its
    ``/v1/traces`` (``server.otlp_exporter``) and the explainer's
    decision records to its ``/v1/logs`` (``server.otlp_log_exporter``);
    ``server.stop()`` detaches and flushes both."""
    from ..observability.otlp import (
        build_exporter_from_config,
        build_log_exporter_from_config,
    )

    server.otlp_exporter = build_exporter_from_config(
        cfg.tracing_config(), server.registry.tracer)
    server.otlp_log_exporter = build_log_exporter_from_config(
        cfg.tracing_config(), server.registry.get("explain"))


def _vectorstore_registry(vs_cfg: dict):
    """The vector stores' durable metadata registry:
    ``vectorstore.registry.backend: postgres`` connects a
    ``PostgresMetadataRegistry``; one that cannot connect fails open
    (``vectorstore_registry_failed``, no registry).  None otherwise."""
    reg_cfg = vs_cfg.get("registry") or {}
    if reg_cfg.get("backend") != "postgres":
        return None
    from ..vectorstore.pg_registry import PostgresMetadataRegistry

    try:
        return PostgresMetadataRegistry(
            host=reg_cfg.get("host", "127.0.0.1"),
            port=int(reg_cfg.get("port", 5432)),
            user=reg_cfg.get("user", "postgres"),
            database=reg_cfg.get("database", "postgres"),
            password=str(reg_cfg.get("password", "")))
    except Exception as exc:
        component_event("bootstrap", "vectorstore_registry_failed",
                        level="warning", error=str(exc)[:200])
        return None


def _memory_store(cfg: RouterConfig, embed_fn, remote=None):
    """The ``memory`` block's store: SQLite at ``memory.path`` under
    ``backend: sqlite``; the Qdrant / Milvus store of ``memory.ann_store``
    under ``qdrant`` / ``milvus``, embedding on the engine's task or,
    without one, through ``remote`` (the router's remote embedding
    provider, ``external_models``), and in-process, stamped
    ``memory_backend_fallback``, when there is neither; else
    in-process."""
    from ..memory import InMemoryMemoryStore, SQLiteMemoryStore

    mem_cfg = cfg.memory or {}
    backend = mem_cfg.get("backend", "")
    if backend == "sqlite" and mem_cfg.get("path"):
        return SQLiteMemoryStore(mem_cfg["path"], embed_fn)
    if backend in ("qdrant", "milvus"):
        mem_embed = embed_fn
        if mem_embed is None and remote is not None:
            mem_embed = lambda text: remote.embed("embedding", [text])[0]
        if mem_embed is None:
            component_event("bootstrap", "memory_backend_fallback",
                            backend=backend, level="warning",
                            reason="no embedding source; using in-proc")
            return InMemoryMemoryStore(embed_fn)
        if backend == "qdrant":
            from ..memory.ann_store import QdrantMemoryStore

            return QdrantMemoryStore(
                mem_embed,
                base_url=mem_cfg.get("base_url", "http://127.0.0.1:6333"),
                api_key=str(mem_cfg.get("api_key", "")),
                collection=mem_cfg.get("collection", "vsr_memory"))
        from ..memory.ann_store import MilvusMemoryStore

        return MilvusMemoryStore(
            mem_embed,
            base_url=mem_cfg.get("base_url", "http://127.0.0.1:19530"),
            token=str(mem_cfg.get("token", "")),
            db_name=mem_cfg.get("db_name", "default"),
            collection=mem_cfg.get("collection", "vsr_memory"))
    return InMemoryMemoryStore(embed_fn)


def apply_ann_knobs(cfg: RouterConfig, registry, router) -> None:
    """Attach, configure or detach the on-device ANN plane (``ann/``) for
    a registry and router pair; called by ``build_router``, at boot and
    on a rebuild.  ``ann.enabled: false`` (the default) constructs
    nothing and closes any plane the registry holds (``ann_detached``);
    the cache's similarity and the vector stores' search stay as they
    were.  Enabled: the registry's plane (made once, on the engine's
    device, ``ann_attached``) takes the normalized knobs; under
    ``share.cache`` the shared semantic cache's similarity moves onto the
    ``cache`` index (bound to the state plane's cache rows when a plane
    is attached) and its mirror gates off; under ``share.vectorstore``
    the ``ann`` vector-store backend gets the plane.  A malformed block
    never stops the server (``ann_config_invalid``)."""
    try:
        ak = cfg.ann_config()
        cache = getattr(router, "cache", None)
        vsm = getattr(router, "vectorstores", None)
        if not ak["enabled"]:
            close_ann(registry)
            if cache is not None and hasattr(cache, "detach_ann"):
                cache.detach_ann()
            if vsm is not None:
                vsm.ann = None
            return
        from ..ann import AnnPlane

        plane = registry.get("ann")
        if plane is None:
            engine = getattr(router, "engine", None)
            plane = AnnPlane(registry.metrics,
                             programstats=registry.get("programstats"),
                             runtime_stats=registry.get("runtimestats"),
                             device=engine.device if engine is not None
                             else None)
            registry.swap(ann=plane)
            component_event("bootstrap", "ann_attached",
                            device=str(plane.device))
        plane.configure(ak)
        if cache is not None and hasattr(cache, "attach_ann"):
            if ak["share"]["cache"]:
                sp = getattr(router, "stateplane", None)
                idx = plane.bind_cache_sync(sp) if sp is not None \
                    else plane.index("cache")
                cache.attach_ann(idx)
            else:
                cache.detach_ann()
        if vsm is not None:
            vsm.ann = plane if ak["share"]["vectorstore"] else None
        component_event("bootstrap", "ann_configured", quant=ak["quant"])
    except Exception as exc:
        component_event("bootstrap", "ann_config_invalid",
                        error=f"{type(exc).__name__}: {exc}"[:200],
                        level="warning")


def close_ann(registry) -> None:
    """Close the ANN plane ``registry`` holds (its maintenance thread and
    lookup batchers) and let it go; a no-op without one."""
    plane = registry.get("ann")
    if plane is None:
        return
    registry.swap(ann=None)
    try:
        plane.close()
    except Exception:
        pass
    component_event("bootstrap", "ann_detached")


def apply_flywheel_knobs(cfg: RouterConfig, registry, router) -> None:
    """Attach, configure or detach the routing flywheel
    (``flywheel/controller.py``) for a registry and router pair, as the
    reference's does: enabled, the registry's ``flywheel`` controller
    (made once, so a reload keeps its state, its candidate and a
    promotion, re-installed on the new router by ``bind``) binds the
    registry's decision records, event bus and cost model and the
    router, whose route then calls it; ``flywheel.enabled: false`` (the
    default) builds nothing and closes and lets go a previous
    controller.  A malformed block never stops the server."""
    try:
        fw_cfg = cfg.flywheel_config()
        if not fw_cfg["enabled"]:
            old = registry.get("flywheel")
            if old is not None:
                try:
                    old.close()
                except Exception:
                    pass
                registry.swap(flywheel=None)
                component_event("bootstrap", "flywheel_detached")
            if router is not None:
                router.flywheel = None
            return
        from ..flywheel import FlywheelController

        fw = registry.get("flywheel")
        if fw is None:
            fw = FlywheelController(registry.metrics)
            registry.swap(flywheel=fw)
            component_event("bootstrap", "flywheel_attached")
        res = registry.get("resilience")
        fw.bind(explain=registry.get("explain"),
                events=registry.get("events"),
                cost_model=getattr(res, "cost_model", None)
                if res is not None else None,
                router=router)
        fw.configure(fw_cfg)
        if router is not None:
            router.flywheel = fw
    except Exception as exc:
        component_event("bootstrap", "flywheel_config_invalid",
                        error=f"{type(exc).__name__}: {exc}"[:200],
                        level="warning")


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
        # re-bound every apply: a reload swaps the router (and with it
        # the flywheel handle the ordering and the passthrough read)
        casc.flywheel_provider = lambda: getattr(router, "flywheel", None)
        casc.runtime_stats = registry.get("runtimestats")
        casc.configure(ck)
        if router is not None:
            router.cascade = casc
    except Exception:
        log.warning("cascade config invalid", exc_info=True)


def apply_stateplane_knobs(cfg: RouterConfig, registry, router,
                           carry_from=None) -> None:
    """Attach, carry or detach the shared state plane (``stateplane/``)
    for a registry and router pair.  Enabled: the plane ``carry_from``
    or the registry already holds is kept (a reload keeps its
    membership and breaker), else one is built and started
    (``stateplane_attached``; a plane that fails to build leaves the
    replica on local state, ``stateplane_failed``).  Disabled: a plane
    the registry or ``carry_from`` holds is closed and let go
    (``stateplane_detached``).  Then the consumers follow the plane:
    the in-process semantic cache is wrapped in a ``SharedSemanticCache``
    under ``share.cache`` (which embeds through the cache's own embedding
    function, on the engine's embedding task) or unwrapped to its local
    fallback; the degradation controller steps from the fleet's pressure
    under ``share.fleet``; the decision mirror follows ``share.explain``
    (``_attach_durable``).  ``enabled: false`` (the default) builds
    nothing."""
    sp_cfg = cfg.stateplane_config()
    old = registry.get("stateplane")
    if old is None and carry_from is not None:
        old = carry_from.stateplane
    plane = None
    if sp_cfg["enabled"]:
        plane = old
        if plane is None:
            try:
                from ..stateplane import build_state_plane

                plane = build_state_plane(cfg, metrics=registry.metrics)
                plane.start()
                component_event("bootstrap", "stateplane_attached",
                                backend=sp_cfg["backend"],
                                replica=plane.replica_id)
            except Exception as exc:
                component_event("bootstrap", "stateplane_failed",
                                level="warning",
                                error=f"{type(exc).__name__}: "
                                      f"{exc}"[:200])
                plane = None
    elif old is not None:
        # a reload that turned the plane off must stop it: heartbeat
        # thread, registry slot, /debug/stateplane, fleet sensing
        try:
            old.close()
        except Exception:
            pass
        component_event("bootstrap", "stateplane_detached")
    registry.swap(stateplane=plane)
    if router is not None:
        router.stateplane = plane
        _wrap_cache(cfg, sp_cfg, plane, router)
    _bind_fleet(cfg, registry)
    explain = registry.get("explain")
    if explain is not None and (plane is not None or getattr(
            explain.durable_store, "plane", None) is not None):
        _attach_durable(cfg, registry, explain)
    _attach_fleetobs(cfg, registry)


def _attach_fleetobs(cfg: RouterConfig, registry) -> None:
    """The fleet observability plane (``observability/fleetobs.py``),
    built only when both the registry holds a state plane and
    ``observability.fleet.enabled``: its publisher on the plane's
    heartbeat, the registry's ``fleetobs`` slot (``fleetobs_attached``)
    and the SLO monitor's ``fleet_source``.  A plane swapped out under
    an attached one re-homes it onto the new plane; an unchanged one
    retunes its knobs and rebinds its sinks in place.  Disabled, or with
    no plane: ``_detach_fleetobs``."""
    fl_cfg = cfg.fleet_obs_config()
    plane = registry.get("stateplane")
    fobs = registry.get("fleetobs")
    slo = registry.get("slo")
    try:
        if fl_cfg["enabled"] and plane is not None:
            if fobs is None or fobs.plane is not plane:
                from ..observability.fleetobs import build_fleet_obs

                if fobs is not None:  # the plane was swapped out
                    fobs.plane.remove_publisher(fobs.publisher.maybe_publish)
                fobs = build_fleet_obs(
                    fl_cfg, plane, registry.metrics,
                    flightrec=registry.get("flightrec"),
                    explain=registry.get("explain"), slo=slo)
                plane.add_publisher(fobs.publisher.maybe_publish)
                registry.swap(fleetobs=fobs)
                component_event("bootstrap", "fleetobs_attached",
                                replica=plane.replica_id)
            else:
                fobs.publisher.interval_s = fl_cfg["publish_interval_s"]
                fobs.publisher.debug_top_n = fl_cfg["debug_top_n"]
                fobs.aggregator.cache_s = fl_cfg["cache_s"]
                fobs.publisher.flightrec = registry.get("flightrec")
                fobs.publisher.explain = registry.get("explain")
                fobs.publisher.slo = slo
            if slo is not None:
                slo.fleet_source = fobs.aggregator.merged_registry
        else:
            _detach_fleetobs(registry)
    except Exception as exc:
        component_event("bootstrap", "fleetobs_config_invalid",
                        error=str(exc)[:200], level="warning")


def _wrap_cache(cfg: RouterConfig, sp_cfg: Dict, plane, router) -> None:
    """The plane-shared semantic cache: only an in-process cache is
    wrapped (a redis / valkey cache is cross-replica already), and it
    stays as the local fallback the plane degrades to.  Reload-aware
    both ways: a carried plain cache is wrapped when the plane turns on,
    a carried shared one unwraps when the plane (or ``share.cache``)
    turns off."""
    from ..stateplane.cache import SharedSemanticCache

    cache = router.cache
    if plane is not None and sp_cfg["share"]["cache"] \
            and cache is not None \
            and cfg.semantic_cache.backend_type in ("memory", "hnsw",
                                                    "hybrid"):
        if not isinstance(cache, SharedSemanticCache):
            router.cache = SharedSemanticCache(
                plane, cache.embed_fn,
                similarity_threshold=cfg.semantic_cache
                .similarity_threshold,
                ttl_seconds=cfg.semantic_cache.ttl_seconds,
                local=cache)
    elif isinstance(cache, SharedSemanticCache) and cache.local is not None:
        cache.backend.off_recover(cache.reconcile)
        router.cache = cache.local


def _bind_fleet(cfg: RouterConfig, registry) -> None:
    """The ladder's fleet sensor: the registry's plane under
    ``stateplane.share.fleet``, else none (``bind`` only attaches, so a
    reload that turned the share off detaches here)."""
    res = registry.get("resilience")
    if res is None:
        return
    plane = registry.get("stateplane")
    if plane is not None and cfg.stateplane_config()["share"]["fleet"]:
        res.bind(fleet=plane)
    else:
        res.fleet = None


def _attach_durable(cfg: RouterConfig, registry, explain) -> None:
    """The decision records' durable mirror: SQLite at
    ``observability.decisions.durable.path`` when configured (the same
    path keeps the same store across reloads), else the plane's
    fleet-wide mirror while a plane is attached with ``share.explain``
    (every replica then serves the fleet's records at
    ``/debug/decisions?source=durable``), else none."""
    durable = cfg.decision_explain_config().get("durable") or {}
    plane = registry.get("stateplane")
    cur = explain.durable_store
    if durable.get("backend") == "sqlite" and durable.get("path"):
        if cur is None or getattr(cur, "path", "") != durable["path"]:
            from ..observability.explain_store import SQLiteDecisionStore

            explain.attach_durable(SQLiteDecisionStore(
                durable["path"],
                max_records=int(durable.get("max_records", 100_000))))
    elif plane is not None \
            and cfg.stateplane_config()["share"]["explain"]:
        from ..stateplane import StatePlaneDecisionStore

        if not isinstance(cur, StatePlaneDecisionStore) \
                or cur.plane is not plane:
            explain.attach_durable(StatePlaneDecisionStore(
                plane, max_records=int(durable.get("max_records",
                                                   10_000))))
    elif cur is not None:
        explain.attach_durable(None)


def apply_upstream_knobs(cfg: RouterConfig, registry, router) -> None:
    """Attach, reconfigure or detach the upstream health plane
    (``resilience/upstream.py``): enabled, the registry's plane (made
    once, so a reload keeps its breakers) takes the normalized block and
    reads the ladder's level through the registry's controller; disabled,
    nothing is built and the router forwards with plain endpoint
    failover.  With a state plane in the registry and ``fleet_share``
    on, open circuits and the retry budget are shared over it.  A
    malformed block never stops the server."""
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
                plane=registry.get("stateplane"),
                resilience=registry.get("resilience"))
        if not up_cfg["fleet_share"]:
            # bind() only ever attaches; a reload that turned
            # fleet_share off must detach the plane or open circuits
            # keep publishing
            up.plane = None
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
            _bind_fleet(cfg, registry)
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
    SQLite mirror, the fleet observability plane over the registry's
    state plane (``_attach_fleetobs``), and then the SLO monitor and the
    degradation ladder (``apply_resilience_knobs``).  The accessors already fall back to the
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
        explain.configure(cfg.decision_explain_config())
        _attach_durable(cfg, registry, explain)
    _attach_fleetobs(cfg, registry)
    apply_resilience_knobs(cfg, registry)


# seconds a router a reload replaced keeps its dispatcher, so requests
# already inside its route() finish their fan-out
RELOAD_GRACE_S = 30.0


def attach_config_watcher(server, config_path: str, engine, registry,
                          start: bool = True):
    """Hot reload for a live server: a ``ConfigWatcher`` on
    ``config_path`` whose swap builds the new config's router over the
    same engine (``build_router(carry_from=)`` hands on the semantic
    cache, the state plane, the memory store and the vector stores, and
    applies the flywheel, cascade, state-plane, upstream and ANN knobs),
    swaps ``server.router`` and ``server.cfg``, re-applies the knob blocks
    in the reference's order (observability, flywheel, cascade, upstream,
    ANN, packing, then ``engine.quant`` / ``engine.kernels`` through
    ``apply_kernel_knobs``), emits ``config_reloaded`` on the registry's
    event bus and retires the old router's dispatcher after
    ``RELOAD_GRACE_S`` (``server.stop()`` ends the grace at once).  A
    file that does not load (invalid, refused, half written) leaves the
    old config serving.  ``start`` runs the watcher's polling thread
    (every 2 s); without it the caller drives ``poll_once()``."""
    from ..config.loader import ConfigWatcher
    from .events import CONFIG_RELOADED

    def on_reload(new_cfg: RouterConfig) -> None:
        old = server.router
        new_router = build_router(new_cfg, engine, registry=registry,
                                  carry_from=old)
        server.router = new_router
        server.cfg = new_cfg
        apply_observability_knobs(new_cfg, registry)
        apply_flywheel_knobs(new_cfg, registry, new_router)
        apply_cascade_knobs(new_cfg, registry, new_router)
        apply_upstream_knobs(new_cfg, registry, new_router)
        apply_ann_knobs(new_cfg, registry, new_router)
        apply_packing_knobs(new_cfg, engine)
        apply_kernel_knobs(new_cfg, engine)
        server.retire_router(old, RELOAD_GRACE_S)
        component_event("bootstrap", "config_reloaded")
        bus = registry.get("events")
        if bus is not None:
            bus.emit(CONFIG_RELOADED, decisions=len(new_cfg.decisions))

    watcher = ConfigWatcher(config_path, on_reload)
    server.watcher = watcher
    return watcher.start() if start else watcher


def serve(config: str, backend: str, host: str = "127.0.0.1",
          port: int = 8801, device: DeviceLike = None,
          status_path: Optional[str] = None, block: bool = True,
          watch_config: bool = True):
    """Load the config, build engine + router over the process-default
    observability sinks (configured by ``apply_observability_knobs``),
    and serve ``POST /v1/chat/completions``, the Classification API,
    ``/metrics``, ``/debug/*`` and the ``/config/*`` management API until
    interrupted.  The engine warms (captures every served step at batch
    1) before the server accepts a request; a warmup failure raises.
    With ``watch_config`` (the default) the config file is watched and
    hot reloaded into the live server (``attach_config_watcher``); the
    watcher is ``server.watcher``.

    A ``StartupTracker`` (written to ``status_path`` when given) follows
    the boot through ``loading_config``, ``loading_models``, ``warming``
    and ``ready``, or ``failed`` with the error; the server's
    ``GET /startup-status`` serves it.  With ``block=False`` the server
    starts in the background and (server, tracker) is returned; the
    caller then does what the blocking path does when it ends (stop the
    server, which stops its watcher, shut ``server.router`` and the
    engine down, stop the registry's sampler, SLO monitor and
    controller, close its flywheel, ``close_ann``,
    ``close_stateplane``)."""
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
                              registry=registry, config_path=config)
        server.startup = tracker
        attach_otlp(server, cfg)
    except Exception as exc:
        # a readiness monitor must see failed, not a boot that never ends
        tracker.fail(f"{type(exc).__name__}: {exc}")
        if engine is not None:
            engine.shutdown()
        raise
    if watch_config:
        attach_config_watcher(server, config, engine, registry)
    tracker.advance("ready")
    log.info("serving on %s → %s", server.url, backend)
    if not block:
        return server.start(), tracker
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        server.router.shutdown()
        if engine is not None:
            engine.shutdown()
        registry.runtimestats.stop()
        registry.slo.stop()
        registry.resilience.stop()
        if registry.get("flywheel") is not None:
            registry.flywheel.close()
        close_ann(registry)
        close_stateplane(registry)


def close_stateplane(registry) -> None:
    """Stop what the state plane runs in ``registry``: its decision
    mirror's writer and its heartbeat (the replica leaves the ring), and
    let the plane go.  A no-op without a plane."""
    plane = registry.get("stateplane")
    if plane is None:
        return
    explain = registry.get("explain")
    if explain is not None and getattr(explain.durable_store, "plane",
                                       None) is plane:
        explain.attach_durable(None)
    registry.swap(stateplane=None)
    _detach_fleetobs(registry)
    plane.close()


def _detach_fleetobs(registry) -> None:
    """"Off" means off: the registry's fleet plane comes off its state
    plane's heartbeat, its published keys are dropped and its slot
    emptied (``fleetobs_detached``), and the SLO monitor's
    ``fleet_source`` is unbound."""
    fobs = registry.get("fleetobs")
    if fobs is not None:
        fobs.plane.remove_publisher(fobs.publisher.maybe_publish)
        registry.swap(fleetobs=None)
        try:
            fobs.close()
        except Exception:
            pass
        component_event("bootstrap", "fleetobs_detached")
    slo = registry.get("slo")
    if slo is not None:
        slo.fleet_source = None
