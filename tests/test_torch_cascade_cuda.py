"""The decision-aware cascade on the card: a request that needs the
skippable wave runs it through the hand-written kernels (K1 once a layer
per trunk forward, K2 once a head bank), and routes as the port does on
the CPU.  ``cuda``-marked: skips without a GPU.  Imports no JAX, so it
runs on a machine without it (``python -m pytest --noconftest -m cuda
tests/test_torch_cascade_cuda.py``; chip_smoke.py's phase 10 does)."""

import pytest
import torch

from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.engine import cascade
from semantic_router_tpu_torch.engine.testing import TINY, \
    make_shared_trunk_engine
from semantic_router_tpu_torch.observability.metrics import MetricSeries, \
    MetricsRegistry
from semantic_router_tpu_torch.observability.tracing import Tracer
from semantic_router_tpu_torch.ops import _cuda
from semantic_router_tpu_torch.router import Router

PROB_TOL = 1e-4
TASKS = [("intent", ["business", "law", "other"]),
         ("user_feedback", ["none", "positive", "negative"]),
         ("modality", ["ar", "diffusion", "both"])]

CONFIG = {
    "default_model": "backend-model",
    "engine": {"max_batch_size": 8, "max_wait_ms": 1.0,
               "seq_len_buckets": [32, 128],
               "kernels": {"epilogue": {"enabled": True}}},
    "routing": {
        "signals": {
            "keywords": [{"name": "escalate", "keywords": ["urgent"]}],
            "domains": [{"name": "law"}],
            "user_feedbacks": [{"name": "positive"}, {"name": "negative"}],
            "modality": [{"name": "diffusion"}, {"name": "both"}]},
        "decisions": [
            {"name": "escalation", "priority": 100,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "keyword", "name": "escalate"}]},
             "modelRefs": [{"model": "escalation-model"}]},
            {"name": "law_route", "priority": 60,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "domain", "name": "law"}]},
             "modelRefs": [{"model": "law-model"}]},
            {"name": "feedback", "priority": 50,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "user_feedback", "name": "negative"},
                 {"type": "user_feedback", "name": "positive"}]},
             "modelRefs": [{"model": "retry-model"}]},
            {"name": "imagegen", "priority": 40,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "modality", "name": "diffusion"},
                 {"type": "modality", "name": "both"}]},
             "modelRefs": [{"model": "image-model"}]}]},
}
TEXTS = ["please summarize the quarterly report",
         "urgent: the database is down",
         "draw a red bicycle in the rain"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K2 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _router(device):
    cfg = load_config(CONFIG)
    engine = make_shared_trunk_engine(
        tasks=TASKS, lora_tasks=("modality",), device=device, seed=3,
        engine_cfg=cfg.engine,
        model_config=dict(TINY, attention_impl="flash"
                          if device == "cuda" else "dense"))
    router = Router(cfg, engine=engine, metrics=MetricSeries(
        MetricsRegistry()), tracer=Tracer(sample_rate=0.0))
    router.cascade = cascade.CascadeEvaluator()
    router.cascade.configure(cascade.normalize_cascade(
        {"enabled": True, "wave_size": 2}))
    return router, engine


def _name(res):
    return res.decision.decision.name if res.decision else None


@pytest.mark.cuda
def test_cascaded_waves_launch_k1_and_k2_and_match_the_cpu(cuda_device):
    card, card_engine = _router(cuda_device)
    cpu, cpu_engine = _router("cpu")
    layers = TINY["num_hidden_layers"]
    try:
        for text in TEXTS:
            body = {"model": "auto",
                    "messages": [{"role": "user", "content": text}]}
            _cuda.reset_launch_counts()
            forwards0 = card_engine.trunk_forwards
            got = card.route(body)
            launches = _cuda.launch_counts()
            forwards = card_engine.trunk_forwards - forwards0
            want = cpu.route(body)
            assert (_name(got), got.model) == (_name(want), want.model)
            assert got.report.cascade["waves"] == \
                want.report.cascade["waves"]
            assert got.report.cascade["skipped"] == \
                want.report.cascade["skipped"]
            assert got.signals.matches == want.signals.matches
            for k, v in want.signals.confidences.items():
                assert abs(got.signals.confidences[k] - v) <= PROB_TOL, k
            # every trunk forward of every wave ran K1 once a layer, and
            # its head bank through K2: no wave fell back to a plain path
            assert forwards > 0
            assert launches["flash_attention"] == layers * forwards
            assert launches["head_epilogue"] >= forwards
        assert any(r for r in card.cascade.report()["skipped_forwards"])
    finally:
        for r, e in ((card, card_engine), (cpu, cpu_engine)):
            r.shutdown()
            e.shutdown()
