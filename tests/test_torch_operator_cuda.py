"""The operator plane on the card, cut to tiny sizes.

- A live server over a flash-attention bank, its config file written by a
  ``KubeOperator`` (``attach_kube_operator``) from CRs on a loopback
  ``MiniKubeAPI``: each CR step (a pool and a route, a changed model, a
  second route, an invalid route, a deletion) reaches the file and, through
  the hot-reload watcher, the live router, whose decisions and models equal
  the CPU port's router over the same rendered config; K1 launches on the
  routes, and the invalid route leaves the file as it was.
- ``Qwen3EmbeddingModel`` and ``GemmaEmbeddingModel`` on the card against
  the CPU port on the same weights (float32, TF32 off, within 1e-4).

``cuda``-marked: skips without a GPU.  Imports no JAX
(``python -m pytest --noconftest -m cuda tests/test_torch_operator_cuda.py``;
chip_smoke.py runs it beside its phase 22)."""

import copy
import os
import time

import pytest
import torch
import yaml

from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.engine.testing import TINY, \
    init_weights, make_shared_trunk_engine
from semantic_router_tpu_torch.models.gemma import GemmaConfig, \
    GemmaEmbeddingModel
from semantic_router_tpu_torch.models.qwen3 import Qwen3Config, \
    Qwen3EmbeddingModel
from semantic_router_tpu_torch.ops import _cuda
from semantic_router_tpu_torch.router import MockVLLMServer, Router, \
    RouterServer
from semantic_router_tpu_torch.runtime import RuntimeRegistry, \
    apply_kernel_knobs, attach_config_watcher, attach_kube_operator, \
    build_router
from semantic_router_tpu_torch.runtime.kubewatch import MiniKubeAPI

TOL = 1e-4
POOL = {"kind": "IntelligentPool", "metadata": {"name": "pool"},
        "spec": {"defaultModel": "m1",
                 "models": [{"name": "m1"}, {"name": "m2"}]}}
ROUTE = {"kind": "IntelligentRoute", "metadata": {"name": "domains"},
         "spec": {
             "signals": {"domains": [{"name": "law"}, {"name": "business"},
                                     {"name": "health"}]},
             "decisions": [
                 {"name": "law_route", "priority": 20,
                  "rules": {"operator": "OR", "conditions": [
                      {"type": "domain", "name": "law"}]},
                  "modelRefs": [{"model": "m2"}]},
                 {"name": "business_route", "priority": 10,
                  "rules": {"operator": "OR", "conditions": [
                      {"type": "domain", "name": "business"}]},
                  "modelRefs": [{"model": "m1"}]}]}}
ROUTE2 = {"kind": "IntelligentRoute", "metadata": {"name": "health"},
          "spec": {"decisions": [
              {"name": "health_route", "priority": 30,
               "rules": {"operator": "OR", "conditions": [
                   {"type": "domain", "name": "health"}]},
               "modelRefs": [{"model": "m2"}]}]}}
BAD = {"kind": "IntelligentRoute", "metadata": {"name": "bad"},
       "spec": {"decisions": [{"name": "ghost", "modelRefs": [
           {"model": "m1"}]}]}}
TEXTS = ["sue them for breach of contract", "quarterly revenue is up",
         "a dose of vitamin d", "the court ruled on appeal",
         "merger talks stalled again", "ok"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K2 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _engine(device, cfg):
    engine = make_shared_trunk_engine(
        device=device, seed=5, engine_cfg=cfg.engine,
        model_config=dict(TINY, attention_impl="flash"
                          if device == "cuda" else "dense"))
    apply_kernel_knobs(cfg, engine)
    return engine


def _routes(router):
    out = []
    for text in TEXTS:
        res = router.route({"model": "auto", "messages": [
            {"role": "user", "content": text}]})
        out.append((res.decision.decision.name if res.decision else None,
                    res.model))
    return out


def _wait(pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


@pytest.mark.cuda
def test_kube_operator_reloads_route_like_the_cpu_port(cuda_device,
                                                      tmp_path):
    api = MiniKubeAPI()
    path = str(tmp_path / "router.yaml")
    boot = {"default_model": "m1", "resilience": {"enabled": False},
            "engine": {"max_batch_size": 8, "max_wait_ms": 1.0,
                       "seq_len_buckets": [32, 128],
                       "kernels": {"epilogue": {"enabled": True}}},
            "routing": {"modelCards": [{"name": "m1"}], "decisions": []},
            "kubernetes": {"enabled": True, "api_url": api.url}}
    with open(path, "w") as f:
        yaml.safe_dump(boot, f)
    cfg = load_config(path)
    registry = RuntimeRegistry.isolated()
    engine = _engine(cuda_device, cfg)
    cpu = _engine("cpu", cfg)
    backend = MockVLLMServer().start()
    server = RouterServer(build_router(cfg, engine, registry=registry),
                          backend.url, registry=registry,
                          config_path=path).start()
    watcher = attach_config_watcher(server, path, engine, registry,
                                    start=False)
    op = attach_kube_operator(server, cfg, path, registry)
    assert op is not None and server.kube_operator is op
    steps = [("apply", "intelligentpools", POOL),
             ("apply", "intelligentroutes", ROUTE),
             ("model", "intelligentroutes", ROUTE),
             ("apply", "intelligentroutes", ROUTE2),
             ("invalid", "intelligentroutes", BAD),
             ("delete", "intelligentroutes", ROUTE2)]
    try:
        n_reloads = 0
        for i, (kind, plural, doc) in enumerate(steps):
            before = open(path).read()
            doc = copy.deepcopy(doc)
            if kind == "model":
                doc["spec"]["decisions"][1]["modelRefs"] = [{"model": "m2"}]
            if kind == "delete":
                api.delete(plural, doc["metadata"]["name"])
            else:
                api.apply(plural, doc)
            if kind == "invalid":
                assert _wait(lambda: op.last_status.startswith("invalid: "))
                assert open(path).read() == before
                api.delete(plural, "bad")
                assert _wait(lambda: op.reconcile_count > 0
                             and op.last_status == "unchanged")
                continue
            assert _wait(lambda: open(path).read() != before), kind
            st = os.stat(path)
            os.utime(path, (st.st_atime, st.st_mtime + 10 + i))
            assert watcher.poll_once(), kind
            n_reloads += 1
            rendered = load_config(path)
            assert "engine" not in (rendered.raw or {})
            _cuda.reset_launch_counts()
            got = _routes(server.router)
            launches = _cuda.launch_counts()
            ref = Router(rendered, engine=cpu)
            try:
                want = _routes(ref)
            finally:
                ref.shutdown()
            assert got == want, (kind, got, want)
            if rendered.decisions:
                assert launches["flash_attention"] > 0, launches
        assert n_reloads == 5
        # a CR-rendered config carries no engine block: the reference's
        # defaults apply, the head epilogue among them (off)
        meta = next(iter(engine.kernels_report()["groups"].values()))
        assert meta["epilogue"] is False
    finally:
        server.stop()
        assert not op._threads or not any(t.is_alive() for t in op._threads)
        server.router.shutdown()
        engine.shutdown()
        cpu.shutdown()
        backend.stop()
        api.close()
        for slot in ("runtimestats", "slo", "resilience"):
            registry.get(slot).stop()


def _ids(vocab, seed):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, vocab, (3, 20), generator=g)
    mask = torch.ones_like(ids)
    mask[1, 11:] = 0
    mask[2, 4:] = 0
    return ids * mask, mask


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["qwen3", "gemma"])
def test_embedding_models_on_the_card(cuda_device, kind):
    def build():
        if kind == "qwen3":
            return Qwen3EmbeddingModel(Qwen3Config(
                vocab_size=256, hidden_size=64, intermediate_size=96,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, head_dim=16))
        return GemmaEmbeddingModel(GemmaConfig(
            vocab_size=256, hidden_size=48, intermediate_size=80,
            num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=1, head_dim=16, sliding_window=6,
            sliding_pattern=3, rope_scaling_factor=2.0, causal=False),
            bottleneck_dims=(96, 32))

    module = build().eval()
    init_weights(module, 7, std=0.05)
    card = build().eval()
    card.load_state_dict(module.state_dict())
    card.to(cuda_device)
    ids, mask = _ids(256, 7)
    with torch.no_grad():
        want = module(ids, mask)
        got = card(ids.to(cuda_device), mask.to(cuda_device)).cpu()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= TOL
    assert torch.allclose(got.norm(dim=-1), torch.ones(3), atol=1e-5)
