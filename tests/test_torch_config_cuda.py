"""A config hot reload on the card, cut to tiny sizes: a live server over a
flash-attention bank with the head epilogue on takes chat requests from
4 client threads while its config file flips ``engine.quant`` to bf16
and the BGMV gather on (``min_tasks: 2``), then back: no request fails,
the launch counters show K1 in bf16 and K3 after the flip, and K1 in
float32 and K2 (the sequence heads off BGMV again) only after the flip
back, and the card's probabilities equal the CPU port's under the same
config (within 1e-4 in float32, 5e-2 in bf16).  ``cuda``-marked: skips without a GPU.  Imports no JAX
(``python -m pytest --noconftest -m cuda tests/test_torch_config_cuda.py``;
chip_smoke.py runs it after phase 19)."""

import copy
import http.client
import json
import os
import threading
import urllib.parse

import pytest
import torch
import yaml

from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.engine.testing import SHARED_TRUNK_TASKS, \
    TINY, make_shared_trunk_engine
from semantic_router_tpu_torch.ops import _cuda
from semantic_router_tpu_torch.router import MockVLLMServer, RouterServer
from semantic_router_tpu_torch.runtime import RuntimeRegistry, \
    apply_kernel_knobs, attach_config_watcher, build_router

TASKS = [name for name, _ in SHARED_TRUNK_TASKS]
TOL = {"off": 1e-4, "bf16": 5e-2}
CONFIG = {
    "default_model": "m1",
    # the degradation ladder stays off: no answer here may be shed
    "resilience": {"enabled": False},
    "engine": {"max_batch_size": 8, "max_wait_ms": 1.0,
               "seq_len_buckets": [32, 128],
               "kernels": {"epilogue": {"enabled": True}}},
    "routing": {
        "modelCards": [{"name": "m1"}, {"name": "m2"}],
        "signals": {"domains": [{"name": "law"}, {"name": "business"}]},
        "decisions": [
            {"name": "law_route", "priority": 20,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "domain", "name": "law"}]},
             "modelRefs": [{"model": "m2"}]},
            {"name": "business_route", "priority": 10,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "domain", "name": "business"}]},
             "modelRefs": [{"model": "m1"}]}]}}
FLIPPED = copy.deepcopy(CONFIG)
FLIPPED["engine"]["quant"] = {"mode": "bf16"}
FLIPPED["engine"]["kernels"]["bgmv"] = {"enabled": True, "min_tasks": 2}
TEXTS = ["sue them for breach of contract", "quarterly revenue is up",
         "what is the capital of france", "the court ruled on appeal",
         "merger talks stalled again", "ok"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1, K2 and K3 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _engine(device, cfg):
    engine = make_shared_trunk_engine(
        device=device, seed=4, engine_cfg=cfg.engine,
        model_config=dict(TINY, attention_impl="flash"
                          if device == "cuda" else "dense"))
    apply_kernel_knobs(cfg, engine)
    return engine


def _post(url, text):
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    try:
        conn.request("POST", "/v1/chat/completions", body=json.dumps(
            {"model": "auto", "messages": [
                {"role": "user", "content": text}]}).encode(),
            headers={"content-type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        return resp.status
    finally:
        conn.close()


def _probs(engine):
    return {t: [r.probs for r in rs]
            for t, rs in engine.classify_multi(TASKS, TEXTS).items()}


def _close(got, want, tol):
    return max(abs(g[k] - w[k]) for t in TASKS
               for g, w in zip(got[t], want[t]) for k in w) <= tol


@pytest.mark.cuda
def test_reload_flips_quant_and_bgmv_under_traffic(cuda_device, tmp_path):
    path = str(tmp_path / "router.yaml")
    with open(path, "w") as f:
        f.write(yaml.safe_dump(CONFIG))
    cfg = load_config(path)
    registry = RuntimeRegistry.isolated()
    engine = _engine(cuda_device, cfg)
    backend = MockVLLMServer().start()
    server = RouterServer(build_router(cfg, engine, registry=registry),
                          backend.url, registry=registry,
                          config_path=path).start()
    watcher = attach_config_watcher(server, path, engine, registry,
                                    start=False)
    statuses, stop = [], threading.Event()

    def client(i):
        while not stop.is_set():
            statuses.append(_post(server.url, TEXTS[i % len(TEXTS)]))
            i += 1

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    cpu = {}
    try:
        for t in threads:
            t.start()
        for mode, doc in (("bf16", FLIPPED), ("off", CONFIG)):
            with open(path, "w") as f:
                f.write(yaml.safe_dump(doc))
            st = os.stat(path)
            os.utime(path, (st.st_atime, st.st_mtime + 5))
            assert watcher.poll_once()
            _cuda.reset_launch_counts()
            got = _probs(engine)
            by_dtype = _cuda.launch_counts_by_dtype()["flash_attention"]
            counts = _cuda.launch_counts()
            if mode == "bf16":
                # the sequence heads go through BGMV, not the epilogue
                assert by_dtype.get("bfloat16", 0) > 0, by_dtype
                assert counts["bgmv"] > 0, counts
            else:
                assert by_dtype.get("bfloat16", 0) == 0, by_dtype
                assert by_dtype.get("float32", 0) > 0, by_dtype
                assert counts["bgmv"] == 0, counts
                assert counts["head_epilogue"] > 0, counts
            ref = _engine("cpu", load_config(copy.deepcopy(doc)))
            try:
                cpu[mode] = _probs(ref)
            finally:
                ref.shutdown()
            assert _close(got, cpu[mode], TOL[mode]), mode
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        server.stop()
        server.router.shutdown()
        engine.shutdown()
        backend.stop()
        for slot in ("runtimestats", "slo", "resilience"):
            registry.get(slot).stop()
    assert statuses and set(statuses) == {200}, set(statuses)
