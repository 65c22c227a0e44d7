"""The decision record on the card, cut to tiny sizes: a port server over
a flash-attention bank with the head epilogue on and a tiny embedding
model (the semantic cache's), with no ``router_replay`` block, answers 8
concurrent chat requests; its replay store holds 8 records whose
decisions and models equal the CPU port's route of the same bodies; every
``POST /debug/decisions/{id}/replay`` under the live config answers
unchanged; ``/dashboard/api/embedmap?source=cache`` equals ``build_map``
of the vectors the card embedded; a playground request reaches no
backend; and the launch counters show K1 and K2.  ``cuda``-marked: skips
without a GPU.  Imports no JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_replay_cuda.py``; chip_smoke.py runs it after phase
21)."""

import http.client
import json
import urllib.parse
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.dashboard.embedmap import build_map
from semantic_router_tpu_torch.engine.testing import TINY, init_weights, \
    make_shared_trunk_engine, tiny_config
from semantic_router_tpu_torch.models import MmBertEmbeddingModel
from semantic_router_tpu_torch.ops import _cuda
from semantic_router_tpu_torch.router import MockVLLMServer, RouterServer
from semantic_router_tpu_torch.runtime import RuntimeRegistry, \
    apply_kernel_knobs, build_router

CACHE_WRITE_ONLY = [{"type": "semantic-cache",
                     "configuration": {"similarity_threshold": 1.5}}]
CONFIG = {
    "default_model": "m1",
    # the degradation ladder stays off: no answer here may be shed
    "resilience": {"enabled": False},
    "engine": {"max_batch_size": 8, "max_wait_ms": 1.0,
               "seq_len_buckets": [32, 128],
               "kernels": {"epilogue": {"enabled": True}}},
    # the plugins' threshold is above any cosine: every answer is
    # written to the cache, none is read from it
    "semantic_cache": {"enabled": True, "backend_type": "memory",
                       "embedding_model": "embedding"},
    "routing": {
        "modelCards": [{"name": "m1"}, {"name": "m2"}],
        "signals": {"domains": [{"name": "law"}, {"name": "business"}]},
        "decisions": [
            {"name": "law_route", "priority": 20,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "domain", "name": "law"}]},
             "modelRefs": [{"model": "m2"}],
             "plugins": CACHE_WRITE_ONLY},
            {"name": "business_route", "priority": 10,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "domain", "name": "business"}]},
             "modelRefs": [{"model": "m1"}],
             "plugins": CACHE_WRITE_ONLY}]}}
TEXTS = ["sue them for breach of contract", "quarterly revenue is up",
         "what is the capital of france", "the court ruled on appeal",
         "merger talks stalled again", "ok then", "a contract for the lease",
         "file the appeal by friday"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K2 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _router(device, registry):
    cfg = load_config(CONFIG)
    engine = make_shared_trunk_engine(
        device=device, seed=4, engine_cfg=cfg.engine,
        model_config=dict(TINY, attention_impl="flash"
                          if device == "cuda" else "dense"))
    emb = MmBertEmbeddingModel(tiny_config(
        2, attention_impl="flash" if device == "cuda" else "dense"))
    init_weights(emb, seed=5)
    engine.register_task("embedding", "embedding", emb.to(device),
                         engine.trunk_group("intent").tokenizer, [],
                         max_seq_len=128)
    apply_kernel_knobs(cfg, engine)
    return build_router(cfg, engine, registry=registry), engine, emb


def _call(url, method, path, body=None):
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body).encode(),
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), json.loads(resp.read())
    finally:
        conn.close()


def _body(i):
    return {"model": "auto",
            "messages": [{"role": "user", "content": TEXTS[i]}]}


@pytest.mark.cuda
def test_recorded_routes_replay_on_the_card(cuda_device):
    reg = RuntimeRegistry.isolated()
    router, engine, _ = _router(cuda_device, reg)
    cpu_router, cpu_engine, _ = _router("cpu", RuntimeRegistry.isolated())
    backend = MockVLLMServer().start()
    server = RouterServer(router, backend.url, registry=reg).start()
    try:
        engine.warmup()
        _cuda.reset_launch_counts()
        with ThreadPoolExecutor(max_workers=8) as pool:
            replies = list(pool.map(
                lambda i: _call(server.url, "POST", "/v1/chat/completions",
                                _body(i)), range(8)))
        launches = _cuda.launch_counts()
        assert all(st == 200 for st, _, _ in replies), replies
        assert len(router.replay_store) == 8
        records = {r.request_id: r for r in router.replay_store.list()}
        for i, (_, hdrs, _) in enumerate(replies):
            rec = records[hdrs["x-vsr-request-id"]]
            want = cpu_router.route(_body(i))
            assert rec.decision == (want.decision.decision.name
                                    if want.decision else "")
            assert rec.model == want.model
            st, _, rep = _call(server.url, "POST",
                               f"/debug/decisions/"
                               f"{hdrs['x-vsr-decision-record']}/replay", {})
            assert st == 200 and rep["identical"], rep
        st, _, got = _call(server.url, "GET",
                           "/dashboard/api/embedmap?source=cache")
        entries = list(router.cache._entries.values())
        # one entry a request its decision caches (a default route has
        # no semantic-cache plugin)
        assert st == 200 and len(entries) == sum(
            bool(r.decision) for r in records.values()) > 0
        assert got == build_map([(e.query, e.embedding) for e in entries])
        hits = backend.hits
        st, _, pg = _call(server.url, "POST", "/dashboard/api/playground",
                          {"messages": [{"role": "user",
                                         "content": "appeal the lease"}]})
        assert st == 200 and backend.hits == hits
        want = router.route(_body(0) | {"messages": [
            {"role": "user", "content": "appeal the lease"}]})
        assert pg["decision"] == (want.decision.decision.name
                                  if want.decision else "")
        assert launches["flash_attention"] > 0, launches
        assert launches["head_epilogue"] > 0, launches
    finally:
        server.stop()
        backend.stop()
        router.shutdown()
        cpu_router.shutdown()
        engine.shutdown()
        cpu_engine.shutdown()
