"""The ExtProc filter on the card, cut to tiny sizes: a router over a
flash-attention bank with the head epilogue on, behind ``ExtProcService``,
answers 8 concurrent streams, half of them STREAMED (``messages`` in the
first chunk, an inert trailing field in four more), each with a body
mutation whose decision and model equal the CPU port's route of the same
body; every streamed body's prefetch starts before its last chunk on the
filter's ``extproc-prefetch`` workers and is reused (one signal evaluation
a request), and the launch counters show K1 and K2.  ``cuda``-marked:
skips without a GPU.  Imports no JAX (``python -m pytest --noconftest -m
cuda tests/test_torch_extproc_cuda.py``; chip_smoke.py runs it after phase
20)."""

import json
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.engine.testing import TINY, \
    make_shared_trunk_engine
from semantic_router_tpu_torch.extproc import ExtProcService
from semantic_router_tpu_torch.extproc import external_processor_pb2 as pb
from semantic_router_tpu_torch.ops import _cuda
from semantic_router_tpu_torch.router import Router
from semantic_router_tpu_torch.runtime import apply_kernel_knobs

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
TEXTS = ["sue them for breach of contract", "quarterly revenue is up",
         "what is the capital of france", "the court ruled on appeal",
         "merger talks stalled again", "ok", "a contract for the lease",
         "file the appeal by friday"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K2 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _router(device):
    cfg = load_config(CONFIG)
    engine = make_shared_trunk_engine(
        device=device, seed=4, engine_cfg=cfg.engine,
        model_config=dict(TINY, attention_impl="flash"
                          if device == "cuda" else "dense"))
    apply_kernel_knobs(cfg, engine)
    return Router(cfg, engine=engine), engine


def _body(i):
    return {"model": "auto",
            "messages": [{"role": "user", "content": TEXTS[i]}],
            "metadata": {"pad": "p" * 2000}}


def _messages(i, streamed, sent):
    yield pb.ProcessingRequest(request_headers=pb.HttpHeaders())
    raw = json.dumps(_body(i)).encode()
    if not streamed:
        yield pb.ProcessingRequest(request_body=pb.HttpBody(
            body=raw, end_of_stream=True))
        sent.append(time.perf_counter())
        return
    cut = raw.index(b'"metadata"')
    step = (len(raw) - cut + 3) // 4
    yield pb.ProcessingRequest(request_body=pb.HttpBody(
        body=raw[:cut], end_of_stream=False))
    for k, at in enumerate(range(cut, len(raw), step)):
        time.sleep(0.02)
        last = at + step >= len(raw)
        if last:
            sent.append(time.perf_counter())
        yield pb.ProcessingRequest(request_body=pb.HttpBody(
            body=raw[at:at + step], end_of_stream=last))


class _Events(logging.Handler):
    def __init__(self):
        super().__init__()
        self.rows = []

    def emit(self, record):
        try:
            row = json.loads(record.getMessage())
        except ValueError:
            return
        if row.get("component") == "extproc":
            self.rows.append(row)


@pytest.mark.cuda
def test_concurrent_streams_match_the_cpu_port(cuda_device):
    router, engine = _router(cuda_device)
    cpu_router, cpu_engine = _router("cpu")
    svc = ExtProcService(router)
    calls, lock = [], threading.Lock()
    evaluate = router.evaluate_signals

    def counted(*a, **k):
        with lock:
            calls.append(threading.current_thread().name)
        return evaluate(*a, **k)

    router.evaluate_signals = counted
    events = _Events()
    log = logging.getLogger("semantic_router_tpu_torch")
    log.addHandler(events)
    try:
        engine.warmup()
        _cuda.reset_launch_counts()

        def stream(i):
            sent = []
            out = list(svc.Process(_messages(i, i % 2 == 1, sent), None))
            return out, sent[0], time.perf_counter()

        with ThreadPoolExecutor(max_workers=8) as pool:
            results = list(pool.map(stream, range(8)))
        launches = _cuda.launch_counts()
        for i, (resps, _sent, _done) in enumerate(results):
            common = resps[-1].request_body.response
            assert common.HasField("body_mutation"), (i, resps[-1])
            hdrs = {o.header.key: o.header.raw_value.decode()
                    for o in common.header_mutation.set_headers}
            want = cpu_router.route(_body(i))
            assert hdrs["x-vsr-selected-decision"] == \
                (want.decision.decision.name if want.decision else None)
            assert json.loads(common.body_mutation.body)["model"] == \
                want.model == hdrs["x-vsr-selected-model"]
        # one evaluation per streamed request, on the prefetch workers;
        # a buffered request evaluates inline in route()
        assert len(calls) == 4, calls
        assert all(n.startswith("extproc-prefetch") for n in calls)
        early = [r for r in events.rows
                 if r["event"] == "streamed_early_detection"]
        assert len(early) == 4
        assert all(r["prefetch_started_at_chunk"] < r["chunks"]
                   for r in early)
        assert launches["flash_attention"] > 0, launches
        assert launches["head_epilogue"] > 0, launches
    finally:
        log.removeHandler(events)
        svc.close()
        router.shutdown()
        cpu_router.shutdown()
        engine.shutdown()
        cpu_engine.shutdown()
