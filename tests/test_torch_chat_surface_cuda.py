"""The chat surface on the card, at a tiny trunk: a router on ``cuda``
behind the port's ``RouterServer`` and mock backend.  A streamed request
and its non-streamed twin route alike and launch equal K1 / K2 counts
(the route's heads, then the response path's jailbreak screen on the
answer, assembled from the stream's frames for the streamed one); the
relayed text is the backend's; fusion's grounding launches one ``nli``
trunk forward per panel answer.  ``cuda``-marked: skips without a GPU.
Imports no JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_chat_surface_cuda.py``; chip_smoke.py's phase 12
does)."""

import copy
import http.client
import json
import urllib.parse

import pytest
import torch

from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.engine.testing import TINY, \
    make_shared_trunk_engine
from semantic_router_tpu_torch.ops import _cuda
from semantic_router_tpu_torch.router import MockVLLMServer, Router, \
    RouterServer
from semantic_router_tpu_torch.router import headers as H

TASKS = [("intent", ["business", "computer science", "other"]),
         ("jailbreak", ["benign", "jailbreak"]),
         ("nli", ["entailment", "neutral", "contradiction"])]
PII = [("pii", ["O", "B-EMAIL_ADDRESS", "I-EMAIL_ADDRESS"])]
CONFIG = {
    "default_model": "base",
    "engine": {"max_batch_size": 8, "max_wait_ms": 1.0,
               "seq_len_buckets": [32, 128, 512],
               "kernels": {"epilogue": {"enabled": True}}},
    "routing": {
        # one learned family: with two, the batcher may run their steps
        # fused or apart, so a request's launches would vary with timing
        "signals": {
            "keywords": [{"name": "panel", "keywords": ["panel"]}],
            "domains": [{"name": "computer science"}]},
        "decisions": [
            {"name": "fusion", "priority": 300,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "keyword", "name": "panel"}]},
             "modelRefs": [{"model": m} for m in ("p-a", "p-b", "p-c")],
             "algorithm": {"type": "fusion", "fusion": {
                 "grounding": {"enabled": True}}}},
            {"name": "cs_route", "priority": 100,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "domain", "name": "computer science"}]},
             "modelRefs": [{"model": "cs"}]}]},
}
TEXTS = ["please summarize the quarterly report",
         "why does my python function leak memory",
         "my email is someone@example.com, call me"]


def answer(body):
    last = next(m["content"] for m in reversed(body["messages"])
                if m["role"] == "user")
    return f"{body.get('model')} says: " + " ".join(
        f"{w}{i}" for i, w in enumerate(str(last).split() * 6))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K2 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _post(url, body):
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    try:
        conn.request("POST", "/v1/chat/completions",
                     body=json.dumps(body).encode(),
                     headers={"content-type": "application/json"})
        r = conn.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        conn.close()


def _streamed_text(raw: bytes) -> str:
    out = []
    for frame in raw.decode().split("\n\n"):
        if frame.startswith("data: ") and frame != "data: [DONE]":
            chunk = json.loads(frame[6:])
            out.append((chunk["choices"][0].get("delta") or {})
                       .get("content") or "")
    return "".join(out)


@pytest.mark.cuda
def test_stream_and_its_twin_launch_alike_on_the_card(cuda_device):
    cfg = load_config(copy.deepcopy(CONFIG))
    engine = make_shared_trunk_engine(
        tasks=TASKS, token_tasks=PII, device=cuda_device, seed=9,
        engine_cfg=cfg.engine, model_config=dict(TINY,
                                                 attention_impl="flash"))
    router = Router(cfg, engine=engine)
    backend = MockVLLMServer(content_fn=answer).start()
    server = RouterServer(router, backend.url).start()
    try:
        engine.warmup()
        for text in TEXTS:
            rows = []
            for stream in (False, True):
                body = {"model": "auto", "stream": stream,
                        "messages": [{"role": "user", "content": text}]}
                _cuda.reset_launch_counts()
                status, hdrs, raw = _post(server.url, body)
                launches = _cuda.launch_counts()
                assert status == 200
                content = _streamed_text(raw) if stream else \
                    json.loads(raw)["choices"][0]["message"]["content"]
                assert content == answer(dict(
                    body, model=hdrs[H.MODEL]))
                rows.append((hdrs.get(H.DECISION), hdrs[H.MODEL],
                             launches["flash_attention"],
                             launches["head_epilogue"]))
            assert rows[0] == rows[1], text
            assert rows[0][2] > 0 and rows[0][3] > 0
        # fusion: one nli trunk forward per panel answer on top of the
        # route's and the answer screen's
        seen = []
        inner = engine.classify

        def classify(task, text, *a, **kw):
            seen.append(task)
            return inner(task, text, *a, **kw)

        engine.classify = classify
        status, hdrs, _ = _post(server.url, {"model": "auto", "messages": [
            {"role": "user", "content": "ask the panel about tides"}]})
        assert status == 200
        assert hdrs["x-vsr-looper-algorithm"] == "fusion"
        assert seen.count("nli") == 3
    finally:
        server.stop()
        backend.stop()
        router.shutdown()
        engine.shutdown()
