"""The port's Classification API over HTTP against the JAX server's on the
same weights, and against the port engine's direct calls, on the CPU:
every ``/api/v1/classify/*`` route (windowed included), embeddings with
``dimensions``, similarity and its batch form, and ``GET /api/v1``."""

import http.client
import json
import urllib.parse

import numpy as np
import pytest
import torch

from semantic_router_tpu.config.schema import RouterConfig as JRouterConfig
from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.router import Router as JRouter
from semantic_router_tpu.router.server import RouterServer as JRouterServer
from semantic_router_tpu_torch.config import InferenceEngineConfig, \
    load_config
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.router import MockVLLMServer, Router, \
    RouterServer
from semantic_router_tpu_torch.router.server import API_CATALOG

PII_LABELS = ["O", "B-EMAIL_ADDRESS", "I-EMAIL_ADDRESS", "B-PERSON",
              "I-PERSON"]
TASKS = [("intent", "sequence", ["business", "law", "health", "other"]),
         ("jailbreak", "sequence", ["benign", "jailbreak"]),
         ("fact_check", "sequence", ["no_fact_check", "fact_check"]),
         ("user_feedback", "sequence", ["none", "positive", "negative"]),
         ("pii", "token", PII_LABELS),
         ("embedding", "embedding", [])]
TEXT = "contact jane at jane@example.com about the quarterly taxes"
TEXTS = ["is this medication safe", "hello", "write a sorting function"]
LONG = " ".join(f"w{i % 53} v{i}" for i in range(700))  # 1400 tokens
ROUTES = ["intent", "pii", "security", "fact-check", "user-feedback"]


@pytest.fixture(scope="module")
def servers():
    """(JAX server URL, port server URL, port engine), one set of
    weights."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jeng = jtesting.make_test_engine(tasks=TASKS, seed=6)
    teng = ttesting.make_test_engine(
        tasks=TASKS, device="cpu",
        engine_cfg=InferenceEngineConfig(max_batch_size=8, max_wait_ms=1.0,
                                         seq_len_buckets=[32, 128, 512]),
        flax_params={k: t.params for k, t in jeng._tasks.items()})
    jcfg = JRouterConfig.from_dict({})
    jrouter = JRouter(jcfg, engine=jeng)
    jserver = JRouterServer(jrouter, jcfg).start()
    backend = MockVLLMServer().start()
    trouter = Router(load_config({}), engine=teng)
    tserver = RouterServer(trouter, backend.url).start()
    yield jserver.url, tserver.url, teng
    tserver.stop()
    backend.stop()
    jserver.stop()
    for r in (trouter, jrouter):
        r.shutdown()
    jeng.shutdown()
    teng.shutdown()
    torch.set_num_threads(n)


def _call(url, path, body=None):
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    try:
        if body is None:
            conn.request("GET", path)
        else:
            conn.request("POST", path, body=json.dumps(body).encode(),
                         headers={"content-type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _same(got, want, tol, path="$"):
    """Equal JSON, numbers within ``tol``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, got, want)
        for k in want:
            _same(got[k], want[k], tol, f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, tol, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert abs(got - want) <= tol, (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("body", [
    {"text": TEXT}, {"text": LONG}, {"text": LONG, "windowed": True},
    {"text": LONG, "windowed": True, "stride": 16}, {"text": ""}],
    ids=["short", "long", "windowed", "windowed_s16", "empty"])
@pytest.mark.parametrize("route", ROUTES)
def test_classify_route_matches_jax(servers, route, body):
    jurl, turl, _ = servers
    path = f"/api/v1/classify/{route}"
    js, jbody = _call(jurl, path, body)
    ts, tbody = _call(turl, path, body)
    assert ts == js == 200, (tbody, jbody)
    _same(tbody, jbody, 1e-4)
    if route != "pii" and body.get("windowed"):
        assert "truncated" not in tbody
    elif body["text"] == LONG:
        assert tbody["truncated"] is True


@pytest.mark.parametrize("route,body", [
    ("combined", {"text": TEXT}),
    ("batch", {"texts": TEXTS + [LONG]}),
    ("batch", {"task": "fact_check", "texts": TEXTS}),
])
def test_combined_and_batch_match_jax(servers, route, body):
    jurl, turl, _ = servers
    path = f"/api/v1/classify/{route}"
    js, jbody = _call(jurl, path, body)
    ts, tbody = _call(turl, path, body)
    assert ts == js == 200
    _same(tbody, jbody, 1e-4)


def test_classify_answers_the_engine(servers):
    _, turl, teng = servers
    _, got = _call(turl, "/api/v1/classify/security", {"text": TEXT})
    want = teng.classify("jailbreak", TEXT)
    assert got["label"] == want.label and got["class_idx"] == want.index
    _same(got["probs"], want.probs, 1e-6)
    _, got = _call(turl, "/api/v1/classify/intent",
                   {"text": LONG, "windowed": True, "stride": 32})
    want = teng.classify_windowed("intent", LONG, stride=32)
    assert got["label"] == want.label
    _same(got["probs"], want.probs, 1e-6)
    _, got = _call(turl, "/api/v1/classify/pii", {"text": TEXT})
    want = teng.token_classify("pii", TEXT)
    assert [(e["type"], e["start"], e["end"]) for e in got["entities"]] == \
        [(e.type, e.start, e.end) for e in want.entities]


@pytest.mark.parametrize("body", [
    {"input": TEXT}, {"input": TEXTS}, {"input": TEXTS, "dimensions": 16},
    {"input": [LONG], "dimensions": 8}], ids=["one", "many", "dim16", "dim8"])
def test_embeddings_match_jax(servers, body):
    jurl, turl, teng = servers
    js, jbody = _call(jurl, "/api/v1/embeddings", body)
    ts, tbody = _call(turl, "/api/v1/embeddings", body)
    assert ts == js == 200
    _same(tbody, jbody, 1e-4)
    texts = [body["input"]] if isinstance(body["input"], str) \
        else body["input"]
    want = teng.embed("embedding", texts, output_dim=body.get("dimensions"))
    got = np.asarray([d["embedding"] for d in tbody["data"]], np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("path,body", [
    ("/api/v1/similarity", {"text_a": TEXT, "text_b": TEXTS[0]}),
    ("/api/v1/similarity", {"text1": TEXTS[1], "text2": TEXTS[1]}),
    ("/api/v1/similarity/batch", {"pairs": [
        {"text_a": TEXT, "text_b": TEXTS[0]},
        {"text_a": TEXTS[1], "text_b": TEXTS[2]}]}),
])
def test_similarity_matches_jax(servers, path, body):
    jurl, turl, _ = servers
    js, jbody = _call(jurl, path, body)
    ts, tbody = _call(turl, path, body)
    assert ts == js == 200
    _same(tbody, jbody, 1e-4)


def test_api_catalog_lists_every_route(servers):
    jurl, turl, _ = servers
    status, got = _call(turl, "/api/v1")
    assert status == 200 and got == API_CATALOG
    _, jcat = _call(jurl, "/api/v1")
    want = {(e["path"], e["method"]) for e in jcat["endpoints"]}
    mine = {(e["path"], e["method"]) for e in got["endpoints"]}
    assert mine <= want  # a subset of the reference's routes
    for route in ROUTES + ["combined", "batch"]:
        assert (f"/api/v1/classify/{route}", "POST") in mine
    for path in ("/api/v1/embeddings", "/api/v1/similarity",
                 "/api/v1/similarity/batch"):
        assert (path, "POST") in mine


def test_refusals(servers):
    _, turl, _ = servers
    assert _call(turl, "/api/v1/classify/nope", {"text": "x"})[0] == 404
    assert _call(turl, "/api/v1/unknown", {"text": "x"})[0] == 404
    assert _call(turl, "/api/v1/embeddings",
                 {"model": "ghost", "input": "x"})[0] == 503


def test_no_engine_answers_503():
    router = Router(load_config({}), engine=None)
    backend = MockVLLMServer().start()
    server = RouterServer(router, backend.url).start()
    try:
        assert _call(server.url, "/api/v1/classify/intent",
                     {"text": "x"})[0] == 503
        assert _call(server.url, "/api/v1/similarity",
                     {"text_a": "x", "text_b": "y"})[0] == 503
    finally:
        server.stop()
        backend.stop()
        router.shutdown()
