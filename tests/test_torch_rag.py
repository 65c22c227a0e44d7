"""The ``rag`` plugin and the ``/v1/vector_stores*`` endpoints of the port
against the JAX package's, on the CPU, over one seeded tiny engine pair
(the same Flax weights through ``params_from_flax``).

Both routers on one config, each with a store ingested through its own
engine's embedding task (in memory, and on the ANN plane's device bank),
give the same body (the retrieved context as the first system message),
headers (``x-vsr-rag-chunks``), decision and model for every request; a
store that is absent, or a search that raises, fails open.  Over HTTP
both servers answer every vector-store route (create, ingest, list,
stats, files, search, deletes, the 400 / 404 / 409 cases) with the same
status and JSON (ids aside), audit-log the reference's actions, and a
chat through the rag decision reaches the mock backend with the context
message and the header."""

import copy
import http.client
import json
import urllib.parse

import pytest
import torch

from semantic_router_tpu import ann as jann
from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.models.embeddings import \
    MmBertEmbeddingModel as JEmbeddingModel
from semantic_router_tpu.observability.metrics import \
    MetricsRegistry as JMetricsRegistry
from semantic_router_tpu.router.pipeline import Router as JaxRouter
from semantic_router_tpu.router.server import RouterServer as JServer
from semantic_router_tpu.vectorstore import \
    VectorStoreManager as JVectorStoreManager
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.models import MmBertEmbeddingModel, \
    params_from_flax
from semantic_router_tpu_torch.router import MockVLLMServer, RouterServer
from semantic_router_tpu_torch.router import headers as H
from semantic_router_tpu_torch.router import server as tserver_mod
from semantic_router_tpu_torch.runtime import RuntimeRegistry, build_router

SEQ_TASKS = [("jailbreak", ["benign", "jailbreak"])]
SCORE_TOL = 1e-4  # the search route rounds scores to 4 places

CORPUS = [
    ("pasta", "Boil the water before adding pasta. Salt the water well. "
              "Drain the pasta when it is al dente. Toss it with sauce."),
    ("rust", "The borrow checker enforces ownership. A value has one "
             "owner. References must not outlive the value."),
    ("trains", "Night trains cross Europe. Sleeper cabins hold two or "
               "four berths. Book early in summer."),
    ("tax", "Quarterly estimated taxes are due four times a year. Keep "
            "receipts for deductions. File before April."),
    ("tea", "Green tea steeps for two minutes. Black tea takes longer. "
            "Use water just off the boil."),
]


def _decision(name, priority, keyword, plugins):
    return {"name": name, "priority": priority,
            "rules": {"operator": "OR",
                      "conditions": [{"type": "keyword", "name": keyword}]},
            "modelRefs": [{"model": f"{name}-model"}], "plugins": plugins}


def _config(backend, store="kb"):
    return {
        "default_model": "base",
        "vectorstore": {"backend": backend},
        "ann": {"enabled": backend == "ann", "min_capacity": 16},
        "routing": {
            "signals": {"keywords": [
                {"name": "ask", "operator": "OR",
                 "keywords": ["how", "what", "when"]},
                {"name": "plain", "operator": "OR", "keywords": ["hello"]},
                {"name": "missing", "operator": "OR",
                 "keywords": ["unknownstore"]}]},
            "decisions": [
                _decision("rag_route", 10, "ask", [
                    {"type": "system_prompt", "configuration": {
                        "system_prompt": "Answer briefly.",
                        "mode": "insert"}},
                    {"type": "rag", "configuration": {
                        "store": store, "top_k": 2, "max_chars": 400}}]),
                _decision("missing_route", 8, "missing", [
                    {"type": "rag", "configuration": {"store": "nope"}}]),
                _decision("plain_route", 5, "plain", []),
            ]},
    }


REQUESTS = [
    "how long do I boil pasta",
    "what does the borrow checker do",
    "when are estimated taxes due",
    "how long should green tea steep",
    "what about sleeper train berths in summer",
    "hello there",
    "unknownstore question",
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    import jax
    import jax.numpy as jnp

    jeng = jtesting.make_shared_trunk_engine(tasks=SEQ_TASKS, seed=21)
    emb = JEmbeddingModel(jtesting.tiny_config(2))
    emb_params = emb.init(jax.random.PRNGKey(9), jnp.ones((1, 8), jnp.int32))
    tok = jeng._tasks["jailbreak"].tokenizer
    jeng.register_task("embedding", "embedding", emb, emb_params, tok, [],
                       max_seq_len=512)
    teng = ttesting.make_shared_trunk_engine(
        tasks=SEQ_TASKS, device="cpu",
        flax_params={n: jeng._tasks[n].params for n, _ in SEQ_TASKS})
    temb = MmBertEmbeddingModel(ttesting.tiny_config(2))
    temb.load_state_dict(params_from_flax(emb_params))
    teng.register_task("embedding", "embedding", temb,
                       teng.trunk_group("jailbreak").tokenizer, [],
                       max_seq_len=512)
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


def _routers(engines, backend):
    """(JAX router, port router, port registry, JAX plane) on one config,
    each with the corpus ingested into ``kb`` through its own engine."""
    jeng, teng = engines
    cfg = _config(backend)
    jr = JaxRouter(JRouterConfig.from_dict(copy.deepcopy(cfg)), engine=jeng)
    jplane = jann.AnnPlane(JMetricsRegistry()) if backend == "ann" else None
    if jplane is not None:
        jplane.configure(jann.normalize_ann(cfg["ann"]))
    jr.vectorstores = JVectorStoreManager(
        lambda t: jeng.embed("embedding", [t])[0], backend=backend,
        ann=jplane)
    reg = RuntimeRegistry.isolated(runtimestats=None)
    tr = build_router(load_config(copy.deepcopy(cfg)), teng, registry=reg)
    for mgr in (jr.vectorstores, tr.vectorstores):
        store = mgr.create("kb")
        for name, text in CORPUS:
            store.ingest(name, text, metadata={"source": name})
        if getattr(store, "index", None) is not None:
            store.index.flush()  # onto the device bank
    return jr, tr, reg, jplane


def _close(jr, tr, reg, jplane):
    if jplane is not None:
        jplane.close()
    plane = reg.get("ann")
    if plane is not None:
        plane.close()
    jr.shutdown()
    tr.shutdown()


def _port_headers(h):
    names = {v for k, v in vars(H).items()
             if k.isupper() and isinstance(v, str) and v.startswith("x-vsr-")}
    return {k: (True if k == H.DECISION_RECORD else v)
            for k, v in h.items() if k in names}


def _body(text):
    return {"model": "auto",
            "messages": [{"role": "user", "content": text}]}


@pytest.mark.parametrize("backend", ["memory", "ann"])
def test_rag_route_matches_jax(engines, backend):
    jr, tr, reg, jplane = _routers(engines, backend)
    try:
        if backend == "ann":
            idx = reg.get("ann").index("vs:kb")
            assert idx.bank.report()["entries"] == len(
                tr.vectorstores.get("kb").chunks)
        seen_rag = 0
        for i, text in enumerate(REQUESTS):
            hdrs = {H.REQUEST_ID: f"rag-{i}"}
            want = jr.route(_body(text), dict(hdrs))
            got = tr.route(_body(text), dict(hdrs))
            assert got.kind == want.kind == "route"
            assert got.decision.decision.name \
                == want.decision.decision.name
            assert got.model == want.model
            assert got.body == want.body, text
            assert _port_headers(got.headers) \
                == _port_headers(want.headers)
            if H.RAG_CHUNKS in got.headers:
                seen_rag += 1
                assert got.body["messages"][0]["content"].startswith(
                    "Relevant context:\n[")
                assert got.headers[H.RAG_CHUNKS] == "2"
        assert seen_rag == 5  # every rag_route request; none elsewhere
    finally:
        _close(jr, tr, reg, jplane)


def test_rag_fails_open(engines):
    jr, tr, reg, jplane = _routers(engines, "memory")
    try:
        store = tr.vectorstores.get("kb")
        store.search = lambda *a, **kw: (_ for _ in ()).throw(
            RuntimeError("store down"))
        got = tr.route(_body(REQUESTS[0]), {})
        assert got.kind == "route" and H.RAG_CHUNKS not in got.headers
        assert got.decision.decision.name == "rag_route"
        assert got.body["messages"][0]["content"].startswith(
            "Answer briefly.")
    finally:
        _close(jr, tr, reg, jplane)


def _call(url, method, path, body=None):
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={"content-type": "application/json"}
                     if data else {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def _strip(reply):
    """A reply with its random ids set aside."""
    if isinstance(reply, dict):
        return {k: ("<id>" if k in ("id", "document_id")
                    and k != "name" and isinstance(v, str)
                    and len(v) == 12 else _strip(v))
                for k, v in reply.items()}
    if isinstance(reply, list):
        return [_strip(v) for v in reply]
    return reply


def _same(got, want, path="$"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= SCORE_TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


def test_vector_store_endpoints_match_jax(engines, monkeypatch):
    jeng, teng = engines
    audits = []
    real = tserver_mod.component_event
    monkeypatch.setattr(tserver_mod, "component_event",
                        lambda c, e, **kw: (audits.append((c, e)),
                                            real(c, e, **kw)))
    seen = []

    def content(body):
        seen.append(body)
        return "ok"

    backend = MockVLLMServer(content_fn=content).start()
    cfg = _config("memory", store="docs")
    jcfg = JRouterConfig.from_dict(copy.deepcopy(cfg))
    jr = JaxRouter(jcfg, engine=jeng)
    jr.vectorstores = JVectorStoreManager(
        lambda t: jeng.embed("embedding", [t])[0])
    jserver = JServer(jr, jcfg, default_backend=backend.url).start()
    reg = RuntimeRegistry.isolated(runtimestats=None)
    tr = build_router(load_config(copy.deepcopy(cfg)), teng, registry=reg)
    tserver = RouterServer(tr, backend.url, registry=reg).start()
    urls = {"jax": jserver.url, "port": tserver.url}
    try:
        def both(method, path, body=None):
            out = {k: _call(u, method, path, body) for k, u in urls.items()}
            assert out["port"][0] == out["jax"][0], (path, out)
            _same(_strip(out["port"][1]), _strip(out["jax"][1]), path)
            return out

        both("GET", "/v1/vector_stores")
        both("POST", "/v1/vector_stores", {})
        both("POST", "/v1/vector_stores", {"name": "docs"})
        both("POST", "/v1/vector_stores", {"name": "docs"})  # 409
        ingested = {}
        for name, text in CORPUS:
            out = both("POST", "/v1/vector_stores/docs/files",
                       {"name": name, "text": text,
                        "metadata": {"source": name}})
            ingested[name] = {k: v[1]["id"] for k, v in out.items()}
        both("GET", "/v1/vector_stores")
        both("GET", "/v1/vector_stores/docs")
        files = {k: _call(u, "GET", "/v1/vector_stores/docs/files")
                 for k, u in urls.items()}
        assert sorted((d["name"], d["chunks"])
                      for d in files["port"][1]["data"]) \
            == sorted((d["name"], d["chunks"])
                      for d in files["jax"][1]["data"])
        for q in ("boil pasta", "borrow checker", "green tea"):
            both("POST", "/v1/vector_stores/docs/search",
                 {"query": q, "top_k": 3})
        both("GET", "/v1/vector_stores/nope")
        both("POST", "/v1/vector_stores/nope/search", {"query": "x"})
        # a chat through the rag decision: the context reaches the backend
        n0 = len(seen)
        status, reply = _call(tserver.url, "POST", "/v1/chat/completions",
                              _body("how long do I boil pasta"))
        assert status == 200
        sent = seen[n0]
        assert sent["messages"][0]["content"].startswith(
            "Relevant context:\n[")
        assert backend.headers_seen[-1][H.RAG_CHUNKS] == "2"
        status, _ = _call(jserver.url, "POST", "/v1/chat/completions",
                          _body("how long do I boil pasta"))
        assert status == 200 and seen[-1]["messages"] == sent["messages"]
        # deletes: one document, a missing one, the store, a missing store
        for k, u in urls.items():
            status, reply = _call(
                u, "DELETE",
                f"/v1/vector_stores/docs/files/{ingested['tea'][k]}")
            assert (status, reply) == (200, {"deleted": True}), k
        both("DELETE", "/v1/vector_stores/docs/files/absent00000")
        both("GET", "/v1/vector_stores/docs")
        both("DELETE", "/v1/vector_stores/docs")
        both("DELETE", "/v1/vector_stores/docs")
        both("GET", "/v1/vector_stores")
    finally:
        tserver.stop()
        jserver.stop()
        backend.stop()
        jr.shutdown()
        tr.shutdown()
    actions = [e for c, e in audits if c == "audit"]
    assert actions.count("vectorstore_create") == 3
    assert actions.count("vectorstore_ingest") == len(CORPUS)
    assert actions.count("vectorstore_delete") == 4
