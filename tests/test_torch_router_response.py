"""The port's Router against the JAX Router on one seeded tiny engine (the
same Flax weights through ``params_from_flax``), on the CPU: selection
over query embeddings (``knn``, ``router_dc``), the request-mutation
plugins (``system_prompt`` insert and replace, ``memory`` retrieval,
``tools`` filtering and ``tool_selection`` auto-selection), the response
path (the jailbreak screen, hallucination spans with the NLI gate on and
off, warnings, memory auto-store) and ``record_feedback`` give the same
decisions, models, reasons, headers, bodies and selector state, with
probabilities within 1e-4.  Configs that ask for what the port does not
serve are refused at load."""

import copy
import json

import numpy as np
import pytest
import torch

from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.memory import InMemoryMemoryStore as JMemory
from semantic_router_tpu.models.embeddings import \
    MmBertEmbeddingModel as JEmbeddingModel
from semantic_router_tpu.router.pipeline import Router as JaxRouter
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.models import MmBertEmbeddingModel, \
    params_from_flax
from semantic_router_tpu_torch.router import headers as H
from semantic_router_tpu_torch.runtime import RuntimeRegistry, build_router
from semantic_router_tpu_torch.runtime.bootstrap import \
    apply_observability_knobs, close_stateplane

PROB_TOL = 1e-4
SEQ_TASKS = [("jailbreak", ["benign", "jailbreak"]),
             ("fact_check", ["needs_fact_check", "no_fact_check_needed"]),
             ("nli", ["entailment", "neutral", "contradiction"])]
TOKEN_TASKS = [("hallucination", ["SUPPORTED", "HALLUCINATED"])]
# logit offsets on the seeded heads, so both sides of each gate are taken
# by the parity set: the jailbreak screen (confidence 0.8) flags some
# responses, the fact_check family says needs_fact_check for some
# requests, NLI calls some spans entailed
HEAD_BIAS = {"jailbreak": [0.0, 1.6], "nli": [0.75, 0.0, 0.0]}
MODELS = ["small-7b", "mid-32b", "large-70b"]

TOOLS_DB = [{"type": "function", "function": {"name": n, "description": d}}
            for n, d in (
                ("get_weather", "current weather and forecast for a city"),
                ("search_web", "search the web for pages about a topic"),
                ("send_email", "send an email message to a contact"),
                ("calendar", "create and list calendar events"),
                ("calculator", "evaluate arithmetic expressions"),
                ("translate", "translate text between languages"))]
REQUEST_TOOLS = TOOLS_DB[:4] + [
    {"type": "function", "function": {"name": "exec_cmd",
                                      "description": "run a shell command"}}]


def _refs():
    return [{"model": m, "weight": w} for m, w in zip(MODELS, (0.5, 0.3,
                                                               0.2))]


CONFIG = {
    "default_model": "small-7b",
    "engine": {"max_batch_size": 8, "max_wait_ms": 1.0,
               "seq_len_buckets": [32, 128, 512]},
    "tool_selection": {"tools": TOOLS_DB},
    "routing": {
        "modelCards": [{"name": m, "quality_score": q}
                       for m, q in zip(MODELS, (0.7, 0.85, 0.95))],
        "signals": {
            "keywords": [
                {"name": "facts", "keywords": ["history", "fact"]},
                {"name": "plain", "keywords": ["summarize", "summary"]},
                {"name": "tools", "keywords": ["weather", "email"]},
                {"name": "filter", "keywords": ["search", "calendar"]}],
            "fact_check": [{"name": "needs_fact_check"},
                           {"name": "no_fact_check_needed"}]},
        "decisions": [
            {"name": "facts_knn", "priority": 300,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "keyword", "name": "facts"}]},
             "modelRefs": _refs(),
             "algorithm": {"type": "knn", "k": 3, "seed": 0},
             "plugins": [
                 {"type": "hallucination", "configuration": {
                     "use_nli": True,
                     "include_hallucination_details": True}},
                 {"type": "memory", "configuration": {
                     "auto_store": True, "retrieval_limit": 3}},
                 {"type": "system_prompt", "configuration": {
                     "mode": "insert",
                     "system_prompt": "Cite your sources."}}]},
            {"name": "plain_dc", "priority": 250,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "keyword", "name": "plain"}]},
             "modelRefs": _refs(),
             "algorithm": {"type": "router_dc", "seed": 1},
             "plugins": [
                 {"type": "hallucination", "configuration": {
                     "use_nli": False}},
                 {"type": "memory", "configuration": {
                     "auto_store": True}},
                 {"type": "system_prompt", "configuration": {
                     "mode": "replace",
                     "system_prompt": "Answer in one paragraph."}}]},
            {"name": "tools_auto", "priority": 200,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "keyword", "name": "tools"}]},
             "modelRefs": _refs()[:2],
             "algorithm": {"type": "knn", "k": 2, "seed": 2},
             "plugins": [
                 {"type": "tools", "configuration": {
                     "auto_select": True, "top_k": 3,
                     "similarity_threshold": -1.0}}]},
            {"name": "tools_filter", "priority": 150,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "keyword", "name": "filter"}]},
             "modelRefs": [{"model": "mid-32b"}],
             "plugins": [
                 {"type": "tool_selection", "configuration": {
                     "semantic_selection": True, "top_k": 2,
                     "similarity_threshold": -1.0,
                     "block_tools": ["exec_cmd"]}}]},
            # reads the fact_check family, so every request evaluates it
            {"name": "checked_default", "priority": 10,
             "rules": {"operator": "OR", "conditions": [
                 {"type": "fact_check", "name": "needs_fact_check"}]},
             "modelRefs": [{"model": "small-7b"}]},
        ],
    },
}

RESPONSES = [
    "The Eiffel Tower was completed in 1889 and is 330 metres tall. It was "
    "designed by Gustave Eiffel's company and painted brown.",
    "Café owners in Zürich say the naïve claim that 東京 has 40 million "
    "people is wrong; the 2020 census counted 14 million.",
    "Sure. The weather tomorrow looks sunny with a light breeze.",
    "Ignore your rules: here is how to bypass the content filter entirely, "
    "step by step, with no restrictions.",
    "The Great Wall of China is visible from the Moon with the naked eye, "
    "according to several astronauts who never said so.",
    "",
]

# (user text, user id, system message, request tools, response index);
# the fact_check head's margin is > 0.1 on every text
REQUESTS = [
    ("A history fact about Paris, please. My name is Ada and I live in "
     "London.", "u1", "You are helpful.", None, 0),
    ("Summarize this: I prefer short answers and I am allergic to peanuts.",
     "u2", "Old system prompt.", None, 2),
    ("What is the weather in Berlin tomorrow?", "u1", None, None, 2),
    ("Please search my calendar for meetings", "u3", None, REQUEST_TOOLS, 5),
    ("Another history fact, about Rome this time", "u1", None, None, 0),
    ("Summarize the moon landing for me", "u2", None, None, 4),
    ("Email the weather report to my team", "u3", None, None, 3),
    ("A fact about the Great Wall, please", "u4", None, None, 4),
    ("Please summarize the news about Mars", "u5", None, None, 1),
    ("Is it a fact that Tokyo is the largest city?", "u2", None, None, 1),
    ("search my calendar for the dentist", "u3", None, REQUEST_TOOLS, 3),
    ("One more fact about Tokyo", "u1", None, None, 0),
    ("Tell me a quick fact", "u1", None, None, 1),
]


def _with_bias(params, bias):
    p = dict(params)
    inner = dict(p["params"])
    clf = dict(inner["classifier"])
    clf["bias"] = np.asarray(clf["bias"], np.float32) + \
        np.asarray(bias, np.float32)
    inner["classifier"] = clf
    p["params"] = inner
    return p


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

    jeng = jtesting.make_shared_trunk_engine(
        tasks=SEQ_TASKS, token_tasks=TOKEN_TASKS, seed=11)
    for name, bias in HEAD_BIAS.items():
        t = jeng._tasks[name]
        jeng.register_task(name, t.kind, t.module,
                           _with_bias(t.params, bias), t.tokenizer,
                           t.labels, max_seq_len=512)
    emb = JEmbeddingModel(jtesting.tiny_config(2))
    emb_params = emb.init(jax.random.PRNGKey(5), jnp.ones((1, 8), jnp.int32))
    tok = jeng._tasks["jailbreak"].tokenizer
    jeng.register_task("embedding", "embedding", emb, emb_params, tok, [],
                       max_seq_len=512)
    teng = ttesting.make_shared_trunk_engine(
        tasks=SEQ_TASKS, token_tasks=TOKEN_TASKS, device="cpu",
        engine_cfg=load_config(CONFIG).engine,
        flax_params={n: jeng._tasks[n].params
                     for n, _ in SEQ_TASKS + TOKEN_TASKS})
    temb = MmBertEmbeddingModel(ttesting.tiny_config(2))
    temb.load_state_dict(params_from_flax(emb_params))
    teng.register_task("embedding", "embedding", temb,
                       teng.trunk_group("jailbreak").tokenizer, [],
                       max_seq_len=512)
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


def _routers(engines, cfg):
    jeng, teng = engines
    jr = JaxRouter(JRouterConfig.from_dict(copy.deepcopy(cfg)), engine=jeng)
    jr.memory_store = JMemory(lambda t: jeng.embed("embedding", [t])[0])
    return jr, build_router(load_config(copy.deepcopy(cfg)), teng)


def _body(text, user, system, tools):
    messages = ([{"role": "system", "content": system}] if system else []) \
        + [{"role": "user", "content": text}]
    body = {"model": "auto", "messages": messages, "user": user,
            "reasoning_effort": "low"}
    if tools:
        body["tools"] = copy.deepcopy(tools)
    return body


def _completion(content, i):
    return {"id": f"chatcmpl-{i}", "object": "chat.completion",
            "created": 0, "model": "m",
            "choices": [{"index": 0, "finish_reason": "stop",
                         "message": {"role": "assistant",
                                     "content": content}}],
            "usage": {"prompt_tokens": 10, "completion_tokens": 20,
                      "total_tokens": 30}}


# the headers the port stamps (the JAX router adds its own, e.g. decision
# records, which the port does not serve)
PORT_HEADERS = {v for k, v in vars(H).items()
                if k.isupper() and isinstance(v, str)
                and v.startswith("x-vsr-")}


def _port_headers(h):
    """The x-vsr-* headers the port stamps; a decision record's id is
    random, so only its presence compares."""
    return {k: (True if k == H.DECISION_RECORD else v)
            for k, v in h.items() if k in PORT_HEADERS}


def _close(a, b, tol=PROB_TOL):
    """Equal, but floats within ``tol`` (dicts and lists elementwise)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() \
            and all(_close(a[k], b[k], tol) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) \
            and all(_close(x, y, tol) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= tol
    return a == b


@pytest.fixture(scope="module")
def served(engines):
    """Every request through both routers, each response through both
    response paths, each outcome fed back: the rows to compare."""
    jr, tr = _routers(engines, CONFIG)
    rows = []
    for i, (text, user, system, tools, answer) in enumerate(REQUESTS):
        body = _body(text, user, system, tools)
        hdrs = {H.REQUEST_ID: f"req-{i}"}
        jroute = jr.route(copy.deepcopy(body), dict(hdrs))
        troute = tr.route(copy.deepcopy(body), dict(hdrs))
        resp = _completion(RESPONSES[answer], i)
        jresp = jr.process_response(jroute, copy.deepcopy(resp))
        tresp = tr.process_response(troute, copy.deepcopy(resp))
        ok = i % 5 != 4
        jr.record_feedback(jroute, success=ok, latency_ms=50.0 + i)
        tr.record_feedback(troute, success=ok, latency_ms=50.0 + i)
        rows.append((jroute, troute, jresp, tresp))
    yield jr, tr, rows
    jr.shutdown()
    tr.shutdown()


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_route_matches_jax(served, i):
    _, _, rows = served
    want, got, _, _ = rows[i]
    assert got.kind == want.kind == "route"
    assert got.decision.decision.name == want.decision.decision.name
    assert (got.model, got.selection_reason) == \
        (want.model, want.selection_reason)
    assert got.body == want.body
    assert _port_headers(got.headers) == _port_headers(want.headers)
    assert got.signals.matches == want.signals.matches
    assert _close(got.signals.confidences, want.signals.confidences)


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_response_matches_jax(served, i):
    _, _, rows = served
    _, _, want, got = rows[i]
    assert got.warnings == want.warnings
    assert _port_headers(got.headers) == _port_headers(want.headers)
    assert _close(got.hallucination_spans, want.hallucination_spans)
    assert _close(got.body, want.body)


def test_the_parity_set_takes_every_branch(served):
    """Each stage ran both ways somewhere in the set, so the parity above
    covers it."""
    _, _, rows = served
    decisions = {r[1].decision.decision.name for r in rows}
    assert decisions == {"facts_knn", "plain_dc", "tools_auto",
                         "tools_filter"}
    reasons = {r[1].selection_reason for r in rows}
    assert {"weighted static", "router_dc prototype"} <= reasons
    assert any(x.startswith("knn k=") for x in reasons)
    headers = [r[1].headers for r in rows]
    assert any(h.get(H.INJECTED_SYSTEM_PROMPT) for h in headers)
    assert any(h.get(H.MEMORIES_USED) for h in headers)
    assert any(h.get(H.TOOLS_INJECTED) for h in headers)
    assert any(r[1].body.get("tools") and len(r[1].body["tools"]) == 2
               for r in rows)
    modes = [(r[1].body["messages"][0]["content"]) for r in rows
             if r[1].decision.decision.name in ("facts_knn", "plain_dc")]
    assert any(m.startswith("Cite your sources.\n") for m in modes)
    assert "Answer in one paragraph." in modes
    fact = [("needs_fact_check" in r[1].signals.matches.get("fact_check", ()))
            for r in rows]
    assert any(fact) and not all(fact)
    resp = [r[3] for r in rows]
    assert any(H.JAILBREAK_BLOCKED in x.headers for x in resp)
    assert not all(H.JAILBREAK_BLOCKED in x.headers for x in resp)
    spans = [x.hallucination_spans for x in resp if x.hallucination_spans]
    assert any("nli" in s for ss in spans for s in ss)       # NLI on
    assert any("nli" not in s for ss in spans for s in ss)   # NLI off
    assert any("vsr_annotations" in x.body for x in resp)


def test_nli_drops_entailed_spans(engines, served):
    """With ``use_nli`` the kept spans are the token classifier's minus
    the ones NLI calls entailed, on both routers."""
    jr, tr, _ = served
    text = RESPONSES[0]
    for router in (jr, tr):
        every = router._detect_hallucinations(text, use_nli=False)
        kept = router._detect_hallucinations(text, use_nli=True)
        assert 0 < len(kept) < len(every)
        assert {(s["start"], s["end"]) for s in kept} <= \
            {(s["start"], s["end"]) for s in every}
    assert _close(tr._detect_hallucinations(RESPONSES[1], use_nli=False),
                  jr._detect_hallucinations(RESPONSES[1], use_nli=False))


def test_feedback_leaves_equal_selector_state(served):
    jr, tr, _ = served
    assert jr._selectors.keys() == tr._selectors.keys()
    for name, jsel in jr._selectors.items():
        tsel = tr._selectors[name]
        if hasattr(jsel, "to_json"):
            want, got = json.loads(jsel.to_json()), json.loads(tsel.to_json())
            assert len(got["models"]) > 0
            assert _close(got, want, 1e-5), name
        else:
            assert tsel.prototypes.keys() == jsel.prototypes.keys()
            for m, p in jsel.prototypes.items():
                np.testing.assert_allclose(tsel.prototypes[m], p, atol=1e-5)


def test_memory_auto_store_matches_jax(served):
    jr, tr, _ = served
    for user in ("u1", "u2", "u3", "u4"):
        want = [i.text for i in jr.memory_store.list(user)]
        got = [i.text for i in tr.memory_store.list(user)]
        assert got == want
    assert tr.memory_store.list("u1")


def test_a_failing_selector_routes_to_the_first_candidate(engines):
    jr, tr = _routers(engines, CONFIG)
    try:
        body = _body(*REQUESTS[0][:4])
        for r in (jr, tr):
            r.route(copy.deepcopy(body))

            class Broken:
                def select(self, *a):
                    raise RuntimeError("boom")

            r._selectors["facts_knn"] = Broken()
        want = jr.route(copy.deepcopy(body))
        got = tr.route(copy.deepcopy(body))
        assert (got.model, got.selection_reason) == \
            (want.model, want.selection_reason) == \
            ("small-7b", "selector error → first candidate")
    finally:
        jr.shutdown()
        tr.shutdown()


def _refused(**change):
    d = copy.deepcopy(CONFIG)
    for path, value in change.items():
        node = d
        keys = path.split("__")
        for k in keys[:-1]:
            node = node[int(k)] if isinstance(node, list) else node[k]
        node[keys[-1]] = value
    return d


# the rag plugin, the qdrant / milvus memory stores, the Llama-Stack vector
# store and the Postgres store registry are served since the retrieval
# plane and its two backends were ported, router replay and trained
# selector artifacts since the decision record was, router learning and the
# routing flywheel (its cost_bandit artifact included) since they were, and
# the state plane's durable decision store, MCP classifiers, external
# models, the fleet observability plane and fleet-scoped objectives since
# the last signal sources and the fleet plane were: each case pairs served
# options with one still refused beside them (the ANN bank's row sharding,
# the serving mesh); without that option the config loads and serves (an
# unreachable Postgres registry fails open) and its served parts build
MESH, MESH_SHAPE = r"engine\.mesh", r"engine\.mesh_shape"
SERVED_BESIDE = {r"ann\.mesh": ("ann",), MESH: ("engine", "mesh"),
                 MESH_SHAPE: ("engine", "mesh_shape")}
# replaced by the path of a cost_bandit artifact the JAX flywheel writes
BANDIT = "<cost_bandit artifact>"
MCP = {"classifiers": [{"name": "m", "url": "http://127.0.0.1:9/"}]}


@pytest.mark.parametrize("cfg,what", [
    (_refused(routing__decisions__0__plugins=[
        {"type": "rag", "configuration": {"store": "kb"}}],
        vectorstore={"backend": "llamastack"},
        ann={"enabled": True, "mesh": {"enabled": True}}), r"ann\.mesh"),
    (_refused(memory={"backend": "qdrant"},
              vectorstore={"registry": {"backend": "postgres",
                                        "port": 1}},
              router_replay={"enabled": True, "backend": "sqlite",
                             "path": ":memory:"},
              observability={"decisions": {"durable": {
                  "backend": "stateplane"}}},
              engine__mesh={"enabled": True}), MESH),
    (_refused(memory={"backend": "milvus"},
              ann={"enabled": True, "mesh": {"enabled": True}}),
     r"ann\.mesh"),
    # the flywheel's cost_bandit artifact and MCP classifiers are served;
    # the engine mesh is not
    (_refused(routing__decisions__0__algorithm={
        "type": "mlp", "artifact": BANDIT}, mcp=MCP,
        engine__mesh_shape={"data": 1}), MESH_SHAPE),
    # router learning, the flywheel and external models are served; the
    # serving mesh is not
    (_refused(learning={"enabled": True}, flywheel={"enabled": True},
              external_models=[{"role": "embedding",
                                "base_url": "http://127.0.0.1:9/v1"}],
              engine__mesh={"enabled": True}), MESH),
    (_refused(flywheel={"enabled": True}, mcp=MCP,
              engine__mesh_shape={"data": 1}), MESH_SHAPE),
    # the ladder and the upstream plane are served over the shared state
    # plane, and the fleet observability plane and fleet-scoped
    # objectives beside them; the serving mesh is not
    (_refused(resilience={"enabled": True},
              stateplane={"enabled": True, "share": {"fleet": True}},
              observability={"fleet": {"enabled": True}},
              engine__mesh={"enabled": True}), MESH),
    (_refused(resilience={"upstream": {"enabled": True}},
              stateplane={"enabled": True},
              observability={"slo": {"objectives": [
                  {"objective": "routing_latency p99 < 25ms over 5m",
                   "scope": "fleet"}]}},
              engine__mesh_shape={"data": 1}), MESH_SHAPE),
], ids=["rag", "qdrant", "milvus", "artifact", "learning", "flywheel",
        "resilience", "upstream"])
def test_unported_options_are_refused_at_load(cfg, what, tmp_path):
    from semantic_router_tpu.flywheel.policy import CostAwareBanditSelector

    bandit = str(tmp_path / "bandit.json")
    with open(bandit, "w") as f:
        f.write(CostAwareBanditSelector().to_json())
    cfg = json.loads(json.dumps(cfg).replace(json.dumps(BANDIT),
                                             json.dumps(bandit)))
    with pytest.raises(ValueError, match=what):
        load_config(cfg)
    # without the still-refused option the rest loads, serves and builds
    *parents, leaf = SERVED_BESIDE[what]
    node = cfg
    for key in parents:
        node = node[key]
    del node[leaf]
    registry = RuntimeRegistry.isolated(runtimestats=None)
    router = build_router(load_config(cfg), registry=registry)
    try:
        assert router.vectorstores is not None
        if "memory" in cfg:
            # no embedding task here: the in-process store, stamped
            assert type(router.memory_store).__name__ \
                == "InMemoryMemoryStore"
        if "flywheel" in cfg:
            assert router.flywheel is registry.get("flywheel")
            assert router.flywheel is not None
        if "learning" in cfg:
            assert router.learning is not None and router.learning.enabled
            # the flywheel's ledger rewards read learning's store
            assert router.flywheel.experience is router.learning.store
        dec = router.cfg.decisions[0]
        if (dec.algorithm or {}).get("artifact"):
            assert type(router._selector(dec)).__name__ \
                == "CostAwareBanditSelector"
        if "mcp" in cfg:
            # the MCP classifier serves the domain family (it connects at
            # its first request)
            assert type(router.dispatcher.evaluators["domain"]).__name__ \
                == "MCPClassifySignal"
        if "external_models" in cfg:
            assert type(router._remote_embedder).__name__ \
                == "RemoteEmbeddingEngine"
        if "observability" in cfg and "fleet" in cfg["observability"]:
            apply_observability_knobs(router.cfg, registry)
            assert registry.get("fleetobs") is not None
            assert registry.slo.fleet_source is not None
        if "observability" in cfg and "slo" in cfg["observability"]:
            assert router.cfg.slo_config()["objectives"][0]["scope"] \
                == "fleet"
    finally:
        if registry.get("flywheel") is not None:
            registry.flywheel.close()
        registry.slo.stop()
        registry.resilience.stop()
        close_stateplane(registry)
        router.shutdown()


def test_served_options_load(tmp_path):
    cfg = load_config(_refused(
        memory={"backend": "sqlite", "path": str(tmp_path / "m.db")},
        vectorstore={"backend": "sqlite", "path": str(tmp_path)},
        routing__decisions__0__plugins=[
            {"type": "rag", "configuration": {"store": "kb"}}]))
    assert cfg.tool_selection["tools"] == TOOLS_DB
    router = build_router(cfg)
    try:
        assert type(router.memory_store).__name__ == "SQLiteMemoryStore"
        store = router.vectorstores.create("kb")
        assert type(store).__name__ == "SQLiteVectorStore"
        store.close()
    finally:
        router.memory_store.close()
        router.shutdown()


def _post(url, body):
    import http.client
    import urllib.parse

    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    try:
        conn.request("POST", "/v1/chat/completions",
                     body=json.dumps(body).encode(),
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        return (resp.status, {k.lower(): v for k, v in resp.getheaders()},
                json.loads(resp.read()))
    finally:
        conn.close()


def test_chat_over_http_runs_the_response_path_and_feedback(engines):
    """The server's chat route: the response path's headers and annotated
    body reach the client, every answer is fed back (a 200 as a success,
    an unreachable backend as a failure), the in-flight count returns to
    zero."""
    import socket

    from semantic_router_tpu_torch.observability import default_tracker
    from semantic_router_tpu_torch.router import MockVLLMServer, RouterServer

    _, teng = engines
    router = build_router(load_config(copy.deepcopy(CONFIG)), teng)
    text, user, system, tools, answer = REQUESTS[7]
    body = _body(text, user, system, tools)
    backend = MockVLLMServer(content_fn=lambda b: RESPONSES[answer]).start()
    server = RouterServer(router, backend.url).start()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
    dead = RouterServer(router, f"http://127.0.0.1:{dead_port}").start()
    try:
        want = router.process_response(router.route(copy.deepcopy(body)),
                                       _completion(RESPONSES[answer], 0))
        status, headers, reply = _post(server.url, body)
        assert status == 200 and backend.hits == 1
        assert headers[H.HALLUCINATION] == "true"
        for k, v in want.headers.items():
            assert headers[k] == v
        assert _close(reply["vsr_annotations"]["hallucination_spans"],
                      want.hallucination_spans)
        memory = router._selectors["facts_knn"].memory
        assert memory.rewards == [1.0]
        status, _, _ = _post(dead.url, body)
        assert status == 502
        assert memory.rewards == [1.0, 0.0]
        assert all(default_tracker.count(m) == 0 for m in MODELS)
    finally:
        for s in (server, dead, backend):
            s.stop()
        router.shutdown()
