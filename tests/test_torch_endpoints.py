"""The reference's remaining endpoints over ported parts, on the port's
server against the JAX server's on the same config and weights, on the
CPU: ``POST /api/v1/eval`` (every family's matches, confidences, kb
metrics and errors, every decision) over the fixture config,
``POST /api/v1/nli`` (and its 503 without an ``nli`` task), the
``/v1/memory`` routes (a DELETE without ``user_id`` finding the owner),
``GET /debug/upstreams`` on and off, ``/openapi.json`` (``build_spec`` on
the same catalog equal to JAX's, the document valid), ``/docs``,
``/startup-status`` with and without a tracker (the tracker's phases and
file against JAX's, and ``serve``'s boot through them), and
``/info/models``; ``API_CATALOG`` lists exactly the routes the port
answers."""

import copy
import http.client
import json
import os
import urllib.parse

import pytest
import torch

from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.memory.store import \
    InMemoryMemoryStore as JMemoryStore
from semantic_router_tpu.router import openapi as jopenapi
from semantic_router_tpu.router.pipeline import Router as JRouter
from semantic_router_tpu.router.server import RouterServer as JServer
from semantic_router_tpu.runtime import startup as jstartup
from semantic_router_tpu_torch.config import InferenceEngineConfig, \
    load_config
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.memory import InMemoryMemoryStore
from semantic_router_tpu_torch.router import MockVLLMServer, Router, \
    RouterServer
from semantic_router_tpu_torch.router import openapi as topenapi
from semantic_router_tpu_torch.router.server import API_CATALOG
from semantic_router_tpu_torch.runtime import bootstrap as tboot
from semantic_router_tpu_torch.runtime import startup as tstartup
from test_torch_router_fixture import BODIES, _fixture_dict, _with_probes
from test_torch_router_fixture import engines  # noqa: F401  (a fixture)
from test_torch_upstream import _Pair

NLI = ["entailment", "neutral", "contradiction"]
TASKS = [("nli", "sequence", NLI),
         ("intent", "sequence", ["business", "law", "health", "other"]),
         ("embedding", "embedding", [])]
# summaries the port words for its own backend (torch.profiler, CUDA
# graphs, no XLA)
PORT_SUMMARIES = {("get", "/debug/runtime"), ("get", "/debug/programs"),
                  ("post", "/debug/profiler/start"),
                  ("post", "/debug/profiler/xla-dump")}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _call(url, method, path, body=None):
    """(status, headers, parsed JSON or text)."""
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={"content-type": "application/json"}
                     if data else {})
        resp = conn.getresponse()
        raw = resp.read()
        headers = {k.lower(): v for k, v in resp.getheaders()}
        if headers.get("content-type", "").startswith("application/json"):
            return resp.status, headers, json.loads(raw or b"{}")
        return resp.status, headers, raw.decode()
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


def _answer_headers(h):
    return {k: v for k, v in h.items() if k not in ("date", "server")}


@pytest.fixture(scope="module")
def served():
    """{"jax": url, "port": url} over one seeded engine pair (an ``nli``
    head, an intent head, an embedding task), each router with an
    in-memory memory store; and the port engine."""
    jeng = jtesting.make_test_engine(tasks=TASKS, seed=16)
    teng = ttesting.make_test_engine(
        tasks=TASKS, device="cpu",
        engine_cfg=InferenceEngineConfig(max_batch_size=8, max_wait_ms=1.0,
                                         seq_len_buckets=[32, 128, 512]),
        flax_params={k: t.params for k, t in jeng._tasks.items()})
    backend = MockVLLMServer().start()
    jcfg = JRouterConfig.from_dict({})
    jrouter = JRouter(jcfg, engine=jeng)
    jrouter.memory_store = JMemoryStore()
    jserver = JServer(jrouter, jcfg, default_backend=backend.url).start()
    trouter = Router(load_config({}), engine=teng)
    trouter.memory_store = InMemoryMemoryStore()
    tserver = RouterServer(trouter, backend.url).start()
    yield {"jax": jserver.url, "port": tserver.url, "engine": teng}
    tserver.stop()
    jserver.stop()
    backend.stop()
    for r in (trouter, jrouter):
        r.shutdown()
    jeng.shutdown()
    teng.shutdown()


@pytest.fixture(scope="module")
def fixture_servers(engines, fixture_config_path):  # noqa: F811
    """Both servers over the fixture config with a probe decision per
    family it leaves unread, on the fixture's engine pair."""
    jeng, teng = engines
    d = _with_probes(_fixture_dict(fixture_config_path))
    backend = MockVLLMServer().start()
    jcfg = JRouterConfig.from_dict(copy.deepcopy(d))
    jrouter = JRouter(jcfg, engine=jeng)
    jserver = JServer(jrouter, jcfg, default_backend=backend.url).start()
    trouter = Router(load_config(copy.deepcopy(d)), engine=teng)
    tserver = RouterServer(trouter, backend.url).start()
    yield {"jax": jserver.url, "port": tserver.url}
    tserver.stop()
    jserver.stop()
    backend.stop()
    for r in (trouter, jrouter):
        r.shutdown()


def _eval_text(body) -> str:
    msgs = [m for m in body["messages"] if m["role"] == "user"]
    return msgs[-1]["content"]


def _without_latency(reply):
    reply = copy.deepcopy(reply)
    for fam in reply["families"].values():
        fam.pop("latency_ms")
    return reply


@pytest.mark.parametrize("i", range(len(BODIES)))
def test_eval_matches_jax(fixture_servers, i):
    """Every family's matches, confidences, kb metrics and errors, and
    every matching decision, as the JAX server reports them."""
    text = _eval_text(BODIES[i][0])
    out = {}
    for side in ("jax", "port"):
        status, headers, reply = _call(fixture_servers[side], "POST",
                                       "/api/v1/eval", {"text": text})
        assert status == 200
        out[side] = (_answer_headers(headers), reply)
    assert out["port"][0].keys() == out["jax"][0].keys()
    got, want = out["port"][1], out["jax"][1]
    assert all(f["latency_ms"] >= 0 for f in got["families"].values())
    _same({k: sorted(v) for k, v in got["signals"].items()},
          {k: sorted(v) for k, v in want["signals"].items()}, 0)
    got.pop("signals")
    want.pop("signals")
    _same(_without_latency(got), _without_latency(want), 1e-4)


def test_eval_reports_decisions_and_kb_metrics(fixture_servers):
    """Across the parity set the eval route reports the kb family's
    metrics and more than one decision for some text."""
    seen_kb = seen_many = False
    for body, _ in BODIES:
        _, _, reply = _call(fixture_servers["port"], "POST",
                            "/api/v1/eval", {"text": _eval_text(body)})
        seen_kb |= bool(reply["kb_metrics"])
        seen_many |= len(reply["decisions"]) > 1
    assert seen_many and seen_kb


@pytest.mark.parametrize("body", [
    {"premise": "the sky is blue", "hypothesis": "the sky has a colour"},
    {"premise": "", "hypothesis": ""}, {}])
def test_nli_matches_jax(served, body):
    out = {}
    for side in ("jax", "port"):
        status, headers, reply = _call(served[side], "POST", "/api/v1/nli",
                                       body)
        out[side] = (status, _answer_headers(headers).keys(), reply)
    assert out["port"][:2] == out["jax"][:2]
    assert out["port"][0] == 200 and out["port"][2]["label"] in NLI
    _same(out["port"][2], out["jax"][2], 1e-4)
    want = served["engine"].classify(
        "nli", f"{body.get('premise', '')}\n[SEP]\n"
               f"{body.get('hypothesis', '')}")
    assert out["port"][2]["label"] == want.label


def test_nli_without_the_task_and_eval_without_an_engine_match_jax():
    backend = MockVLLMServer().start()
    jcfg = JRouterConfig.from_dict({})
    jrouter = JRouter(jcfg)
    jserver = JServer(jrouter, jcfg, default_backend=backend.url).start()
    trouter = Router(load_config({}))
    tserver = RouterServer(trouter, backend.url).start()
    try:
        for path, body in (("/api/v1/nli", {"premise": "a"}),
                           ("/api/v1/eval", {"text": "hello there"}),
                           ("/v1/memory", {"user_id": "u", "text": "x"})):
            replies = []
            for url in (jserver.url, tserver.url):
                status, _, reply = _call(url, "POST", path, body)
                replies.append((status, _without_latency(reply)
                                if path == "/api/v1/eval" else reply))
            assert replies[0] == replies[1], path
        assert replies[0][0] == 503
        for method, path in (("GET", "/v1/memory?user_id=u"),
                             ("GET", "/v1/memory/abc"),
                             ("DELETE", "/v1/memory?user_id=u"),
                             ("DELETE", "/v1/memory/abc"),
                             ("GET", "/debug/upstreams"),
                             ("GET", "/info/models")):
            answers = [_call(url, method, path)[::2]
                       for url in (jserver.url, tserver.url)]
            assert answers[0] == answers[1], (method, path)
    finally:
        tserver.stop()
        jserver.stop()
        backend.stop()
        trouter.shutdown()
        jrouter.shutdown()


def _strip_ids(reply):
    """A memory answer with its generated ids and times set aside."""
    reply = copy.deepcopy(reply)
    for item in reply.get("data", [reply]) if isinstance(reply, dict) \
            else []:
        item.pop("id", None)
        item.pop("created", None)
    return reply


def test_memory_round_trip_matches_jax(served):
    """Create for two users, list, get by id, delete one without
    ``user_id`` (the owner found by id), then a user's whole scope."""
    ids = {}
    for side in ("jax", "port"):
        url = served[side]
        got = []
        made = []
        for user, text in (("alice", "I prefer window seats"),
                           ("alice", "my dog is called Rex"),
                           ("bob", "bob works at night")):
            status, _, reply = _call(url, "POST", "/v1/memory",
                                     {"user_id": user, "text": text,
                                      "kind": "preference"})
            got.append((status, _strip_ids(reply)))
            made.append(reply["id"])
        for q in ("?user_id=alice", "?user_id=bob", "", "?user_id=nobody"):
            status, _, reply = _call(url, "GET", "/v1/memory" + q)
            got.append((status, _strip_ids(reply)))
        for mid in (made[2], "missing"):
            status, _, reply = _call(url, "GET", f"/v1/memory/{mid}")
            got.append((status, _strip_ids(reply)))
        for path in (f"/v1/memory/{made[0]}", f"/v1/memory/{made[0]}",
                     f"/v1/memory/{made[2]}?user_id=alice",
                     "/v1/memory?user_id=alice",
                     "/v1/memory?user_id=bob", "/v1/other"):
            status, _, reply = _call(url, "DELETE", path)
            got.append((status, reply))
        status, _, reply = _call(url, "GET", "/v1/memory?user_id=alice")
        got.append((status, reply))
        ids[side] = got
    assert ids["port"] == ids["jax"]
    assert ids["port"][0][0] == 200
    assert ids["port"][-1] == (200, {"data": []})


def test_memory_store_lists_all_and_finds_by_id_like_jax():
    stores = (JMemoryStore(), InMemoryMemoryStore())
    for store in stores:
        for i in range(7):
            store.remember(f"user{i % 3}", f"fact number {i} about things")
    listed = [[(m.user_id, m.text) for m in s.list_all()] for s in stores]
    assert listed[0] == listed[1] and len(listed[0]) == 7
    for limit in (0, 2, 3, 5, 100):
        assert [(m.user_id, m.text) for m in stores[1].list_all(limit)] \
            == [(m.user_id, m.text) for m in stores[0].list_all(limit)]
    for store in stores:
        item = store.list_all()[4]
        assert store.find_by_id(item.id) is item
        assert store.find_by_id("nope") is None


def test_memory_on_sqlite_inherits_list_all(tmp_path):
    from semantic_router_tpu_torch.memory import SQLiteMemoryStore

    store = SQLiteMemoryStore(str(tmp_path / "m.db"))
    try:
        item = store.remember("carol", "carol likes tea")
        assert store.list_all() == [item]
        assert store.find_by_id(item.id) is item
    finally:
        store.close()


def test_debug_upstreams_matches_jax():
    """Off: 503 with the reference's message; on: the plane's report
    after a routed request, rows and config as the JAX plane's."""
    backend = MockVLLMServer().start()
    cfg = {"routing": {"modelCards": [{"name": "m"}]},
           "default_model": "m"}
    off = _Pair(cfg, backend.url)
    on = _Pair(dict(cfg, resilience={"upstream": {"enabled": True}}),
               backend.url, upstream=True)
    try:
        answers = [_call(off.jserver.url, "GET", "/debug/upstreams"),
                   _call(off.tserver.url, "GET", "/debug/upstreams")]
        assert answers[0][::2] == answers[1][::2]
        assert answers[0][0] == 503
        replies = []
        for url in (on.jserver.url, on.tserver.url):
            status, _, _ = _call(url, "POST", "/v1/chat/completions", {
                "model": "m", "messages": [{"role": "user",
                                            "content": "hello"}]})
            assert status == 200
            status, _, reply = _call(url, "GET", "/debug/upstreams")
            assert status == 200
            for row in reply["endpoints"]:
                assert row.pop("latency_ewma_ms") >= 0
            replies.append(reply)
        # the fleet-shared circuits and budget need a state plane, which
        # this config does not attach: both planes report them inert
        for reply in replies:
            assert reply.pop("fleet_budget") == {
                "active": False, "granted": 0, "denied": 0}
            assert reply.pop("fleet_open") == []
        assert replies[0] == replies[1]
        assert replies[1]["endpoints"][0]["requests"] == 1
    finally:
        off.stop()
        on.stop()
        backend.stop()


def test_info_models_matches_jax(served):
    answers = [_call(served[side], "GET", "/info/models")
               for side in ("jax", "port")]
    assert answers[0][0] == answers[1][0] == 200
    assert answers[1][2] == answers[0][2]
    kinds = {r["task"]: r["kind"] for r in answers[1][2]["tasks"]}
    assert kinds == {"nli": "sequence", "intent": "sequence",
                     "embedding": "embedding"}


def test_openapi_spec_equals_jax_on_the_port_catalog(served):
    """``build_spec`` of the port's catalog equals JAX's but for the
    port's own wording of four summaries and the description; the
    document validates in both packages and is what the server serves."""
    got = topenapi.build_spec(API_CATALOG)
    want = jopenapi.build_spec(API_CATALOG)
    for spec in (got, want):
        for method, path in PORT_SUMMARIES:
            spec["paths"][path][method].pop("summary")
        spec["info"].pop("description")
    assert got == want
    spec = topenapi.build_spec(API_CATALOG)
    assert topenapi.validate_spec(spec) == []
    assert jopenapi.validate_spec(spec) == []
    ops = {(m, p) for p, d in spec["paths"].items() for m in d}
    assert ops == {(e["method"].lower(), e["path"])
                   for e in API_CATALOG["endpoints"]}
    status, headers, served_spec = _call(served["port"], "GET",
                                         "/openapi.json")
    assert status == 200 and served_spec == spec
    jstatus, jheaders, jspec = _call(served["jax"], "GET", "/openapi.json")
    assert jstatus == 200 and headers.keys() == jheaders.keys()
    assert jopenapi.validate_spec(jspec) == []


def test_openapi_on_the_jax_catalog_and_broken_specs_equal_jax():
    from semantic_router_tpu.router.server import API_CATALOG as JCATALOG

    got = topenapi.build_spec(JCATALOG, server_url="/x")
    want = jopenapi.build_spec(JCATALOG, server_url="/x")
    for spec in (got, want):
        for method, path in PORT_SUMMARIES:
            spec["paths"][path][method].pop("summary")
        spec["info"].pop("description")
    assert got == want
    broken = topenapi.build_spec(API_CATALOG)
    broken["openapi"] = "2.0"
    broken["info"]["title"] = ""
    broken["paths"]["/v1/memory/{id}"]["get"]["parameters"] = []
    broken["paths"]["/health"]["get"]["operationId"] = "getApiV1"
    broken["paths"]["/docs"]["get"]["responses"]["200"] = {
        "$ref": "#/components/schemas/Nope"}
    assert topenapi.validate_spec(broken) == jopenapi.validate_spec(broken)
    assert len(topenapi.validate_spec(broken)) >= 5


def test_docs_page_matches_jax(served):
    answers = [_call(served[side], "GET", "/docs")
               for side in ("jax", "port")]
    assert answers[0][0] == answers[1][0] == 200
    assert answers[1][1]["content-type"] == answers[0][1]["content-type"] \
        == "text/html"
    assert answers[1][2] == answers[0][2] == topenapi.DOCS_HTML


def test_startup_status_without_a_tracker_matches_jax(served):
    answers = [_call(served[side], "GET", "/startup-status")
               for side in ("jax", "port")]
    for status, _, reply in answers:
        assert status == 200 and reply.pop("uptime_s") >= 0
    assert answers[1][2] == answers[0][2] == {"ready": True}


def test_startup_tracker_matches_jax(tmp_path):
    """Phases, notes, failure and the status file, as JAX's tracker."""
    assert tstartup.PHASES == jstartup.PHASES
    snaps, files = [], []
    for mod, name in ((jstartup, "j.json"), (tstartup, "t.json")):
        path = str(tmp_path / name)
        tr = mod.StartupTracker(path=path)
        seen = [tr.snapshot()]
        tr.advance("loading_config", "router.yaml")
        tr.note("a note")
        for phase in ("loading_models", "warming", "ready"):
            tr.advance(phase)
            seen.append((tr.snapshot(), tr.ready))
        with pytest.raises(ValueError) as exc:
            tr.advance("booting")
        seen.append(str(exc.value))
        tr.fail("boom")
        seen.append((tr.snapshot(), tr.ready))
        with open(path) as f:
            files.append(json.load(f))
        for s in seen:
            snap = s[0] if isinstance(s, tuple) else s
            if isinstance(snap, dict):
                snap.pop("uptime_s")
        snaps.append(seen)
    for f in files:
        f.pop("uptime_s")
    assert snaps[1] == snaps[0]
    assert files[1] == files[0]
    assert files[1]["phase"] == "failed" and files[1]["error"] == "boom"
    # no path: nothing is written, the snapshot still moves
    tr = tstartup.StartupTracker()
    tr.advance("warming")
    assert tr.snapshot()["phase"] == "warming" and not tr.ready


def test_serve_boots_through_the_phases(tmp_path):
    """``serve`` advances the tracker to ready and the server's
    /startup-status serves it; a config that fails to load leaves the
    status file at failed with the error."""
    cfg_path = tmp_path / "router.json"
    cfg_path.write_text(json.dumps({"default_model": "m"}))
    backend = MockVLLMServer().start()
    status_path = str(tmp_path / "status.json")
    server, tracker = tboot.serve(str(cfg_path), backend.url, port=0,
                                  device="cpu", status_path=status_path,
                                  block=False)
    try:
        assert tracker.ready and server.startup is tracker
        status, _, reply = _call(server.url, "GET", "/startup-status")
        assert status == 200 and reply["phase"] == "ready"
        assert [n.split(":")[0] for n in reply["notes"]] == \
            ["loading_config", "loading_models"]
        with open(status_path) as f:
            assert json.load(f)["ready"] is True
    finally:
        server.stop()
        server.router.shutdown()
        reg = server.registry
        reg.runtimestats.stop()
        reg.slo.stop()
        reg.resilience.stop()
        backend.stop()
    bad = tmp_path / "missing.yaml"
    with pytest.raises(Exception):
        tboot.serve(str(bad), backend.url, port=0, device="cpu",
                    status_path=status_path, block=False)
    with open(status_path) as f:
        failed = json.load(f)
    assert failed["phase"] == "failed" and failed["failed"] is True
    assert failed["error"]
    assert os.path.exists(status_path)


def test_catalog_lists_exactly_what_the_port_serves(served):
    """Every catalog route answers (never the unknown-route 404), and a
    route the reference serves that the port does not is absent."""
    url = served["port"]
    bodies = {"/v1/chat/completions": {"model": "auto", "messages": [
        {"role": "user", "content": "hi"}]},
        "/v1/messages": {"model": "auto", "max_tokens": 8, "messages": [
            {"role": "user", "content": "hi"}]},
        "/v1/responses": {"model": "auto", "input": "hi"},
        "/api/v1/classify/batch": {"task": "intent", "texts": ["a"]},
        "/api/v1/similarity": {"text_a": "a", "text_b": "b"},
        "/v1/memory": {"user_id": "z", "text": "zed likes maps"}}
    for ep in API_CATALOG["endpoints"]:
        path = ep["path"].replace("{id}", "x").replace("{asset}", "app.js")
        if path.startswith("/debug/profiler/"):
            continue  # starting a trace is not for this test
        status, _, reply = _call(url, ep["method"], path,
                                 bodies.get(path, {"text": "a"})
                                 if ep["method"] == "POST" else None)
        assert not (status == 404 and reply == {"error": "not found"}), ep
    from semantic_router_tpu.router.server import API_CATALOG as JCATALOG

    served_paths = {(e["path"], e["method"]) for e in API_CATALOG[
        "endpoints"]}
    assert served_paths <= {(e["path"], e["method"])
                            for e in JCATALOG["endpoints"]}
    # the fleet observability plane is served (503 without a plane, as
    # the reference's); the dashboard's reads are, the ones the
    # reference's catalog leaves out included
    for path in ("/debug/fleet", "/metrics/fleet"):
        assert (path, "GET") in served_paths
        assert _call(url, "GET", path)[0] == 503
    assert ("/dashboard/embedmap", "GET") in served_paths
    for path in ("/dashboard/api/overview", "/dashboard/embedmap",
                 "/dashboard", "/dashboard/api/events"):
        assert _call(url, "GET", path)[0] == 200, path
