"""The management API's access gate against the JAX server's: with three
API keys configured (``view``, ``edit``, ``admin`` + ``secret_view``),
every ``(path, method)`` of the port's ``API_CATALOG`` is called with no
key, a bad key and each key (as ``x-api-key``, as a bearer token and as
a dashboard session token from ``POST /dashboard/api/login``); the
port's status class (2xx / 401-403 / other) equals the JAX server's
over the same config and one seeded engine pair, on the CPU, and the
audit lines of the mutations name the same action and roles."""

import http.client
import json
import logging
import urllib.parse

import pytest
import torch
import yaml

from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.memory.store import \
    InMemoryMemoryStore as JMemoryStore
from semantic_router_tpu.router.pipeline import Router as JRouter
from semantic_router_tpu.router.server import RouterServer as JServer
from semantic_router_tpu_torch.config import InferenceEngineConfig, \
    load_config
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.memory import InMemoryMemoryStore
from semantic_router_tpu_torch.router import MockVLLMServer, Router, \
    RouterServer
from semantic_router_tpu_torch.router.server import API_CATALOG

NLI = ["entailment", "neutral", "contradiction"]
TASKS = [("nli", "sequence", NLI),
         ("intent", "sequence", ["business", "law", "health", "other"]),
         ("embedding", "embedding", [])]
KEYS = {"view-key": ["view"], "edit-key": ["edit"],
        "admin-key": ["admin", "secret_view"]}
CONFIG = {"default_model": "m1",
          "routing": {"modelCards": [{"name": "m1"}]},
          "api_server": {"api_keys": [{"key": k, "roles": r}
                                      for k, r in KEYS.items()]
                         + [{"roles": ["admin"]}]}}
BODIES = {
    "/v1/chat/completions": {"model": "auto", "messages": [
        {"role": "user", "content": "hi"}]},
    "/v1/messages": {"model": "auto", "max_tokens": 8, "messages": [
        {"role": "user", "content": "hi"}]},
    "/v1/responses": {"model": "auto", "input": "hi"},
    "/api/v1/classify/batch": {"task": "intent", "texts": ["a"]},
    "/api/v1/similarity": {"text_a": "a", "text_b": "b"},
    "/v1/memory": {"user_id": "z", "text": "zed likes maps"},
    "/config/router": {"tags": {"rbac": True}},
    "/config/router/rollback": {"version": "19700101T000000-000"},
    "/dashboard/api/login": {"api_key": "nope"},
    "/dashboard/api/dsl/compile": {"dsl": 'model "m1"\n'},
    "/dashboard/api/dsl/decompile": {"config": {}},
    "/dashboard/api/config/validate": {"yaml": "{}"},
    "/dashboard/api/config/deploy": {"yaml": yaml.safe_dump(CONFIG)},
}
# starting a trace (or an XLA dump) is not for this test: these are
# called only with credentials the gate refuses
PROFILER = ("/debug/profiler/start", "/debug/profiler/stop",
            "/debug/profiler/xla-dump")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("rbac")
    paths = {}
    for name in ("jax", "port"):
        paths[name] = str(root / f"{name}.yaml")
        with open(paths[name], "w") as f:
            f.write(yaml.safe_dump(CONFIG))
    jeng = jtesting.make_test_engine(tasks=TASKS, seed=16)
    teng = ttesting.make_test_engine(
        tasks=TASKS, device="cpu",
        engine_cfg=InferenceEngineConfig(max_batch_size=8, max_wait_ms=1.0,
                                         seq_len_buckets=[32, 128, 512]),
        flax_params={k: t.params for k, t in jeng._tasks.items()})
    backend = MockVLLMServer().start()
    jcfg = JRouterConfig.from_dict(dict(CONFIG))
    jrouter = JRouter(jcfg, engine=jeng)
    jrouter.memory_store = JMemoryStore()
    jserver = JServer(jrouter, jcfg, default_backend=backend.url,
                      config_path=paths["jax"]).start()
    trouter = Router(load_config(dict(CONFIG)), engine=teng)
    trouter.memory_store = InMemoryMemoryStore()
    tserver = RouterServer(trouter, backend.url,
                           config_path=paths["port"]).start()
    yield {"jax": jserver.url, "port": tserver.url}
    tserver.stop()
    jserver.stop()
    backend.stop()
    for r in (trouter, jrouter):
        r.shutdown()
    jeng.shutdown()
    teng.shutdown()


def _call(url, method, path, body=None, headers=None):
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    try:
        data = None if body is None else json.dumps(body).encode()
        h = dict(headers or {})
        if data:
            h["content-type"] = "application/json"
        conn.request(method, path, body=data, headers=h)
        resp = conn.getresponse()
        raw = resp.read()
        try:
            return resp.status, json.loads(raw or b"{}")
        except ValueError:
            return resp.status, raw.decode(errors="replace")
    finally:
        conn.close()


def _class(status: int) -> str:
    if 200 <= status < 300:
        return "2xx"
    return "auth" if status in (401, 403) else "other"


def _credentials(url):
    """(label, headers) of every way to call ``url``'s server."""
    out = [("none", {}), ("bad", {"x-api-key": "nope"}),
           ("bad-bearer", {"authorization": "Bearer a.b.c"})]
    for key in KEYS:
        out.append((key, {"x-api-key": key}))
        out.append((f"{key}-bearer", {"authorization": f"Bearer {key}"}))
        st, body = _call(url, "POST", "/dashboard/api/login",
                         {"api_key": key})
        assert st == 200 and sorted(body["roles"]) == sorted(KEYS[key])
        out.append((f"{key}-token",
                    {"authorization": f"Bearer {body['token']}"}))
    return out


def _audits(records, logger):
    out = []
    for r in records:
        if r.name != logger:
            continue
        try:
            ev = json.loads(r.getMessage())
        except ValueError:
            continue
        if ev.get("component") == "audit":
            out.append((ev["event"], ev["path"], tuple(ev["roles"])))
    return out


@pytest.mark.parametrize("ep", API_CATALOG["endpoints"],
                         ids=lambda e: f"{e['method']} {e['path']}")
def test_status_class_equals_the_reference(servers, ep, caplog):
    path = ep["path"].replace("{id}", "x").replace("{file_id}", "f")
    body = BODIES.get(ep["path"], {"text": "a"}) \
        if ep["method"] in ("POST", "PATCH", "PUT") else None
    creds = {name: _credentials(url) for name, url in servers.items()}
    rows = {"jax": [], "port": []}
    with caplog.at_level(logging.INFO):
        for name, url in servers.items():
            for label, headers in creds[name]:
                if ep["path"] in PROFILER and not label.startswith(
                        ("none", "bad", "view")):
                    continue
                st, reply = _call(url, ep["method"], path, body, headers)
                rows[name].append((label, _class(st)))
        audits = {"jax": _audits(caplog.records, "semantic_router_tpu"),
                  "port": _audits(caplog.records,
                                  "semantic_router_tpu_torch")}
    assert rows["port"] == rows["jax"]
    assert audits["port"] == audits["jax"]
    if ep["method"] in ("PATCH", "PUT", "DELETE"):
        # every credential holding edit or admin is audited, by its roles
        assert {a[2] for a in audits["port"]} == {("edit",),
                                                  ("admin", "secret_view")}
    got = dict(rows["port"])
    assert got["none"] == got["bad"] == (
        "auth" if ep["path"] not in (
            "/health", "/ready", "/metrics", "/metrics/external",
            "/metrics/fleet",
            "/v1/models", "/startup-status", "/openapi.json", "/docs",
            "/v1/chat/completions", "/v1/messages", "/v1/responses",
            "/dashboard/api/login", "/dashboard/embedmap",
            "/dashboard/static/{asset}") else got["admin-key"])


def test_login_refuses_a_bad_key_and_keyless_entries(servers):
    for url in servers.values():
        assert _call(url, "POST", "/dashboard/api/login",
                     {"api_key": "nope"})[0] == 401
        assert _call(url, "POST", "/dashboard/api/login",
                     {"api_key": ""})[0] == 401
        assert _call(url, "GET", "/config/hash",
                     headers={"x-api-key": ""})[0] == 401
        # latin-1 bytes in a header compare as bytes, never raise
        assert _call(url, "GET", "/config/hash",
                     headers={"x-api-key": "kéy"})[0] == 401
