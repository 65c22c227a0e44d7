"""The config management API and the config editor's backend, on the
port's server against the JAX server on the same config file (a copy
each), on the CPU: ``GET /config/router`` (redacted without
``secret_view``), ``PATCH`` (an RFC 7396 merge into the on-disk
document: ``None`` deletes, env placeholders stay placeholders on disk),
``PUT``, ``/config/router/versions``, rollback and ``/config/hash``
answering the same JSON but for times and ids, the watcher reloading
what they wrote; concurrent PATCHes losing none; the editor's validate
(against an empty environment), deploy (the operator's text kept, its
comments and order) and raw (``secret_view``-gated); ``dsl/compile`` and
``dsl/decompile`` on the reference DSL tests' programs; and the port's
400 for a document it refuses, with nothing written."""

import copy
import http.client
import json
import os
import threading
import urllib.parse

import pytest
import yaml

from semantic_router_tpu.config import ConfigWatcher as JWatcher
from semantic_router_tpu.config import load_config as jload
from semantic_router_tpu.router.pipeline import Router as JRouter
from semantic_router_tpu.router.server import RouterServer as JServer
from semantic_router_tpu.runtime.bootstrap import \
    build_router as jbuild_router
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.router import Router, RouterServer
from semantic_router_tpu_torch.runtime import RuntimeRegistry, \
    attach_config_watcher
from test_dsl import PROGRAM

NOWHERE = "http://127.0.0.1:9"

CONFIG_TEXT = """\
# the management API's test config
default_model: m1
providers:
  openai:
    api_key: ${VSR_TEST_SECRET:-sk-default}
    base_url: http://upstream.invalid
semantic_cache:
  enabled: false
  similarity_threshold: 0.9
routing:
  modelCards:
    - {name: m1}
    - {name: m2}
  signals:
    keywords:
      - {name: urgent_kw, keywords: [urgent, asap]}
      - {name: code_kw, keywords: [python, rust]}
  decisions:
    - name: urgent_route
      priority: 200
      rules: {operator: OR, conditions: [{type: keyword, name: urgent_kw}]}
      modelRefs: [{model: m2}]
    - name: code_route
      priority: 100
      rules: {operator: OR, conditions: [{type: keyword, name: code_kw}]}
      modelRefs: [{model: m1}]
"""

KEYS = {"view-key": ["view"], "edit-key": ["edit"],
        "admin-key": ["admin", "secret_view"]}


def _call(url, method, path, body=None, key=""):
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    try:
        data = None if body is None else json.dumps(body).encode()
        headers = {"content-type": "application/json"} if data else {}
        if key:
            headers["x-api-key"] = key
        conn.request(method, path, body=data, headers=headers)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


class _Pair:
    """A JAX and a port server, each over its own copy of one config
    file, each with its package's watcher (driven by ``poll``)."""

    def __init__(self, root, text):
        self.paths, self.urls = {}, {}
        for name in ("jax", "port"):
            os.makedirs(os.path.join(root, name), exist_ok=True)
            self.paths[name] = os.path.join(root, name, "router.yaml")
            with open(self.paths[name], "w") as f:
                f.write(text)
        jcfg = jload(self.paths["jax"])
        self.jserver = JServer(JRouter(jcfg), jcfg,
                               config_path=self.paths["jax"]).start()

        def jswap(new_cfg):
            old = self.jserver.router
            self.jserver.router = jbuild_router(new_cfg, None,
                                                carry_from=old)
            self.jserver.cfg = new_cfg
            old.dispatcher.shutdown()

        self.jwatch = JWatcher(self.paths["jax"], jswap)
        self.registry = RuntimeRegistry.isolated()
        self.tserver = RouterServer(Router(load_config(self.paths["port"])),
                                    NOWHERE, registry=self.registry,
                                    config_path=self.paths["port"]).start()
        self.twatch = attach_config_watcher(
            self.tserver, self.paths["port"], None, self.registry,
            start=False)
        self.urls = {"jax": self.jserver.url, "port": self.tserver.url}

    def both(self, method, path, body=None, key=""):
        return {n: _call(u, method, path, copy.deepcopy(body), key)
                for n, u in self.urls.items()}

    def disk(self, name):
        with open(self.paths[name]) as f:
            return f.read()

    def poll(self):
        for name in self.paths:   # a newer mtime than the last load's
            st = os.stat(self.paths[name])
            os.utime(self.paths[name], (st.st_atime, st.st_mtime + 5))
        return self.jwatch.poll_once(), self.twatch.poll_once()

    def close(self):
        self.tserver.stop()
        self.tserver.router.shutdown()
        self.jserver.stop()
        self.jserver.router.shutdown()


@pytest.fixture
def pair(tmp_path, monkeypatch):
    monkeypatch.setenv("VSR_TEST_SECRET", "sk-live-123")
    p = _Pair(str(tmp_path), CONFIG_TEXT)
    yield p
    p.close()


@pytest.fixture
def keyed(tmp_path, monkeypatch):
    monkeypatch.setenv("VSR_TEST_SECRET", "sk-live-123")
    d = yaml.safe_load(CONFIG_TEXT)
    d["api_server"] = {"api_keys": [{"key": k, "roles": r}
                                    for k, r in KEYS.items()]}
    p = _Pair(str(tmp_path), yaml.safe_dump(d, sort_keys=False))
    yield p
    p.close()


def _same(got, drop=()):
    """Both servers' (status, body), with the ``drop`` keys set aside."""
    (js, jb), (ts, tb) = got["jax"], got["port"]
    strip = (lambda b: {k: v for k, v in b.items() if k not in drop}) \
        if isinstance(jb, dict) and isinstance(tb, dict) else (lambda b: b)
    assert ts == js, got
    assert strip(tb) == strip(jb), got
    return ts, tb


def test_get_config_redacted_hash_and_versions(pair):
    st, body = _same(pair.both("GET", "/config/router"))
    assert st == 200 and body["providers"]["openai"]["api_key"] == "***"
    st, body = _same(pair.both("GET", "/config/hash"))
    assert st == 200 and len(body["hash"]) == 16
    st, body = _same(pair.both("GET", "/config/router/versions"))
    assert st == 200 and body == {"versions": []}
    st, body = _same(pair.both("GET", "/dashboard/api/config"))
    assert body["decisions"] == ["urgent_route", "code_route"]


def test_get_config_unredacted_for_secret_view(keyed):
    for key, want in (("admin-key", "sk-live-123"), ("view-key", "***")):
        st, body = _same(keyed.both("GET", "/config/router", key=key))
        assert st == 200
        assert body["providers"]["openai"]["api_key"] == want


def test_patch_merges_on_disk_and_reloads(pair):
    patch = {"semantic_cache": None,
             "routing": {"strategy": "priority"},
             "observability": {"tracing": {"sample_rate": 0.25}}}
    st, body = _same(pair.both("PATCH", "/config/router", patch),
                     drop=("backup_version",))
    assert st == 200 and body["applied"] is True
    for name in ("jax", "port"):
        disk = yaml.safe_load(pair.disk(name))
        assert "semantic_cache" not in disk
        assert disk["observability"] == {"tracing": {"sample_rate": 0.25}}
        # the placeholder, never the resolved secret, is written
        assert disk["providers"]["openai"]["api_key"] == \
            "${VSR_TEST_SECRET:-sk-default}"
    assert pair.disk("port") == pair.disk("jax")
    assert pair.poll() == (True, True)
    st, body = _same(pair.both("GET", "/config/router"))
    assert "semantic_cache" not in body
    assert body["observability"]["tracing"]["sample_rate"] == 0.25
    _same(pair.both("GET", "/config/hash"))
    st, body = _same(pair.both("GET", "/config/router/versions"),
                     drop=("versions",))
    jv, tv = (pair.both("GET", "/config/router/versions")[n][1]["versions"]
              for n in ("jax", "port"))
    assert [v["hash"] for v in tv] == [v["hash"] for v in jv]
    assert len(tv) == 1


def test_put_then_rollback(pair):
    doc = yaml.safe_load(CONFIG_TEXT)
    doc["routing"]["decisions"][0]["name"] = "renamed_route"
    st, _ = _same(pair.both("PUT", "/config/router", doc),
                  drop=("backup_version",))
    assert st == 200
    assert pair.poll() == (True, True)
    st, body = _same(pair.both("GET", "/dashboard/api/config"),
                     drop=("config",))
    assert body["decisions"][0] == "renamed_route"
    versions = {n: r[1]["versions"] for n, r in
                pair.both("GET", "/config/router/versions").items()}
    for name, url in pair.urls.items():
        st, body = _call(url, "POST", "/config/router/rollback",
                         {"version": versions[name][0]["id"]})
        assert st == 200
        assert body == {"rolled_back_to": versions[name][0]["id"]}
    assert pair.disk("port") == pair.disk("jax") == CONFIG_TEXT
    assert pair.poll() == (True, True)
    st, body = _same(pair.both("GET", "/dashboard/api/config"),
                     drop=("config",))
    assert body["decisions"][0] == "urgent_route"
    _same(pair.both("POST", "/config/router/rollback",
                    {"version": "19700101T000000-000"}))
    _same(pair.both("POST", "/config/router/rollback",
                    {"version": "../../etc/passwd"}))
    st, _ = _same(pair.both("PUT", "/config/router", ["not", "a", "map"]))
    assert st == 400


def test_invalid_document_is_refused_by_both(pair):
    doc = yaml.safe_load(CONFIG_TEXT)
    doc["routing"]["decisions"][0]["modelRefs"] = [{"model": "ghost"}]
    st, body = _same(pair.both("PUT", "/config/router", doc))
    assert st == 400 and "ghost" in json.dumps(body)
    assert pair.disk("port") == CONFIG_TEXT


def test_concurrent_patches_lose_none(pair):
    def patch(url, i):
        st, _ = _call(url, "PATCH", "/config/router",
                      {"tags": {f"t{i}": i}})
        assert st == 200

    for url in pair.urls.values():
        threads = [threading.Thread(target=patch, args=(url, i))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for name in ("jax", "port"):
        assert yaml.safe_load(pair.disk(name))["tags"] == \
            {f"t{i}": i for i in range(8)}
    jv, tv = (pair.both("GET", "/config/router/versions")[n][1]["versions"]
              for n in ("jax", "port"))
    assert len(tv) == len(jv) == 8


def test_editor_validate_against_an_empty_environment(pair, monkeypatch):
    monkeypatch.setenv("VSR_TEST_MODEL", "secret-model-name")
    text = CONFIG_TEXT.replace("{name: m2}",
                               "{name: \"${VSR_TEST_MODEL:-m2}\"}")
    st, body = _same(pair.both("POST", "/dashboard/api/config/validate",
                               {"yaml": text}))
    assert st == 200 and body["ok"] is True
    assert body["models"] == ["m1", "m2"]
    for bad in ("a: [unclosed", "- a list", CONFIG_TEXT.replace(
            "model: m2", "model: ghost")):
        st, body = _same(pair.both("POST", "/dashboard/api/config/validate",
                                   {"yaml": bad}))
        assert st == 200 and body["ok"] is False


def test_editor_deploy_keeps_the_text_and_raw_is_gated(keyed):
    text = CONFIG_TEXT.replace("# the management API's test config",
                               "# deployed from the editor\n# keep me") \
        + "api_server:\n  api_keys:\n" + "".join(
            f"    - {{key: {k}, roles: {r}}}\n" for k, r in KEYS.items())
    st, _ = _same(keyed.both("POST", "/dashboard/api/config/deploy",
                             {"yaml": text}, key="edit-key"),
                  drop=("backup_version",))
    assert st == 200
    assert keyed.disk("port") == keyed.disk("jax") == text
    for key in ("", "bad-key", "view-key", "edit-key", "admin-key"):
        got = keyed.both("GET", "/dashboard/api/config/raw", key=key)
        st, body = _same(got, drop=("path", "versions"))
        assert st == {"": 401, "bad-key": 401, "view-key": 403,
                      "edit-key": 403, "admin-key": 200}[key]
        if st == 200:
            assert body["yaml"] == text
            assert len(got["port"][1]["versions"]) == 1
    st, _ = _same(keyed.both("POST", "/dashboard/api/config/deploy",
                             {"yaml": "a: [unclosed"}, key="admin-key"))
    assert st == 400


BAD_PROGRAMS = [
    'signal domain business\ndecision d priority 1 {\n'
    '    when domain(nonexistent)\n    route to "m1"\n'
    '    algorithm static\n}\nmodel "m1"\n',
    'signal wibble x\n',
    'model "a"\nmodel "b"\ndecision }',
    'model "m1"\ndecision d { route to "m1"\n algorithm static }',
]


@pytest.mark.parametrize("program", [PROGRAM] + BAD_PROGRAMS)
def test_dsl_compile(pair, program):
    st, body = _same(pair.both("POST", "/dashboard/api/dsl/compile",
                               {"dsl": program}))
    assert st == (200 if program is PROGRAM else 422)
    if st == 200:
        assert body["decisions"] == ["cs_route", "urgent_route"]
        assert yaml.safe_load(body["yaml"])["default_model"] == "qwen3-8b"
    st, _ = _same(pair.both("POST", "/dashboard/api/dsl/compile",
                            {"dsl": program, "skip_validate": True}))


def test_dsl_decompile(pair, fixture_config_path):
    with open(fixture_config_path) as f:
        fixture = yaml.safe_load(f)
    for config in (fixture, yaml.safe_load(CONFIG_TEXT), {}):
        st, body = _same(pair.both("POST", "/dashboard/api/dsl/decompile",
                                   {"config": config}))
        assert st == 200 and body["ok"]
    st, body = _same(pair.both("POST", "/dashboard/api/dsl/compile",
                               {"dsl": body["dsl"]}))


def test_a_refused_document_is_answered_400_and_not_written(pair):
    doc = yaml.safe_load(CONFIG_TEXT)
    # the engine mesh: an option the port still refuses (the routing
    # flywheel and then MCP classifiers, once the refused option here,
    # are served now)
    doc.setdefault("engine", {})["mesh_shape"] = {"data": 1}
    for method in ("PUT", "PATCH"):
        body = doc if method == "PUT" else {"engine": {
            "mesh_shape": {"data": 1}}}
        st, reply = _call(pair.urls["port"], method, "/config/router", body)
        assert st == 400 and "the engine mesh" in reply["error"]["message"]
        # the JAX server serves the engine mesh: it takes the document
        assert _call(pair.urls["jax"], method, "/config/router",
                     body)[0] == 200
    st, reply = _call(pair.urls["port"], "POST",
                      "/dashboard/api/config/deploy",
                      {"yaml": yaml.safe_dump(doc)})
    assert st == 400 and "the engine mesh" in reply["error"]["message"]
    assert pair.disk("port") == CONFIG_TEXT
    assert _call(pair.urls["port"], "GET",
                 "/config/router/versions")[1] == {"versions": []}
    st, reply = _call(pair.urls["port"], "POST",
                      "/dashboard/api/config/validate",
                      {"yaml": yaml.safe_dump(doc)})
    assert st == 200 and reply["ok"] is False
    assert "the engine mesh" in reply["errors"][0]
