"""Upstream credentials: the port's ``CredentialResolver`` against the
JAX one over a grid of rules, users, groups and models (first match
wins, identity headers only when trusted, fail closed only with
``fail_open: false``), and both HTTP servers over one config: the
credential header reaches the backend on the plain forward, the stream
and each looper fan-out call (its own candidate's key), and a request
with no credential under ``fail_open: false`` gets the reference's 403
while the backend sees nothing."""

import copy
import http.client
import json
import urllib.parse

import pytest

from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.router.authz import CredentialResolver as JRes
from semantic_router_tpu.router.pipeline import Router as JRouter
from semantic_router_tpu.router.server import RouterServer as JServer
from semantic_router_tpu.runtime.registry import RuntimeRegistry as \
    JRegistry
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.router import MockVLLMServer, Router, \
    RouterServer
from semantic_router_tpu_torch.router.authz import CredentialResolver
from semantic_router_tpu_torch.runtime import RuntimeRegistry

RULES = [
    {"models": ["m-a"], "users": ["vip"], "api_key": "vip-key"},
    {"groups": ["premium"], "api_key": "basic dXNlcjpwYXNz"},
    {"models": ["m-b"], "api_key": "b-key", "header": "X-Api-Key"},
    {"models": ["m-c"], "api_key": ""},  # no key: dropped
    {"users": ["ops"], "groups": ["sre"], "api_key": "Bearer ops-key"},
]

CASES = [(model, user, groups)
         for model in ("m-a", "m-b", "m-c", "")
         for user, groups in (("", ()), ("vip", ()), ("ops", ()),
                              ("x", ("premium",)), ("x", ("sre", "dev")))]


def _outcome(resolver, model, user, groups):
    try:
        return resolver.headers_for(model, user, groups)
    except PermissionError as exc:
        return ("denied", str(exc))


@pytest.mark.parametrize("fail_open", [True, False])
@pytest.mark.parametrize("trust", [True, False])
def test_resolver_agrees_with_the_reference(fail_open, trust):
    cfg = {"credentials": copy.deepcopy(RULES), "fail_open": fail_open,
           "trust_identity_headers": trust}
    t, j = CredentialResolver.from_config(cfg), JRes.from_config(cfg)
    assert [(r.models, r.users, r.groups, r.header, r.api_key)
            for r in t.rules] == [(r.models, r.users, r.groups, r.header,
                                   r.api_key) for r in j.rules]
    for case in CASES:
        assert _outcome(t, *case) == _outcome(j, *case), case


@pytest.mark.parametrize("cfg", [None, {}, {"fail_open": False},
                                 {"credentials": [{"api_key": "k"}]}])
def test_degenerate_configs_agree(cfg):
    t, j = CredentialResolver.from_config(cfg), JRes.from_config(cfg)
    for case in CASES:
        assert _outcome(t, *case) == _outcome(j, *case)


# ---------------------------------------------------------------------------
# over HTTP, both servers


def _dec(name, kw, models, algorithm=None):
    d = {"name": name, "priority": 10,
         "rules": {"operator": "OR", "conditions": [
             {"type": "keyword", "name": kw}]},
         "modelRefs": [{"model": m} for m in models]}
    if algorithm:
        d["algorithm"] = algorithm
    return d


CONFIG = {
    "default_model": "m-open",
    "authz": {"fail_open": False, "trust_identity_headers": True,
              "credentials": [
                  {"models": ["m-a"], "users": ["vip"], "api_key": "a-vip"},
                  {"models": ["m-b"], "api_key": "b-all",
                   "header": "x-api-key"},
                  {"models": ["m-c"], "api_key": "c-all"}]},
    "routing": {
        "signals": {"keywords": [{"name": k, "keywords": [k]}
                                 for k in ("alpha", "beta", "panel")]},
        "decisions": [_dec("to_a", "alpha", ["m-a"]),
                      _dec("to_b", "beta", ["m-b"]),
                      _dec("panel", "panel", ["m-b", "m-c"],
                           {"type": "fusion"})]}}


class _Pair:
    def __init__(self, cfg):
        self.backend = {"jax": MockVLLMServer().start(),
                        "port": MockVLLMServer().start()}
        jreg = JRegistry.isolated()
        treg = RuntimeRegistry.isolated(runtimestats=None)
        jcfg = JRouterConfig.from_dict(copy.deepcopy(cfg))
        self.jrouter = JRouter(jcfg, metrics=jreg.metric_series(),
                               explain=jreg.get("explain"),
                               resilience=jreg.get("resilience"))
        self.trouter = Router(load_config(copy.deepcopy(cfg)),
                              metrics=treg.metric_series(),
                              explain=treg.explain,
                              resilience=treg.resilience)
        self.server = {
            "jax": JServer(self.jrouter, jcfg,
                           default_backend=self.backend["jax"].url,
                           registry=jreg).start(),
            "port": RouterServer(self.trouter, self.backend["port"].url,
                                 registry=treg).start()}

    def post(self, side, body, headers=None):
        u = urllib.parse.urlsplit(self.server[side].url)
        conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
        try:
            conn.request("POST", "/v1/chat/completions",
                         body=json.dumps(body).encode(),
                         headers={"content-type": "application/json",
                                  **(headers or {})})
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    def stop(self):
        for s in self.server.values():
            s.stop()
        for b in self.backend.values():
            b.stop()
        self.trouter.shutdown()


@pytest.fixture(scope="module")
def pair():
    p = _Pair(CONFIG)
    yield p
    p.stop()


def _creds(seen):
    """The credential headers of each call, in an order of their own
    (a looper's fan-out calls arrive in any order)."""
    return sorted(({k: v for k, v in h.items()
                    if k in ("authorization", "x-api-key")} for h in seen),
                  key=lambda h: json.dumps(h, sort_keys=True))


@pytest.mark.parametrize("text, headers, stream", [
    ("alpha please", {"x-authz-user-id": "vip"}, False),
    ("beta please", {}, False),
    ("beta please", {}, True),
    ("panel please", {}, False),
])
def test_credential_reaches_the_backend_on_both(pair, text, headers,
                                                stream):
    body = {"model": "auto", "stream": stream,
            "messages": [{"role": "user", "content": text}]}
    seen = {}
    for side in ("jax", "port"):
        before = len(pair.backend[side].headers_seen)
        status, _ = pair.post(side, copy.deepcopy(body), headers)
        assert status == 200
        seen[side] = _creds(pair.backend[side].headers_seen[before:])
    assert seen["port"] == seen["jax"]
    assert seen["port"] and all(seen["port"])


@pytest.mark.parametrize("text, headers", [
    ("alpha please", {"x-authz-user-id": "nobody"}),
    ("alpha please", {}),
    ("no keyword at all", {}),
])
def test_fail_closed_miss_is_403_and_forwards_nothing(pair, text, headers):
    body = {"model": "auto",
            "messages": [{"role": "user", "content": text}]}
    out = {}
    for side in ("jax", "port"):
        before = pair.backend[side].hits
        status, data = pair.post(side, copy.deepcopy(body), headers)
        out[side] = (status, json.loads(data))
        assert pair.backend[side].hits == before
    assert out["port"] == out["jax"]
    assert out["port"][0] == 403
    assert out["port"][1]["error"]["type"] == "authz_error"
