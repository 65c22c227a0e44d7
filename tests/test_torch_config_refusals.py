"""The port's loader against the JAX loader on the options the port does
not serve: each one the JAX router acts on is loaded by the JAX loader and
refused by the port's, the key named in the message, and loads on both
when off; the options a later slice ported (the cascade, the rate limit,
skip-processing, prompt compression, recipes and entrypoints, the
in-memory Responses store) load on both and parse to the same block; a
canonical ``global:`` block lifts to the same fields on both; a
``stream: true`` request whose backend cannot answer gets the
reference's error body, and a looper decision is routed as the
reference routes it, executed over a live backend and refused (502,
``looper_error``) when none of its models answers, as the reference's
server does; a checkpoint of an architecture the port does not serve
(Gemma3, a SigLIP checkpoint under a classifier kind) is refused by
name, and a DeBERTa-v2/v3 classifier and a SigLIP ``kind: multimodal``
checkpoint load; an enabled ``image_generation`` plugin and a ``rag``
one load.
The resilience plane (the degradation ladder, the upstream health
plane, local SLO objectives) loads and parses as the reference's.  The
shared state plane (``stateplane``), its fleet-shared ladder
(``stateplane.share.fleet``), the fleet-shared open circuits and retry
budget, the RESP-backed Responses and workflow stores, and the retrieval
plane (the ANN plane on one device, the vector stores, the ``rag``
plugin, a qdrant / milvus memory store) load and parse as the
reference's too, as do router replay (every store the reference
builds), OTLP span and log export, trained selector artifacts, router
learning (``learning``) and the routing flywheel (``flywheel``, its
``cost_bandit`` artifact as a decision's ``algorithm.artifact``
included), and the MCP classifiers (``mcp``), the external models
(``external_models``), the fleet observability plane
(``observability.fleet``), fleet-scoped objectives, a durable decision
backend other than SQLite and an unknown ``response_store`` backend;
beside each stays a refused option (the serving mesh, the ANN bank's row
sharding).  Sequence packing (``engine.packing``, its autotune block
included) loads and parses as the reference's; the serving mesh
(``engine.mesh``, ``engine.mesh_shape``) stays refused."""

import copy
import http.client
import json
import urllib.parse

import pytest
import torch

from semantic_router_tpu.config import RouterConfig as JRouterConfig
from semantic_router_tpu.router.pipeline import Router as JRouter
from semantic_router_tpu_torch.config import load_config
from semantic_router_tpu_torch.router import MockVLLMServer, Router, \
    RouterServer
from semantic_router_tpu_torch.runtime import build_engine

DEC = {"name": "d", "priority": 1,
       "rules": {"operator": "OR",
                 "conditions": [{"type": "keyword", "name": "k"}]},
       "modelRefs": [{"model": "m"}]}

# ported key → (the config that enables it, the same block off)
PORTED = {
    "engine.cascade": ({"engine": {"cascade": {"enabled": True}}},
                       {"engine": {"cascade": {"enabled": False}}}),
    "ratelimit": ({"ratelimit": {"requests_per_minute": 60}},
                  {"ratelimit": {}}),
    "skip_processing": ({"skip_processing": {"enabled": True}},
                        {"skip_processing": {"enabled": False}}),
    "prompt_compression": ({"prompt_compression": {"enabled": True}},
                           {"prompt_compression": {"enabled": False}}),
    "recipes": ({"recipes": [{"name": "fast", "decisions": [DEC]}]},
                {"recipes": []}),
    "entrypoints": ({"entrypoints": [{"name": "auto", "recipe": "fast"}]},
                    {"entrypoints": []}),
    "resilience.enabled": (
        {"resilience": {"enabled": True, "interval_s": 0.5,
                        "max_level": 3, "brownout_class": "high",
                        "admission": {"reject_class": "normal"},
                        "priority": {"model_classes": {"m": "low"}}}},
        {"resilience": {"enabled": False}}),
    "resilience.upstream.enabled": (
        {"resilience": {"upstream": {
            "enabled": True, "breaker": {"failures": 3, "open_s": 2},
            "retry": {"on": "connect", "max_attempts": "4"},
            "deadline": {"default_s": 5}}}},
        {"resilience": {"upstream": {"enabled": False}}}),
    "response_store": ({"response_store": {"enabled": True,
                                           "backend": "memory",
                                           "max_entries": 8}},
                       {"response_store": {"enabled": False}}),
    # the state plane and the RESP-backed stores (served since they were
    # refused; SERVED_SINCE below names what stays refused beside each)
    "stateplane": ({"stateplane": {"enabled": True, "backend": "memory"}},
                   {"stateplane": {"enabled": False, "backend": "memory"}}),
    "stateplane.share.fleet": (
        {"stateplane": {"enabled": True, "share": {"fleet": True}}},
        {"stateplane": {"enabled": False, "share": {"fleet": True}}}),
    "resilience.upstream.fleet_share": (
        {"stateplane": {"enabled": True},
         "resilience": {"upstream": {"enabled": True}}},
        {"stateplane": {"enabled": False},
         "resilience": {"upstream": {"enabled": True}}}),
    "response_store.backend": ({"response_store": {"backend": "redis",
                                                   "host": "r"}},
                               {"response_store": {"backend": "memory"}}),
    "looper.workflow_state.backend": (
        {"looper": {"workflow_state": {"backend": "valkey"}}},
        {"looper": {"workflow_state": {"backend": "memory",
                                       "ttl_seconds": 60}}}),
    # a global: block is lifted before the refusals run
    "resilience": ({"global": {"resilience": {"enabled": True},
                               "stateplane": {"enabled": True,
                                              "share": {"fleet": True}}}},
                   {"global": {"resilience": {"enabled": True}}}),
    "observability.slo.objectives": (
        {"observability": {"slo": {"evaluation_interval_s": 0.25,
                                   "objectives": [
            "routing_latency p99 < 20ms over 1s",
            {"name": "errs", "objective": "signal error-rate < 1% over 5m",
             "scope": "local"}]}}},
        {"observability": {"slo": {"objectives": []}}}),
}

# refused key → (the config that enables it, the same block off)
REFUSED = {
    "engine.mesh": ({"engine": {"mesh": {"enabled": True, "dp": 1,
                                         "tp": 1}}},
                    {"engine": {"mesh": {"enabled": False}}}),
    "engine.mesh_shape": ({"engine": {"mesh_shape": {"data": 1}}},
                          {"engine": {"mesh_shape": {}}}),
}
# the other signal sources, the fleet observability plane, fleet-scoped
# objectives, a durable decision backend other than SQLite (the state
# plane's mirror, as the reference reads it) and an unknown Responses
# store backend (in memory, as the reference builds it): served since
# they were refused; SERVED_SINCE pairs each with a mesh knob
PORTED["mcp"] = (
    {"mcp": {"classifiers": [{"name": "x", "transport": "stdio"}]}},
    {"mcp": {}})
PORTED["external_models"] = (
    {"external_models": [{"name": "x", "role": "guard"}]},
    {"external_models": []})
PORTED["observability.slo"] = (
    {"observability": {"slo": {"enabled": True, "objectives": [
        {"objective": "routing_latency p99 < 25ms over 5m",
         "scope": "fleet"}]}}},
    {"observability": {"slo": {"enabled": True, "objectives": [
        {"objective": "routing_latency p99 < 25ms over 5m",
         "scope": "local"}]}}})
PORTED["observability.fleet.enabled"] = (
    {"observability": {"fleet": {"enabled": True, "cache_s": 0.5}}},
    {"observability": {"fleet": {"enabled": False}}})
PORTED["observability.decisions.durable.backend"] = (
    {"observability": {"decisions": {"durable": {
        "backend": "stateplane"}}}},
    {"observability": {"decisions": {"durable": {
        "backend": "sqlite", "path": ""}}}})
PORTED["response_store.backend.unknown"] = (
    {"response_store": {"backend": "dynamo", "max_entries": 8}},
    {"response_store": {"backend": "memory"}})
# options the port once refused and serves now, each beside the option of
# the same refusal that stays refused (and a config enabling that one)
PORTED["image_generation"] = (
    {"routing": {"decisions": [dict(DEC, plugins=[
        {"type": "image_generation",
         "configuration": {"backend": "mock"}}])]}},
    {"routing": {"decisions": [dict(DEC, plugins=[
        {"type": "image_generation",
         "configuration": {"enabled": False, "backend": "mock"}}])]}})
# sequence packing: served since it was refused (on by default, as the
# reference's); the serving mesh stays refused
PORTED["engine.packing"] = (
    {"engine": {"packing": {"enabled": True, "max_segments_per_row": 4,
                            "starvation_steps": 7,
                            "autotune": {"enabled": False}}}},
    {"engine": {"packing": {"enabled": False}}})
PORTED["engine.packing.autotune"] = (
    {"engine": {"packing": {"autotune": {"interval_s": 5,
                                         "target_fill": 0.7}}}},
    {"engine": {"packing": {"autotune": {"enabled": False}}}})
# the retrieval plane: served since it was refused
PORTED["ann"] = ({"ann": {"enabled": True, "quant": "int8", "top_k": 4,
                          "batch": {"enabled": True}}},
                 {"ann": {"enabled": False}})
PORTED["vectorstore"] = ({"vectorstore": {"enabled": True,
                                          "backend": "ann"}},
                         {"vectorstore": {"enabled": False}})
PORTED["rag"] = (
    {"routing": {"decisions": [dict(DEC, plugins=[
        {"type": "rag", "configuration": {"store": "kb", "top_k": 3}}])]}},
    {"routing": {"decisions": [dict(DEC, plugins=[
        {"type": "rag", "configuration": {"enabled": False}}])]}})
PORTED["memory.backend"] = ({"memory": {"backend": "milvus",
                                        "base_url": "http://m:19530"}},
                            {"memory": {"backend": ""}})
PORTED["vectorstore.backend"] = (
    {"vectorstore": {"backend": "llamastack", "backend_config": {
        "url": "http://ls:8321", "search_type": "hybrid"}}},
    {"vectorstore": {"backend": "memory"}})
PORTED["vectorstore.registry"] = (
    {"vectorstore": {"backend": "sqlite", "path": "/tmp/vs", "registry": {
        "backend": "postgres", "host": "pg", "port": 5433,
        "user": "router", "database": "vsr", "password": "pw"}}},
    {"vectorstore": {"registry": {"backend": ""}}})
# the management API's keys: served since the config API and its access
# gate were ported
PORTED["api_server.api_keys"] = (
    {"api_server": {"api_keys": [{"key": "k1", "roles": ["view"]},
                                 {"roles": ["admin"]}]}},
    {"api_server": {"api_keys": []}})
# router replay, OTLP export and selector artifacts: served since they
# were refused
PORTED["router_replay"] = (
    {"router_replay": {"enabled": True, "backend": "sqlite",
                       "path": "/tmp/replay.db", "max_records": 50}},
    {"router_replay": {"enabled": False}})
PORTED["observability.tracing.otlp_endpoint"] = (
    {"observability": {"tracing": {
        "otlp_endpoint": "http://collector:4318", "sample_rate": 0.5}}},
    {"observability": {"tracing": {"sample_rate": 0.5}}})
PORTED["learning"] = (
    {"routing": {"learning": {
        "enabled": True, "store": {"backend": "sqlite", "path": "l.db"},
        "adaptation": {"candidate_set": "tier", "mode": "observe"},
        "protection": {"enabled": True, "scope": "session",
                       "tuning": {"min_turns_before_switch": 3}}}}},
    {"routing": {"learning": {"enabled": False}}})
PORTED["algorithm.artifact"] = (
    {"routing": {"decisions": [dict(
        DEC, modelRefs=[{"model": "m"}, {"model": "n"}],
        algorithm={"type": "knn", "artifact": "sel.json"})]}},
    {"routing": {"decisions": [dict(DEC, algorithm={"type": "knn"})]}})
# the routing flywheel and its cost_bandit policy as a decision's
# artifact: served since they were refused
PORTED["flywheel"] = (
    {"flywheel": {"enabled": True, "cycle_interval_s": 30,
                  "trainer": {"algorithms": ["cost_bandit", "mlp"]},
                  "evaluator": {"min_rows": "nope"},
                  "promotion": {"mode": "auto", "canary_fraction": 0.25}}},
    {"flywheel": {"enabled": False}})
PORTED["algorithm.artifact.cost_bandit"] = (
    {"routing": {"decisions": [dict(
        DEC, modelRefs=[{"model": "m"}, {"model": "n"}],
        algorithm={"type": "cost_bandit", "artifact": "bandit.json"})]}},
    {"routing": {"decisions": [dict(DEC, algorithm={"type": "static"})]}})
# the file of a cost_bandit artifact (written per test) and the serving
# mesh's refusals
BANDIT = "<cost_bandit artifact>"
MESH, MESH_SHAPE = r"engine\.mesh", r"engine\.mesh_shape"
SERVED_SINCE = {
    "engine.packing": (r"engine\.mesh", {
        "engine": {"packing": {"enabled": True},
                   "mesh": {"enabled": True, "dp": 1, "tp": 1}}}),
    "engine.packing.autotune": (r"engine\.mesh_shape", {
        "engine": {"packing": {"autotune": {"enabled": True}},
                   "mesh_shape": {"data": 1}}}),
    "image_generation": (
        MESH_SHAPE, {"routing": {"decisions": [dict(
            DEC, algorithm={"type": "mlp", "artifact": BANDIT},
            plugins=[{"type": "image_generation",
                      "configuration": {"backend": "mock"}}])]},
            "external_models": [{"name": "x", "role": "guard"}],
            "engine": {"mesh_shape": {"data": 1}}}),
    # the plane and the ANN plane over it are served; the bank's row
    # sharding is not
    "stateplane": (r"ann\.mesh", {"stateplane": {"enabled": True},
                                  "ann": {"enabled": True,
                                          "mesh": {"enabled": True}}}),
    "ann": (r"ann\.mesh", {"ann": {"enabled": True,
                                   "mesh": {"enabled": True, "dp": 2}}}),
    "vectorstore": (r"ann\.mesh", {
        "vectorstore": {"backend": "llamastack"},
        "ann": {"enabled": True, "mesh": {"enabled": True}}}),
    "rag": (MESH_SHAPE, {
        "routing": {"decisions": [dict(
            DEC, algorithm={"type": "mlp", "artifact": BANDIT},
            plugins=[{"type": "rag", "configuration": {"store": "kb"}}])]},
        "vectorstore": {"registry": {"backend": "postgres"}},
        "mcp": {"enabled": True},
        "engine": {"mesh_shape": {"data": 1}}}),
    # the Llama-Stack store and the Postgres registry, and the state
    # plane's durable decision store beside them: served since they were
    # refused; the serving mesh is not
    "vectorstore.backend": (MESH, {
        "vectorstore": {"backend": "llamastack"},
        "observability": {"decisions": {"durable": {
            "backend": "stateplane"}}},
        "engine": {"mesh": {"enabled": True, "dp": 1, "tp": 1}}}),
    "vectorstore.registry": (MESH, {
        "vectorstore": {"registry": {"backend": "postgres"}},
        "observability": {"decisions": {"durable": {
            "backend": "stateplane"}}},
        "engine": {"mesh": {"enabled": True}}}),
    "memory.backend": (r"ann\.mesh", {
        "memory": {"backend": "qdrant"},
        "routing": {"decisions": [dict(
            DEC, algorithm={"type": "knn", "artifact": BANDIT})]},
        "observability": {"fleet": {"enabled": True}},
        "ann": {"enabled": True, "mesh": {"enabled": True}}}),
    # the fleet-shared ladder and the fleet observability plane
    # (federated metrics, fleet-scoped objectives) are served; the
    # serving mesh is not
    "stateplane.share.fleet": (
        MESH_SHAPE, {
            "stateplane": {"enabled": True, "share": {"fleet": True}},
            "observability": {"fleet": {"enabled": True}},
            "engine": {"mesh_shape": {"data": 1}}}),
    "resilience.upstream.fleet_share": (
        MESH, {
            "stateplane": {"enabled": True},
            "resilience": {"upstream": {"enabled": True}},
            "observability": {"slo": {"objectives": [
                {"objective": "routing_latency p99 < 25ms over 5m",
                 "scope": "fleet"}]}},
            "engine": {"mesh": {"enabled": True}}}),
    # the RESP stores, the vector stores (the Llama-Stack store and the
    # Postgres registry included), the fleet observability plane and the
    # state plane's durable decision store are served; the ANN bank's row
    # sharding and the serving mesh are not
    "response_store.backend": (
        r"ann\.mesh", {
            "response_store": {"backend": "redis"},
            "vectorstore": {"backend": "llamastack"},
            "observability": {"fleet": {"enabled": True}},
            "ann": {"enabled": True, "mesh": {"enabled": True}}}),
    "looper.workflow_state.backend": (
        MESH_SHAPE, {
            "looper": {"workflow_state": {"backend": "redis"}},
            "memory": {"backend": "milvus"},
            "vectorstore": {"registry": {"backend": "postgres"}},
            "observability": {"decisions": {"durable": {
                "backend": "stateplane"}}},
            "engine": {"mesh_shape": {"data": 1}}}),
    # router replay (on by default, every store the reference builds),
    # OTLP span and log export and the plane's durable decision store:
    # served since they were refused; the serving mesh is not
    "router_replay": (MESH, {
        "router_replay": {"enabled": True, "backend": "postgres"},
        "observability": {"decisions": {"durable": {
            "backend": "stateplane"}}},
        "engine": {"mesh": {"enabled": True}}}),
    "observability.tracing.otlp_endpoint": (
        MESH_SHAPE, {"observability": {
            "tracing": {"otlp_endpoint": "http://collector:4318"},
            "fleet": {"enabled": True}},
            "engine": {"mesh_shape": {"data": 1}}}),
    # router learning, the routing flywheel and MCP classifiers beside
    # them are served; the serving mesh is not
    "learning": (MESH, {"learning": {"enabled": True},
                        "flywheel": {"enabled": True},
                        "mcp": {"enabled": True},
                        "engine": {"mesh": {"enabled": True}}}),
    "flywheel": (MESH_SHAPE, {"flywheel": {"enabled": True},
                              "mcp": {"enabled": True},
                              "engine": {"mesh_shape": {"data": 1}}}),
    # trained selector artifacts (the flywheel's cost_bandit policy
    # included) and external models are served; the mesh is not
    "algorithm.artifact": (MESH, {
        "routing": {"decisions": [dict(
            DEC, algorithm={"type": "knn", "artifact": BANDIT})]},
        "external_models": [{"name": "x", "role": "guard"}],
        "engine": {"mesh": {"enabled": True}}}),
    "algorithm.artifact.cost_bandit": (MESH_SHAPE, {
        "routing": {"decisions": [dict(
            DEC, modelRefs=[{"model": "m"}, {"model": "n"}],
            algorithm={"type": "cost_bandit", "artifact": BANDIT})]},
        "external_models": [{"name": "x", "role": "guard"}],
        "engine": {"mesh_shape": {"data": 1}}}),
    "resilience": (
        MESH, {"global": {
            "resilience": {"enabled": True},
            "stateplane": {"enabled": True, "share": {"fleet": True}},
            "observability": {"fleet": {"enabled": True}},
            "engine": {"mesh": {"enabled": True, "dp": 1, "tp": 1}}}}),
    # the options this slice serves, each beside a mesh knob
    "mcp": (MESH_SHAPE, {
        "mcp": {"classifiers": [{"name": "x", "url": "http://m:1"}]},
        "engine": {"mesh_shape": {"data": 1}}}),
    "external_models": (MESH, {
        "external_models": [{"role": "guardrail",
                             "base_url": "http://g:1"}],
        "engine": {"mesh": {"enabled": True}}}),
    "observability.slo": (r"ann\.mesh", {
        "observability": {"slo": {"objectives": [
            {"objective": "routing_latency p99 < 25ms over 5m",
             "scope": "fleet"}]}},
        "ann": {"enabled": True, "mesh": {"enabled": True}}}),
    "observability.fleet.enabled": (MESH_SHAPE, {
        "stateplane": {"enabled": True},
        "observability": {"fleet": {"enabled": True}},
        "engine": {"mesh_shape": {"data": 1}}}),
    "observability.decisions.durable.backend": (MESH, {
        "observability": {"decisions": {"durable": {
            "backend": "stateplane"}}},
        "engine": {"mesh": {"enabled": True}}}),
    "response_store.backend.unknown": (r"ann\.mesh", {
        "response_store": {"backend": "dynamo"},
        "ann": {"enabled": True, "mesh": {"enabled": True, "dp": 2}}}),
}


def _with_bandit(doc, path):
    """``doc`` with ``BANDIT`` replaced by ``path``."""
    return json.loads(json.dumps(doc).replace(json.dumps(BANDIT),
                                              json.dumps(path)))


@pytest.fixture
def cost_bandit(tmp_path):
    """The path of a cost_bandit artifact the JAX flywheel's policy
    writes."""
    from semantic_router_tpu.flywheel.policy import CostAwareBanditSelector

    path = str(tmp_path / "bandit.json")
    with open(path, "w") as f:
        f.write(CostAwareBanditSelector().to_json())
    return path


@pytest.mark.parametrize("key", sorted({**REFUSED, **SERVED_SINCE}))
def test_refused_at_load(key, cost_bandit):
    if key in SERVED_SINCE:
        # served since: the config loads and parses as the reference's;
        # its sibling option stays refused
        on, _ = PORTED[key]
        assert _parsed(load_config(copy.deepcopy(on)), key) == _parsed(
            JRouterConfig.from_dict(copy.deepcopy(on)), key)
        still, twin = SERVED_SINCE[key]
        twin = _with_bandit(twin, cost_bandit)
        JRouterConfig.from_dict(copy.deepcopy(twin))
        with pytest.raises(ValueError, match=still):
            load_config(copy.deepcopy(twin))
        return
    on, _ = REFUSED[key]
    JRouterConfig.from_dict(copy.deepcopy(on))  # the reference serves it
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        load_config(copy.deepcopy(on))


@pytest.mark.parametrize("key", sorted({**REFUSED, **PORTED}))
def test_off_loads_on_both(key):
    _, off = {**REFUSED, **PORTED}[key]
    JRouterConfig.from_dict(copy.deepcopy(off))
    load_config(copy.deepcopy(off))


def _parsed(cfg, key):
    """The block ``key`` parses to, as plain data."""
    if key == "engine.cascade":
        return cfg.engine.cascade, cfg.engine.cascade_config()
    if key in ("engine.packing", "engine.packing.autotune"):
        return cfg.engine.packing, cfg.engine.packing_config()
    if key == "recipes":
        return [(r.name, r.description, r.strategy,
                 [(d.name, d.priority, [m.model for m in d.model_refs])
                  for d in r.decisions]) for r in cfg.recipes]
    if key == "entrypoints":
        return [(e.model_names, e.recipe) for e in cfg.entrypoints]
    if key == "resilience.enabled":
        return cfg.resilience_config()
    if key == "resilience.upstream.enabled":
        return cfg.upstream_config()
    if key == "observability.slo.objectives":
        return cfg.slo_config()
    if key == "image_generation":
        return [(d.name, [(p.type, p.configuration, p.enabled)
                          for p in d.plugins]) for d in cfg.decisions]
    if key in ("stateplane", "stateplane.share.fleet"):
        return cfg.stateplane_config()
    if key == "resilience.upstream.fleet_share":
        return cfg.stateplane_config(), cfg.upstream_config()
    if key == "resilience":
        return cfg.stateplane_config(), cfg.resilience_config()
    if key in ("response_store.backend", "response_store.backend.unknown"):
        return cfg.response_store
    if key == "observability.slo":
        return cfg.slo_config()
    if key == "observability.fleet.enabled":
        return cfg.fleet_obs_config()
    if key == "observability.decisions.durable.backend":
        return cfg.decision_explain_config()
    if key == "looper.workflow_state.backend":
        return cfg.looper
    if key == "ann":
        return cfg.ann_config()
    if key == "rag":
        return [(d.name, [(p.type, p.configuration, p.enabled)
                          for p in d.plugins]) for d in cfg.decisions]
    if key == "memory.backend":
        return cfg.memory
    if key in ("vectorstore.backend", "vectorstore.registry"):
        return cfg.vectorstore
    if key == "api_server.api_keys":
        return cfg.api_server
    if key == "observability.tracing.otlp_endpoint":
        return cfg.tracing_config()
    if key in ("algorithm.artifact", "algorithm.artifact.cost_bandit"):
        return [(d.name, d.algorithm) for d in cfg.decisions]
    if key == "flywheel":
        return cfg.flywheel_config()
    return getattr(cfg, key)


@pytest.mark.parametrize("key", sorted(PORTED))
def test_ported_option_loads_like_the_reference(key):
    on, _ = PORTED[key]
    j = JRouterConfig.from_dict(copy.deepcopy(on))
    t = load_config(copy.deepcopy(on))
    assert _parsed(t, key) == _parsed(j, key)
    assert _parsed(t, key)  # the enabled block is not parsed away


GLOBAL = {
    "global": {
        "default_model": "global-model",
        "engine": {"max_batch_size": 12, "max_wait_ms": 3.0,
                   "seq_len_buckets": [64, 256],
                   "kernels": {"epilogue": {"enabled": True}},
                   "quant": {"mode": "bf16"}},
        "semantic_cache": {"enabled": True, "similarity_threshold": 0.9,
                           "max_entries": 77},
        "observability": {"tracing": {"sample_rate": 0.25},
                          "decisions": {"ring_size": 9}},
        "memory": {"backend": "sqlite", "path": "m.db"},
    },
    # explicit top-level keys win over the global block's
    "semantic_cache": {"enabled": False, "max_entries": 5},
    "routing": {"decisions": [DEC], "modelCards": [{"name": "m"}]},
}


def test_global_block_lifts_like_the_reference():
    j = JRouterConfig.from_dict(copy.deepcopy(GLOBAL))
    t = load_config(copy.deepcopy(GLOBAL))
    assert t.default_model == j.default_model == "global-model"
    for f in ("max_batch_size", "max_wait_ms", "seq_len_buckets", "kernels",
              "quant"):
        assert getattr(t.engine, f) == getattr(j.engine, f), f
    for f in ("enabled", "similarity_threshold", "max_entries"):
        assert getattr(t.semantic_cache, f) \
            == getattr(j.semantic_cache, f), f
    assert t.semantic_cache.max_entries == 5
    assert t.tracing_sample_rate() == j.tracing_sample_rate() == 0.25
    assert t.decision_explain_config() == j.decision_explain_config()
    assert t.memory == j.memory
    assert [d.name for d in t.decisions] == [d.name for d in j.decisions]


@pytest.mark.parametrize("knob, value, want", [
    ("tracing.sample_rate", "often", 0.1),
    ("runtime_stats.interval_s", "soon", 10.0),
    ("decisions.ring_size", "big", 512),
])
def test_malformed_telemetry_falls_back_like_the_reference(knob, value,
                                                           want):
    block, key = knob.split(".")
    d = {"observability": {block: {key: value}}}
    j = JRouterConfig.from_dict(copy.deepcopy(d))
    t = load_config(copy.deepcopy(d))
    read = {"tracing": lambda c: c.tracing_sample_rate(),
            "runtime_stats": lambda c: c.runtime_stats_config()["interval_s"],
            "decisions": lambda c: c.decision_explain_config()["ring_size"]}
    assert read[block](t) == read[block](j) == want
    assert t.programstats_config() == j.programstats_config()


def _post(url, body):
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
    try:
        conn.request("POST", "/v1/chat/completions",
                     body=json.dumps(body).encode(),
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("content-type"), \
            json.loads(resp.read())
    finally:
        conn.close()


LOOPER = {"default_model": "base",
          "routing": {"decisions": [
              {"name": "fusion_route", "priority": 10,
               "rules": {"operator": "OR", "conditions": [
                   {"type": "keyword", "name": "panel"}]},
               "modelRefs": [{"model": "qwen3-8b", "weight": 0.3},
                             {"model": "qwen3-32b", "weight": 0.7}],
               "algorithm": {"type": "fusion"}}],
              "signals": {"keywords": [
                  {"name": "panel", "keywords": ["panel"]}]}}}


@pytest.fixture
def served():
    """{"jax" | "port": (server URL, mock backend)} over the looper
    config, and a URL where nothing listens."""
    from semantic_router_tpu.router.server import RouterServer as JServer

    out = {}
    stop = []
    for side in ("jax", "port"):
        backend = MockVLLMServer().start()
        if side == "jax":
            router = JRouter(JRouterConfig.from_dict(copy.deepcopy(LOOPER)))
            server = JServer(router, router.cfg,
                             default_backend=backend.url).start()
        else:
            router = Router(load_config(copy.deepcopy(LOOPER)))
            server = RouterServer(router, backend.url).start()
        out[side] = (server.url, backend)
        stop.append((server, backend, router))
    dead = MockVLLMServer()
    dead_url = dead.url
    dead.httpd.server_close()
    out["dead"] = dead_url
    yield out
    for server, backend, router in stop:
        server.stop()
        backend.stop()
        router.shutdown()


def _strip(reply):
    """An answer without its random id and time."""
    return {k: v for k, v in reply.items() if k not in ("id", "created")}


def test_stream_true_gets_an_error_body(served):
    """A streamed request whose backend cannot be reached gets the
    reference's error body (502, JSON), not an SSE stream; with a live
    backend the stream is relayed as the reference relays it."""
    from semantic_router_tpu.router.server import RouterServer as JServer

    body = {"model": "auto", "stream": True,
            "messages": [{"role": "user", "content": "hello"}]}
    out = {}
    for side in ("jax", "port"):
        if side == "jax":
            router = JRouter(JRouterConfig.from_dict(copy.deepcopy(LOOPER)))
            server = JServer(router, router.cfg,
                             default_backend=served["dead"]).start()
        else:
            router = Router(load_config(copy.deepcopy(LOOPER)))
            server = RouterServer(router, served["dead"]).start()
        try:
            status, ctype, reply = _post(server.url, body)
        finally:
            server.stop()
            router.shutdown()
        out[side] = (status, ctype, reply["error"]["type"])
    assert out["port"] == out["jax"] == (502, "application/json",
                                         "backend_error")
    for side in ("jax", "port"):
        url, backend = served[side]
        u = urllib.parse.urlsplit(url)
        conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
        conn.request("POST", "/v1/chat/completions",
                     body=json.dumps(body).encode())
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("content-type") == "text/event-stream"
        assert resp.read().endswith(b"data: [DONE]\n\n")
        conn.close()
        assert backend.hits == 1


def test_looper_decision_is_routed_and_refused_by_the_server(served):
    """Routed as the reference routes it; executed over the live backend
    as the reference executes it (the panel, then the synthesis); and
    refused (502, ``looper_error``) by both servers when no model of the
    panel answers."""
    from semantic_router_tpu.router.server import RouterServer as JServer

    body = {"model": "auto",
            "messages": [{"role": "user", "content": "ask the panel"}]}
    jr = JRouter(JRouterConfig.from_dict(copy.deepcopy(LOOPER)))
    tr = Router(load_config(copy.deepcopy(LOOPER)))
    try:
        want, got = jr.route(copy.deepcopy(body)), tr.route(
            copy.deepcopy(body))
        assert want.looper_algorithm == got.looper_algorithm == "fusion"
        assert (got.model, got.selection_reason) == \
            (want.model, want.selection_reason)
    finally:
        jr.shutdown()
        tr.shutdown()
    answers = {}
    for side in ("jax", "port"):
        url, backend = served[side]
        status, _, reply = _post(url, body)
        answers[side] = (status, _strip(reply), backend.hits)
    assert answers["port"] == answers["jax"]
    assert answers["port"][0] == 200 and answers["port"][2] == 3
    refused = {}
    for side in ("jax", "port"):
        if side == "jax":
            router = JRouter(JRouterConfig.from_dict(copy.deepcopy(LOOPER)))
            server = JServer(router, router.cfg,
                             default_backend=served["dead"]).start()
        else:
            router = Router(load_config(copy.deepcopy(LOOPER)))
            server = RouterServer(router, served["dead"]).start()
        try:
            status, _, reply = _post(server.url, body)
        finally:
            server.stop()
            router.shutdown()
        refused[side] = (status, reply["error"]["type"],
                         reply["error"]["message"].split(" (")[0])
    assert refused["port"] == refused["jax"] == (
        502, "looper_error", "looper failed: all fusion panel models "
                             "failed")


def _siglip_checkpoint(ckpt, hf) -> None:
    """A tiny SigLIP checkpoint: weights, a config declaring ``hf``, a
    word-level tokenizer."""
    st = pytest.importorskip("safetensors.torch")
    tokenizers = pytest.importorskip("tokenizers")
    from semantic_router_tpu_torch.models.siglip import (
        SiglipModel,
        SiglipTowerConfig,
    )

    text = dict(vocab_size=16, hidden_size=8, intermediate_size=16,
                num_hidden_layers=1, num_attention_heads=2,
                max_position_embeddings=4)
    vision = dict(hidden_size=8, intermediate_size=16, num_hidden_layers=1,
                  num_attention_heads=2, image_size=8, patch_size=4)
    model = SiglipModel(SiglipTowerConfig.from_hf(text),
                        SiglipTowerConfig.from_hf(vision))
    state = {k: v.contiguous() for k, v in model.state_dict().items()}
    state["vision_model.head.attention.in_proj_weight"] = torch.cat(
        [state.pop(f"vision_model.head.attn_{n}.weight") for n in "qkv"])
    state["vision_model.head.attention.in_proj_bias"] = torch.cat(
        [state.pop(f"vision_model.head.attn_{n}.bias") for n in "qkv"])
    st.save_file(state, str(ckpt / "model.safetensors"))
    (ckpt / "config.json").write_text(json.dumps(dict(
        hf, text_config=text, vision_config=vision)))
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        {"[PAD]": 0, "[UNK]": 1, "hello": 2}, unk_token="[UNK]"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tok.save(str(ckpt / "tokenizer.json"))


@pytest.mark.parametrize("hf, spec, name", [
    ({"model_type": "gemma3",
      "architectures": ["Gemma3ForSequenceClassification"]}, {},
     "gemma3"),
    ({"architectures": ["SiglipModel"]}, {"kind": "multimodal"},
     "SiglipModel"),
    ({"model_type": "siglip"}, {"kind": "multimodal"}, "multimodal"),
])
def test_non_modernbert_checkpoint_refused_by_name(tmp_path, hf, spec,
                                                   name):
    """Gemma3 stays refused by name; a SigLIP checkpoint (declared by its
    architectures or its model type) now loads as a ``multimodal`` task,
    which the port once refused."""
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    cfg = load_config({"classifier_models": {
        "intent": dict(spec, checkpoint=str(ckpt))}})
    if name == "gemma3":
        (ckpt / "config.json").write_text(json.dumps(
            dict(hf, id2label={"0": "a", "1": "b"})))
        (ckpt / "model.safetensors").write_bytes(b"")
        with pytest.raises(ValueError, match=name):
            build_engine(cfg, device="cpu")
        return
    _siglip_checkpoint(ckpt, hf)
    eng = build_engine(cfg, device="cpu")
    try:
        assert eng.task_kind("intent") == "multimodal"
        out = eng.embed_multimodal("intent", texts=["hello"],
                                   images=torch.zeros(1, 8, 8, 3).numpy())
        assert out["text"].shape == out["image"].shape == (1, 8)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("hf, spec, name", [
    ({"architectures": ["SiglipModel"]}, {"kind": "sequence"},
     "SiglipModel"),
    ({"model_type": "gemma3"}, {"kind": "multimodal"}, "gemma3"),
])
def test_siglip_under_another_kind_and_others_as_multimodal_refused(
        tmp_path, hf, spec, name):
    """A SigLIP checkpoint served as a classifier, and another
    architecture served as ``multimodal``, are refused by name."""
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps(
        dict(hf, id2label={"0": "a", "1": "b"})))
    (ckpt / "model.safetensors").write_bytes(b"")
    cfg = load_config({"classifier_models": {
        "intent": dict(spec, checkpoint=str(ckpt))}})
    with pytest.raises(ValueError, match=name):
        build_engine(cfg, device="cpu")


@pytest.mark.parametrize("hf, spec, kind", [
    ({"model_type": "deberta-v2",
      "architectures": ["DebertaV2ForSequenceClassification"]}, {},
     "sequence"),
    ({"architectures": ["DebertaV2ForTokenClassification"]},
     {"kind": "token"}, "token"),
    ({"model_type": "modernbert"}, {"architecture": "deberta-v3"},
     "sequence"),
])
def test_deberta_checkpoint_loads(tmp_path, hf, spec, kind):
    """The DeBERTa declarations the port once refused now load, each as
    the classifier its kind names, on the per-task path."""
    st = pytest.importorskip("safetensors.torch")
    tokenizers = pytest.importorskip("tokenizers")
    from semantic_router_tpu_torch.models.deberta import (
        DebertaV3Config,
        DebertaV3ForSequenceClassification,
        DebertaV3ForTokenClassification,
    )

    fields = dict(vocab_size=64, hidden_size=16, intermediate_size=32,
                  num_hidden_layers=1, num_attention_heads=2,
                  max_position_embeddings=32, position_buckets=8,
                  relative_attention=True, pos_att_type=["p2c", "c2p"],
                  share_att_key=True, norm_rel_ebd="layer_norm",
                  position_biased_input=False)
    cls = DebertaV3ForTokenClassification if kind == "token" \
        else DebertaV3ForSequenceClassification
    module = cls(DebertaV3Config(**fields, num_labels=2))
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    st.save_file({k: v.contiguous() for k, v in module.state_dict().items()},
                 str(ckpt / "model.safetensors"))
    (ckpt / "config.json").write_text(json.dumps(
        dict(fields, **hf, id2label={"0": "a", "1": "b"})))
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        {"[PAD]": 0, "[UNK]": 1, "hello": 2}, unk_token="[UNK]"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tok.save(str(ckpt / "tokenizer.json"))
    cfg = load_config({
        "engine": {"seq_len_buckets": [16, 32]},
        "classifier_models": {"intent": dict(spec, checkpoint=str(ckpt))}})
    eng = build_engine(cfg, device="cpu")
    try:
        assert eng.task_kind("intent") == kind
        assert isinstance(eng._tasks["intent"].module, cls)
        assert eng.trunk_group_info() == {}
        out = eng.token_classify("intent", "hello world") \
            if kind == "token" else eng.classify("intent", "hello world")
        assert out is not None
    finally:
        eng.shutdown()


@pytest.mark.parametrize("with_plane", [False, True],
                         ids=["no_plane", "plane"])
def test_unknown_backends_build_the_references_stores(with_plane):
    """An unknown durable decision backend and an unknown Responses store
    backend, served since they were refused: both packages build the same
    kind of store, the durable one through the state plane's mirror (with
    ``share.explain``) or none, the Responses one in memory."""
    from semantic_router_tpu import stateplane as jsp
    from semantic_router_tpu.router import responseapi as jresp
    from semantic_router_tpu.runtime import bootstrap as jboot
    from semantic_router_tpu.runtime.registry import \
        RuntimeRegistry as JRuntimeRegistry
    from semantic_router_tpu_torch import stateplane as tsp
    from semantic_router_tpu_torch.router import responseapi as tresp
    from semantic_router_tpu_torch.runtime import RuntimeRegistry
    from semantic_router_tpu_torch.runtime import bootstrap as tboot

    d = {"observability": {"decisions": {"durable": {
             "backend": "dynamo", "max_records": 7}}},
         "stateplane": {"enabled": with_plane, "backend": "memory",
                        "share": {"explain": True}},
         "response_store": {"backend": "dynamo", "max_entries": 8}}
    kinds = []
    for sp, Registry, boot, resp, cfg in (
            (jsp, JRuntimeRegistry, jboot, jresp,
             JRouterConfig.from_dict(copy.deepcopy(d))),
            (tsp, RuntimeRegistry, tboot, tresp,
             load_config(copy.deepcopy(d)))):
        plane = sp.StatePlane(sp.build_backend({"backend": "memory"}),
                              replica_id="r") if with_plane else None
        registry = Registry.isolated(stateplane=plane)
        try:
            boot.apply_observability_knobs(cfg, registry)
            store = registry.get("explain").durable_store
            resp_store = resp.build_response_store(cfg.response_store)
            kinds.append((type(store).__name__,
                          getattr(store, "max_records", None),
                          type(resp_store).__name__,
                          resp_store.max_entries))
        finally:
            for slot in ("resilience", "slo", "runtimestats"):
                registry.get(slot).stop()
            registry.get("explain").attach_durable(None)
            if plane is not None:
                plane.close()
    assert kinds[1] == kinds[0] == (
        ("StatePlaneDecisionStore", 7) if with_plane else ("NoneType", None)
    ) + ("ResponseStore", 8)
