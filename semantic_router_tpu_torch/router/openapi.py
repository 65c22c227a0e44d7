"""OpenAPI 3.0 document for the router's management and inference
surface, built from the same ``API_CATALOG`` the server dispatches on,
plus a per-route metadata table (summaries, tags, request schemas).
Every catalog route becomes an operation; a route the table does not
describe gets a generic one.  ``GET /openapi.json`` serves the document
and ``GET /docs`` a self-contained HTML viewer (no CDN assets).  The
port's copy of the JAX package's ``router/openapi.py``: the same
document for the same catalog, but for the summaries of the routes whose
backend differs (``/debug/runtime``, ``/debug/programs``,
``/debug/profiler/start``, ``/debug/profiler/xla-dump``) and the
description.
"""

from __future__ import annotations

import re
from typing import Any, Dict

SPEC_VERSION = "3.0.3"
API_VERSION = "1.0.0"

# ---------------------------------------------------------------------------
# reusable schemas (components.schemas) — request/response shapes for the
# routes where the wire contract matters; everything else gets a generic
# object.  Shapes mirror the server handlers, not the reference's Go structs.

_SCHEMAS: Dict[str, Any] = {
    "Error": {
        "type": "object",
        "properties": {"error": {"type": "string"}},
        "required": ["error"],
    },
    "ChatCompletionRequest": {
        "type": "object",
        "properties": {
            "model": {
                "type": "string",
                "description": "Model name, or 'auto'/'MoM' to let the "
                               "router decide.",
            },
            "messages": {
                "type": "array",
                "items": {
                    "type": "object",
                    "properties": {
                        "role": {"type": "string"},
                        "content": {},
                    },
                    "required": ["role"],
                },
            },
            "stream": {"type": "boolean"},
            "tools": {"type": "array", "items": {"type": "object"}},
        },
        "required": ["messages"],
    },
    "ChatCompletionResponse": {
        "type": "object",
        "properties": {
            "id": {"type": "string"},
            "object": {"type": "string"},
            "model": {"type": "string"},
            "choices": {"type": "array", "items": {"type": "object"}},
            "usage": {"type": "object"},
        },
    },
    "AnthropicMessageRequest": {
        "type": "object",
        "properties": {
            "model": {"type": "string"},
            "max_tokens": {"type": "integer"},
            "messages": {"type": "array", "items": {"type": "object"}},
            "system": {},
            "stream": {"type": "boolean"},
        },
        "required": ["messages"],
    },
    "ClassifyRequest": {
        "type": "object",
        "properties": {
            "text": {"type": "string"},
            "windowed": {
                "type": "boolean",
                "description": "Classify the WHOLE input via stride "
                               "windows instead of flagged truncation "
                               "at max_seq_len.",
            },
            "stride": {"type": "integer",
                       "description": "Window overlap in tokens "
                                      "(windowed mode)."},
        },
        "required": ["text"],
    },
    "ClassifyResponse": {
        "type": "object",
        "properties": {
            "classification": {
                "type": "object",
                "properties": {
                    "category": {"type": "string"},
                    "confidence": {"type": "number"},
                    "processing_time_ms": {"type": "number"},
                },
            },
        },
    },
    "BatchClassifyRequest": {
        "type": "object",
        "properties": {
            "texts": {"type": "array", "items": {"type": "string"}},
            "task_type": {"type": "string"},
        },
        "required": ["texts"],
    },
    "EmbeddingsRequest": {
        "type": "object",
        "properties": {
            "texts": {"type": "array", "items": {"type": "string"}},
            "model": {"type": "string"},
            "dimension": {"type": "integer"},
            "quality_priority": {"type": "number"},
            "latency_priority": {"type": "number"},
        },
        "required": ["texts"],
    },
    "SimilarityRequest": {
        "type": "object",
        "properties": {
            "text1": {"type": "string"},
            "text2": {"type": "string"},
            "model": {"type": "string"},
        },
        "required": ["text1", "text2"],
    },
    "ModelList": {
        "type": "object",
        "properties": {
            "object": {"type": "string"},
            "data": {"type": "array", "items": {"type": "object"}},
        },
    },
    "ConfigPatch": {
        "type": "object",
        "description": "Partial router config; deep-merged into the "
                       "running config, snapshotted for rollback.",
        "additionalProperties": True,
    },
    "MemoryItem": {
        "type": "object",
        "properties": {
            "user_id": {"type": "string"},
            "text": {"type": "string"},
            "kind": {"type": "string"},
        },
        "required": ["user_id", "text"],
    },
    "VectorStoreCreate": {
        "type": "object",
        "properties": {
            "name": {"type": "string"},
            "metadata": {"type": "object"},
        },
    },
    "VectorSearchRequest": {
        "type": "object",
        "properties": {
            "query": {"type": "string"},
            "max_num_results": {"type": "integer"},
        },
        "required": ["query"],
    },
}

# ---------------------------------------------------------------------------
# per-route metadata: (METHOD, path) -> summary/tag/schema refs.  Routes
# not listed fall back to a generic operation (still present in the spec —
# the catalog drives WHICH routes exist; this table only enriches them).


def _ref(name: str) -> Dict[str, str]:
    return {"$ref": f"#/components/schemas/{name}"}


_META: Dict[tuple, Dict[str, Any]] = {
    ("GET", "/health"): {
        "tag": "system", "summary": "Liveness probe.", "open": True},
    ("GET", "/ready"): {
        "tag": "system", "summary": "Readiness probe.", "open": True},
    ("GET", "/startup-status"): {
        "tag": "system",
        "summary": "Model-by-model startup progress.", "open": True},
    ("GET", "/metrics"): {
        "tag": "system", "summary": "Prometheus exposition.", "open": True},
    ("GET", "/api/v1"): {
        "tag": "system", "summary": "Machine-readable route catalog."},
    ("GET", "/openapi.json"): {
        "tag": "system", "summary": "This document.", "open": True},
    ("GET", "/docs"): {
        "tag": "system", "summary": "Human-readable API docs.",
        "open": True, "html": True},
    ("POST", "/v1/chat/completions"): {
        "tag": "inference",
        "summary": "OpenAI-compatible chat completion; the router "
                   "classifies, decides, and forwards to the selected "
                   "backend. Decision metadata returns in x-vsr-* "
                   "headers.",
        "request": _ref("ChatCompletionRequest"),
        "response": _ref("ChatCompletionResponse"), "open": True},
    ("POST", "/v1/messages"): {
        "tag": "inference",
        "summary": "Anthropic-compatible inbound; translated to the "
                   "routed backend's dialect and back.",
        "request": _ref("AnthropicMessageRequest"), "open": True},
    ("POST", "/v1/responses"): {
        "tag": "inference",
        "summary": "OpenAI Responses API (stateful; previous_response_id "
                   "chains).", "open": True},
    ("GET", "/v1/models"): {
        "tag": "inference", "summary": "Configured model cards.",
        "response": _ref("ModelList"), "open": True},
    ("POST", "/api/v1/classify/intent"): {
        "tag": "classify", "summary": "Intent category classification.",
        "request": _ref("ClassifyRequest"),
        "response": _ref("ClassifyResponse")},
    ("POST", "/api/v1/classify/pii"): {
        "tag": "classify", "summary": "Token-level PII detection.",
        "request": _ref("ClassifyRequest")},
    ("POST", "/api/v1/classify/security"): {
        "tag": "classify", "summary": "Jailbreak/prompt-attack detection.",
        "request": _ref("ClassifyRequest")},
    ("POST", "/api/v1/classify/fact-check"): {
        "tag": "classify", "summary": "Fact-check-worthiness gate.",
        "request": _ref("ClassifyRequest")},
    ("POST", "/api/v1/classify/user-feedback"): {
        "tag": "classify", "summary": "User-feedback sentiment signal.",
        "request": _ref("ClassifyRequest")},
    ("POST", "/api/v1/classify/combined"): {
        "tag": "classify",
        "summary": "All classifier families in one call.",
        "request": _ref("ClassifyRequest")},
    ("POST", "/api/v1/classify/batch"): {
        "tag": "classify", "summary": "Batched classification.",
        "request": _ref("BatchClassifyRequest")},
    ("POST", "/api/v1/eval"): {
        "tag": "classify",
        "summary": "Answer-correctness eval (reference pkg/apiserver "
                   "eval route)."},
    ("POST", "/api/v1/nli"): {
        "tag": "classify", "summary": "NLI entailment scoring."},
    ("POST", "/api/v1/embeddings"): {
        "tag": "embeddings",
        "summary": "Matryoshka-aware embedding generation.",
        "request": _ref("EmbeddingsRequest")},
    ("POST", "/api/v1/similarity"): {
        "tag": "embeddings", "summary": "Pairwise cosine similarity.",
        "request": _ref("SimilarityRequest")},
    ("POST", "/api/v1/similarity/batch"): {
        "tag": "embeddings", "summary": "One-vs-many similarity."},
    ("GET", "/config/router"): {
        "tag": "config",
        "summary": "Live config (secrets redacted without secret_view "
                   "role)."},
    ("PATCH", "/config/router"): {
        "tag": "config",
        "summary": "Deep-merge a partial config; snapshot for rollback.",
        "request": _ref("ConfigPatch")},
    ("PUT", "/config/router"): {
        "tag": "config", "summary": "Replace the whole config.",
        "request": _ref("ConfigPatch")},
    ("POST", "/config/router/rollback"): {
        "tag": "config", "summary": "Roll back to a stored version."},
    ("GET", "/config/router/versions"): {
        "tag": "config", "summary": "Stored config versions."},
    ("GET", "/config/hash"): {
        "tag": "config", "summary": "Canonical hash of the live config."},
    ("GET", "/v1/memory"): {
        "tag": "memory", "summary": "List memory items for a user.",
        "params": [{"name": "user_id", "in": "query",
                    "schema": {"type": "string"}}]},
    ("POST", "/v1/memory"): {
        "tag": "memory", "summary": "Store a memory item.",
        "request": _ref("MemoryItem")},
    ("DELETE", "/v1/memory"): {
        "tag": "memory", "summary": "Delete a user's memory scope.",
        "params": [{"name": "user_id", "in": "query",
                    "schema": {"type": "string"}}]},
    ("POST", "/v1/vector_stores"): {
        "tag": "vector-stores", "summary": "Create a vector store.",
        "request": _ref("VectorStoreCreate")},
    ("POST", "/v1/vector_stores/{id}/search"): {
        "tag": "vector-stores", "summary": "ANN search within a store.",
        "request": _ref("VectorSearchRequest")},
    ("GET", "/debug/profiler"): {
        "tag": "debug", "summary": "Profiler status."},
    ("GET", "/debug/flightrec"): {
        "tag": "debug",
        "summary": "Slow-request flight recorder: the retained "
                   "over-threshold request traces (docs/TRACING.md); "
                   "?source=fleet merges the live siblings' slowest-N "
                   "summaries.",
        "params": [{"name": "source", "in": "query",
                    "schema": {"type": "string",
                               "enum": ["fleet"]}}]},
    ("POST", "/debug/flightrec/clear"): {
        "tag": "debug", "summary": "Drop the retained flight-recorder "
                                   "traces."},
    ("GET", "/debug/slo"): {
        "tag": "debug",
        "summary": "SLO engine state: per-objective burn rates, "
                   "multiwindow alert status, error budgets."},
    ("GET", "/debug/runtime"): {
        "tag": "debug",
        "summary": "Per-step-program device-step sampler: cold vs warm "
                   "steps, padding waste, token fill, kernel/quant "
                   "program-set state, process gauges, and the "
                   "early-exit cascade block (ordering, per-family "
                   "cost EWMAs, skip counters) when engine.cascade is "
                   "on."},
    ("GET", "/debug/programs"): {
        "tag": "debug",
        "summary": "Program-level performance observatory: per-step-"
                   "program costs (FLOPs and bytes counted at a step's "
                   "first execution) joined with measured warm-step "
                   "EWMAs into roofline fractions against the device "
                   "peak table."},
    ("GET", "/debug/resilience"): {
        "tag": "debug",
        "summary": "Degradation-ladder snapshot: level, pressure "
                   "inputs, shed counts, admission bucket fill, "
                   "fleet-aggregated view."},
    ("GET", "/debug/decisions"): {
        "tag": "debug",
        "summary": "Recent decision records (replay-grade routing "
                   "audit trail); ?source=durable reads the SQLite "
                   "mirror, ?source=fleet merges the live siblings' "
                   "newest-record summaries.",
        "params": [{"name": "limit", "in": "query",
                    "schema": {"type": "integer"}},
                   {"name": "source", "in": "query",
                    "schema": {"type": "string",
                               "enum": ["durable", "fleet"]}}]},
    ("GET", "/debug/decisions/{id}"): {
        "tag": "debug", "summary": "One decision record, full detail."},
    ("POST", "/debug/decisions/{id}/replay"): {
        "tag": "debug",
        "summary": "Deterministically re-drive a recorded decision "
                   "(optionally against the live config for a "
                   "counterfactual diff)."},
    ("GET", "/debug/flywheel"): {
        "tag": "debug",
        "summary": "Learned-routing flywheel state: promotion ladder, "
                   "last cycle report, counterfactual eval."},
    ("POST", "/debug/flywheel/cycle"): {
        "tag": "debug",
        "summary": "Run one flywheel cycle now (export → train → "
                   "eval → shadow-on-win); serialized with the "
                   "scheduled runner."},
    ("GET", "/debug/stateplane"): {
        "tag": "debug",
        "summary": "Shared-state-plane snapshot: replica membership, "
                   "consistent-hash ring distribution, backend health, "
                   "aggregated fleet pressure."},
    ("GET", "/debug/upstreams"): {
        "tag": "debug",
        "summary": "Upstream resilience plane snapshot: per-(model, "
                   "endpoint) circuit-breaker state, EWMA error rate "
                   "and latency, retry-budget fill, and fleet-shared "
                   "open circuits."},
    ("GET", "/debug/fleet"): {
        "tag": "debug",
        "summary": "Fleet observability snapshot: merged-view scope "
                   "(fleet vs local-fallback), per-replica snapshot "
                   "staleness, publisher/aggregator health, union of "
                   "firing fleet SLO alerts."},
    ("GET", "/metrics/external"): {
        "tag": "system", "open": True,
        "summary": "ExternalMetricValueList-shaped scaling signals "
                   "(llm_degradation_level, llm_queue_pressure) for "
                   "KEDA / an HPA external-metrics adapter."},
    ("GET", "/metrics/fleet"): {
        "tag": "system", "open": True,
        "summary": "Fleet-merged Prometheus exposition: the live "
                   "members' published metric snapshots folded with "
                   "the local registry (counters/histograms summed, "
                   "gauges worst-of-fleet), scope and staleness "
                   "stamped as llm_fleet_* series."},
    ("POST", "/debug/profiler/start"): {
        "tag": "debug", "summary": "Start a torch.profiler trace."},
    ("POST", "/debug/profiler/stop"): {
        "tag": "debug", "summary": "Stop the trace; returns artifacts."},
    ("POST", "/debug/profiler/xla-dump"): {
        "tag": "debug",
        "summary": "Answers 501: this backend compiles no XLA."},
    ("POST", "/dashboard/api/login"): {
        "tag": "dashboard", "summary": "Exchange an API key for a "
                                       "dashboard session token."},
    ("POST", "/dashboard/api/playground"): {
        "tag": "dashboard",
        "summary": "Trace one request through the full pipeline without "
                   "forwarding it."},
    ("GET", "/dashboard/api/config/raw"): {
        "tag": "dashboard",
        "summary": "The on-disk config YAML + stored versions (the "
                   "editor's source of truth; env placeholders "
                   "unresolved)."},
    ("POST", "/dashboard/api/config/validate"): {
        "tag": "dashboard",
        "summary": "Server-side dry validation of editor YAML — parse, "
                   "schema, semantic checks; nothing written."},
    ("POST", "/dashboard/api/config/deploy"): {
        "tag": "dashboard",
        "summary": "Deploy editor YAML through the same "
                   "snapshot-then-write path as PUT /config/router."},
    ("GET", "/dashboard/static/{asset}"): {
        "tag": "dashboard", "summary": "Dashboard page assets (js/css).",
        "open": True, "html": True},
}

_TAG_ORDER = ["inference", "classify", "embeddings", "config", "memory",
              "vector-stores", "dashboard", "debug", "system"]


def _op_id(method: str, path: str) -> str:
    clean = re.sub(r"[{}]", "", path)
    parts = [p for p in re.split(r"[/._-]+", clean) if p]
    camel = parts[0] if parts else "root"
    for p in parts[1:]:
        camel += p[:1].upper() + p[1:]
    return method.lower() + camel[:1].upper() + camel[1:]


def _path_params(path: str):
    return [{"name": m, "in": "path", "required": True,
             "schema": {"type": "string"}}
            for m in re.findall(r"\{(\w+)\}", path)]


def build_spec(catalog: Dict[str, Any],
               server_url: str = "/") -> Dict[str, Any]:
    """Build the OpenAPI document from the live route catalog.

    Every catalog endpoint becomes an operation; the _META table adds
    summaries/schemas where defined.  Routes carrying no ``open`` flag
    are marked with the ApiKeyAuth security requirement (the server's
    RBAC gate, routes.go:27-45 role).
    """
    paths: Dict[str, Dict[str, Any]] = {}
    for ep in catalog["endpoints"]:
        path, method = ep["path"], ep["method"].upper()
        meta = _META.get((method, path), {})
        op: Dict[str, Any] = {
            "operationId": _op_id(method, path),
            "tags": [meta.get("tag", "management")],
            "summary": meta.get("summary",
                                f"{method} {path}"),
            "responses": {
                "200": {
                    "description": "Success",
                    "content": {
                        ("text/html" if meta.get("html")
                         else "application/json"): {
                            "schema": meta.get(
                                "response",
                                {"type": "object",
                                 "additionalProperties": True})
                            if not meta.get("html")
                            else {"type": "string"},
                        },
                    },
                },
                "default": {
                    "description": "Error",
                    "content": {"application/json": {
                        "schema": _ref("Error")}},
                },
            },
        }
        params = _path_params(path) + list(meta.get("params", []))
        if params:
            op["parameters"] = params
        if method in ("POST", "PUT", "PATCH"):
            op["requestBody"] = {
                "required": True,
                "content": {"application/json": {
                    "schema": meta.get(
                        "request",
                        {"type": "object", "additionalProperties": True}),
                }},
            }
        if not meta.get("open"):
            op["security"] = [{"ApiKeyAuth": []}]
        paths.setdefault(path, {})[method.lower()] = op

    tags_seen = {m.get("tag", "management") for m in _META.values()}
    tags_seen.add("management")
    return {
        "openapi": SPEC_VERSION,
        "info": {
            "title": "semantic-router-tpu",
            "version": API_VERSION,
            "description":
                "Semantic router on PyTorch and CUDA: OpenAI/Anthropic-"
                "compatible "
                "routing data plane + management API. Decision metadata "
                "is returned in x-vsr-* response headers.",
        },
        "servers": [{"url": server_url}],
        "tags": [{"name": t} for t in _TAG_ORDER if t in tags_seen]
                + [{"name": "management",
                    "description": "Routes without richer metadata."}],
        "paths": paths,
        "components": {
            "schemas": dict(_SCHEMAS),
            "securitySchemes": {
                "ApiKeyAuth": {
                    "type": "apiKey", "in": "header",
                    "name": "x-api-key",
                    "description": "Management-API key from "
                                   "api_server.api_keys; roles gate "
                                   "individual routes.",
                },
            },
        },
    }


def validate_spec(spec: Dict[str, Any]) -> list:
    """Structural validation (no external validator in this image):
    returns a list of problems, empty when the document is well-formed
    per the OpenAPI 3.0 rules we rely on."""
    problems = []
    for key in ("openapi", "info", "paths"):
        if key not in spec:
            problems.append(f"missing top-level '{key}'")
    if not str(spec.get("openapi", "")).startswith("3."):
        problems.append("openapi version must be 3.x")
    info = spec.get("info", {})
    for key in ("title", "version"):
        if not info.get(key):
            problems.append(f"info.{key} missing")
    op_ids = set()
    for path, ops in spec.get("paths", {}).items():
        if not path.startswith("/"):
            problems.append(f"path '{path}' must start with /")
        declared = set(re.findall(r"\{(\w+)\}", path))
        for method, op in ops.items():
            where = f"{method.upper()} {path}"
            if "responses" not in op or not op["responses"]:
                problems.append(f"{where}: no responses")
            oid = op.get("operationId")
            if not oid:
                problems.append(f"{where}: no operationId")
            elif oid in op_ids:
                problems.append(f"{where}: duplicate operationId {oid}")
            else:
                op_ids.add(oid)
            got = {p["name"] for p in op.get("parameters", [])
                   if p.get("in") == "path"}
            if declared != got:
                problems.append(
                    f"{where}: path params declared {sorted(declared)} "
                    f"!= documented {sorted(got)}")
            for p in op.get("parameters", []):
                if p.get("in") == "path" and not p.get("required"):
                    problems.append(
                        f"{where}: path param {p['name']} not required")
    # every $ref must resolve
    schemas = spec.get("components", {}).get("schemas", {})

    def _walk(node, where):
        if isinstance(node, dict):
            ref = node.get("$ref")
            if ref is not None:
                name = ref.rsplit("/", 1)[-1]
                if not ref.startswith("#/components/schemas/") \
                        or name not in schemas:
                    problems.append(f"{where}: dangling $ref {ref}")
            for v in node.values():
                _walk(v, where)
        elif isinstance(node, list):
            for v in node:
                _walk(v, where)

    _walk(spec.get("paths", {}), "paths")
    _walk(schemas, "components.schemas")
    return problems


# self-contained viewer: groups operations by tag, renders schemas —
# no CDN assets (zero-egress image; the reference bundles its UI too)
DOCS_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>semantic-router-tpu API</title>
<style>
 body{font:14px/1.5 system-ui,sans-serif;margin:0;background:#f7f7f9;color:#1a1a2e}
 header{background:#1a1a2e;color:#fff;padding:14px 24px}
 header h1{font-size:18px;margin:0}
 main{max-width:980px;margin:0 auto;padding:16px 24px}
 h2{text-transform:uppercase;font-size:13px;letter-spacing:.08em;color:#555;margin:28px 0 8px}
 .op{background:#fff;border:1px solid #e2e2ea;border-radius:6px;margin:8px 0;overflow:hidden}
 .op>summary{display:flex;gap:10px;align-items:center;padding:8px 12px;cursor:pointer;list-style:none}
 .m{font-weight:700;font-size:11px;padding:2px 8px;border-radius:4px;color:#fff;min-width:46px;text-align:center}
 .m.get{background:#2e7d32}.m.post{background:#1565c0}.m.put{background:#ef6c00}
 .m.patch{background:#6a1b9a}.m.delete{background:#c62828}
 .p{font-family:ui-monospace,monospace;font-size:13px}
 .s{color:#666;font-size:12px;margin-left:auto;text-align:right;max-width:50%}
 .body{padding:10px 14px;border-top:1px solid #eee;background:#fafafd}
 pre{background:#13131f;color:#d5d5e4;padding:10px;border-radius:6px;overflow:auto;font-size:12px}
 .lock{opacity:.55;font-size:12px}
</style></head><body>
<header><h1>semantic-router-tpu API</h1></header>
<main id="app">loading /openapi.json…</main>
<script>
fetch('openapi.json').then(r=>r.json()).then(spec=>{
  const app=document.getElementById('app');app.textContent='';
  const byTag={};
  for(const [path,ops] of Object.entries(spec.paths))
    for(const [m,op] of Object.entries(ops))
      ((byTag[(op.tags||['other'])[0]] ||= [])).push([m,path,op]);
  const order=(spec.tags||[]).map(t=>t.name);
  for(const tag of Object.keys(byTag).sort((a,b)=>order.indexOf(a)-order.indexOf(b))){
    const h=document.createElement('h2');h.textContent=tag;app.appendChild(h);
    for(const [m,path,op] of byTag[tag]){
      const d=document.createElement('details');d.className='op';
      const sum=document.createElement('summary');
      const badge=document.createElement('span');badge.className='m '+m;badge.textContent=m.toUpperCase();
      const p=document.createElement('span');p.className='p';p.textContent=path;
      const s=document.createElement('span');s.className='s';
      s.textContent=(op.security?'\\uD83D\\uDD12 ':'')+(op.summary||'');
      sum.append(badge,p,s);d.appendChild(sum);
      const body=document.createElement('div');body.className='body';
      const rq=op.requestBody?.content?.['application/json']?.schema;
      if(rq){const t=document.createElement('div');t.textContent='Request body:';body.appendChild(t);
        const pre=document.createElement('pre');pre.textContent=JSON.stringify(resolve(rq,spec),null,1);body.appendChild(pre);}
      const rs=op.responses?.['200']?.content?.['application/json']?.schema;
      if(rs){const t=document.createElement('div');t.textContent='200 response:';body.appendChild(t);
        const pre=document.createElement('pre');pre.textContent=JSON.stringify(resolve(rs,spec),null,1);body.appendChild(pre);}
      d.appendChild(body);app.appendChild(d);
    }
  }
  function resolve(node,spec,depth=0){
    if(depth>6||!node)return node;
    if(node.$ref){const name=node.$ref.split('/').pop();
      return resolve(spec.components.schemas[name]||{},spec,depth+1);}
    if(Array.isArray(node))return node.map(n=>resolve(n,spec,depth+1));
    if(typeof node==='object'){const out={};
      for(const [k,v] of Object.entries(node))out[k]=resolve(v,spec,depth+1);
      return out;}
    return node;
  }
}).catch(e=>{document.getElementById('app').textContent='failed: '+e});
</script></body></html>
"""
