"""HTTP front end: ``POST /v1/chat/completions`` routes the request, forwards
the rewritten body to the routed model's backend, and answers with the
backend's response stamped with the router's x-vsr-* headers; a
semantic-cache hit is answered by the router without the backend.
``POST /v1/messages`` takes an Anthropic Messages request and
``POST /v1/responses`` an OpenAI Responses request through the same
route (``anthropic.py``, ``responseapi.py`` translate both ways; a
Responses turn is stored, and ``previous_response_id`` threads the
stored conversation into the next); ``GET /v1/models`` lists the model
cards.

Backends: each model card's ``backend_refs`` (weighted endpoints) name
the model's own backends (``BackendResolver``: a seeded weighted pick,
then the others heaviest first); a model without any goes to the
server's default backend.  Forwards ride a pooled keep-alive client
(``httpclient.UpstreamPool``).  Without the upstream plane a request the
chosen endpoint never received (connect refused, a send-phase failure)
fails over to the next endpoint, and one it may have executed does not.
With ``resilience.upstream.enabled`` (``_forward_resilient``) every
attempt is gated by its endpoint's circuit breaker, retried to the next
candidate (the model's other endpoints, then the route's ranked
``fallback_models``) under the retry budget and the end-to-end deadline
(``x-vsr-deadline``, forwarded with what remains), and recorded in the
decision record's ``failover_path``.  Each backend call is counted
in the in-flight tracker (the ``multi_factor`` selector's load) and timed;
a 200 goes through the router's response path (its headers and annotated
body are what the client gets), and every answer, 200 or not, is fed
back to the decision's selector (``record_feedback``).  The client's W3C
``traceparent`` is continued by the router's ``router.route`` span, and
the router's own goes to the backend.  A rate-limited request is answered
429 with ``retry-after``, and never reaches the backend; a passthrough
(``x-vsr-skip-processing``, when enabled) goes to the default backend
untouched, and its answer goes through the response path and feedback
like any other.  A request the degradation ladder sheds is answered 429
with ``retry-after`` and never reaches a backend; a fail-static one is
forwarded to the static model.  Every upstream call carries the
client's headers, the route's x-vsr-* headers and the credential
``authz.credentials`` names for the (user, model) pair
(``authz.CredentialResolver``); with no credential and ``fail_open:
false`` the request is answered 403 and forwarded nowhere.

A ``stream: true`` request is relayed frame by frame from one backend
(the first whose circuit is not open), its time to first token fed
back; when the stream ends with ``[DONE]`` or a ``finish_reason`` the
response path runs on the assembled text (so the cache is written only
then), and a truncated or aborted stream is never cached and fed back
as a failure.  A decision with a looper algorithm (confidence, ratings,
remom, fusion, workflows) is executed over its models
(``looper/``): the router becomes the client, each fan-out call marked
``x-vsr-looper-request`` (a request so marked is served single-model)
and carrying its own candidate's credential; fusion's grounding runs
one ``nli`` classification per panel answer.  A decision whose
``image_generation`` plugin is enabled runs on the plugin's image
backend (``imagegen.py``; one per decision and configuration) and
answers as a chat completion with ``x-vsr-image-backend``
(Anthropic-shaped for ``/v1/messages``, one SSE chunk for a stream); a
backend that cannot be built or fails answers 502 ``imagegen_error``.
``GET /health`` reports
liveness (``healthy``, or ``degraded`` with the firing SLO objectives,
HTTP 200 either way), ``GET /ready`` readiness.  Serves on
``httpserver.PooledHTTPServer`` (``api_server.http_workers`` request
workers, idle keep-alive connections parked on a selector); request
bodies may be chunked.  Standard library only.

The management routes sit behind the reference's access gate:
``api_server.api_keys`` ([{key, roles}]; ``x-api-key`` or a bearer
token, or a session token from ``POST /dashboard/api/login``) gives
``view`` the reads, ``edit`` the writes (audited with the caller's
roles), ``admin`` both, and ``secret_view`` (or ``admin``) the
unredacted config; with no keys they are open and the config redacted.
The chat routes, the login, liveness, the scrapes, ``/v1/models`` and
the API's own description stay open.  The Classification API answers
as the reference server's handlers do:

  POST /api/v1/classify/intent|pii|security|fact-check|user-feedback
       (``windowed`` / ``stride`` classify a long text over stride windows)
  POST /api/v1/classify/combined   every loaded task on one text
  POST /api/v1/classify/batch      one task over ``texts``
  POST /api/v1/embeddings          ``input``, ``dimensions`` → output_dim
  POST /api/v1/similarity[/batch]  cosine of embedded text pairs
  POST /api/v1/eval                every signal family and decision for
                                   a text
  POST /api/v1/nli                 ``premise`` / ``hypothesis`` on the
                                   ``nli`` task
  GET|POST|DELETE /v1/memory       a user's memories (``user_id``)
  GET|DELETE /v1/memory/{id}       one memory; a DELETE without
                                   ``user_id`` finds its owner
  GET|POST /v1/vector_stores       the named vector stores; create one
  GET|DELETE /v1/vector_stores/{id}   a store's stats; drop it
  POST /v1/vector_stores/{id}/search  hybrid search (``query``, ``top_k``,
                                   ``threshold``)
  GET|POST /v1/vector_stores/{id}/files  its documents; ingest one
                                   (``name``, ``text``, ``metadata``)
  DELETE /v1/vector_stores/{id}/files/{file_id}  one document
  GET  /info/models                every task: kind, labels, task_info
  GET  /startup-status             the boot's phases (``serve``)
  GET  /openapi.json, /docs        the OpenAPI document of the catalog
  GET  /api/v1                     the routes this server answers

and the reference's telemetry surface, over the server's
``RuntimeRegistry``:

  GET  /metrics                    Prometheus 0.0.4, or OpenMetrics with
                                   trace-id exemplars when
                                   ``observability.metrics.exemplars``
  GET  /debug/profiler             profiler status
  POST /debug/profiler/start|stop  a torch.profiler trace (Chrome JSON)
  POST /debug/profiler/xla-dump    501: no XLA on this backend
  GET  /debug/flightrec            slowest requests with span trees
  POST /debug/flightrec/clear
  GET  /debug/runtime              per-step-program stats, process and
                                   torch.cuda memory rows, kernel knobs,
                                   the cascade's block when one is
                                   attached
  GET  /debug/programs             step costs and roofline fractions
  GET  /debug/decisions[/{id}]     decision records (?source=durable)
  GET  /debug/slo                  SLO objectives, burn rates, alerts
  GET  /debug/resilience           the degradation ladder (level,
                                   pressure, buckets, transitions) and,
                                   under ``upstreams``, the upstream
                                   plane's breakers and retry budget
  GET  /debug/upstreams            the upstream plane alone (503 when
                                   it is off)
  GET  /debug/stateplane           the shared state plane: members, the
                                   ring's distribution, the backend's
                                   health, fleet pressure (503 without
                                   a plane)
  GET  /debug/flywheel             the routing flywheel: promotion state,
                                   the last train and evaluation, shadow
                                   agreement, admission weights (503
                                   when it is off)
  POST /debug/flywheel/cycle       one flywheel cycle now (export, train,
                                   evaluate, shadow on a win); edit-gated
  GET  /metrics/external           ExternalMetricValueList scaling
                                   signals (degradation level, queue
                                   pressure; the fleet maximum and one
                                   level row per replica with a plane,
                                   through the fleet plane's aggregator
                                   when one is attached) for an
                                   autoscaler
  GET  /metrics/fleet              the fleet plane's merged exposition
                                   (Prometheus 0.0.4, open like
                                   /metrics; 503 without the plane)
  GET  /debug/fleet                the fleet plane: merged-view scope,
                                   per-replica staleness, publisher and
                                   aggregator health, the fleet's firing
                                   SLO alerts (503 without it);
                                   ``?source=fleet`` on /debug/flightrec
                                   and /debug/decisions merges the live
                                   replicas' published summaries

and the config management API over the file ``serve`` watches
(``config_path``; its hot-reload watcher applies what these write):

  GET  /config/router              the live config (redacted)
  PATCH|PUT /config/router         an RFC 7396 merge into the on-disk
                                   document, or a whole one: validated,
                                   backed up, written; a document the
                                   port refuses is answered 400
  GET  /config/router/versions     the kept backups
  POST /config/router/rollback     a backup made live again
  GET  /config/hash                the live config's hash
  GET  /dashboard/api/config[/raw] the editor's view; the on-disk text
                                   (``secret_view``)
  POST /dashboard/api/config/validate|deploy  a dry run (empty
                                   environment); the operator's text
                                   written verbatim
  POST /dashboard/api/dsl/compile|decompile   the routing DSL

and the rest of the dashboard (``dashboard/``):

  GET  /dashboard, /dashboard/static/{asset}  the bundled page and its
                                   ``.js`` / ``.css`` assets (open; a
                                   basename, no traversal)
  GET  /dashboard/embedmap         the embedding map's page (open, empty)
  GET  /dashboard/api/overview|signals|events  the router's series, the
                                   event bus
  GET  /dashboard/api/replay       the replay store's newest records
  GET  /dashboard/api/embedmap[/sources]  the 2-D map of the cache's,
                                   the memory store's or a vector
                                   store's embeddings (``?source=``)
  GET|POST /dashboard/api/jobs, GET /dashboard/api/jobs/{id}  the
                                   dashboard's jobs (``selection_benchmark``,
                                   ``accuracy_eval``)
  POST /dashboard/api/playground   what route() does with a request,
                                   forwarded nowhere
  POST /debug/decisions/{id}/replay  a decision record re-driven under the
                                   live or a candidate ``config``, with
                                   the diff

With ``observability.tracing.otlp_endpoint`` the finished spans and the
decision records go to that collector (``runtime.bootstrap.attach_otlp``);
``stop()`` detaches and flushes the exporters and ends the jobs.
"""

from __future__ import annotations

import datetime
import http.client
import json
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..config.schema import RouterConfig, config_hash, redact_config
from ..looper import HTTPLLMClient, Looper
from ..looper.workflows import WorkflowsLooper, build_workflow_state_store
from ..observability.inflight import default_tracker
from ..observability.logging import component_event
from ..observability.profiler import XLA_DUMP_UNSUPPORTED
from ..resilience.upstream import attempt_timeout, parse_deadline
from . import headers as H
from .anthropic import (
    anthropic_to_openai,
    openai_sse_to_anthropic_events,
    openai_to_anthropic_response,
)
from .authz import CredentialResolver
from .httpclient import UpstreamPool
from .httpserver import PooledHTTPServer
from .pipeline import EMBEDDING_TASK, Router, usage_cost
from .responseapi import (
    build_incomplete_response,
    build_response_store,
    chat_sse_to_response_events,
    chat_to_response,
    responses_to_chat,
)

# the routes this server answers (the reference's discovery document,
# trimmed to what the port serves; like the reference's it leaves out the
# dashboard page and its overview / signals / replay / events / config
# reads)
API_CATALOG = {"endpoints": [
    {"path": p, "method": m} for p, m in (
        ("/health", "GET"),
        ("/startup-status", "GET"),
        ("/api/v1", "GET"),
        ("/openapi.json", "GET"),
        ("/docs", "GET"),
        ("/v1/chat/completions", "POST"),
        ("/v1/messages", "POST"),
        ("/v1/responses", "POST"),
        ("/v1/models", "GET"),
        ("/api/v1/classify/intent", "POST"),
        ("/api/v1/classify/pii", "POST"),
        ("/api/v1/classify/security", "POST"),
        ("/api/v1/classify/fact-check", "POST"),
        ("/api/v1/classify/user-feedback", "POST"),
        ("/api/v1/classify/combined", "POST"),
        ("/api/v1/classify/batch", "POST"),
        ("/api/v1/eval", "POST"),
        ("/api/v1/nli", "POST"),
        ("/api/v1/embeddings", "POST"),
        ("/api/v1/similarity", "POST"),
        ("/api/v1/similarity/batch", "POST"),
        ("/ready", "GET"),
        ("/metrics", "GET"),
        ("/debug/profiler", "GET"),
        ("/debug/profiler/start", "POST"),
        ("/debug/profiler/stop", "POST"),
        ("/debug/profiler/xla-dump", "POST"),
        ("/debug/flightrec", "GET"),
        ("/debug/flightrec/clear", "POST"),
        ("/debug/runtime", "GET"),
        ("/debug/programs", "GET"),
        ("/debug/decisions", "GET"),
        ("/debug/decisions/{id}", "GET"),
        ("/debug/flywheel", "GET"),
        ("/debug/flywheel/cycle", "POST"),
        ("/debug/slo", "GET"),
        ("/debug/resilience", "GET"),
        ("/debug/upstreams", "GET"),
        ("/debug/stateplane", "GET"),
        ("/debug/fleet", "GET"),
        ("/metrics/external", "GET"),
        ("/metrics/fleet", "GET"),
        ("/info/models", "GET"),
        ("/v1/memory", "GET"),
        ("/v1/memory", "POST"),
        ("/v1/memory", "DELETE"),
        ("/v1/memory/{id}", "GET"),
        ("/v1/memory/{id}", "DELETE"),
        ("/v1/vector_stores", "GET"),
        ("/v1/vector_stores", "POST"),
        ("/v1/vector_stores/{id}", "GET"),
        ("/v1/vector_stores/{id}", "DELETE"),
        ("/v1/vector_stores/{id}/search", "POST"),
        ("/v1/vector_stores/{id}/files", "GET"),
        ("/v1/vector_stores/{id}/files", "POST"),
        ("/v1/vector_stores/{id}/files/{file_id}", "DELETE"),
        ("/config/router", "GET"),
        ("/config/router", "PATCH"),
        ("/config/router", "PUT"),
        ("/config/router/rollback", "POST"),
        ("/config/router/versions", "GET"),
        ("/config/hash", "GET"),
        ("/debug/decisions/{id}/replay", "POST"),
        ("/dashboard/embedmap", "GET"),
        ("/dashboard/api/embedmap", "GET"),
        ("/dashboard/api/embedmap/sources", "GET"),
        ("/dashboard/api/login", "POST"),
        ("/dashboard/api/jobs", "GET"),
        ("/dashboard/api/jobs", "POST"),
        ("/dashboard/api/jobs/{id}", "GET"),
        ("/dashboard/api/playground", "POST"),
        ("/dashboard/static/{asset}", "GET"),
        ("/dashboard/api/dsl/compile", "POST"),
        ("/dashboard/api/dsl/decompile", "POST"),
        ("/dashboard/api/config/raw", "GET"),
        ("/dashboard/api/config/validate", "POST"),
        ("/dashboard/api/config/deploy", "POST"),
    )]}

# Classification API route name → engine task
CLASSIFY_TASKS = {"intent": "intent", "security": "jailbreak", "pii": "pii",
                  "fact-check": "fact_check",
                  "user-feedback": "user_feedback"}


# gated POST routes → (write, audited action); None = open (the data plane
# and the dashboard login)
_POST_GATES = {
    "/v1/chat/completions": None, "/v1/messages": None,
    "/v1/responses": None, "/dashboard/api/login": None,
    "/api/v1/embeddings": (False, ""), "/api/v1/similarity": (False, ""),
    "/api/v1/similarity/batch": (False, ""), "/api/v1/eval": (False, ""),
    "/api/v1/nli": (False, ""),
    "/dashboard/api/config/validate": (False, ""),
    "/dashboard/api/dsl/compile": (False, ""),
    "/dashboard/api/dsl/decompile": (False, ""),
    "/v1/memory": (True, "memory_create"),
    "/v1/vector_stores": (True, "vectorstore_create"),
    "/config/router/rollback": (True, "config_rollback"),
    "/dashboard/api/config/deploy": (True, "config_put"),
    "/dashboard/api/playground": (False, ""),
    "/dashboard/api/jobs": (True, "dashboard_job"),
}
# the config API's and the editor's POST routes → their handler
_CONFIG_POSTS = {
    "/config/router/rollback": "_config_rollback",
    "/dashboard/api/config/validate": "_config_validate",
    "/dashboard/api/config/deploy": "_config_deploy",
    "/dashboard/api/dsl/compile": "_dsl_compile",
    "/dashboard/api/dsl/decompile": "_dsl_decompile",
    "/dashboard/api/login": "_login",
    "/dashboard/api/playground": "_playground",
    "/dashboard/api/jobs": "_job_submit",
}


def _post_gate(path: str):
    """A POST route's gate: () when it is open, (write, action) when it
    is gated, None when the route is unknown."""
    if path.startswith("/api/v1/classify/"):
        return (False, "")
    if path.startswith("/debug/decisions/") and path.endswith("/replay"):
        # the re-drive computes and mutates nothing: view-gated
        return (False, "")
    if path.startswith("/v1/vector_stores/"):
        if path.endswith("/search"):
            return (False, "")
        if path.endswith("/files"):
            return (True, "vectorstore_ingest")
        return None
    if path not in _POST_GATES:
        return None
    return _POST_GATES[path] or ()


def _parse_yaml_mapping(text: str):
    """(doc, error): editor or deploy YAML text as a config mapping."""
    import yaml

    try:
        doc = yaml.safe_load(text) or {}
    except yaml.YAMLError as exc:
        return None, f"YAML: {exc}"[:500]
    if not isinstance(doc, dict):
        return None, "config must be a mapping"
    return doc, None


def _resolve_and_validate(doc: Dict[str, Any], env=None):
    """(candidate, fatal, warnings) of a config document as it would load:
    placeholders substituted (``env``, else the process's), the schema
    parsed (the port's refusals raise here) and the validator run."""
    import yaml

    from ..config.loader import substitute_env
    from ..config.validator import validate_config

    resolved = yaml.safe_load(substitute_env(yaml.safe_dump(doc), env)) \
        or {}
    candidate = RouterConfig.from_dict(resolved)
    findings = validate_config(candidate)
    return (candidate, [str(e) for e in findings if e.fatal],
            [str(e) for e in findings if not e.fatal])


class _Handler(BaseHTTPRequestHandler):
    server_version = "semantic-router-torch/0.1"
    # keep-alive: every JSON answer carries content-length; an SSE answer
    # closes its connection (_sse_headers)
    protocol_version = "HTTP/1.1"
    # an idle kept-alive connection must not pin a pool worker forever
    timeout = 65
    # the most a chunked request body may carry
    _MAX_CHUNKED = 64 * 1024 * 1024

    def log_message(self, *args):  # silence
        pass

    def handle_one_request(self):
        # the handler instance serves every request of its connection:
        # whether THIS request's body was read is per request
        self._body_consumed = False
        super().handle_one_request()

    def _req_headers(self) -> Dict[str, str]:
        return {k.lower(): v for k, v in self.headers.items()}

    # -- request bodies ----------------------------------------------------

    def _raw_body(self) -> bytes:
        """The request body: chunked or content-length framed."""
        if "chunked" in self.headers.get("transfer-encoding", "").lower():
            raw = self._read_chunked()
        else:
            length = int(self.headers.get("content-length", 0) or 0)
            raw = self.rfile.read(length) if length else b""
        self._body_consumed = True
        return raw

    def _read_chunked(self) -> bytes:
        """A ``Transfer-Encoding: chunked`` body.  Left unread, its bytes
        would be parsed as the connection's next request."""
        out, total = [], 0
        while True:
            line = self.rfile.readline(65557)
            try:
                size = int(line.split(b";")[0].strip() or b"0", 16)
            except ValueError:
                self.close_connection = True
                break
            if size == 0:
                while True:  # trailers until the blank line
                    t = self.rfile.readline(65557)
                    if t in (b"\r\n", b"\n", b""):
                        break
                break
            total += size
            if total > self._MAX_CHUNKED:
                self.close_connection = True
                break
            out.append(self.rfile.read(size))
            self.rfile.read(2)  # the chunk's CRLF
        return b"".join(out)

    def _drain_body(self) -> None:
        """Consume an unread request body before answering, so an early
        answer leaves no body bytes to be read as the next request."""
        if getattr(self, "_body_consumed", False):
            return
        self._body_consumed = True
        if "chunked" in self.headers.get("transfer-encoding", "").lower():
            # no parser for a drain: stop reusing the connection
            self.close_connection = True
            return
        remaining = int(self.headers.get("content-length", 0) or 0)
        while remaining > 0:
            chunk = self.rfile.read(min(65536, remaining))
            if not chunk:
                break
            remaining -= len(chunk)

    def _sse_headers(self, headers: Dict[str, str]) -> None:
        """Start a text/event-stream answer.  SSE has no content-length,
        so the connection closes when the stream ends (a kept-alive
        connection's next request would hang otherwise)."""
        self.send_response(200)
        self.send_header("content-type", "text/event-stream")
        self.send_header("connection", "close")
        self.close_connection = True
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()

    def _event(self, event: str, payload: dict) -> None:
        self.wfile.write(f"event: {event}\ndata: "
                         f"{json.dumps(payload)}\n\n".encode())

    def _query(self) -> dict:
        q = urllib.parse.urlsplit(self.path).query
        return {k: v[-1] for k, v in urllib.parse.parse_qs(q).items()}

    def do_GET(self):
        srv: RouterServer = self.server.owner
        reg = srv.registry
        path = self.path.split("?", 1)[0]
        if path in ("/health", "/healthz"):
            # a firing burn-rate alert flips the body to "degraded" but
            # stays 200: liveness must not restart a slow-but-serving pod
            slo = reg.get("slo")
            breaches = slo.degraded() if slo is not None else []
            if breaches:
                self._reply(200, {"status": "degraded",
                                  "slo_breaches": breaches})
            else:
                self._reply(200, {"status": "healthy"})
        elif path == "/startup-status":
            if srv.startup is not None:
                self._reply(200, srv.startup.snapshot())
            else:
                self._reply(200, {"ready": srv.ready.is_set(),
                                  "uptime_s": round(
                                      time.time() - srv.started_t, 1)})
        elif path == "/openapi.json":
            self._reply(200, srv.openapi_spec())
        elif path == "/docs":
            from .openapi import DOCS_HTML

            self._reply_text(200, DOCS_HTML, "text/html")
        elif path == "/v1/models":
            self._reply(200, {"object": "list", "data": [
                {"id": m.name, "object": "model",
                 "metadata": {"quality_score": m.quality_score,
                              "modality": m.modality, "tags": m.tags}}
                for m in srv.router.cfg.model_cards]})
        elif path == "/ready":
            ok = srv.ready.is_set()
            self._reply(200 if ok else 503, {
                "ready": ok,
                "uptime_s": round(time.time() - srv.started_t, 1)})
        elif path == "/metrics/external":
            self._reply(200, srv.external_metrics(
                self._query().get("metric", "")))
        elif path == "/metrics/fleet":
            # the live members' published snapshots and the local
            # registry merged, scope and staleness stamped as
            # llm_fleet_* series; merged registries carry no exemplars,
            # so always 0.0.4
            fobs = reg.get("fleetobs")
            if fobs is None:
                self._reply(503, {"error": "no fleet observability plane "
                                           "(observability.fleet.enabled "
                                           "is false)"})
            else:
                self._reply_text(200, fobs.aggregator.exposition()[0],
                                 "text/plain; version=0.0.4")
        elif path in ("/dashboard", "/dashboard/") \
                or path.startswith("/dashboard/static/"):
            # the page and its assets hold code, not data: open; their
            # API calls carry the key the operator types in
            self._dashboard_file(path)
        elif path == "/dashboard/embedmap":
            # served empty: store names and points come from the gated
            # /dashboard/api/embedmap*
            from ..dashboard.embedmap import render_page

            self._reply_text(200, render_page(()), "text/html")
        elif path == "/metrics":
            # exemplars are only legal in OpenMetrics (a 0.0.4 parser
            # rejects the '# {...}' clause and fails the whole scrape):
            # the format and the content type flip with the knob
            if reg.metrics.exemplars_enabled:
                self._reply_text(200, reg.metrics.expose() + "# EOF\n",
                                 "application/openmetrics-text; "
                                 "version=1.0.0; charset=utf-8")
            else:
                self._reply_text(200, reg.metrics.expose(),
                                 "text/plain; version=0.0.4")
        else:
            self._management_get(path)

    def _management_get(self, path: str) -> None:
        """A GET behind the access gate (``view``)."""
        roles = self._authorize()
        if roles is None:
            return
        srv: RouterServer = self.server.owner
        reg = srv.registry
        if path == "/api/v1":
            self._reply(200, API_CATALOG)
        elif path == "/debug/profiler":
            self._reply(200, reg.profiler.status())
        elif path == "/debug/flightrec":
            if self._query().get("source", "") == "fleet":
                # the live siblings' slowest-N summaries merged (full
                # records stay on the owning replica)
                fobs = reg.get("fleetobs")
                if fobs is None:
                    self._reply(503, {"error": "no fleet observability plane "
                                           "(observability.fleet.enabled "
                                           "is false)"})
                else:
                    self._reply(200, fobs.aggregator.flightrec_fleet(
                        reg.flightrec.dump()))
                return
            self._reply(200, reg.flightrec.dump())
        elif path == "/debug/runtime":
            self._reply(200, runtime_debug_report(
                reg, srv.router.engine))
        elif path == "/debug/programs":
            self._reply(200, reg.programstats.report(
                runtime_stats=reg.runtimestats))
        elif path == "/debug/slo":
            slo = reg.get("slo")
            if slo is None:
                self._reply(503, {"error": "no SLO monitor"})
            else:
                self._reply(200, slo.report())
        elif path == "/debug/resilience":
            res = reg.get("resilience")
            if res is None:
                self._reply(503, {"error": "no resilience controller"})
            else:
                rep = res.report()
                up = reg.get("upstreams")
                rep["upstreams"] = up.report() if up is not None \
                    else {"enabled": False}
                self._reply(200, rep)
        elif path == "/debug/upstreams":
            up = reg.get("upstreams")
            if up is None:
                self._reply(503, {"error": "no upstream resilience plane "
                                           "(resilience.upstream.enabled "
                                           "is false)"})
            else:
                self._reply(200, up.report())
        elif path == "/debug/stateplane":
            plane = reg.get("stateplane") or srv.router.stateplane
            if plane is None:
                self._reply(503, {"error": "no state plane "
                                           "(stateplane.enabled is false)"})
            else:
                self._reply(200, plane.report())
        elif path == "/debug/fleet":
            fobs = reg.get("fleetobs")
            if fobs is None:
                self._reply(503, {"error": "no fleet observability plane "
                                           "(observability.fleet.enabled "
                                           "is false)"})
            else:
                self._reply(200, fobs.report())
        elif path == "/debug/flywheel":
            # promotion state, corpus stats, the last train / eval
            # reports, shadow agreement, admission value weights
            fw = reg.get("flywheel")
            if fw is None:
                self._reply(503, {"error": "no flywheel "
                                           "(flywheel.enabled is false)"})
            else:
                self._reply(200, fw.stats())
        elif path == "/info/models":
            self._reply(200, {"tasks": info_models(srv.router.engine)})
        elif path == "/v1/memory":
            store = srv.router.memory_store
            if store is None:
                self._reply(503, {"error": "no memory store"})
                return
            user = self._query().get("user_id", "")
            items = store.list(user) if user else []
            self._reply(200, {"data": [
                {"id": i.id, "user_id": i.user_id, "text": i.text,
                 "kind": i.kind, "created": i.created_t} for i in items]})
        elif path.startswith("/v1/memory/"):
            store = srv.router.memory_store
            item = store.find_by_id(path.rsplit("/", 1)[1]) if store \
                else None
            if item is None:
                self._reply(404, {"error": "memory not found"})
            else:
                self._reply(200, {"id": item.id, "text": item.text,
                                  "kind": item.kind,
                                  "user_id": item.user_id})
        elif path == "/v1/vector_stores":
            mgr = srv.router.vectorstores
            names = mgr.list() if mgr is not None else []
            self._reply(200, {"data": [
                {"id": n, **(mgr.get(n).stats() if mgr.get(n) else {})}
                for n in names]})
        elif path.startswith("/v1/vector_stores/"):
            self._vectorstore_get(path)
        elif path == "/debug/decisions":
            self._decisions(reg.explain)
        elif path.startswith("/debug/decisions/"):
            key = path.rsplit("/", 1)[1]
            ex = reg.explain
            rec = ex.get(key)
            if rec is None and self._query().get("source") == "durable" \
                    and ex.durable_store is not None:
                rec = ex.durable_store.get(key)
            if rec is None:
                self._reply(404, {"error": f"no decision record for "
                                           f"{key!r}"})
            else:
                self._reply(200, rec)
        elif path == "/config/router":
            if srv.api_keys and {"secret_view", "admin"} & roles:
                self._reply(200, srv.cfg.raw)
            else:
                self._reply(200, redact_config(srv.cfg.raw))
        elif path == "/config/hash":
            self._reply(200, {"hash": config_hash(srv.cfg.raw)})
        elif path == "/config/router/versions":
            if srv.version_store is None:
                self._reply(503, {"error": "no config path configured"})
                return
            self._reply(200, {"versions": srv.versions()})
        elif path == "/dashboard/api/config":
            cfg = srv.cfg
            self._reply(200, {
                "hash": config_hash(cfg.raw),
                "decisions": [d.name for d in cfg.decisions],
                "models": [m.name for m in cfg.model_cards],
                "signal_families": cfg.used_signal_types(),
                "config": redact_config(cfg.raw)})
        elif path == "/dashboard/api/config/raw":
            self._config_raw()
        elif path.startswith("/dashboard/api/"):
            self._dashboard(path[len("/dashboard/api/"):])
        else:
            self._reply(404, {"error": "not found"})

    def _vectorstore_get(self, path: str) -> None:
        mgr = self.server.owner.router.vectorstores
        name = path.split("/")[3]
        store = mgr.get(name) if mgr is not None else None
        if store is None:
            self._reply(404, {"error": "vector store not found"})
        elif path.endswith("/files"):
            if hasattr(store, "documents"):
                docs = [{"id": d.id, "name": d.name,
                         "chunks": len(d.chunk_ids)}
                        for d in store.documents.values()]
            else:  # server-side stores (qdrant, milvus) aggregate
                docs = store.list_documents()
            self._reply(200, {"data": docs})
        else:
            self._reply(200, {"id": name, **store.stats()})

    # -- the access gate ----------------------------------------------------
    # The open / management split is the branch order of the do_* methods:
    # the data plane and liveness answer before any ``_authorize``.

    def _roles(self) -> Optional[set]:
        """The presented credential's roles: ``set()`` when no API keys are
        configured (open), None for a missing or unknown key.  The key
        comes as ``x-api-key`` or a bearer token; a dashboard session
        token (two dots) is verified first and, failing that, looked up
        as a key."""
        srv: RouterServer = self.server.owner
        if not srv.api_keys:
            return set()
        h = self._req_headers()
        key = h.get("x-api-key", "")
        auth = h.get("authorization", "")
        if not key and auth.lower().startswith("bearer "):
            key = auth[7:].strip()
        if key.count(".") == 2:
            roles = srv.token_issuer.verify(key)
            if roles is not None:
                return roles
        return srv.roles_for_key(key)

    def _authorize(self, write: bool = False,
                   action: str = "") -> Optional[set]:
        """Gate a management route: ``view`` for reads, ``edit`` for
        mutations (``admin`` holds both); a mutation named by ``action``
        is audited with the caller's roles.  The roles, or None after a
        401 / 403 was sent."""
        roles = self._roles()
        if roles is None:
            self._reply(401, {"error": "missing or invalid API key"})
            return None
        if self.server.owner.api_keys:
            need = "edit" if write else "view"
            if need not in roles and "admin" not in roles:
                self._reply(403, {"error": f"requires role {need!r}"})
                return None
        if action:
            component_event("audit", action, path=self.path.split("?", 1)[0],
                            roles=sorted(roles))
        return roles

    def _decisions(self, ex) -> None:
        """Newest-first decision records, filtered by model / decision /
        rule / family / kind; ``?source=durable`` reads the durable
        mirror, ``?source=fleet`` merges the live replicas' newest record
        summaries (the fleet plane)."""
        q = self._query()
        try:
            limit = int(q.get("limit", "50") or 50)
        except ValueError:
            limit = 50
        if q.get("source", "") == "fleet":
            fobs = self.server.owner.registry.get("fleetobs")
            if fobs is None:
                self._reply(503, {"error": "no fleet observability plane "
                                           "(observability.fleet.enabled "
                                           "is false)"})
            else:
                self._reply(200, fobs.aggregator.decisions_fleet(
                    ex.list(limit=limit)))
            return
        filters = {k: q.get(k, "") for k in ("model", "decision", "rule",
                                              "family", "kind")}
        if q.get("source", "") == "durable":
            store = ex.durable_store
            if store is None:
                self._reply(503, {"error": "no durable decision store"})
                return
            self._reply(200, {"source": "durable",
                              "stats": {"retained": len(store)},
                              "records": store.list(limit=limit,
                                                    **filters)})
            return
        self._reply(200, {"stats": ex.stats(),
                          "records": ex.list(limit=limit, **filters)})

    def _debug_post(self, path: str, body: dict) -> None:
        reg = self.server.owner.registry
        if path == "/debug/flightrec/clear":
            reg.flightrec.clear()
            self._reply(200, {"ok": True})
            return
        action = path.rsplit("/", 1)[1]
        if action == "start":
            out = reg.profiler.start(str(body.get("dir", "")))
        elif action == "stop":
            out = reg.profiler.stop(force=bool(body.get("force")))
        elif action == "xla-dump":
            out = dict(XLA_DUMP_UNSUPPORTED)
        else:
            out = {"error": f"unknown action {action!r}", "status": 404}
        self._reply(out.pop("status", 200), out)

    def do_POST(self):
        path = self.path.split("?", 1)[0]
        data = self._raw_body()
        if path == "/debug/flightrec/clear" \
                or path.startswith("/debug/profiler/"):
            # profiling perturbs the serving process: edit-gated
            if self._authorize(write=True, action="flightrec"
                               if path == "/debug/flightrec/clear"
                               else "profiler") is None:
                return
            try:
                body = json.loads(data or b"{}")
            except json.JSONDecodeError:
                body = {}
            self._debug_post(path, body if isinstance(body, dict) else {})
            return
        if path == "/debug/flywheel/cycle":
            # one flywheel turn (export → train → counterfactual eval →
            # shadow on a win) runs trainers in process: edit-gated and
            # audited like the profiler
            if self._authorize(write=True, action="flywheel") is None:
                return
            fw = self.server.owner.registry.get("flywheel")
            if fw is None:
                self._reply(503, {"error": "no flywheel "
                                           "(flywheel.enabled is false)"})
                return
            try:
                self._reply(200, fw.run_cycle())
            except Exception as exc:
                self._reply(500, {"error": f"{type(exc).__name__}: "
                                           f"{exc}"[:300]})
            return
        gate = _post_gate(path)
        if gate is None:
            self._reply(404, {"error": "not found"})
            return
        try:
            body = json.loads(data or b"{}")
        except json.JSONDecodeError:
            self._reply(400, {"error": {"message": "request body is not JSON"}})
            return
        if gate and self._authorize(*gate) is None:
            return
        if path in ("/v1/chat/completions", "/v1/messages"):
            self._chat(body, anthropic=path == "/v1/messages")
            return
        if path == "/v1/responses":
            self._responses(body)
            return
        try:
            if path.startswith("/api/v1/classify/"):
                self._classify(path.rsplit("/", 1)[1], body)
            elif path == "/api/v1/embeddings":
                self._embeddings(body)
            elif path == "/api/v1/eval":
                self._eval(body)
            elif path == "/api/v1/nli":
                self._nli(body)
            elif path == "/v1/memory":
                self._memory_create(body)
            elif path == "/v1/vector_stores":
                self._vectorstore_create(body)
            elif path in _CONFIG_POSTS:
                getattr(self, _CONFIG_POSTS[path])(body)
            elif path.startswith("/debug/decisions/"):
                self._replay(path.split("/")[3], body)
            elif path.endswith("/search"):
                self._vectorstore_search(path.split("/")[3], body)
            elif path.endswith("/files"):
                self._vectorstore_ingest(path.split("/")[3], body)
            else:
                self._similarity(body)
        except Exception as exc:
            self._reply(500, {"error": {
                "message": f"{type(exc).__name__}: {exc}"}})

    # -- the config management API and the config editor -------------------

    def do_PATCH(self):
        self._config_write(merge=True)

    def do_PUT(self):
        self._config_write(merge=False)

    def _config_write(self, merge: bool) -> None:
        """``PATCH`` (an RFC 7396 merge into the on-disk document) or
        ``PUT`` (the whole document) of ``/config/router``."""
        if self.path.split("?", 1)[0] != "/config/router":
            self._reply(404, {"error": "not found"})
            return
        if self._authorize(write=True, action="config_patch" if merge
                           else "config_put") is None:
            return
        if self.server.owner.version_store is None:
            self._reply(503, {"error": "no config path configured"})
            return
        try:
            doc = json.loads(self._raw_body() or b"{}")
        except json.JSONDecodeError:
            self._reply(400, {"error": {"message": "invalid JSON"}})
            return
        if merge and not isinstance(doc, dict):
            self._reply(400, {"error": {"message":
                                        "a merge patch must be a mapping"}})
            return
        self._config_apply(doc, merge)

    def _config_apply(self, doc: Dict[str, Any], merge: bool,
                      raw_text: Optional[str] = None) -> None:
        """Validate, back up and write a config document (``PATCH`` /
        ``PUT /config/router`` and the editor's deploy); the watcher
        reloads the written file.  The merge reads the ON-DISK document,
        never ``cfg.raw``, whose ``${VAR}`` placeholders hold resolved
        secrets; the whole read-merge-validate-write runs under the
        server's ``config_write_lock``, so concurrent PATCHes serialize.
        A document the validator or the port refuses is answered 400 and
        nothing is written.  ``raw_text`` (deploy): the operator's YAML,
        written verbatim."""
        import yaml

        from ..config.versions import deep_merge

        srv: RouterServer = self.server.owner
        with srv.config_write_lock:
            try:
                with open(srv.version_store.config_path) as f:
                    disk_raw = yaml.safe_load(f) or {}
            except Exception as exc:
                self._reply(500, {"error": {
                    "message": f"cannot read live config: {exc}"}})
                return
            new_raw = deep_merge(disk_raw, doc) if merge else doc
            try:
                _, fatal, _w = _resolve_and_validate(new_raw)
            except Exception as exc:
                self._reply(400, {"error": {
                    "message": f"invalid config: {exc}"}})
                return
            if fatal:
                self._reply(400, {"error": {"message": "invalid config",
                                            "details": fatal}})
                return
            version = srv.version_store.snapshot()
            if raw_text is not None and not merge:
                srv.version_store.write_live_text(raw_text)
            else:
                srv.version_store.write_live(new_raw)
        self._reply(200, {"applied": True,
                          "backup_version": version.version_id,
                          "hash": config_hash(new_raw),
                          "note": "hot-reload watcher applies the new "
                                  "config within its poll interval"})

    def _config_rollback(self, body: dict) -> None:
        srv: RouterServer = self.server.owner
        if srv.version_store is None:
            self._reply(503, {"error": "no config path configured"})
            return
        version = str(body.get("version", ""))
        # serialized with PATCH / PUT: a concurrent merge must not
        # clobber the restored version
        with srv.config_write_lock:
            ok = srv.version_store.rollback(version)
        if ok:
            self._reply(200, {"rolled_back_to": version})
        else:
            self._reply(404, {"error": f"version {version!r} not found"})

    def _config_raw(self) -> None:
        """The editor's source: the ON-DISK document (placeholders
        unresolved) and the kept versions.  The file may hold inline
        secrets, so it takes ``secret_view`` (or ``admin``) as well as
        ``edit``."""
        srv: RouterServer = self.server.owner
        roles = self._authorize(write=True, action="config_raw")
        if roles is None:
            return
        if srv.api_keys and not {"secret_view", "admin"} & roles:
            self._reply(403, {"error": "config_raw requires the "
                                       "secret_view role"})
            return
        if srv.version_store is None:
            self._reply(503, {"error": "no config path configured"})
            return
        try:
            with open(srv.version_store.config_path) as f:
                text = f.read()
        except OSError as exc:
            self._reply(500, {"error": str(exc)})
            return
        self._reply(200, {"yaml": text,
                          "path": srv.version_store.config_path,
                          "versions": srv.versions()})

    def _config_validate(self, body: dict) -> None:
        """The editor's dry run: parse, substitute, parse the schema and
        validate, nothing written.  Substitution runs against an EMPTY
        environment (a placeholder becomes its default, else ""): the
        process's environment holds secrets, and names or messages echoed
        from resolved values would hand them to a view-role key."""
        doc, err = _parse_yaml_mapping(str(body.get("yaml", "")))
        if err is not None:
            self._reply(200, {"ok": False, "errors": [err]})
            return
        try:
            candidate, fatal, warnings = _resolve_and_validate(doc, env={})
        except Exception as exc:
            self._reply(200, {"ok": False, "errors": [
                f"{type(exc).__name__}: {exc}"[:500]]})
            return
        self._reply(200, {
            "ok": not fatal, "errors": fatal, "warnings": warnings,
            "hash": config_hash(doc),
            "decisions": [d.name for d in candidate.decisions],
            "models": [m.name for m in candidate.model_cards]})

    def _config_deploy(self, body: dict) -> None:
        """The editor's deploy: the gate and the write path of ``PUT
        /config/router``, with the operator's YAML kept verbatim."""
        if self.server.owner.version_store is None:
            self._reply(503, {"error": "no config path configured"})
            return
        text = str(body.get("yaml", ""))
        doc, err = _parse_yaml_mapping(text)
        if err is not None:
            self._reply(400, {"error": {"message": err}})
            return
        self._config_apply(doc, merge=False, raw_text=text)

    def _dsl_compile(self, body: dict) -> None:
        from ..dsl.compiler import DSLCompileError, compile_dsl, emit_yaml
        from ..dsl.parser import DSLSyntaxError

        try:
            compiled = compile_dsl(str(body.get("dsl", "")),
                                   validate=not body.get("skip_validate"))
        except (DSLCompileError, DSLSyntaxError, ValueError) as exc:
            self._reply(422, {"ok": False, "error": str(exc)[:500]})
            return
        self._reply(200, {
            "ok": True, "yaml": emit_yaml(compiled),
            "decisions": [d.name for d in compiled.decisions],
            "signal_families": compiled.used_signal_types()})

    def _dsl_decompile(self, body: dict) -> None:
        from ..dsl.compiler import decompile

        try:
            # the dict as given: a YAML round trip would substitute
            # literal ${VAR} strings
            cfg = RouterConfig.from_dict(body.get("config") or {})
            self._reply(200, {"ok": True, "dsl": decompile(cfg)})
        except Exception as exc:
            self._reply(422, {"ok": False, "error": str(exc)[:500]})

    def _login(self, body: dict) -> None:
        """An API key for a short-lived dashboard session token."""
        srv: RouterServer = self.server.owner
        if not srv.api_keys:
            self._reply(200, {"token": "", "open": True, "roles": []})
            return
        found = srv.roles_for_key(str(body.get("api_key", "")))
        if found is None:
            self._reply(401, {"error": "invalid API key"})
            return
        self._reply(200, {"token": srv.token_issuer.issue(found),
                          "roles": sorted(found),
                          "expires_in_s": srv.token_issuer.ttl_s})

    # -- the dashboard ------------------------------------------------------

    def _dashboard_file(self, path: str) -> None:
        """The bundled page, or one of its assets: the basename of the
        path, and only a ``.js`` or ``.css`` one (no traversal)."""
        import os

        root = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "dashboard")
        if path.startswith("/dashboard/static/"):
            name = os.path.basename(path)
            ctype = {".js": "text/javascript",
                     ".css": "text/css"}.get(os.path.splitext(name)[1])
            if ctype is None:
                self._reply(404, {"error": "not found"})
                return
            fname, missing = os.path.join(root, "static", name), \
                {"error": "not found"}
        else:
            fname, ctype, missing = os.path.join(root, "index.html"), \
                "text/html", {"error": "dashboard not bundled"}
        try:
            with open(fname, encoding="utf-8") as f:
                self._reply_text(200, f.read(), ctype)
        except (OSError, ValueError):
            self._reply(404, missing)

    def _dashboard(self, sub: str) -> None:
        """``/dashboard/api/{sub}``: the router's own series (an embedded
        router's registry, not the process's), the replay store, the
        embedding map, the event bus and the jobs."""
        srv: RouterServer = self.server.owner
        router = srv.router
        M = router.M
        if sub == "overview":
            cache_stats = {}
            if router.cache is not None:
                st = router.cache.stats()
                cache_stats = {"hits": st.hits, "misses": st.misses,
                               "entries": st.entries,
                               "hit_rate": round(st.hit_rate, 4)}
            sessions = srv.registry.get("sessions")
            self._reply(200, {
                "uptime_s": round(time.time() - srv.started_t, 1),
                "requests_total": M.model_requests.total(),
                "requests_by_model": {
                    dict(k).get("model", "?"): v for k, v in
                    M.model_requests.values().items()},
                "decisions": {
                    dict(k).get("name", "?"): v for k, v in
                    M.decision_matches.values().items()},
                "routing_latency": M.routing_latency.summary(),
                "completion_latency": M.completion_latency.summary(),
                "cost_total": round(M.model_cost.total(), 6),
                "cache": cache_stats,
                "sessions": sessions.count() if sessions is not None else 0,
                "blocks": {"jailbreak": M.jailbreak_blocks.total(),
                           "pii": M.pii_violations.total()},
            })
        elif sub == "signals":
            self._reply(200, {
                "latency": {dict(k).get("family", "?"): {"count": v}
                            for k, v in M.signal_latency.totals().items()},
                "summary": M.signal_latency.summary(),
            })
        elif sub == "replay" and router.replay_store is None:
            self._reply(200, {"records": []})
        elif sub in ("replay", "events"):
            try:
                limit = int(self._query().get("limit", "50"))
            except ValueError:
                self._reply(400, {"error": "limit must be an integer"})
                return
            if sub == "events":
                bus = srv.registry.get("events")
                self._reply(200, {"events": [
                    e.public() for e in (bus.recent(
                        limit, self._query().get("stage", ""))
                        if bus is not None else [])]})
                return
            self._reply(200, {"records": [
                {"id": r.record_id, "ts": r.timestamp,
                 "decision": r.decision, "model": r.model, "kind": r.kind,
                 "latency_ms": r.routing_latency_ms,
                 "matched_rules": r.matched_rules}
                for r in router.replay_store.list(limit=limit)]})
        elif sub == "embedmap":
            self._embedmap()
        elif sub == "embedmap/sources":
            self._reply(200, {"sources": self._embedmap_sources()})
        elif sub == "jobs":
            self._reply(200, {"kinds": srv.jobs.kinds(),
                              "jobs": [j.public()
                                       for j in srv.jobs.store.list()]})
        elif sub.startswith("jobs/"):
            job = srv.jobs.store.get(sub.split("/", 1)[1])
            if job is None:
                self._reply(404, {"error": "no such job"})
            else:
                self._reply(200, job.public())
        else:
            self._reply(404, {"error": "not found"})

    def _embedmap_sources(self) -> list:
        mgr = self.server.owner.router.vectorstores
        return ["cache", "memory"] + (
            [f"vectorstore:{n}" for n in mgr.list()] if mgr is not None
            else [])

    def _embedmap(self) -> None:
        """The 2-D map of ``?source=`` (cache, memory, vectorstore:NAME):
        its (text, embedding) pairs, projected on the host."""
        from ..dashboard.embedmap import build_map

        router = self.server.owner.router
        source = self._query().get("source", "cache")
        items = []
        if source == "cache":
            entries = getattr(router.cache, "_entries", {}) \
                if router.cache is not None else {}
            items = [(e.query, e.embedding) for e in list(entries.values())]
        elif source == "memory":
            store = router.memory_store
            if store is not None and hasattr(store, "list_all"):
                try:
                    items = [(m.text, m.embedding)
                             for m in store.list_all()]
                except Exception:
                    items = []
        elif source.startswith("vectorstore:"):
            mgr = router.vectorstores
            store = mgr.get(source.split(":", 1)[1]) if mgr is not None \
                else None
            chunks = getattr(store, "chunks", {}) if store else {}
            items = [(c.text, c.embedding) for c in list(chunks.values())]
        else:
            self._reply(400, {"error": f"unknown source {source!r}"})
            return
        self._reply(200, build_map(items))

    def _playground(self, body: dict) -> None:
        """What the router would do with a request, without forwarding
        it: the route's kind, model, decision, matched rules, selection
        reason, looper algorithm, signals (eight matches a family, with
        confidences), headers and routing latency."""
        req = dict(body)
        req.setdefault("model", "auto")
        res = self.server.owner.router.route(req)
        signals = {}
        if res.signals is not None:
            signals = {
                family: {
                    "matches": list(names)[:8],
                    "confidences": {
                        n: round(res.signals.confidences.get(
                            f"{family}:{n}", 1.0), 4)
                        for n in list(names)[:8]},
                }
                for family, names in res.signals.matches.items()}
        self._reply(200, {
            "kind": res.kind,
            "model": res.model,
            "decision": res.decision.decision.name if res.decision else "",
            "matched_rules": list(res.decision.matched_rules)
            if res.decision else [],
            "selection_reason": res.selection_reason,
            "looper_algorithm": res.looper_algorithm,
            "signals": signals,
            "headers": res.headers,
            "routing_latency_ms": round(res.routing_latency_s * 1e3, 3),
        })

    def _job_submit(self, body: dict) -> None:
        jobs = self.server.owner.jobs
        try:
            job = jobs.submit(str(body.get("kind", "")),
                              body.get("params") or {})
        except KeyError as exc:
            self._reply(400, {"error": str(exc), "kinds": jobs.kinds()})
            return
        self._reply(202, job.public())

    def _replay(self, key: str, body: dict) -> None:
        """The counterfactual re-drive of decision record ``key`` under the
        live config, or the candidate one in ``body["config"]``, with its
        diff against the record."""
        from ..replay import replay_decision, replay_diff

        srv: RouterServer = self.server.owner
        rec = srv.registry.explain.get(key)
        if rec is None:
            self._reply(404, {"error": f"no decision record for {key!r}"})
            return
        cfg2, basis = srv.cfg, "live config"
        if body.get("config"):
            try:
                cfg2 = RouterConfig.from_dict(body["config"])
                basis = "candidate config"
            except Exception as exc:
                self._reply(422, {"error": f"bad config: {exc}"[:500]})
                return
        try:
            replayed = replay_decision(rec, cfg2)
        except Exception as exc:
            self._reply(500, {"error": f"replay failed: "
                                       f"{type(exc).__name__}: {exc}"[:500]})
            return
        recorded = rec.get("decision") or {}
        self._reply(200, {
            "record_id": rec["record_id"],
            "config_basis": basis,
            "recorded": {"decision": recorded.get("name"),
                         "model": rec.get("model", ""),
                         "matched_rules": recorded.get("matched_rules", [])},
            "replayed": replayed,
            **replay_diff(rec, replayed)})

    # -- the Classification API --------------------------------------------

    def _classify(self, task: str, body: dict) -> None:
        eng = self.server.owner.router.engine
        if eng is None:
            self._reply(503, {"error": "no inference engine"})
            return
        if task == "batch":
            results = eng.classify_batch(body.get("task", "intent"),
                                         body.get("texts", []))
            self._reply(200, {"results": [
                dict({"label": r.label, "confidence": r.confidence},
                     **({"truncated": True} if r.truncated else {}))
                for r in results]})
            return
        if task == "combined":
            text = body.get("text", "")
            out = {}
            for api_name, engine_task in CLASSIFY_TASKS.items():
                if not eng.has_task(engine_task):
                    continue
                if engine_task == "pii":
                    r = eng.token_classify(engine_task, text)
                    out[api_name] = {"entities": [e.__dict__
                                                  for e in r.entities]}
                else:
                    r = eng.classify(engine_task, text)
                    out[api_name] = {"label": r.label, "class_idx": r.index,
                                     "confidence": r.confidence}
            self._reply(200, out)
            return
        engine_task = CLASSIFY_TASKS.get(task, task)
        if not eng.has_task(engine_task):
            self._reply(404, {"error": f"task {engine_task!r} not loaded"})
            return
        text = body.get("text", "")
        if engine_task == "pii":
            r = eng.token_classify(engine_task, text)
            resp = {"entities": [e.__dict__ for e in r.entities]}
        else:
            if body.get("windowed"):
                r = eng.classify_windowed(engine_task, text,
                                          stride=int(body.get("stride", 64)))
            else:
                r = eng.classify(engine_task, text)
            resp = {"label": r.label, "class_idx": r.index,
                    "confidence": r.confidence, "probs": r.probs}
        if r.truncated:
            # the model never saw the input's tail: a consumer reading
            # "no entities" or a label as covering all of it must see this
            resp["truncated"] = True
        self._reply(200, resp)

    def _embeddings(self, body: dict) -> None:
        router = self.server.owner.router
        eng = router.engine
        task = body.get("model", EMBEDDING_TASK)
        if eng is None or not eng.has_task(task):
            self._reply(503, {"error": "embedding task not loaded"})
            return
        texts = body.get("input")
        if isinstance(texts, str):
            texts = [texts]
        embs = eng.embed(task, texts, output_dim=body.get("dimensions"))
        self._reply(200, {"object": "list", "data": [
            {"object": "embedding", "index": i, "embedding": e.tolist()}
            for i, e in enumerate(embs)]})

    def _similarity(self, body: dict) -> None:
        router = self.server.owner.router
        eng = router.engine
        task = EMBEDDING_TASK
        if eng is None or not eng.has_task(task):
            self._reply(503, {"error": "embedding task not loaded"})
            return
        pairs = body.get("pairs")
        if pairs:
            out = []
            for p in pairs:
                e = eng.embed(task, [p.get("text_a", ""),
                                     p.get("text_b", "")])
                out.append(float(e[0] @ e[1]))
            self._reply(200, {"similarities": out})
            return
        a = body.get("text_a") or body.get("text1", "")
        b = body.get("text_b") or body.get("text2", "")
        e = eng.embed(task, [a, b])
        self._reply(200, {"similarity": float(e[0] @ e[1])})

    def _eval(self, body: dict) -> None:
        """Every configured signal family and decision for one text: each
        family's matches, confidences, kb metrics, latency and error."""
        from ..signals.base import RequestContext

        router = self.server.owner.router
        ctx = RequestContext.from_openai_body(
            {"messages": [{"role": "user", "content": body.get("text", "")}]})
        signals, report = router.dispatcher.evaluate(ctx)
        decisions = router.decision_engine.evaluate_all(signals)
        kb_metrics: dict = {}
        for r in report.results.values():
            if r.metrics:
                kb_metrics.update(r.metrics)
        self._reply(200, {
            "signals": {t: list(names)
                        for t, names in signals.matches.items()},
            "confidences": dict(signals.confidences),
            "kb_metrics": kb_metrics,
            "families": {t: {"latency_ms": round(r.latency_s * 1e3, 3),
                             "error": r.error}
                         for t, r in report.results.items()},
            "decisions": [{"name": d.decision.name,
                           "confidence": round(d.confidence, 4),
                           "matched_rules": d.matched_rules}
                          for d in decisions]})

    def _nli(self, body: dict) -> None:
        eng = self.server.owner.router.engine
        if eng is None or not eng.has_task("nli"):
            self._reply(503, {"error": "nli task not loaded"})
            return
        r = eng.classify("nli", f"{body.get('premise', '')}\n[SEP]\n"
                                f"{body.get('hypothesis', '')}")
        self._reply(200, {"label": r.label, "confidence": r.confidence,
                          "probs": r.probs})

    def _memory_create(self, body: dict) -> None:
        store = self.server.owner.router.memory_store
        if store is None:
            self._reply(503, {"error": "no memory store"})
            return
        item = store.remember(str(body.get("user_id", "")),
                              str(body.get("text", "")),
                              kind=str(body.get("kind", "fact")))
        self._reply(200, {"id": item.id, "text": item.text})

    def _vectorstore_create(self, body: dict) -> None:
        mgr = self.server.owner.router.vectorstores
        if mgr is None:
            self._reply(503, {"error": "no vectorstore manager"})
            return
        name = str(body.get("name", ""))
        if not name:
            self._reply(400, {"error": "name required"})
            return
        try:
            mgr.create(name)
        except ValueError as exc:
            self._reply(409, {"error": str(exc)})
            return
        self._reply(200, {"id": name})

    def _vectorstore_search(self, name: str, body: dict) -> None:
        mgr = self.server.owner.router.vectorstores
        store = mgr.get(name) if mgr is not None else None
        if store is None:
            self._reply(404, {"error": "vector store not found"})
            return
        hits = store.search(str(body.get("query", "")),
                            top_k=int(body.get("top_k", 5)),
                            threshold=float(body.get("threshold", 0.0)))
        self._reply(200, {"data": [
            {"text": h.chunk.text, "score": round(h.score, 4),
             "document_id": h.chunk.document_id,
             "metadata": h.chunk.metadata} for h in hits]})

    def _vectorstore_ingest(self, name: str, body: dict) -> None:
        mgr = self.server.owner.router.vectorstores
        if mgr is None:
            self._reply(503, {"error": "no vectorstore manager"})
            return
        store = mgr.get(name) or mgr.get_or_create(name)
        doc = store.ingest(str(body.get("name", "file")),
                           str(body.get("text", "")),
                           metadata=body.get("metadata"))
        mgr.record_file(name, doc)
        self._reply(200, {"id": doc.id, "chunks": len(doc.chunk_ids)})

    def do_DELETE(self):
        path = self.path.split("?", 1)[0]
        if path.startswith("/v1/vector_stores/"):
            if self._authorize(write=True,
                               action="vectorstore_delete") is not None:
                self._vectorstore_delete(path)
            return
        if not path.startswith("/v1/memory"):
            self._reply(404, {"error": "not found"})
            return
        if self._authorize(write=True, action="memory_delete") is None:
            return
        store = self.server.owner.router.memory_store
        if store is None:
            self._reply(503, {"error": "no memory store"})
            return
        user = self._query().get("user_id", "")
        if path == "/v1/memory":  # the user's whole scope
            n = sum(bool(store.delete(user, item.id))
                    for item in list(store.list(user)))
            self._reply(200, {"deleted": n})
            return
        mid = path.rsplit("/", 1)[1]
        if not user:  # the owner, found by id
            item = store.find_by_id(mid)
            user = item.user_id if item else ""
        ok = store.delete(user, mid) if user else False
        self._reply(200 if ok else 404, {"deleted": bool(ok)})

    def _vectorstore_delete(self, path: str) -> None:
        """``/v1/vector_stores/{id}`` drops the store,
        ``/v1/vector_stores/{id}/files/{file_id}`` one document."""
        mgr = self.server.owner.router.vectorstores
        if mgr is None:
            self._reply(503, {"error": "no vectorstore manager"})
            return
        parts = path.split("/")
        if len(parts) >= 6 and parts[4] == "files":
            store = mgr.get(parts[3])
            ok = store.delete_document(parts[5]) if store else False
        else:
            ok = mgr.delete(parts[3])
        self._reply(200 if ok else 404, {"deleted": bool(ok)})

    # -- chat ----------------------------------------------------------------

    def _chat(self, body: dict, anthropic: bool) -> None:
        """A chat turn, OpenAI-shaped or (``anthropic``) a Messages
        request translated in and its answer translated back."""
        srv: RouterServer = self.server.owner
        router = srv.router
        req_headers = self._req_headers()
        openai_body = anthropic_to_openai(body) if anthropic else body
        result = router.route(openai_body, req_headers)
        if result.kind in ("cache_hit", "blocked", "rate_limited", "shed") \
                or result.response_body is not None:
            payload = result.response_body
            if anthropic and result.status == 200 and payload \
                    and "choices" in payload:
                payload = openai_to_anthropic_response(payload)
            self._reply(result.status, payload, result.headers)
            return
        # a looper-marked request is one of the looper's own fan-out calls
        # coming back: served single-model, never fanned out again
        is_looper_call = req_headers.get(H.LOOPER, "").lower() in (
            "1", "true")
        if result.looper_algorithm and result.decision is not None \
                and not is_looper_call:
            self._looper_chat(result, req_headers, anthropic)
            return
        # an image_generation decision runs on an image backend and
        # answers as a chat completion
        plugin = result.decision.decision.plugin("image_generation") \
            if result.decision is not None else None
        if plugin is not None and plugin.enabled:
            self._image_generation(result, plugin.configuration, anthropic,
                                   req_headers)
            return
        try:
            fwd_headers = srv.upstream_headers(result, req_headers)
        except PermissionError as exc:
            self._reply(403, {"error": {"message": str(exc),
                                        "type": "authz_error"}},
                        result.headers)
            return
        if result.body.get("stream"):
            # a stream pins one endpoint (no failover mid-stream), the
            # first whose circuit is not open
            backend = srv._pick_stream_backend(result.model)
            if not backend:
                self._reply(502, {"error": {
                    "message": f"no backend for model {result.model!r}",
                    "type": "backend_error"}}, result.headers)
                return
            token = default_tracker.begin(result.model)
            try:
                self._stream_chat(result, backend, fwd_headers, anthropic)
            finally:
                default_tracker.end(result.model, token)
            return
        t0 = time.perf_counter()
        token = default_tracker.begin(result.model)
        try:
            status, data, _, path = srv._forward_resilient(
                result, fwd_headers, req_headers)
        finally:
            default_tracker.end(result.model, token)
        latency_ms = (time.perf_counter() - t0) * 1e3
        failover_headers = srv._annotate_failover(result, path)
        reply = _parse_upstream(data)
        if status != 200:
            router.record_feedback(result, success=False,
                                   latency_ms=latency_ms)
            self._reply(status, reply, result.headers)
            return
        processed = router.process_response(result, reply)
        router.record_feedback(result, success=True, latency_ms=latency_ms)
        self._record_session(result, reply, req_headers)
        payload = processed.body
        if anthropic:
            payload = openai_to_anthropic_response(payload)
        self._reply(200, payload, {**result.headers, **failover_headers,
                                   **processed.headers})

    def _image_generation(self, route, conf: Dict[str, Any],
                          anthropic: bool,
                          req_headers: Dict[str, str]) -> None:
        """Generate on the decision's image backend: a 502
        ``imagegen_error`` when the backend cannot be built or its call
        fails; else the image as a chat completion (Anthropic-shaped for
        ``/v1/messages``, one SSE chunk then ``[DONE]`` when the body
        streams) with ``x-vsr-image-backend``, fed back and recorded as
        a session turn."""
        from ..signals.base import RequestContext
        from .imagegen import GenerateRequest, image_chat_completion

        srv: RouterServer = self.server.owner
        try:
            backend = srv._imagegen_backend(route.decision.decision.name,
                                            conf)
        except ValueError as exc:
            self._reply(502, {"error": {"message": str(exc),
                                        "type": "imagegen_error"}},
                        route.headers)
            return
        prompt = RequestContext.from_openai_body(route.body or {}).user_text
        req = GenerateRequest(
            prompt=prompt, model=conf.get("model", ""),
            width=int(conf.get("width", 1024)),
            height=int(conf.get("height", 1024)),
            num_inference_steps=int(conf.get("num_inference_steps", 0)),
            guidance_scale=float(conf.get("guidance_scale", 0.0)),
            quality=conf.get("quality", ""), style=conf.get("style", ""))
        t0 = time.perf_counter()
        try:
            result = backend.generate(req)
        except Exception as exc:
            srv.router.record_feedback(
                route, success=False,
                latency_ms=(time.perf_counter() - t0) * 1e3)
            self._reply(502, {"error": {
                "message": f"image generation failed: {exc}",
                "type": "imagegen_error"}}, route.headers)
            return
        payload = image_chat_completion(result, prompt)
        srv.router.record_feedback(
            route, success=True, latency_ms=(time.perf_counter() - t0) * 1e3)
        self._record_session(route, payload, req_headers)
        out_headers = dict(route.headers)
        out_headers["x-vsr-image-backend"] = result.backend
        if anthropic:
            self._reply(200, openai_to_anthropic_response(payload),
                        out_headers)
            return
        if (route.body or {}).get("stream"):
            self._sse_headers(out_headers)
            chunk = {"id": payload["id"], "object": "chat.completion.chunk",
                     "created": payload["created"], "model": payload["model"],
                     "choices": [{"index": 0, "delta": {
                         "role": "assistant",
                         "content": payload["choices"][0]["message"][
                             "content"]},
                         "finish_reason": "stop"}]}
            self.wfile.write(f"data: {json.dumps(chunk)}\n\n".encode())
            self.wfile.write(b"data: [DONE]\n\n")
            return
        self._reply(200, payload, out_headers)

    def _record_session(self, route, resp: dict,
                        headers: Dict[str, str]) -> None:
        """Session telemetry after an answered turn: turns, tokens, cost
        and model transitions of the session the conversation derives.
        Telemetry never fails a request."""
        sessions = self.server.owner.registry.get("sessions")
        if sessions is None:
            return
        try:
            usage = resp.get("usage") or {}
            card = self.server.owner.router.model_cards.get(route.model)
            cost = usage_cost(usage, (card.pricing if card else {}) or {})
            category = ""
            if route.signals:
                category = next(iter(
                    route.signals.matches.get("domain", ())), "")
            sessions.record_turn(
                (route.body or {}).get("messages", []), route.model,
                user_id=headers.get("x-authz-user-id",
                                    (route.body or {}).get("user", "")),
                prompt_tokens=usage.get("prompt_tokens", 0),
                completion_tokens=usage.get("completion_tokens", 0),
                cost=cost, domain=category)
        except Exception:
            pass

    def _open_stream(self, route, backend: str, body: dict,
                     fwd_headers: Dict[str, str]):
        """POST a streaming request to ``backend``: (the open response,
        t0), or (None, t0) once an error answer went to the client (the
        backend's own status and payload on an HTTP error, 502 when it
        cannot be reached) and the failure was fed back."""
        srv: RouterServer = self.server.owner
        req = urllib.request.Request(backend + "/v1/chat/completions",
                                     data=json.dumps(body).encode(),
                                     method="POST")
        req.add_header("content-type", "application/json")
        for k, v in fwd_headers.items():
            if k.lower() not in _HOP_BY_HOP:
                req.add_header(k, v)
        t0 = time.perf_counter()
        try:
            upstream = urllib.request.urlopen(req,
                                              timeout=srv.forward_timeout_s)
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read() or b"{}")
            except json.JSONDecodeError:
                payload = {"error": {"message": str(e)}}
            srv.router.record_feedback(
                route, success=False,
                latency_ms=(time.perf_counter() - t0) * 1e3)
            srv._note_stream_outcome(route.model, backend, e.code < 500,
                                     time.perf_counter() - t0,
                                     kind="5xx" if e.code >= 500 else "ok")
            self._reply(e.code, payload, route.headers)
            return None, t0
        except Exception as exc:
            srv.router.record_feedback(
                route, success=False,
                latency_ms=(time.perf_counter() - t0) * 1e3)
            srv._note_stream_outcome(route.model, backend, False,
                                     time.perf_counter() - t0)
            self._reply(502, {"error": {
                "message": f"backend unreachable: {exc}",
                "type": "backend_error"}}, route.headers)
            return None, t0
        srv._note_stream_outcome(route.model, backend, True,
                                 time.perf_counter() - t0)
        return upstream, t0

    def _stream_chat(self, route, backend: str, fwd_headers: Dict[str, str],
                     anthropic: bool) -> None:
        """Relay the backend's SSE answer frame by frame (re-synthesized
        as Anthropic events for ``/v1/messages``), time its first token,
        and run the response path on the assembled text once the stream
        completed; a truncated or aborted stream is never cached."""
        srv: RouterServer = self.server.owner
        upstream, t0 = self._open_stream(route, backend, route.body,
                                         fwd_headers)
        if upstream is None:
            return
        self._sse_headers(route.headers)
        chunks: list = []
        ttft_ms = 0.0
        aborted = finished = False

        def iter_chunks():
            nonlocal ttft_ms, finished
            while True:
                line = upstream.readline()
                if not line:
                    break
                if not line.startswith(b"data:"):
                    continue
                payload = line[5:].strip()
                if payload == b"[DONE]":
                    finished = True
                    break
                try:
                    chunk = json.loads(payload)
                except json.JSONDecodeError:
                    continue
                if not ttft_ms:
                    ttft_ms = (time.perf_counter() - t0) * 1e3
                chunks.append(chunk)
                if any((c.get("finish_reason") or "")
                       for c in chunk.get("choices", ())):
                    finished = True
                yield chunk

        try:
            if anthropic:
                for event, payload in openai_sse_to_anthropic_events(
                        iter_chunks()):
                    self._event(event, payload)
            else:
                for chunk in iter_chunks():
                    self.wfile.write(
                        f"data: {json.dumps(chunk)}\n\n".encode())
                self.wfile.write(b"data: [DONE]\n\n")
        except Exception:
            # the client left or the backend stalled: the SSE headers are
            # on the wire, so stop writing (never a second answer)
            aborted = True
        finally:
            upstream.close()
        latency_ms = (time.perf_counter() - t0) * 1e3
        if aborted or not finished:
            srv.router.record_feedback(route, success=False,
                                       latency_ms=latency_ms,
                                       ttft_ms=ttft_ms)
            return
        text = "".join((c.get("choices") or [{}])[0].get("delta", {})
                       .get("content") or "" for c in chunks)
        usage = next((c.get("usage") for c in reversed(chunks)
                      if c.get("usage")), {})
        final = {"choices": [{"message": {"role": "assistant",
                                          "content": text},
                              "finish_reason": "stop"}],
                 "usage": usage or {}}
        srv.router.process_response(route, final)
        srv.router.record_feedback(route, success=True,
                                   latency_ms=latency_ms, ttft_ms=ttft_ms)

    # -- the Responses API ---------------------------------------------------

    def _responses(self, body: dict) -> None:
        """``POST /v1/responses``: translate to a chat request (with the
        stored conversation of ``previous_response_id``), route, forward,
        translate back and store."""
        srv: RouterServer = self.server.owner
        router = srv.router
        req_headers = self._req_headers()
        chat_body = responses_to_chat(body, srv.response_store)
        result = router.route(chat_body, req_headers)
        if result.kind in ("cache_hit", "blocked", "rate_limited", "shed") \
                or result.response_body is not None:
            payload = result.response_body
            if result.status == 200 and payload and "choices" in payload:
                payload = chat_to_response(payload, body,
                                           chat_request=result.body,
                                           store=srv.response_store)
                if body.get("stream"):
                    # an SSE client gets an event sequence, never a bare
                    # JSON body
                    self._oneshot_response_sse(payload, result.headers)
                    return
            self._reply(result.status, payload, result.headers)
            return
        if result.looper_algorithm and result.decision is not None \
                and req_headers.get(H.LOOPER, "").lower() not in (
                    "1", "true"):
            self._looper_chat(result, req_headers, anthropic=False,
                              responses_request=body)
            return
        try:
            fwd_headers = srv.upstream_headers(result, req_headers)
        except PermissionError as exc:
            self._reply(403, {"error": {"message": str(exc),
                                        "type": "authz_error"}},
                        result.headers)
            return
        if body.get("stream"):
            backend = srv._pick_stream_backend(result.model)
            if not backend:
                self._reply(502, {"error": {
                    "message": f"no backend for model {result.model!r}",
                    "type": "backend_error"}}, result.headers)
                return
            self._stream_responses(result, backend, fwd_headers, body)
            return
        t0 = time.perf_counter()
        status, data, _, path = srv._forward_resilient(result, fwd_headers,
                                                       req_headers)
        latency_ms = (time.perf_counter() - t0) * 1e3
        failover_headers = srv._annotate_failover(result, path)
        reply = _parse_upstream(data)
        if status != 200:
            router.record_feedback(result, success=False,
                                   latency_ms=latency_ms)
            self._reply(status, reply, result.headers)
            return
        processed = router.process_response(result, reply)
        router.record_feedback(result, success=True, latency_ms=latency_ms)
        out = chat_to_response(processed.body, body,
                               chat_request=result.body,
                               store=srv.response_store)
        self._reply(200, out, {**result.headers, **failover_headers,
                               **processed.headers})

    def _oneshot_response_sse(self, response_obj: dict,
                              headers: Dict[str, str]) -> None:
        """A finished response object as the whole event sequence
        (created → item added → part added → delta → text done → part
        done → item done → completed): SDK accumulators key deltas on the
        announced item."""
        self._sse_headers(headers)
        text = response_obj.get("output_text", "")
        item_id = f"msg_{uuid.uuid4().hex[:16]}"
        part = {"type": "output_text", "text": text, "annotations": []}
        where = {"item_id": item_id, "output_index": 0, "content_index": 0}
        events = [
            ("response.created", {
                "type": "response.created",
                "response": {**response_obj, "status": "in_progress",
                             "output": []}}),
            ("response.output_item.added", {
                "type": "response.output_item.added", "output_index": 0,
                "item": {"type": "message", "id": item_id,
                         "role": "assistant", "status": "in_progress",
                         "content": []}}),
            ("response.content_part.added", {
                "type": "response.content_part.added", **where,
                "part": {"type": "output_text", "text": "",
                         "annotations": []}}),
            ("response.output_text.delta", {
                "type": "response.output_text.delta", **where,
                "delta": text}),
            ("response.output_text.done", {
                "type": "response.output_text.done", **where,
                "text": text}),
            ("response.content_part.done", {
                "type": "response.content_part.done", **where,
                "part": part}),
            ("response.output_item.done", {
                "type": "response.output_item.done", "output_index": 0,
                "item": {"type": "message", "id": item_id,
                         "role": "assistant", "status": "completed",
                         "content": [part]}}),
            ("response.completed", {"type": "response.completed",
                                    "response": response_obj}),
        ]
        try:
            for event, payload in events:
                self._event(event, payload)
        except Exception:
            pass

    def _stream_responses(self, route, backend: str,
                          fwd_headers: Dict[str, str],
                          request_body: dict) -> None:
        """A streamed Responses turn: the backend's chat SSE chunks become
        the response.* event sequence; an upstream that dies mid-answer
        ends it with ``response.incomplete`` carrying the partial text,
        and nothing is stored or cached."""
        srv: RouterServer = self.server.owner
        upstream_body = dict(route.body)
        upstream_body["stream"] = True
        # without include_usage an OpenAI-compatible backend sends no
        # usage chunk
        upstream_body.setdefault("stream_options", {})
        upstream_body["stream_options"].setdefault("include_usage", True)
        upstream, t0 = self._open_stream(route, backend, upstream_body,
                                         fwd_headers)
        if upstream is None:
            return
        self._sse_headers(route.headers)
        finished = False

        def iter_chunks():
            nonlocal finished
            while True:
                try:
                    line = upstream.readline()
                except OSError:
                    break  # a reset mid-answer reads as its end
                if not line:
                    break
                if not line.startswith(b"data:"):
                    continue
                payload = line[5:].strip()
                if payload == b"[DONE]":
                    finished = True
                    break
                try:
                    chunk = json.loads(payload)
                except json.JSONDecodeError:
                    continue
                if any((c.get("finish_reason") or "")
                       for c in chunk.get("choices", ())):
                    finished = True
                yield chunk

        completed = False
        created: Dict[str, Any] = {}
        try:
            for event, payload in chat_sse_to_response_events(
                    iter_chunks(), request_body, chat_request=route.body,
                    store=srv.response_store):
                if event == "response.created":
                    created = payload["response"]
                if event == "response.output_text.done" and not finished:
                    # the upstream died: never done / completed for
                    # partial text, never store it, but tell the client
                    failed = build_incomplete_response(
                        created, payload.get("item_id", ""),
                        payload.get("text", ""))
                    self._event("response.incomplete",
                                {"type": "response.incomplete",
                                 "response": failed})
                    break
                self._event(event, payload)
                if event == "response.completed":
                    completed = True
                    final = payload["response"]
                    usage = final.get("usage") or {}
                    srv.router.process_response(route, {
                        "choices": [{"message": {
                            "role": "assistant",
                            "content": final.get("output_text", "")},
                            "finish_reason": "stop"}],
                        "usage": {
                            "prompt_tokens": usage.get("input_tokens", 0),
                            "completion_tokens":
                                usage.get("output_tokens", 0),
                            "total_tokens": usage.get("total_tokens", 0)}})
        except Exception:
            pass  # the client left mid-stream: stop writing
        finally:
            upstream.close()
        srv.router.record_feedback(
            route, success=completed,
            latency_ms=(time.perf_counter() - t0) * 1e3)

    # -- the looper ----------------------------------------------------------

    def _looper_chat(self, route, req_headers: Dict[str, str],
                     anthropic: bool,
                     responses_request: Optional[dict] = None) -> None:
        """Execute a looper decision over its models: the router is the
        client, each fan-out call carries the client's headers and its
        own candidate's credential (a candidate without one fails
        closed)."""
        srv: RouterServer = self.server.owner
        decision = route.decision.decision
        nli = None
        eng = srv.router.engine
        if eng is not None and eng.has_task("nli"):
            def nli(premise, claim):
                r = eng.classify("nli", f"{premise}\n[SEP]\n{claim}")
                return r.probs.get("entailment", r.confidence)
        looper = Looper(srv.looper_client, nli, pool=srv.looper_pool)

        def headers_for(model: str) -> Dict[str, str]:
            return srv._credentials_for_model(model, req_headers)

        t0 = time.perf_counter()
        try:
            if route.looper_algorithm == "workflows":
                result = srv.workflows.execute(
                    decision.algorithm, decision.model_refs, route.body,
                    headers=req_headers, headers_for=headers_for)
            else:
                result = looper.execute(
                    decision.algorithm, decision.model_refs, route.body,
                    headers=req_headers, headers_for=headers_for)
        except Exception as exc:
            srv.router.record_feedback(
                route, success=False,
                latency_ms=(time.perf_counter() - t0) * 1e3)
            self._reply(502, {"error": {"message": f"looper failed: {exc}",
                                        "type": "looper_error"}},
                        route.headers)
            return
        latency_ms = (time.perf_counter() - t0) * 1e3
        route.model = result.model
        processed = srv.router.process_response(route, result.body)
        srv.router.record_feedback(route, success=True,
                                   latency_ms=latency_ms)
        out_headers = {**route.headers, **processed.headers,
                       H.MODEL: result.model,
                       H.LOOPER_ALGORITHM: result.algorithm,
                       H.LOOPER_CANDIDATES: ",".join(
                           result.candidates_used)}
        payload = processed.body
        if anthropic:
            payload = openai_to_anthropic_response(payload)
        elif responses_request is not None:
            payload = chat_to_response(payload, responses_request,
                                       chat_request=route.body,
                                       store=srv.response_store)
            if responses_request.get("stream"):
                self._oneshot_response_sse(payload, out_headers)
                return
        self._reply(200, payload, out_headers)

    def _reply(self, status: int, payload: dict,
               headers: Optional[dict] = None) -> None:
        self._reply_raw(status, json.dumps(payload).encode(), headers)

    def _reply_text(self, status: int, text: str, ctype: str) -> None:
        self._reply_raw(status, text.encode(), content_type=ctype)

    def _reply_raw(self, status: int, data: bytes,
                   headers: Optional[dict] = None,
                   content_type: str = "application/json") -> None:
        self._drain_body()
        self.send_response(status)
        self.send_header("content-type", content_type)
        self.send_header("content-length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)


def info_models(engine) -> List[dict]:
    """The GET /info/models rows: one per task with its kind, its labels
    (a classifier's; none for the other kinds) and its ``task_info``."""
    rows: List[dict] = []
    if engine is None:
        return rows
    for t in engine.tasks():
        kind = engine.task_kind(t)
        row = {"task": t, "kind": kind,
               "labels": engine.task_labels(t)
               if kind in ("sequence", "token") else []}
        row.update({k: v for k, v in engine.task_info(t).items()
                    if k not in row})
        rows.append(row)
    return rows


def runtime_debug_report(registry, engine) -> dict:
    """The GET /debug/runtime body: the runtimestats snapshot (per
    (group, bucket, variant) step stats, process gauges, torch.cuda memory
    rows) plus the engine's packing block (knobs, scheduler, auto-tuner
    policy; present whenever an engine serves, its ``enabled`` the
    truth), kernel knobs and step-graph caches, and the cascade's block
    exactly when an evaluator is attached."""
    rep = registry.runtimestats.report()
    if engine is not None:
        rep["packing"] = engine.packing_report()
        rep["kernels"] = engine.kernels_report()
        rep["graphs"] = engine.graph_report()
    casc = registry.get("cascade")
    if casc is not None:
        rep["cascade"] = casc.report()
    return rep


# never forwarded upstream: hop-by-hop headers describe this connection
_HOP_BY_HOP = frozenset({
    "content-length", "host", "transfer-encoding", "connection",
    "keep-alive", "te", "upgrade", "proxy-connection", "trailer",
})


def _error_bytes(message: str) -> bytes:
    return json.dumps({"error": {"message": message,
                                 "type": "backend_error"}}).encode()


def _parse_upstream(raw: bytes) -> Any:
    """A backend's answer as JSON; a body that is not JSON becomes an
    error object carrying its first 300 bytes."""
    try:
        return json.loads(raw or b"{}")
    except json.JSONDecodeError:
        return {"error": {"message": raw[:300].decode(errors="replace")}}


class BackendResolver:
    """model name → base URL through ``modelCards[].backend_refs``
    (weighted endpoints); a model without any goes to the default
    backend."""

    def __init__(self, cfg: RouterConfig, default_backend: str = "") -> None:
        self.default_backend = default_backend
        self._by_model: Dict[str, list] = {}
        for card in cfg.model_cards:
            refs = []
            for ref in card.backend_refs:
                endpoint = ref.get("endpoint", "")
                if endpoint and not endpoint.startswith("http"):
                    endpoint = f"http://{endpoint}"
                refs.append((endpoint, float(ref.get("weight", 100))))
            if refs:
                self._by_model[card.name] = refs
        self._rng = np.random.default_rng(0)

    def resolve(self, model: str) -> str:
        """The model's first candidate endpoint ("" when there is none)."""
        candidates = self.resolve_candidates(model)
        return candidates[0] if candidates else ""

    def resolve_candidates(self, model: str) -> list:
        """Ordered endpoint candidates: a weighted pick first, then every
        other configured endpoint, heaviest first, as failover targets (a
        dead replica sheds its share to the survivors)."""
        refs = self._by_model.get(model)
        if not refs:
            return [self.default_backend] if self.default_backend else []
        if len(refs) == 1:
            return [refs[0][0]]
        weights = np.asarray([w for _, w in refs])
        total = weights.sum()
        if total <= 0:
            order = list(range(len(refs)))
        else:
            first = int(self._rng.choice(len(refs), p=weights / total))
            rest = [i for i in range(len(refs)) if i != first]
            rest.sort(key=lambda i: -refs[i][1])
            order = [first] + rest
        return [refs[i][0] for i in order]


class RouterServer:
    """Serves one Router in front of its models' backends.

    ``backend_url`` is the default backend: the one a model without
    ``backend_refs`` (and a passthrough) goes to.  ``registry`` holds the
    sinks ``/metrics`` and ``/debug/*`` read; None binds the router's own
    (its series' metrics registry, tracer, flight recorder, decision
    ring, degradation controller and upstream plane) and the engine's
    runtime stats and program catalog.  The looper's client and its pool
    of 16 fan-out workers, the workflows engine (its pending tool state
    lives across requests), the Responses store and the credential
    resolver are the server's own, built from the config it starts with
    (a hot reload swaps ``router`` and ``cfg`` and keeps them, as the
    reference's server does).

    ``api_server.api_keys`` ([{key, roles}]) gates every management
    route: ``view`` reads, ``edit`` mutates, ``admin`` does both and
    ``secret_view`` (or ``admin``) reads the config unredacted; with no
    keys the management surface is open and the config redacted.
    ``config_path`` (the file ``serve`` loaded and watches) enables the
    config API's writes, versions and rollback."""

    def __init__(self, router: Router, backend_url: str,
                 host: str = "127.0.0.1", port: int = 0,
                 timeout_s: float = 60.0, registry=None,
                 config_path: str = "") -> None:
        from ..runtime.registry import RuntimeRegistry

        if registry is None:
            own = {"metrics": router.M.registry, "tracer": router.tracer,
                   "flightrec": router.flightrec,
                   "explain": router.explain,
                   "resilience": router.resilience,
                   "upstreams": router.upstream_health}
            if router.engine is not None:
                own.update(runtimestats=router.engine._runtime_stats,
                           programstats=router.engine._program_stats)
            if router.cascade is not None:
                own["cascade"] = router.cascade
            registry = RuntimeRegistry.with_defaults(**own)
        self.registry = registry
        self.started_t = time.time()
        self.ready = threading.Event()
        self.router = router
        self.cfg = router.cfg
        u = urllib.parse.urlsplit(backend_url)
        if u.scheme != "http" or not u.hostname:
            raise ValueError(f"backend must be an http:// URL, got "
                             f"{backend_url!r}")
        self.resolver = BackendResolver(router.cfg, backend_url.rstrip("/"))
        self.forward_timeout_s = timeout_s
        cfg = router.cfg
        self.credentials = CredentialResolver.from_config(cfg.authz)
        self.response_store = build_response_store(cfg.response_store)
        self.looper_client = HTTPLLMClient(self.resolver.resolve, timeout_s)
        self.looper_pool = ThreadPoolExecutor(max_workers=16,
                                              thread_name_prefix="looper")
        self.workflows = WorkflowsLooper(
            self.looper_client, pool=self.looper_pool,
            state_store=build_workflow_state_store(cfg.looper))
        self.upstream_pool = UpstreamPool()
        # the management API's keys; an entry without a key is skipped
        # (an empty key would match a request that presents none)
        self.api_keys: Dict[str, set] = {}
        for entry in (cfg.api_server or {}).get("api_keys", []) or []:
            key = str(entry.get("key") or "")
            if key:
                self.api_keys[key] = set(entry.get("roles", []) or [])
        from ..dashboard.auth import TokenIssuer
        from ..dashboard.jobs import JobRunner, JobStore

        self.token_issuer = TokenIssuer()
        # the dashboard's jobs (a SQLite file at dashboard.jobs_path, else
        # in memory)
        dash_cfg = (cfg.raw or {}).get("dashboard", {}) or {}
        self.jobs = JobRunner(JobStore(dash_cfg.get("jobs_path", "")))
        self._register_job_kinds()
        # the OTLP exporters ``runtime.bootstrap.attach_otlp`` attaches;
        # stop() detaches and flushes them
        self.otlp_exporter = None
        self.otlp_log_exporter = None
        from ..config.versions import ConfigVersionStore

        self.version_store = ConfigVersionStore(config_path) \
            if config_path else None
        # serializes the config API's read-merge-backup-write sequences
        self.config_write_lock = threading.Lock()
        # the hot-reload watcher (runtime/bootstrap.py
        # attach_config_watcher) and the routers a reload replaced, each
        # with the timer that retires its dispatcher
        self.watcher = None
        self._retiring: List[Tuple[threading.Timer, Router]] = []
        self._retiring_lock = threading.Lock()
        # the boot's StartupTracker (runtime/startup.py), set by serve()
        self.startup = None
        self._openapi_cache: Optional[Dict[str, Any]] = None
        self._imagegen_backends: Dict[tuple, Any] = {}
        self._imagegen_lock = threading.Lock()
        workers = int((cfg.api_server or {}).get("http_workers", 64))
        self.httpd = PooledHTTPServer((host, port), _Handler,
                                      max_workers=workers)
        self.httpd.owner = self  # type: ignore[attr-defined]
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _register_job_kinds(self) -> None:
        """The dashboard's job kinds.  ``selection_benchmark``: the
        benchmark runner over the candidates (``params.models``, else the
        config's) at their backends (or ``params.endpoint``) on
        ``params.n`` synthetic queries, its corpus written as JSONL and a
        selector artifact trained per ``params.algorithms`` (default
        knn) into ``params.out_dir``, fitted on the engine's device.
        ``accuracy_eval``: ``params.cases`` ({query, expected_decision})
        routed by the live router; the decisions and models counted, and
        the decision accuracy over the labelled cases."""

        def selection_benchmark(params: Dict[str, Any]) -> Dict[str, Any]:
            import os
            import tempfile

            from ..modelselection import (
                BenchmarkRunner,
                candidates_from_config,
            )
            from ..modelselection.benchmark import synthetic_queries
            from ..training.selection_train import (
                featurize,
                load_routing_jsonl,
                train_selector,
            )

            models = params.get("models") or [
                c.name for c in candidates_from_config(self.cfg)]
            endpoint = params.get("endpoint", "")
            resolve = (lambda m: endpoint) if endpoint \
                else self.resolver.resolve
            runner = BenchmarkRunner(
                resolve, concurrency=int(params.get("concurrency", 2)),
                timeout_s=float(params.get("timeout_s", 30.0)))
            results = runner.run(synthetic_queries(int(params.get("n", 16))),
                                 models)
            out_dir = params.get("out_dir") or tempfile.mkdtemp(
                prefix="srt-selection-")
            data_path = os.path.join(out_dir, "routing.jsonl")
            runner.write_jsonl(results, data_path)
            records = load_routing_jsonl(data_path)
            feats, labels, counts = featurize(records)
            engine = self.router.engine
            device = engine.device if engine is not None else None
            artifacts = {}
            for algo in params.get("algorithms", ["knn"]):
                blob = train_selector(algo, feats, labels, records=records,
                                      device=device)
                path = os.path.join(out_dir, f"{algo}.json")
                with open(path, "w") as f:
                    f.write(blob)
                artifacts[algo] = path
            return {"records": len(records),
                    "errors": sum(1 for r in results if r.error),
                    "label_counts": counts, "data": data_path,
                    "artifacts": artifacts}

        def accuracy_eval(params: Dict[str, Any]) -> Dict[str, Any]:
            cases = params.get("cases") or []
            if not cases:
                raise ValueError("cases required: "
                                 "[{query, expected_decision?}]")
            decisions: Dict[str, int] = {}
            models: Dict[str, int] = {}
            correct = scored = 0
            for case in cases:
                res = self.router.route({"model": "auto", "messages": [
                    {"role": "user", "content": str(case["query"])}]})
                dec = res.decision.decision.name if res.decision else ""
                decisions[dec or "default"] = \
                    decisions.get(dec or "default", 0) + 1
                if res.model:
                    models[res.model] = models.get(res.model, 0) + 1
                expected = case.get("expected_decision")
                if expected is not None:
                    scored += 1
                    correct += int(dec == expected)
            out = {"cases": len(cases), "decisions": decisions,
                   "models": models}
            if scored:
                out["decision_accuracy"] = round(correct / scored, 4)
            return out

        self.jobs.register("selection_benchmark", selection_benchmark)
        self.jobs.register("accuracy_eval", accuracy_eval)

    @property
    def url(self) -> str:
        host = self.httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def openapi_spec(self) -> Dict[str, Any]:
        """The OpenAPI document of ``API_CATALOG``, built once."""
        if self._openapi_cache is None:
            from .openapi import build_spec

            self._openapi_cache = build_spec(API_CATALOG)
        return self._openapi_cache

    def _imagegen_backend(self, decision_name: str, conf: Dict[str, Any]):
        """The image backend of (decision, configuration), built once; a
        changed configuration builds a new one."""
        from .imagegen import build_backend

        key = (decision_name, json.dumps(conf, sort_keys=True))
        with self._imagegen_lock:
            backend = self._imagegen_backends.get(key)
            if backend is None:
                backend = build_backend(conf)
                self._imagegen_backends[key] = backend
            return backend

    def roles_for_key(self, presented: str) -> Optional[set]:
        """The roles of a configured API key, compared in constant time
        over bytes (surrogateescape: header values arrive latin-1
        decoded); None when no key matches."""
        import hmac

        presented_b = presented.encode("utf-8", "surrogateescape")
        found = None
        for configured, roles in self.api_keys.items():
            if hmac.compare_digest(
                    configured.encode("utf-8", "surrogateescape"),
                    presented_b):
                found = roles
        return found

    def versions(self) -> List[dict]:
        """The config file's kept versions, newest first."""
        return [{"id": v.version_id, "created": v.created_t, "hash": v.hash}
                for v in self.version_store.list()]

    def retire_router(self, old: Router, grace_s: float) -> None:
        """Shut a router a reload replaced down after ``grace_s`` seconds
        (requests inside its ``route()`` finish their fan-out); ``stop``
        shuts every router still waiting down at once."""
        timer = threading.Timer(grace_s, self._retire, args=(old,))
        timer.name, timer.daemon = "router-retire", True
        with self._retiring_lock:
            self._retiring = [(t, r) for t, r in self._retiring
                              if t.is_alive()] + [(timer, old)]
        timer.start()

    def _retire(self, old: Router) -> None:
        with self._retiring_lock:
            self._retiring = [(t, r) for t, r in self._retiring
                              if r is not old]
        # as the reference's reload: the replaced router's MCP clients
        # stay open (a reference fault the port keeps; ROADMAP, queue 3)
        old.shutdown(close_clients=False)

    @property
    def upstreams(self):
        """The registry's upstream plane; None = disabled (the plain
        endpoint-failover forward)."""
        return self.registry.get("upstreams")

    # -- upstream headers --------------------------------------------------

    def _credentials_for_model(self, model: str, headers: Dict[str, str]
                               ) -> Dict[str, str]:
        """The credential header for (the request's user, ``model``);
        identity headers count only with ``authz.trust_identity_headers``.
        Raises PermissionError with no match and ``fail_open: false``."""
        user_id = headers.get("x-authz-user-id", "")
        groups = [g.strip() for g in
                  headers.get("x-authz-user-groups", "").split(",")
                  if g.strip()]
        return self.credentials.headers_for(model, user_id, groups)

    def upstream_headers(self, route, req_headers: Dict[str, str]
                         ) -> Dict[str, str]:
        """What a routed request's upstream call carries: the client's
        headers, the router's ``traceparent`` (the backend's spans parent
        under ``router.route``), the route's x-vsr-* headers and the
        credential.  Raises PermissionError as the resolver does."""
        fwd = dict(req_headers)
        self.router.tracer.inject(route.trace_id, route.root_span_id, fwd)
        fwd.update(route.headers)
        fwd.update(self._credentials_for_model(route.model, req_headers))
        return fwd

    def _pick_stream_backend(self, model: str) -> str:
        """A stream pins one endpoint: the first candidate whose circuit
        is not open (the first candidate without the upstream plane)."""
        candidates = self.resolver.resolve_candidates(model)
        up = self.upstreams
        if up is not None:
            for url in candidates:
                if up.allow(model, url):
                    return url
        return candidates[0] if candidates else ""

    def _note_stream_outcome(self, model: str, endpoint: str, ok: bool,
                             latency_s: float, kind: str = "") -> None:
        """A stream's outcome for the upstream plane's health scorer
        (streams bypass ``_forward_resilient``)."""
        up = self.upstreams
        if up is not None:
            up.record(model, endpoint, ok, latency_s,
                      kind=kind or ("ok" if ok else "connect"))

    # -- forwarding ------------------------------------------------------------

    @staticmethod
    def _prep_forward(body: dict, headers: Optional[dict]
                      ) -> Tuple[bytes, Dict[str, str]]:
        hdrs = {"content-type": "application/json"}
        for k, v in (headers or {}).items():
            if k.lower() not in _HOP_BY_HOP:
                hdrs[k] = v
        return json.dumps(body).encode(), hdrs

    def _forward_failover(self, model: str, body: dict,
                          headers: Optional[dict]
                          ) -> Tuple[int, bytes, str]:
        """Try each of the model's endpoints in the resolver's order: one
        the request could not be delivered to (connect refused, a
        send-phase failure: the pool's ``request_delivered`` marker)
        sheds to the next; a response-phase failure or an HTTP error does
        not (the backend may have executed the request).
        (status, bytes, endpoint); endpoint "" when there is none."""
        candidates = self.resolver.resolve_candidates(model)
        if not candidates:
            return 502, _error_bytes(f"no backend for model {model!r}"), ""
        data, hdrs = self._prep_forward(body, headers)
        last = None
        for i, url in enumerate(candidates):
            try:
                status, _, raw = self.upstream_pool.request(
                    "POST", url + "/v1/chat/completions", data, hdrs,
                    self.forward_timeout_s)
            except (http.client.HTTPException, OSError) as exc:
                last = (502, _error_bytes(f"backend unreachable: {exc}"),
                        url)
                # no marker = assume delivered: never double-execute
                if getattr(exc, "request_delivered", True):
                    return last
                continue
            if i > 0:
                self.router.M.backend_failovers.inc(model=model)
            return status, raw, url
        return last

    def _attempt_forward(self, endpoint: str, body: dict,
                         headers: Optional[dict], timeout_s: float,
                         remaining_s: float, deadline_header: str):
        """One upstream attempt under the upstream plane: (status, bytes,
        kind, latency_s, error) with kind ok | 5xx | timeout | connect |
        reset.  The backend sees the budget actually left."""
        data, hdrs = self._prep_forward(body, headers)
        hdrs[deadline_header] = f"{max(0.0, remaining_s):.3f}"
        t0 = time.perf_counter()
        try:
            status, _, raw = self.upstream_pool.request(
                "POST", endpoint + "/v1/chat/completions", data, hdrs,
                timeout_s)
        except (http.client.HTTPException, TimeoutError, OSError) as exc:
            latency = time.perf_counter() - t0
            # undelivered first: a connect / send-phase failure (even a
            # connect timeout) is provably unprocessed
            if not getattr(exc, "request_delivered", True):
                kind = "connect"
            elif isinstance(exc, (socket.timeout, TimeoutError)):
                kind = "timeout"
            else:
                kind = "reset"
            return 502, None, kind, latency, f"{type(exc).__name__}: {exc}"
        latency = time.perf_counter() - t0
        return status, raw, ("5xx" if status >= 500 else "ok"), latency, ""

    def _forward_resilient(self, route, fwd_headers: dict,
                           req_headers: Dict[str, str]
                           ) -> Tuple[int, bytes, str, List[dict]]:
        """The budgeted failover forward: candidates are the routed
        model's endpoints, then the ranked ``fallback_models``' (each
        forwarded as that model); each attempt is gated by its circuit
        breaker, every attempt past the first needs a token of the retry
        budget (refused outright at degradation >= L2), and the end-to-end
        deadline sets each attempt's timeout.  Without the upstream plane
        this is the plain endpoint failover.  (status, bytes, endpoint,
        failover_path)."""
        up = self.upstreams
        if up is None:
            status, data, endpoint = self._forward_failover(
                route.model, route.body, fwd_headers)
            return status, data, endpoint, []
        dl_cfg = up.cfg["deadline"]
        deadline_header = str(dl_cfg["header"])
        budget = parse_deadline(
            req_headers,
            float(dl_cfg["default_s"]) or self.forward_timeout_s,
            header=deadline_header)
        deadline_t = time.monotonic() + budget
        floor_s = float(dl_cfg["floor_s"])

        candidates: list = []
        for model in [route.model] + list(route.fallback_models or ()):
            if any(m == model for m, _ in candidates):
                continue
            for url in self.resolver.resolve_candidates(model):
                if url:
                    candidates.append((model, url))
        if not candidates:
            return 502, _error_bytes(
                f"no backend for model {route.model!r}"), "", []

        def body_for(model: str) -> dict:
            if model == route.model:
                return route.body
            return dict(route.body, model=model)

        def attempt(model, endpoint, remaining, attempts_left, outcome):
            timeout_s = attempt_timeout(remaining, attempts_left, floor_s,
                                        self.forward_timeout_s)
            status, data, kind, latency, err = self._attempt_forward(
                endpoint, body_for(model), fwd_headers, timeout_s,
                remaining, deadline_header)
            up.record(model, endpoint, kind == "ok", latency, kind=kind)
            path.append({"model": model, "endpoint": endpoint,
                         "outcome": outcome(kind), "status": int(status),
                         "latency_ms": round(latency * 1e3, 2)})
            if data is None:
                data = _error_bytes(f"backend unreachable: {err}")
            return status, data, kind

        max_attempts = min(up.max_attempts(), len(candidates))
        path: list = []
        last = (502, _error_bytes("all upstream candidates unavailable"),
                "")
        attempts = 0
        for model, endpoint in candidates:
            if attempts >= max_attempts:
                break
            remaining = deadline_t - time.monotonic()
            if remaining <= 0.01:
                path.append({"model": model, "endpoint": endpoint,
                             "outcome": "deadline_exhausted", "status": 0})
                break
            if not up.allow(model, endpoint):
                path.append({"model": model, "endpoint": endpoint,
                             "outcome": "skipped_open", "status": 0})
                continue
            if attempts > 0:
                granted, why = up.try_retry()
                if not granted:
                    path.append({"model": model, "endpoint": endpoint,
                                 "outcome": f"retry_denied:{why}",
                                 "status": 0})
                    break
                time.sleep(min(up.backoff_s(attempts),
                               max(0.0, deadline_t - time.monotonic())))
                remaining = deadline_t - time.monotonic()
                if remaining <= 0.01:
                    # the deadline died in the backoff: a doomed attempt
                    # would charge a failure to a possibly-healthy
                    # endpoint
                    path.append({"model": model, "endpoint": endpoint,
                                 "outcome": "deadline_exhausted",
                                 "status": 0})
                    break
            status, data, kind = attempt(model, endpoint, remaining,
                                         max_attempts - attempts,
                                         lambda k: k)
            attempts += 1
            if kind == "ok":
                if attempts > 1 or model != route.model:
                    up.failovers.inc(model=model)
                    self.router.M.backend_failovers.inc(model=model)
                return status, data, endpoint, path
            last = (status, data, endpoint)
            if not up.retry_on(kind):
                break
        # nothing attempted (every circuit open) and budget left: one
        # forced attempt at the head candidate — a probably-dead backend
        # beats no answer
        if attempts == 0 and deadline_t - time.monotonic() > 0.01:
            model, endpoint = candidates[0]
            remaining = max(0.05, deadline_t - time.monotonic())
            status, data, _ = attempt(model, endpoint, remaining, 1,
                                      lambda k: f"forced:{k}")
            return status, data, endpoint, path
        return (*last, path)

    def _annotate_failover(self, route, path: list) -> Dict[str, str]:
        """A failover's visibility: the decision record's
        ``failover_path`` and ``x-vsr-failover-model`` when another model
        served.  Nothing for the clean single-attempt case."""
        if not path or (len(path) == 1 and path[0].get("outcome") == "ok"):
            return {}
        extra: Dict[str, str] = {}
        final = path[-1]
        if final.get("outcome") in ("ok", "forced:ok") \
                and final.get("model") and final["model"] != route.model:
            extra[H.FAILOVER_MODEL] = final["model"]
        if route.decision_record_id:
            self.registry.explain.annotate(route.decision_record_id,
                                           failover_path=path)
        return extra

    # -- scaling signals -------------------------------------------------------

    def external_metrics(self, metric: str = "") -> dict:
        """ExternalMetricValueList-shaped scaling signals for an
        autoscaler: ``llm_degradation_level`` and the worst
        ``llm_queue_pressure``, first (stable order), then one level row
        per replica when a state plane is attached.  With a plane both
        ``scope="fleet"`` rows are the fleet's maxima over the replicas'
        published pressure (``fleet_pressure``), read through the fleet
        plane's one aggregation point (``FleetAggregator.scaling_view``)
        when it is attached; without a plane, or while it is down, this
        replica's own values.  ``metric`` filters by name."""
        res = self.registry.get("resilience")
        plane = self.registry.get("stateplane") or self.router.stateplane
        fobs = self.registry.get("fleetobs")
        level = float(res.level()) if res is not None else 0.0
        pending = 0.0
        if res is not None:
            try:
                pending = float(res.report()["pressure"].get(
                    "pending_items", 0.0))
            except Exception:
                pending = 0.0
        levels: Dict[str, float] = {}
        if fobs is not None:
            try:
                sv = fobs.aggregator.scaling_view(level, pending)
                levels = {str(r): float(v) for r, v in sv["levels"].items()}
                level = float(sv["level"])
                pending = float(sv["pending"])
            except Exception:
                pass  # fleet view down: serve the local values
        elif plane is not None:
            try:
                fleet = plane.fleet_pressure()
                levels = {str(r): float(v)
                          for r, v in (fleet.get("levels") or {}).items()}
                if levels:
                    level = max(level, max(levels.values()))
                pending = max(pending,
                              float(fleet.get("pending_items", 0.0)))
            except Exception:
                pass  # plane down: serve the local view
        ts = datetime.datetime.now(datetime.timezone.utc).isoformat()

        def item(name: str, value: float, **labels: str) -> dict:
            return {"metricName": name, "metricLabels": dict(labels),
                    "timestamp": ts, "value": str(int(value))
                    if float(value).is_integer() else str(value)}

        items = [item("llm_degradation_level", level, scope="fleet"),
                 item("llm_queue_pressure", pending, scope="fleet")]
        for replica, lvl in sorted(levels.items()):
            items.append(item("llm_degradation_level", lvl,
                              replica=replica))
        if metric:
            items = [i for i in items if i["metricName"] == metric]
        return {"kind": "ExternalMetricValueList",
                "apiVersion": "external.metrics.k8s.io/v1beta1",
                "metadata": {},
                "items": items}

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "RouterServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="router-http")
        self._thread.start()
        self.ready.set()
        return self

    def serve_forever(self) -> None:
        self.ready.set()
        self.httpd.serve_forever()

    def stop(self) -> None:
        if self.watcher is not None:
            self.watcher.stop()
        with self._retiring_lock:
            retiring, self._retiring = self._retiring, []
        for timer, old in retiring:
            timer.cancel()
            timer.join()
            old.shutdown(close_clients=False)
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.upstream_pool.close()
        self.looper_pool.shutdown(wait=False, cancel_futures=True)
        self.jobs.shutdown()
        # detached (a leaked sink would export twice) and flushed
        if self.otlp_exporter is not None:
            self.otlp_exporter.detach(self.registry.tracer)
        if self.otlp_log_exporter is not None \
                and self.registry.get("explain") is not None:
            self.otlp_log_exporter.detach(self.registry.get("explain"))
