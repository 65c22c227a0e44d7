"""HTTP front end: ``POST /v1/chat/completions`` routes the request, forwards
the rewritten body to the routed model's backend, and answers with the
backend's response stamped with the router's x-vsr-* headers; a
semantic-cache hit is answered by the router without the backend.

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
untouched and its answer comes back untouched, with no response path and
no feedback.  A request the degradation ladder sheds is answered 429 with
``retry-after`` and never reaches a backend; a fail-static one is
forwarded to the static model.  A ``stream: true`` request is answered 400 and a request
routed to a looper decision 501: neither is served by this port yet, and
neither reaches the backend.  ``GET /health``
reports liveness (``healthy``, or ``degraded`` with the firing SLO
objectives, HTTP 200 either way), ``GET /ready`` readiness.  Standard
library only (``ThreadingHTTPServer`` + ``http.client``).

The Classification API answers as the reference server's handlers do
with no API keys configured:

  POST /api/v1/classify/intent|pii|security|fact-check|user-feedback
       (``windowed`` / ``stride`` classify a long text over stride windows)
  POST /api/v1/classify/combined   every loaded task on one text
  POST /api/v1/classify/batch      one task over ``texts``
  POST /api/v1/embeddings          ``input``, ``dimensions`` → output_dim
  POST /api/v1/similarity[/batch]  cosine of embedded text pairs
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
  GET  /metrics/external           ExternalMetricValueList scaling
                                   signals (degradation level, queue
                                   pressure) for an autoscaler
"""

from __future__ import annotations

import datetime
import http.client
import json
import socket
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config.schema import RouterConfig
from ..observability.inflight import default_tracker
from ..observability.profiler import XLA_DUMP_UNSUPPORTED
from ..resilience.upstream import attempt_timeout, parse_deadline
from . import headers as H
from .httpclient import UpstreamPool
from .pipeline import EMBEDDING_TASK, Router

# the routes this server answers (the reference's discovery document,
# trimmed to what the port serves)
API_CATALOG = {"endpoints": [
    {"path": p, "method": m} for p, m in (
        ("/health", "GET"),
        ("/api/v1", "GET"),
        ("/v1/chat/completions", "POST"),
        ("/api/v1/classify/intent", "POST"),
        ("/api/v1/classify/pii", "POST"),
        ("/api/v1/classify/security", "POST"),
        ("/api/v1/classify/fact-check", "POST"),
        ("/api/v1/classify/user-feedback", "POST"),
        ("/api/v1/classify/combined", "POST"),
        ("/api/v1/classify/batch", "POST"),
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
        ("/debug/slo", "GET"),
        ("/debug/resilience", "GET"),
        ("/metrics/external", "GET"),
    )]}

# Classification API route name → engine task
CLASSIFY_TASKS = {"intent": "intent", "security": "jailbreak", "pii": "pii",
                  "fact-check": "fact_check",
                  "user-feedback": "user_feedback"}


class _Handler(BaseHTTPRequestHandler):
    server_version = "semantic-router-torch/0.1"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # silence
        pass

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
        elif path == "/api/v1":
            self._reply(200, API_CATALOG)
        elif path == "/ready":
            ok = srv.ready.is_set()
            self._reply(200 if ok else 503, {
                "ready": ok,
                "uptime_s": round(time.time() - srv.started_t, 1)})
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
        elif path == "/debug/profiler":
            self._reply(200, reg.profiler.status())
        elif path == "/debug/flightrec":
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
        elif path == "/metrics/external":
            self._reply(200, srv.external_metrics(
                self._query().get("metric", "")))
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
        else:
            self._reply(404, {"error": "not found"})

    def _decisions(self, ex) -> None:
        """Newest-first decision records, filtered by model / decision /
        rule / family / kind; ``?source=durable`` reads the SQLite
        mirror."""
        q = self._query()
        try:
            limit = int(q.get("limit", "50") or 50)
        except ValueError:
            limit = 50
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
        length = int(self.headers.get("content-length", 0))
        data = self.rfile.read(length)
        if path == "/debug/flightrec/clear" \
                or path.startswith("/debug/profiler/"):
            try:
                body = json.loads(data or b"{}")
            except json.JSONDecodeError:
                body = {}
            self._debug_post(path, body if isinstance(body, dict) else {})
            return
        known = path == "/v1/chat/completions" or path in (
            "/api/v1/embeddings", "/api/v1/similarity",
            "/api/v1/similarity/batch") \
            or path.startswith("/api/v1/classify/")
        if not known:
            self._reply(404, {"error": "not found"})
            return
        try:
            body = json.loads(data or b"{}")
        except json.JSONDecodeError:
            self._reply(400, {"error": {"message": "request body is not JSON"}})
            return
        if path == "/v1/chat/completions":
            self._chat(body)
            return
        try:
            if path.startswith("/api/v1/classify/"):
                self._classify(path.rsplit("/", 1)[1], body)
            elif path == "/api/v1/embeddings":
                self._embeddings(body)
            else:
                self._similarity(body)
        except Exception as exc:
            self._reply(500, {"error": {
                "message": f"{type(exc).__name__}: {exc}"}})

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

    # -- chat ----------------------------------------------------------------

    def _chat(self, body: dict) -> None:
        srv: RouterServer = self.server.owner
        router = srv.router
        if body.get("stream"):
            # the reference streams the backend's SSE answer through its
            # response path; until that is ported the request is refused,
            # never forwarded and answered with raw SSE bytes
            self._reply(400, {"error": {
                "message": "stream: true is not served by this router "
                           "yet; send the request without streaming",
                "type": "unsupported_stream"}})
            return
        req_headers = {k.lower(): v for k, v in self.headers.items()}
        result = router.route(body, req_headers)
        if result.kind in ("cache_hit", "blocked", "rate_limited", "shed"):
            self._reply(result.status, result.response_body, result.headers)
            return
        if result.kind == "passthrough":
            status, data = srv.forward(result.body)
            self._reply_raw(status, data)
            return
        if result.looper_algorithm:
            # the reference fans a looper decision out over its models;
            # forwarding to the one primary model would answer
            # differently without a word
            self._reply(501, {"error": {
                "message": f"decision {result.decision.decision.name!r} "
                           f"runs the looper algorithm "
                           f"{result.looper_algorithm!r} (multi-model "
                           f"execution), which this router does not "
                           f"serve yet",
                "type": "unsupported_looper"}}, result.headers)
            return
        # the backend's spans parent under this request's router.route
        fwd_headers: dict = {}
        router.tracer.inject(result.trace_id, result.root_span_id,
                             fwd_headers)
        t0 = time.perf_counter()
        token = default_tracker.begin(result.model)
        try:
            status, data, _, path = srv._forward_resilient(
                result, fwd_headers, req_headers)
        finally:
            default_tracker.end(result.model, token)
        latency_ms = (time.perf_counter() - t0) * 1e3
        failover_headers = srv._annotate_failover(result, path)
        if status != 200:
            router.record_feedback(result, success=False,
                                   latency_ms=latency_ms)
            self._reply_raw(status, data, result.headers)
            return
        try:
            reply = json.loads(data)
        except ValueError:
            reply = None
        processed = router.process_response(result, reply) \
            if isinstance(reply, dict) else None
        router.record_feedback(result, success=True, latency_ms=latency_ms)
        if processed is None:
            self._reply_raw(status, data,
                            {**result.headers, **failover_headers})
            return
        self._reply(200, processed.body,
                    {**result.headers, **failover_headers,
                     **processed.headers})

    def _reply(self, status: int, payload: dict,
               headers: Optional[dict] = None) -> None:
        self._reply_raw(status, json.dumps(payload).encode(), headers)

    def _reply_text(self, status: int, text: str, ctype: str) -> None:
        self._reply_raw(status, text.encode(), content_type=ctype)

    def _reply_raw(self, status: int, data: bytes,
                   headers: Optional[dict] = None,
                   content_type: str = "application/json") -> None:
        self.send_response(status)
        self.send_header("content-type", content_type)
        self.send_header("content-length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)


def runtime_debug_report(registry, engine) -> dict:
    """The GET /debug/runtime body: the runtimestats snapshot (per
    (group, bucket, variant) step stats, process gauges, torch.cuda memory
    rows) plus the engine's kernel knobs and step-graph caches, and the
    cascade's block exactly when an evaluator is attached."""
    rep = registry.runtimestats.report()
    if engine is not None:
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
    runtime stats and program catalog."""

    def __init__(self, router: Router, backend_url: str,
                 host: str = "127.0.0.1", port: int = 0,
                 timeout_s: float = 60.0, registry=None) -> None:
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
        u = urllib.parse.urlsplit(backend_url)
        if u.scheme != "http" or not u.hostname:
            raise ValueError(f"backend must be an http:// URL, got "
                             f"{backend_url!r}")
        self.resolver = BackendResolver(router.cfg, backend_url.rstrip("/"))
        self.forward_timeout_s = timeout_s
        self.upstream_pool = UpstreamPool()
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.owner = self  # type: ignore[attr-defined]
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host = self.httpd.server_address[0]
        return f"http://{host}:{self.port}"

    @property
    def upstreams(self):
        """The registry's upstream plane; None = disabled (the plain
        endpoint-failover forward)."""
        return self.registry.get("upstreams")

    # -- forwarding ------------------------------------------------------------

    @staticmethod
    def _prep_forward(body: dict, headers: Optional[dict]
                      ) -> Tuple[bytes, Dict[str, str]]:
        hdrs = {"content-type": "application/json"}
        for k, v in (headers or {}).items():
            if k.lower() not in _HOP_BY_HOP:
                hdrs[k] = v
        return json.dumps(body).encode(), hdrs

    def forward(self, body: dict,
                headers: Optional[dict] = None) -> "tuple[int, bytes]":
        """POST ``body`` to the default backend; (status, response bytes),
        502 when it cannot be reached."""
        data, hdrs = self._prep_forward(body, headers)
        try:
            status, _, raw = self.upstream_pool.request(
                "POST", self.resolver.default_backend
                + "/v1/chat/completions", data, hdrs,
                self.forward_timeout_s)
        except (http.client.HTTPException, OSError) as exc:
            return 502, _error_bytes(f"backend unreachable: {exc}")
        return status, raw

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
        autoscaler: the ladder's ``llm_degradation_level`` and the worst
        ``llm_queue_pressure`` (this replica's; the reference's fleet
        rows need the state plane).  ``metric`` filters by name."""
        res = self.registry.get("resilience")
        level = float(res.level()) if res is not None else 0.0
        pending = 0.0
        if res is not None:
            pending = float(res.report()["pressure"].get("pending_items",
                                                         0.0))
        ts = datetime.datetime.now(datetime.timezone.utc).isoformat()

        def item(name: str, value: float, **labels: str) -> dict:
            return {"metricName": name, "metricLabels": dict(labels),
                    "timestamp": ts, "value": str(int(value))
                    if float(value).is_integer() else str(value)}

        items = [item("llm_degradation_level", level, scope="fleet"),
                 item("llm_queue_pressure", pending, scope="fleet")]
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
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.upstream_pool.close()
