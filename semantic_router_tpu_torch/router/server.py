"""HTTP front end: ``POST /v1/chat/completions`` routes the request, forwards
the rewritten body to the backend, and answers with the backend's response
stamped with the router's x-vsr-* headers; a semantic-cache hit is
answered by the router without the backend.  Each backend call is counted
in the in-flight tracker (the ``multi_factor`` selector's load) and timed;
a 200 goes through the router's response path (its headers and annotated
body are what the client gets), and every answer, 200 or not, is fed
back to the decision's selector (``record_feedback``).  The client's W3C
``traceparent`` is continued by the router's ``router.route`` span, and
the router's own goes to the backend.  A rate-limited request is answered
429 with ``retry-after``, and never reaches the backend; a passthrough
(``x-vsr-skip-processing``, when enabled) goes to the backend untouched
and its answer comes back untouched, with no response path and no
feedback.  A ``stream: true`` request is answered 400 and a request
routed to a looper decision 501: neither is served by this port yet, and
neither reaches the backend.  ``GET /health``
reports liveness, ``GET /ready`` readiness.  Standard library only
(``ThreadingHTTPServer`` + ``http.client``).

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
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..observability.inflight import default_tracker
from ..observability.profiler import XLA_DUMP_UNSUPPORTED
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
            self._reply(200, {"status": "ok"})
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
        result = router.route(body, dict(self.headers.items()))
        if result.kind in ("cache_hit", "blocked", "rate_limited"):
            self._reply(result.status, result.response_body, result.headers)
            return
        if result.kind == "passthrough":
            try:
                status, data = srv.forward(result.body)
            except OSError as exc:
                status, data = 502, json.dumps({"error": {
                    "message": f"backend unreachable: {exc}"}}).encode()
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
            status, data = srv.forward(result.body, fwd_headers)
        except OSError as exc:
            status, data = 502, json.dumps({"error": {
                "message": f"backend unreachable: {exc}"}}).encode()
        finally:
            default_tracker.end(result.model, token)
        latency_ms = (time.perf_counter() - t0) * 1e3
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
            self._reply_raw(status, data, result.headers)
            return
        self._reply(200, processed.body,
                    {**result.headers, **processed.headers})

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


class RouterServer:
    """Serves one Router in front of one OpenAI-compatible backend.

    ``registry`` holds the observability sinks ``/metrics`` and
    ``/debug/*`` read; None binds the router's own (its series' metrics
    registry, tracer, flight recorder and decision ring) and the engine's
    runtime stats and program catalog."""

    def __init__(self, router: Router, backend_url: str,
                 host: str = "127.0.0.1", port: int = 0,
                 timeout_s: float = 60.0, registry=None) -> None:
        from ..runtime.registry import RuntimeRegistry

        if registry is None:
            own = {"metrics": router.M.registry, "tracer": router.tracer,
                   "flightrec": router.flightrec,
                   "explain": router.explain}
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
        self._backend = (u.hostname, u.port or 80, u.path.rstrip("/"))
        self.timeout_s = timeout_s
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.owner = self  # type: ignore[attr-defined]
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host = self.httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def forward(self, body: dict,
                headers: Optional[dict] = None) -> "tuple[int, bytes]":
        """POST the routed body to the backend with ``headers`` (the
        router's traceparent); (status, response bytes)."""
        host, port, prefix = self._backend
        conn = http.client.HTTPConnection(host, port, timeout=self.timeout_s)
        try:
            conn.request("POST", f"{prefix}/v1/chat/completions",
                         body=json.dumps(body).encode(),
                         headers={"content-type": "application/json",
                                  **(headers or {})})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

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
