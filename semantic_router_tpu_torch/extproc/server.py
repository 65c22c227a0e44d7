"""Envoy ExtProc gRPC filter: the reference's primary deployment shape.

The port's copy of ``semantic_router_tpu.extproc.server``.  It implements
the ext_proc v3 bidirectional stream over the routing pipeline (reference:
pkg/extproc/router.go:80 ``ExternalProcessorServer``, server.go:98 serve
loop, processor_core.go:28-71 message dispatch):

  Envoy ──ProcessingRequest stream──▶ this filter ──ProcessingResponse──▶

Phases handled per stream (BUFFERED mode is the reference's default; a
STREAMED body arrives in chunks, which ``streamed.StreamedBodyHandler``
scans as they come, starting signal evaluation once ``messages`` is
complete):

- request_headers  → record; CONTINUE
- request_body     → the pipeline (``Router.route``): the body mutated
  (model rewrite), the ``x-vsr-*`` routing headers set (Envoy's route
  config matches its cluster on ``x-vsr-selected-model``) and
  ``clear_route_cache``; or an ImmediateResponse for a cache hit, a policy
  block or a rate limit (processor_req_body.go:31)
- response_headers → record the status, detect SSE; CONTINUE
  (``mode_override`` to STREAMED for an event stream), echo the decision
  record's id and the degradation level
- response_body    → the response pipeline (``Router.process_response``):
  screens, annotations, the cache write, selector feedback

Every pipeline error fails open to CONTINUE: a dead engine degrades the
router, never the data plane (processor_core.go:74-81).  The service is
registered with generic handlers on the real Envoy method path
``/envoy.service.ext_proc.v3.ExternalProcessor/Process``.

``grpc`` is imported only where ``ExtProcServer`` is built: the service
and the streamed handler run without it (in process, over iterators of
``external_processor_pb2`` messages).
"""

from __future__ import annotations

import json
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional

from ..observability import metrics as M
from ..observability.inflight import default_tracker
from ..observability.logging import component_event
from ..router import headers as H
from ..router.pipeline import RouteResult, Router
from . import external_processor_pb2 as pb

SERVICE_NAME = "envoy.service.ext_proc.v3.ExternalProcessor"

# one filter per process: it counts on the default registry
extproc_messages = M.default_registry.counter(
    "llm_extproc_messages_total", "ExtProc stream messages by phase")


def _headers_to_dict(header_map: pb.HeaderMap) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for hv in header_map.headers:
        val = hv.raw_value.decode("utf-8", "replace") if hv.raw_value \
            else hv.value
        out[hv.key.lower()] = val
    return out


def _set_headers(mapping: Dict[str, str]) -> pb.HeaderMutation:
    return pb.HeaderMutation(set_headers=[
        pb.HeaderValueOption(
            header=pb.HeaderValue(key=k, raw_value=v.encode()),
            append_action=pb.HeaderValueOption.OVERWRITE_IF_EXISTS_OR_ADD)
        for k, v in mapping.items()])


def _immediate(status: int, body: Dict[str, Any],
               headers: Dict[str, str]) -> pb.ProcessingResponse:
    hdrs = {"content-type": "application/json"}
    hdrs.update(headers)
    return pb.ProcessingResponse(immediate_response=pb.ImmediateResponse(
        status=pb.HttpStatus(code=status),
        headers=_set_headers(hdrs),
        body=json.dumps(body)))


def _continue_headers() -> pb.ProcessingResponse:
    return pb.ProcessingResponse(request_headers=pb.HeadersResponse(
        response=pb.CommonResponse(status=pb.CommonResponse.CONTINUE)))


def _continue_body() -> pb.ProcessingResponse:
    return pb.ProcessingResponse(request_body=pb.BodyResponse(
        response=pb.CommonResponse(status=pb.CommonResponse.CONTINUE)))


class _StreamState:
    """One Process stream's request context (reference RequestContext,
    processor_core.go:86)."""

    __slots__ = ("headers", "route", "streamed_handler", "response_status",
                 "is_sse", "response_chunks", "t_start", "inflight_token",
                 "passthrough")

    def __init__(self) -> None:
        self.headers: Dict[str, str] = {}
        self.route: Optional[RouteResult] = None
        self.response_status = 200
        self.is_sse = False
        self.response_chunks: Optional[list] = []
        self.t_start = 0.0
        self.inflight_token: Optional[int] = None
        self.passthrough = False  # skip-processing: no accumulation
        self.streamed_handler = None  # the chunk-wise state machine


class ExtProcService:
    """The stream handler.  One instance serves every stream; a stream's
    state lives in its ``_StreamState``."""

    # bound on an accumulated request body (Envoy's default
    # per-connection buffer is 50 MiB: an unbounded accumulator would be a
    # memory DoS)
    MAX_BODY_BYTES = 50 * 1024 * 1024
    # a streamed body that trickles longer than this answers 408 (the
    # reference's StreamedBodyTimeoutSec); 0 disables
    STREAMED_DEADLINE_S = 120.0
    # signal-prefetch workers for streamed bodies: early detection
    # overlaps classification with the body's arrival
    PREFETCH_WORKERS = 4

    def __init__(self, router: Router, looper_execute=None) -> None:
        self.router = router
        self._prefetch_pool = ThreadPoolExecutor(
            max_workers=self.PREFETCH_WORKERS,
            thread_name_prefix="extproc-prefetch")
        # optional callable(route, headers) -> (model, response_body,
        # extra_headers): a looper decision executes inside the filter
        # and answers with an ImmediateResponse (behind Envoy the filter
        # cannot re-enter the router as a client)
        self.looper_execute = looper_execute

    def close(self) -> None:
        """Stop the prefetch workers (queued prefetches are cancelled)."""
        self._prefetch_pool.shutdown(wait=False, cancel_futures=True)

    # -- stream loop -----------------------------------------------------

    def Process(self, request_iterator: Iterator[pb.ProcessingRequest],
                context=None) -> Iterator[pb.ProcessingResponse]:
        state = _StreamState()
        try:
            for req in request_iterator:
                which = req.WhichOneof("request")
                extproc_messages.inc(phase=which or "unknown")
                if which == "request_headers":
                    yield self._on_request_headers(req.request_headers, state)
                elif which == "request_body":
                    resp = self._on_request_body(req.request_body, state)
                    if resp is not None:
                        yield resp
                elif which == "response_headers":
                    yield self._on_response_headers(req.response_headers,
                                                    state)
                elif which == "response_body":
                    resp = self._on_response_body(req.response_body, state)
                    if resp is not None:
                        yield resp
                elif which == "request_trailers":
                    yield pb.ProcessingResponse(
                        request_trailers=pb.TrailersResponse())
                elif which == "response_trailers":
                    yield pb.ProcessingResponse(
                        response_trailers=pb.TrailersResponse())
                else:  # an unknown phase: keep the stream alive
                    yield _continue_headers()
        finally:
            # a stream the client dropped after its route still ends its
            # in-flight entry
            if state.inflight_token is not None and state.route is not None:
                default_tracker.end(state.route.model, state.inflight_token)

    # -- phases ----------------------------------------------------------

    def _on_request_headers(self, msg: pb.HttpHeaders,
                            state: _StreamState) -> pb.ProcessingResponse:
        state.headers = _headers_to_dict(msg.headers)
        state.t_start = time.perf_counter()
        # skip-processing is decided at header time: an opted-out request
        # passes every body chunk through with no accumulation, no model
        # detection and no pipeline (processor_core.go:31)
        try:
            state.passthrough = self.router.skip_requested(state.headers)
        except Exception:
            state.passthrough = False
        return _continue_headers()

    def _on_request_body(self, msg: pb.HttpBody, state: _StreamState
                         ) -> Optional[pb.ProcessingResponse]:
        if state.passthrough:
            return _continue_body()
        if state.streamed_handler is None:
            from .streamed import StreamedBodyHandler

            state.streamed_handler = StreamedBodyHandler(
                self.router, state.headers,
                prefetch_pool=self._prefetch_pool,
                max_bytes=self.MAX_BODY_BYTES,
                deadline_s=self.STREAMED_DEADLINE_S)
        handler = state.streamed_handler
        action, payload = handler.handle_chunk(bytes(msg.body),
                                               msg.end_of_stream)
        if action == "continue":
            # a STREAMED chunk (empty mid-stream frames are legal): eaten;
            # model detection and the signal prefetch ran in the handler
            return _continue_body()
        state.streamed_handler = None
        if action == "error":
            status, err_body = payload
            return _immediate(status, err_body, {})
        if handler.prefetch_started_at is not None:
            component_event(
                "extproc", "streamed_early_detection",
                model_detected_at_chunk=handler.model_detected_at,
                prefetch_started_at_chunk=handler.prefetch_started_at,
                chunks=handler.chunks_seen)
        if action == "passthrough":
            body, precomputed = payload, None
        else:
            body, precomputed = payload
        # the prefetch's pending trace makes route() adopt the pre-minted
        # root span id, so the early signal spans parent under
        # router.route
        route_kw = {}
        if getattr(handler, "pending_trace", None) is not None:
            route_kw["pending_trace"] = handler.pending_trace
        try:
            route = self.router.route(body, state.headers,
                                      precomputed_signals=precomputed,
                                      **route_kw)
        except Exception as exc:  # fail open: continue unmodified
            component_event("extproc", "route_error", error=str(exc))
            return _continue_body()
        state.route = route

        if route.kind in ("blocked", "rate_limited", "cache_hit") \
                or route.response_body is not None:
            return _immediate(route.status, route.response_body,
                              route.headers)
        if route.kind == "passthrough":
            return _continue_body()

        # a looper decision answers from inside the filter when an
        # executor is wired (a multi-model strategy is not one Envoy
        # upstream request)
        is_looper_sub = state.headers.get(H.LOOPER, "").lower() in \
            ("1", "true")
        if route.looper_algorithm and route.decision is not None \
                and not is_looper_sub and self.looper_execute is not None:
            try:
                model, resp_body, extra = self.looper_execute(
                    route, state.headers)
                out_headers = dict(route.headers)
                out_headers.update(extra)
                out_headers[H.MODEL] = model
                return _immediate(200, resp_body, out_headers)
            except Exception as exc:
                component_event("extproc", "looper_error", error=str(exc))
                # fall through to single-model routing (fail open)

        state.inflight_token = default_tracker.begin(route.model)
        mutated = json.dumps(route.body).encode()
        set_hdrs = dict(route.headers)
        set_hdrs["content-length"] = str(len(mutated))
        if getattr(route, "trace_id", "") \
                and getattr(route, "root_span_id", ""):
            # the request's trace continues toward the backend: upstream
            # spans parent under the router.route root span
            self.router.tracer.inject(route.trace_id, route.root_span_id,
                                      set_hdrs)
        return pb.ProcessingResponse(request_body=pb.BodyResponse(
            response=pb.CommonResponse(
                status=pb.CommonResponse.CONTINUE,
                header_mutation=_set_headers(set_hdrs),
                body_mutation=pb.BodyMutation(body=mutated),
                # Envoy re-evaluates its route config, so the header-match
                # cluster selection sees x-vsr-selected-model
                clear_route_cache=True)))

    def _on_response_headers(self, msg: pb.HttpHeaders,
                             state: _StreamState) -> pb.ProcessingResponse:
        hdrs = _headers_to_dict(msg.headers)
        try:
            state.response_status = int(hdrs.get(":status", "200"))
        except ValueError:
            state.response_status = 200
        state.is_sse = "text/event-stream" in hdrs.get("content-type", "")
        common = pb.CommonResponse(status=pb.CommonResponse.CONTINUE)
        echo: Dict[str, str] = {}
        record_id = getattr(state.route, "decision_record_id", "") \
            if state.route is not None else ""
        if record_id:
            # the routing audit record's id on the response: a caller
            # holding a completion fetches the decision chain at
            # GET /debug/decisions/<id>
            echo[H.DECISION_RECORD] = record_id
        if state.route is not None:
            # a response routed under a degraded ladder says so even when
            # the request-path header mutation was already sent
            lvl = (state.route.headers or {}).get(H.DEGRADATION, "")
            if lvl:
                echo[H.DEGRADATION] = lvl
        if echo:
            common = pb.CommonResponse(
                status=pb.CommonResponse.CONTINUE,
                header_mutation=_set_headers(echo))
        resp = pb.ProcessingResponse(response_headers=pb.HeadersResponse(
            response=common))
        if state.is_sse:
            # buffering an SSE stream would stall the client: the response
            # body switches to streamed pass-through (allow_mode_override)
            resp.mode_override.response_body_mode = pb.ProcessingMode.STREAMED
        return resp

    def _on_response_body(self, msg: pb.HttpBody, state: _StreamState
                          ) -> Optional[pb.ProcessingResponse]:
        cont = pb.ProcessingResponse(response_body=pb.BodyResponse(
            response=pb.CommonResponse(status=pb.CommonResponse.CONTINUE)))
        if state.passthrough:
            return cont  # a skipped stream: no accumulation either way
        if state.response_chunks is not None:
            state.response_chunks.append(bytes(msg.body))
            if sum(len(c) for c in state.response_chunks) \
                    > self.MAX_BODY_BYTES:
                # the response already streams to the client, so no 413:
                # stop buffering and skip the end-of-stream bookkeeping
                state.response_chunks = None
        if not msg.end_of_stream:
            return cont  # a streamed chunk passes through untouched
        if state.response_chunks is None:
            return cont  # an over-budget stream: no cache, no feedback
        raw = b"".join(state.response_chunks)
        state.response_chunks = []
        route = state.route
        if route is None:
            return cont
        if state.inflight_token is not None:
            default_tracker.end(route.model, state.inflight_token)
            state.inflight_token = None
        latency_ms = (time.perf_counter() - state.t_start) * 1e3 \
            if state.t_start else 0.0
        success = state.response_status == 200

        # the upstream health feed at the model level (endpoint ""):
        # Envoy owns endpoint selection; the selection-time candidate mask
        # and the x-vsr-fallback-models ranking both read it
        up = getattr(self.router, "upstream_health", None)
        if up is not None:
            try:
                up.record(route.model, "",
                          state.response_status < 500,
                          latency_ms / 1e3,
                          kind="ok" if state.response_status < 500
                          else "5xx")
            except Exception:
                pass

        if state.is_sse:
            final = self._assemble_sse(raw)
            try:
                if success and final is not None:
                    self.router.process_response(route, final)
                self.router.record_feedback(route, success=success,
                                            latency_ms=latency_ms)
            except Exception:
                pass
            return cont

        try:
            body = json.loads(raw or b"{}")
        except json.JSONDecodeError:
            self.router.record_feedback(route, success=False,
                                        latency_ms=latency_ms)
            return cont
        try:
            if success:
                processed = self.router.process_response(route, body)
                self.router.record_feedback(route, success=True,
                                            latency_ms=latency_ms)
                if processed.headers or processed.body is not body:
                    mutated = json.dumps(processed.body).encode()
                    set_hdrs = dict(processed.headers)
                    set_hdrs["content-length"] = str(len(mutated))
                    return pb.ProcessingResponse(
                        response_body=pb.BodyResponse(
                            response=pb.CommonResponse(
                                status=pb.CommonResponse.CONTINUE,
                                header_mutation=_set_headers(set_hdrs),
                                body_mutation=pb.BodyMutation(
                                    body=mutated))))
            else:
                self.router.record_feedback(route, success=False,
                                            latency_ms=latency_ms)
        except Exception as exc:
            component_event("extproc", "response_error", error=str(exc))
        return cont

    @staticmethod
    def _assemble_sse(raw: bytes) -> Optional[Dict[str, Any]]:
        """Reassemble an accumulated SSE body into one final chat
        completion for the cache and feedback (sse_frame_buffer.go)."""
        text_parts = []
        usage: Dict[str, Any] = {}
        for line in raw.splitlines():
            line = line.strip()
            if not line.startswith(b"data:"):
                continue
            payload = line[5:].strip()
            if payload == b"[DONE]":
                continue
            try:
                chunk = json.loads(payload)
            except json.JSONDecodeError:
                continue
            for choice in chunk.get("choices", ()):
                delta = choice.get("delta") or {}
                if delta.get("content"):
                    text_parts.append(delta["content"])
            if chunk.get("usage"):
                usage = chunk["usage"]
        if not text_parts:
            return None
        return {"choices": [{"message": {
            "role": "assistant", "content": "".join(text_parts)},
            "finish_reason": "stop"}], "usage": usage}


def build_looper_executor(cfg, default_backend: str = "",
                          timeout_s: float = 120.0):
    """Multi-model strategies behind Envoy: the filter itself is the
    looper's client and answers with an ImmediateResponse.  Returns
    callable(route, headers) -> (model, response_body, extra_headers)
    for ``ExtProcServer(looper_execute=...)``; backends resolve through
    ``modelCards[].backend_refs``, else ``default_backend``."""
    from ..looper import HTTPLLMClient, Looper
    from ..looper.workflows import WorkflowsLooper, \
        build_workflow_state_store
    from ..router.server import BackendResolver

    resolver = BackendResolver(cfg, default_backend)
    client = HTTPLLMClient(resolver.resolve, timeout_s)
    # one long-lived pool for every looper request; the state store
    # honours the looper.workflow_state config as the HTTP server does
    pool = ThreadPoolExecutor(max_workers=16,
                              thread_name_prefix="extproc-looper")
    workflows = WorkflowsLooper(
        client, pool=pool,
        state_store=build_workflow_state_store(getattr(cfg, "looper", {})))

    def execute(route, headers):
        # Envoy's HTTP/2 pseudo-headers (:method, :path, :authority) name
        # the request to the filter; an HTTP/1.1 upstream call cannot
        # carry them (the reference forwards them and its looper calls
        # fail, so its looper decisions fall back to one model)
        headers = {k: v for k, v in (headers or {}).items()
                   if not k.startswith(":")}
        decision = route.decision.decision
        if route.looper_algorithm == "workflows":
            result = workflows.execute(decision.algorithm,
                                       decision.model_refs, route.body,
                                       headers=headers)
        else:
            result = Looper(client, pool=pool).execute(
                decision.algorithm, decision.model_refs,
                route.body, headers=headers)
        extra = {H.LOOPER_ALGORITHM: result.algorithm,
                 H.LOOPER_CANDIDATES: ",".join(result.candidates_used)}
        return result.model, result.body, extra

    return execute


class ExtProcServer:
    """The gRPC server: binds the service on ``port`` (0 = ephemeral) of
    127.0.0.1 and serves until ``stop()``."""

    def __init__(self, router: Router, port: int = 0,
                 max_workers: int = 16, looper_execute=None) -> None:
        import grpc

        self.service = ExtProcService(router, looper_execute=looper_execute)
        self._server = grpc.server(
            ThreadPoolExecutor(max_workers=max_workers,
                               thread_name_prefix="extproc"),
            options=[("grpc.max_receive_message_length", 64 * 1024 * 1024),
                     ("grpc.max_send_message_length", 64 * 1024 * 1024)])
        rpc = grpc.stream_stream_rpc_method_handler(
            self.service.Process,
            request_deserializer=pb.ProcessingRequest.FromString,
            response_serializer=pb.ProcessingResponse.SerializeToString)
        self._server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(
                SERVICE_NAME, {"Process": rpc}),))
        self.port = self._server.add_insecure_port(f"127.0.0.1:{port}")

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def start(self) -> "ExtProcServer":
        self._server.start()
        return self

    def stop(self, grace: float = 0.5) -> None:
        self._server.stop(grace).wait()
        self.service.close()
