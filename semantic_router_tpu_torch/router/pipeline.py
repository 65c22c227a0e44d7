"""The request/response routing pipeline, trimmed to the port's main path:

  parse → rate limit (``rate_limited``, 429 with ``retry-after``) →
  skip-processing (``x-vsr-skip-processing``, only when the operator
  enabled it: ``passthrough``) → the request model's routing profile (an
  entrypoint's virtual name selects its recipe's dispatcher and decision
  engine) → the overload gate (the degradation ladder, above L0 only:
  ``shed``, 429 with ``retry-after``; L4 fail-static, the static model
  with no signal work; L2 brownout, the request's class routes without
  the learned families but the safety floor, or on a truncated cascade)
  → prompt compression (shed from L1) and the skipped families (operator
  ``skip_signals``; ``x-vsr-skip-signals`` behind
  ``allow_skip_signals_header``) → signal fan-out (heuristic families,
  fused classifier bank, embedding-scored and kb families), or, with
  ``engine.cascade`` attached, the decision-aware cascade's waves
  (engine/cascade) → complexity composers and
  projections → decision engine → policy plugins (``fast_response``
  answers without the backend; PII matches stamp
  ``x-vsr-pii-violation`` or, with the decision's ``pii`` plugin at
  ``action: block``, refuse with 403) → semantic cache (the decision's
  ``semantic-cache`` plugin) → model selection (the decision's
  ``algorithm`` through the selector registry, over query embeddings
  where the algorithm reads them; a looper algorithm's highest-weight
  ref, the server then executing the looper over the decision's
  models; with the upstream plane, a
  model whose every endpoint circuit is open is masked while others
  remain, and the ranked alternates ride ``x-vsr-fallback-models``) →
  request mutation
  (``system_prompt``, ``memory`` retrieval,
  ``tools`` / ``tool_selection`` filtering and auto-selection) → request
  rewrite (model, reasoning fields) → x-vsr-* headers;

and the response path: the response jailbreak screen → hallucination
spans (the ``hallucination`` token classifier, filtered by the ``nli``
classifier; gated on the ``fact_check`` signal and the decision's
``hallucination`` plugin) → warnings → the cache write (shed from L1)
→ memory auto-store; then ``record_feedback`` feeds the outcome to the
decision's selector.

The dispatch report on the result carries the projection trace and the
kb family's metrics (``report.results["kb"].metrics``).

Observability, as the JAX router's: each request is one ``router.route``
span continuing the client's W3C ``traceparent`` (``signals.evaluate``,
the per-family ``signal.<family>`` spans and ``decision.evaluate`` under
it, and through the batcher the engine's ``batch.*`` spans); the
canonical series (``observability.metrics.MetricSeries``) count routes,
decisions, rule hits, cache lookups, policy blocks and latencies; a
sampled request's decision record (``observability.explain``) is
committed and named in ``x-vsr-decision-record``; and every request is
offered to the slow-request flight recorder.

Signal families, plugins and response stages fail open: a dead engine
degrades routing to the default model, never to an outage.
"""

from __future__ import annotations

import dataclasses
import logging
import re
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from ..cache.semantic_cache import build_cache
from ..config.schema import LOOPER_ALGORITHMS, Decision, ModelRef, \
    RouterConfig, refuse_flywheel_artifact
from ..decision.engine import DecisionEngine, DecisionResult, SignalMatches
from ..observability import metrics as M
from ..observability.explain import default_decision_explainer
from ..observability.flightrec import default_flight_recorder
from ..observability.logging import component_event
from ..observability.tracing import PendingTrace, default_tracer, \
    new_span_id
from ..resilience.controller import default_degradation_controller
from ..resilience.priority import PriorityResolver
from ..selection import Feedback, SelectionContext, registry as selectors
from ..signals.base import RequestContext
from ..signals.dispatch import DispatchReport, build_dispatcher
from . import headers as H
from .promptcompression import PromptCompressor
from .ratelimit import RateLimiter

log = logging.getLogger(__name__)

# the engine task the semantic cache (when its config names none),
# selection, tools selection, memory and the server's embeddings and
# similarity routes embed with
EMBEDDING_TASK = "embedding"


@dataclass
class RouteResult:
    # "route" | "cache_hit" | "blocked" | "rate_limited" | "shed" |
    # "passthrough" (an L4 fail-static request is a "route" whose
    # selection_reason is "fail_static")
    kind: str
    model: str = ""
    body: Optional[Dict[str, Any]] = None
    headers: Dict[str, str] = field(default_factory=dict)
    # the answer itself, when the router answers without the backend
    response_body: Optional[Dict[str, Any]] = None
    status: int = 200
    decision: Optional[DecisionResult] = None
    signals: Optional[SignalMatches] = None
    report: Optional[DispatchReport] = None
    selection_reason: str = ""
    routing_latency_s: float = 0.0
    request_id: str = ""
    # a looper decision's algorithm: the server executes it over the
    # decision's models (``looper/``)
    looper_algorithm: str = ""
    # the request's trace and its root (router.route) span, and the
    # committed decision record's id ("" when not sampled)
    trace_id: str = ""
    root_span_id: str = ""
    decision_record_id: str = ""
    # the upstream plane's ranked next-best models (failover targets)
    fallback_models: List[str] = field(default_factory=list)


@dataclass
class ResponseResult:
    """The response path's verdict on a backend answer: the body to send
    (annotated when the hallucination plugin asks), the headers to add,
    the warnings, and the hallucination spans found."""

    body: Dict[str, Any]
    headers: Dict[str, str] = field(default_factory=dict)
    warnings: List[str] = field(default_factory=list)
    hallucination_spans: List[dict] = field(default_factory=list)


def _immediate_chat_completion(content: str, model: str = "router") -> dict:
    return {
        "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant", "content": content},
            "finish_reason": "stop",
        }],
        "usage": {"prompt_tokens": 0, "completion_tokens": 0,
                  "total_tokens": 0},
    }


def usage_cost(usage: Dict[str, Any], pricing: Dict[str, float]) -> float:
    """$ cost of one response from its usage block and a model card's
    per-Mtok pricing."""
    return ((usage or {}).get("prompt_tokens", 0) / 1e6
            * (pricing or {}).get("prompt", 0.0)
            + (usage or {}).get("completion_tokens", 0) / 1e6
            * (pricing or {}).get("completion", 0.0))


def _tool_name(t: dict) -> str:
    return (t.get("function", {}) or {}).get("name", t.get("name", ""))


def _tool_desc(t: dict) -> str:
    f = t.get("function", {}) or {}
    return f"{_tool_name(t)}: {f.get('description', '')}"


class Router:
    """The routing pipeline.  Embed directly, or serve via router.server.

    With ``semantic_cache.enabled`` the router keeps a semantic cache on
    the engine's ``semantic_cache.embedding_model`` task
    (``EMBEDDING_TASK`` when that is empty), provided the engine serves
    it.  ``memory_store`` (None until bootstrap attaches one) backs the
    ``memory`` plugin and the response path's auto-store;
    ``vectorstores`` (a ``VectorStoreManager``, None until bootstrap
    attaches one) holds the named stores the ``rag`` plugin searches.
    ``metrics`` (a MetricSeries), ``tracer``, ``flightrec`` and
    ``explain`` bind the
    router's observability, ``resilience`` its degradation controller
    (None: the process defaults; the default controller stays disabled
    at L0 until bootstrap configures it).  ``upstream_health`` (None
    until bootstrap attaches the upstream plane) masks models whose
    circuits are open and ranks the failover alternates."""

    def __init__(self, cfg: RouterConfig, engine=None, metrics=None,
                 tracer=None, flightrec=None, explain=None,
                 resilience=None) -> None:
        self.cfg = cfg
        self.engine = engine
        self.M = metrics or M.default_series
        self.tracer = tracer or default_tracer
        self.flightrec = flightrec if flightrec is not None \
            else default_flight_recorder
        # tail-based sampling: a request the recorder retains pins its
        # trace as force-sampled on this router's tracer.  The process
        # default recorder pairs only with the default tracer.
        paired = flightrec is not None or self.tracer is default_tracer
        if paired and self.flightrec.on_retain is None:
            self.flightrec.on_retain = self.tracer.force_sample
        self.explain = explain if explain is not None \
            else default_decision_explainer
        # the shed-ladder gate every request passes (one integer read at
        # L0), and the one place a request's priority class is derived
        self.resilience = resilience if resilience is not None \
            else default_degradation_controller
        self.priority = PriorityResolver.from_config(
            cfg.resilience_config())
        self.upstream_health = None
        # the shared state plane (stateplane.StatePlane), attached by
        # build_router when stateplane.enabled; None = single process
        self.stateplane = None
        self._cfg_hash: Optional[str] = None
        # a flywheel-trained selector artifact is refused at boot, as at
        # load (its file may have been written since)
        for dec in list(cfg.decisions) + [d for r in cfg.recipes
                                          for d in r.decisions]:
            artifact = (dec.algorithm or {}).get("artifact")
            if artifact:
                refuse_flywheel_artifact(dec.name, str(artifact))
        self.dispatcher = build_dispatcher(cfg, engine)
        self.decision_engine = DecisionEngine(cfg.decisions, cfg.strategy)
        # each recipe's own dispatcher and decision engine, built once: a
        # request resolves its profile with a dict lookup
        self._recipe_engines: Dict[str, tuple] = {}
        for rec in cfg.recipes:
            sub = dataclasses.replace(
                cfg, signals=rec.signals, projections=rec.projections,
                decisions=rec.decisions, strategy=rec.strategy)
            self._recipe_engines[rec.name] = (
                build_dispatcher(sub, engine, learned_cfg=cfg),
                DecisionEngine(rec.decisions, rec.strategy))
        # each dispatcher's learned families, frozen at construction: the
        # overload gate reads them per request while degraded
        self._learned_types: Dict[int, List[str]] = {
            id(d): d.learned_types() for d in
            [self.dispatcher] + [d for d, _ in
                                 self._recipe_engines.values()]}
        self.rate_limiter = RateLimiter.from_config(cfg.ratelimit)
        sp_cfg = cfg.skip_processing or {}
        self._skip_enabled = bool(sp_cfg.get("enabled", False))
        self._allow_skip_signals_header = bool(
            sp_cfg.get("allow_skip_signals_header", False))
        self._skip_signals_cfg = [str(s) for s in
                                  (sp_cfg.get("skip_signals", []) or [])]
        pc_cfg = cfg.prompt_compression or {}
        self.compressor = PromptCompressor(
            profile=pc_cfg.get("profile", "default"),
            target_ratio=float(pc_cfg.get("target_ratio", 0.5)),
        ) if pc_cfg.get("enabled") else None
        self.pc_min_tokens = int(pc_cfg.get("min_tokens", 512))
        # the decision-aware cascade (engine.cascade.CascadeEvaluator),
        # attached by bootstrap's apply_cascade_knobs; None = full fan-out
        self.cascade = None
        cache_task = cfg.semantic_cache.embedding_model or EMBEDDING_TASK
        self.cache = None
        if cfg.semantic_cache.enabled and engine is not None \
                and engine.has_task(cache_task):
            self.cache = build_cache(
                cfg.semantic_cache,
                lambda text: engine.embed(cache_task, [text])[0])
        self.model_cards = {m.name: m for m in cfg.model_cards}
        # router learning: outcome-driven adaptation over the decision's
        # candidates and session protection; None unless enabled
        self.learning = None
        if (cfg.learning or {}).get("enabled"):
            from ..learning import RouterLearning

            self.learning = RouterLearning(
                cfg.learning,
                model_costs={m.name: float(
                    (m.pricing or {}).get("prompt", 0.0))
                    for m in cfg.model_cards},
                quality_seeds={m.name: m.quality_score
                               for m in cfg.model_cards
                               if m.quality_score > 0})
        # the operator's tools database for auto-selection; its
        # description embeddings are computed once, at first use
        self._tools_db: List[dict] = list(
            (cfg.tool_selection or {}).get("tools", []) or [])
        self._tools_db_embs: Optional[np.ndarray] = None
        # one selector per decision, built at its first request
        self._selectors: Dict[str, Any] = {}
        self.memory_store = None
        self.vectorstores = None
        # callables (route, backend body, ResponseResult) run at the end
        # of process_response; bootstrap appends the replay recorder and
        # keeps its store as ``replay_store``
        self.response_hooks: List[Any] = []
        self.replay_store = None

    def skip_requested(self, headers: Dict[str, str]) -> bool:
        """True when skip-processing is enabled and the request asks for
        it (``x-vsr-skip-processing: 1 | true``)."""
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        return self._skip_enabled and headers.get(
            H.SKIP_PROCESSING, "").lower() in ("1", "true")

    def _engines_for_model(self, model: str) -> tuple:
        """(dispatcher, decision engine, via_entrypoint) for a request's
        model name: an entrypoint's virtual name selects its recipe's
        engines (the top-level ones for the ``default`` recipe); any other
        name the top-level ones."""
        if self._recipe_engines or self.cfg.entrypoints:
            rec = self.cfg.recipe_for_request_model(model)
            if rec is not None:
                pair = self._recipe_engines.get(rec.name)
                if pair is not None:
                    return pair[0], pair[1], True
                return self.dispatcher, self.decision_engine, True
        return self.dispatcher, self.decision_engine, False

    def _prepare_signal_view(self, ctx: RequestContext,
                             headers: Dict[str, str],
                             compress: bool = True) -> List[str]:
        """What reaches the classifiers: with ``compress``, compresses a
        long prompt in ``ctx`` (in place) and returns the families to
        skip — the operator's, plus the request header's only behind
        ``allow_skip_signals_header`` (a client must not empty e.g. the
        pii family and dodge its policy)."""
        if compress and self.compressor is not None \
                and ctx.approx_token_count() >= self.pc_min_tokens:
            ctx._user_text = self.compressor.compress(ctx.user_text).text
        skip = list(self._skip_signals_cfg)
        if self._skip_enabled and self._allow_skip_signals_header:
            skip += [s.strip() for s in
                     headers.get(H.SKIP_SIGNALS, "").split(",")
                     if s.strip()]
        return skip

    def _compress_allowed(self) -> bool:
        """Prompt compression is optional work: shed while the ladder is
        at L1 or above."""
        return self.resilience is None \
            or not self.resilience.shed_optional_active()

    def _learned_families(self, dispatcher, keep=()) -> List[str]:
        """Engine-backed families of ``dispatcher`` minus the brownout
        safety floor ``keep``."""
        return [t for t in self._learned_types[id(dispatcher)]
                if t not in keep]

    def _signals_cfg_for(self, dispatcher):
        """The SignalsConfig ``dispatcher`` was built from (the cascade's
        planner resolves projection members through it); None for a
        dispatcher of neither profile."""
        if dispatcher is self.dispatcher:
            return self.cfg.signals
        for name, (disp, _eng) in self._recipe_engines.items():
            if disp is dispatcher:
                rec = self.cfg.recipe_by_name(name)
                return rec.signals if rec is not None else None
        return None

    def _embeds(self) -> bool:
        return self.engine is not None and self.engine.has_task(EMBEDDING_TASK)

    def _embed(self, texts: List[str]) -> np.ndarray:
        return self.engine.embed(EMBEDDING_TASK, texts)

    def begin_pending_trace(self, headers: Optional[Dict[str, str]] = None
                            ) -> PendingTrace:
        """Mint the (trace_id, root_span_id) a later ``route()`` call will
        adopt: the streamed-prefetch trace seam.  A prefetch enqueued with
        it parents its spans under the root span the request will get."""
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        trace_id, parent = self.tracer.extract(headers)
        return PendingTrace(self.tracer, trace_id, new_span_id(), parent)

    def evaluate_signals(self, body: Dict[str, Any],
                         headers: Optional[Dict[str, str]] = None,
                         pending: Optional[PendingTrace] = None) -> tuple:
        """(signals, report) exactly as ``route()`` evaluates them (the
        same compression, skip view and recipe): the overlap seam of a
        streamed body, whose complete ``messages`` array can start
        classification while the rest arrives.  The degradation ladder's
        brownout gates it too; ``report.compressed_view`` records the
        compression decision for ``route()`` to keep.  ``pending``
        (``begin_pending_trace``) parents the evaluation's spans under the
        request's future ``router.route`` span."""
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        ctx = RequestContext.from_openai_body(body, headers)
        compress = self._compress_allowed()
        skip = self._prepare_signal_view(ctx, headers, compress=compress)
        dispatcher, _, _ = self._engines_for_model(ctx.model)
        # a browned-out priority class must not spend fused-bank capacity
        # on an early evaluation the inline path would skip (read only:
        # shedding and admission stay in route(), which answers)
        if self.resilience is not None and self.resilience.level() > 0:
            try:
                if self.resilience.browned_out(self.priority.resolve(ctx)):
                    skip = skip + self._learned_families(
                        dispatcher,
                        getattr(self.resilience, "brownout_keep", ()))
            except Exception:
                pass
        if pending is None:
            signals, report = dispatcher.evaluate(ctx, skip_signals=skip)
        else:
            with self.tracer.span("signals.evaluate",
                                  trace_id=pending.trace_id,
                                  parent_id=pending.root_span_id,
                                  prefetch=True):
                signals, report = dispatcher.evaluate(ctx,
                                                      skip_signals=skip)
        report.compressed_view = compress
        return signals, report

    def route(self, body: Dict[str, Any],
              headers: Optional[Dict[str, str]] = None,
              precomputed_signals: Optional[tuple] = None,
              pending_trace: Optional[PendingTrace] = None) -> RouteResult:
        """Route one chat request.  ``precomputed_signals`` is the
        (signals, report) of ``evaluate_signals`` on the same body (a
        streamed prefetch); ``pending_trace`` the trace it was evaluated
        under, whose root span id ``router.route`` adopts."""
        start = time.perf_counter()
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        request_id = headers.get(H.REQUEST_ID, uuid.uuid4().hex[:16])
        # ONE root span per request, continuing the caller's traceparent:
        # the signal fan-out and the batcher's batch.wait / batch.ride
        # spans all hang off this trace
        if pending_trace is not None:
            trace_id, parent_span = pending_trace.trace_id, \
                pending_trace.parent_id
        else:
            trace_id, parent_span = self.tracer.extract(headers)
        # the decision-record sampling gate runs once, here; every capture
        # downstream is a no-op when rec is None
        rec = self.explain.begin(trace_id, request_id)
        with self.tracer.span("router.route", trace_id=trace_id,
                              parent_id=parent_span,
                              request_id=request_id) as root:
            if pending_trace is not None:
                # before any child span opens: children read the parent
                # id when they are created
                root.span_id = pending_trace.root_span_id
            result = self._route_impl(body, headers, request_id, trace_id,
                                      start, rec, precomputed_signals)
            result.trace_id = trace_id
            result.root_span_id = root.span_id
            root.set(kind=result.kind, model=result.model)
        # degradation echo: while the ladder is above L0 every response
        # carries the level, so clients and balancers see brownouts
        if self.resilience is not None:
            lvl = self.resilience.level()
            if lvl > 0:
                result.headers.setdefault(H.DEGRADATION, str(lvl))
                if rec is not None:
                    rec.degradation_level = max(rec.degradation_level, lvl)
        self._commit_decision_record(rec, result)
        self._flight_record(result, trace_id, request_id,
                            time.perf_counter() - start)
        return result

    def _config_hash(self) -> str:
        if self._cfg_hash is None:
            from ..config.schema import config_hash

            self._cfg_hash = config_hash(self.cfg.raw)
        return self._cfg_hash

    def _commit_decision_record(self, rec, result: RouteResult) -> None:
        """Freeze and ring the request's decision record, and name it in
        ``x-vsr-decision-record``.  A passthrough, rate-limited or shed
        request ran no signal, so it leaves no record."""
        if rec is None or result.kind in ("passthrough", "rate_limited",
                                          "shed"):
            return
        record = rec.finish(
            kind=result.kind, model=result.model,
            latency_ms=result.routing_latency_s * 1e3, query=rec.query,
            redact_pii=self.explain.redact_pii,
            config_hash=self._config_hash())
        result.decision_record_id = self.explain.commit(record)
        result.headers[H.DECISION_RECORD] = result.decision_record_id
        self.M.decision_records.inc(kind=result.kind)

    def _flight_record(self, result: RouteResult, trace_id: str,
                       request_id: str, duration_s: float) -> None:
        """Offer the finished request to the slow-request flight recorder;
        the span tree only serializes when the recorder keeps it."""
        if self.flightrec is None:
            return
        self.flightrec.consider(
            request_id=request_id, trace_id=trace_id,
            duration_s=duration_s,
            span_provider=lambda: self.tracer.trace(trace_id),
            meta={"kind": result.kind, "model": result.model,
                  "decision": result.decision.decision.name
                  if result.decision else ""})

    def _route_impl(self, body: Dict[str, Any], headers: Dict[str, str],
                    request_id: str, trace_id: str, start: float,
                    rec, precomputed_signals=None) -> RouteResult:
        ctx = RequestContext.from_openai_body(body, headers)
        # the rate limit runs before any client-controlled skip, so a
        # bypass header cannot evade it
        rl = self.rate_limiter.check(ctx.user_id, ctx.model)
        if not rl.allowed:
            return RouteResult(
                kind="rate_limited", status=429, request_id=request_id,
                response_body={"error": {
                    "message": "rate limit exceeded",
                    "type": "rate_limit_exceeded",
                    "retry_after": round(rl.retry_after_s, 2)}},
                headers={H.RETRY_AFTER: str(int(rl.retry_after_s) + 1)})
        if self.skip_requested(headers):
            return RouteResult(kind="passthrough", body=body,
                               request_id=request_id)
        # the overload gate speaks before any signal work; it fails open —
        # a broken controller degrades to full service, never an outage.
        # The engines resolve first, so the gate costs the request's own
        # dispatcher's learned families
        dispatcher, decision_engine, via_entrypoint = \
            self._engines_for_model(ctx.model)
        disp = None
        if self.resilience is not None and self.resilience.level() > 0:
            try:
                disp = self.resilience.admit(
                    self.priority.resolve(ctx),
                    n_signals=len(self._learned_families(dispatcher)) or 1)
            except Exception:
                disp = None
        if disp is not None and rec is not None:
            rec.degradation_level = disp.level
        if disp is not None and disp.action == "shed":
            # L3+ admission: 429 + Retry-After, load-driven
            return RouteResult(
                kind="shed", status=429, request_id=request_id,
                response_body={"error": {
                    "message": "router overloaded — request shed "
                               f"({disp.reason})",
                    "type": "overloaded",
                    "retry_after": round(disp.retry_after_s, 2)}},
                headers={H.RETRY_AFTER: str(int(disp.retry_after_s) + 1),
                         H.DEGRADATION: str(disp.level),
                         H.PRIORITY: disp.priority})
        if disp is not None and disp.fail_static:
            return self._fail_static(body, ctx, request_id, trace_id,
                                     start, disp, rec)
        # compression and the skip view are evaluate_signals()'s too; a
        # prefetched view keeps its recorded compression decision, so a
        # ladder move between the prefetch and here cannot make
        # ctx.user_text (which the cache, selection and memory read)
        # differ from the text its signals saw
        compress = self._compress_allowed()
        if precomputed_signals is not None:
            recorded = getattr(precomputed_signals[1], "compressed_view",
                               None)
            if recorded is not None:
                compress = recorded
        skip = self._prepare_signal_view(ctx, headers, compress=compress)
        browned = (disp is not None and not disp.use_learned
                   and precomputed_signals is None)
        if browned and self.cascade is None:
            # L2 brownout: this class routes without the engine-backed
            # families, except the safety floor (disp.keep_families);
            # with the cascade attached the same level truncates the
            # cascade instead.  A streamed prefetch already paid the
            # forward: it is kept
            skip = skip + self._learned_families(dispatcher,
                                                 disp.keep_families)
        if precomputed_signals is not None:
            # evaluated while the body was still arriving, on the same
            # text, skip view and recipe
            signals, report = precomputed_signals
        else:
            with self.tracer.span("signals.evaluate",
                                  request_id=request_id):
                if self.cascade is not None:
                    signals, report = self.cascade.evaluate(
                        ctx, dispatcher, decision_engine,
                        signals_cfg=self._signals_cfg_for(dispatcher),
                        brownout=browned, skip_signals=skip)
                else:
                    signals, report = dispatcher.evaluate(
                        ctx, skip_signals=skip)
        for family, res in report.results.items():
            # trace-id exemplar: a slow signal-latency bucket links to a
            # trace that landed there (no-op unless exemplars are on)
            self.M.signal_latency.observe(res.latency_s, family=family,
                                          exemplar=trace_id)
            if res.error:
                self.M.signal_errors.inc(family=family)
        if rec is not None:
            rec.query = ctx.user_text
            rec.capture_signals(signals, report, self.explain.redact_pii)
            if report.cascade is not None:
                rec.capture_cascade(report.cascade)
        decision_trace = [] if rec is not None else None
        with self.tracer.decision_span():
            decision_res = decision_engine.evaluate(
                signals, trace=decision_trace)
        self.M.decision_latency.observe(decision_engine.last_eval_latency_s)
        if rec is not None:
            rec.capture_rule_trace(decision_trace)
        result = RouteResult(kind="route", request_id=request_id,
                             signals=signals, report=report,
                             decision=decision_res, body=dict(body))
        if decision_res is None:
            # an entrypoint's virtual name never reaches a backend: with no
            # default model the recipe path falls to the model catalog
            if via_entrypoint and not self.cfg.default_model:
                result.model = (self.cfg.model_cards[0].name
                                if self.cfg.model_cards else ctx.model)
            else:
                result.model = self.cfg.default_model or ctx.model
            result.headers = {H.SCHEMA: H.SCHEMA_VERSION,
                              H.MODEL: result.model}
            self._stamp_affinity(result, ctx)
            self.M.decision_fallbacks.inc(reason="no_decision_matched")
            if rec is not None:
                rec.fallback_reason = "no_decision_matched"
            ref = None
        else:
            decision = decision_res.decision
            self.M.decision_matches.inc(name=decision.name)
            for rule in decision_res.matched_rules:
                self.M.rule_hits.inc(rule=rule, decision=decision.name)
            if rec is not None:
                rec.capture_decision(decision_res, decision_engine.strategy)
            early = self._apply_policy_plugins(decision, signals, result,
                                               rec)
            if early is None:
                early = self._check_cache(decision, ctx, result, rec)
                if early is not None:
                    self._stamp_affinity(early, ctx)
            if early is not None:
                early.routing_latency_s = time.perf_counter() - start
                self.M.routing_latency.observe(early.routing_latency_s,
                                               exemplar=trace_id,
                                               model=early.model)
                return early
            ref, result.selection_reason = self._select_model(
                decision, ctx, signals)
            ref, result.selection_reason = self._apply_learning(
                decision, ctx, ref, result.selection_reason)
            result.model = ref.model
            if result.selection_reason.startswith("selector error"):
                self.M.decision_fallbacks.inc(reason="selector_error")
                if rec is not None:
                    rec.fallback_reason = "selector_error"
            if rec is not None:
                self._capture_selection(rec, decision, ref,
                                        result.selection_reason, ctx,
                                        signals)
            algo = str((decision.algorithm or {}).get("type", "static"))
            if algo in LOOPER_ALGORITHMS:
                result.looper_algorithm = algo
            self._apply_mutation_plugins(decision, ctx, result)
            if self.upstream_health is not None:
                # ranked next-best candidates for the server's budgeted
                # failover
                alts = self._ranked_alternates(decision, ref, ctx, signals)
                if alts:
                    result.fallback_models = alts
                    result.headers[H.FALLBACK_MODELS] = ",".join(alts)
            category = next(iter(signals.matches.get("domain", ())), "")
            result.headers.update(H.decision_headers(
                decision.name, ref.model, category=category,
                use_reasoning=ref.use_reasoning,
                reasoning_effort=ref.reasoning_effort,
                matched_rules=decision_res.matched_rules))
            self._stamp_affinity(result, ctx)
            self.M.model_requests.inc(model=ref.model,
                                      decision=decision.name)
        self._finalize_body(result, ref)
        result.headers[H.REQUEST_ID] = request_id
        result.routing_latency_s = time.perf_counter() - start
        self.M.routing_latency.observe(result.routing_latency_s,
                                       exemplar=trace_id, model=result.model)
        return result

    def _stamp_affinity(self, result: "RouteResult",
                        ctx: RequestContext) -> None:
        """Replica affinity (the state plane's ring): which replica's hot
        local state — encoding rows, classify memos, captured steps —
        this prompt belongs on.  An affinity-aware load balancer keys
        its hashing off this echo; one blake2b and a ring lookup, only
        when a plane is attached, on every routed response (matched,
        fallback or cache hit)."""
        if self.stateplane is not None:
            try:
                result.headers[H.AFFINITY] = \
                    self.stateplane.owner_of(ctx.user_text)
            except Exception:
                pass

    def _fail_static(self, body: Dict[str, Any], ctx: RequestContext,
                     request_id: str, trace_id: str, start: float, disp,
                     rec) -> RouteResult:
        """L4 fail-static: the configured static model with no signal
        extraction — no classifier forward, no cache, no plugin — still a
        valid routed request."""
        model = getattr(self.resilience, "fail_static_model", "") \
            or self.cfg.default_model \
            or (self.cfg.model_cards[0].name if self.cfg.model_cards
                else ctx.model)
        result = RouteResult(
            kind="route", request_id=request_id, model=model,
            body=dict(body), selection_reason="fail_static")
        self._finalize_body(result, None)
        result.headers = {H.SCHEMA: H.SCHEMA_VERSION, H.MODEL: model,
                          H.REQUEST_ID: request_id,
                          H.DEGRADATION: str(disp.level),
                          H.PRIORITY: disp.priority}
        if rec is not None:
            rec.fallback_reason = "fail_static"
            rec.degradation_level = disp.level
        self.M.decision_fallbacks.inc(reason="fail_static")
        self.M.model_requests.inc(model=model, decision="fail_static")
        result.routing_latency_s = time.perf_counter() - start
        self.M.routing_latency.observe(result.routing_latency_s,
                                       exemplar=trace_id, model=model)
        return result

    def _selection_ctx(self, decision: Decision, ctx: RequestContext,
                       signals: SignalMatches,
                       embed_fn=None) -> SelectionContext:
        """The one SelectionContext construction: selection, the decision
        record's breakdown and the failover ranking see the same."""
        return SelectionContext(
            query=ctx.user_text,
            decision_name=decision.name,
            category=next(iter(signals.matches.get("domain", ())), ""),
            session_id=ctx.headers.get("x-session-id", ""),
            user_id=ctx.user_id,
            signals=signals,
            token_count=ctx.approx_token_count(),
            model_cards=self.model_cards,
            embed_fn=embed_fn)

    def _capture_selection(self, rec, decision: Decision, ref: ModelRef,
                           reason: str, ctx: RequestContext,
                           signals: SignalMatches) -> None:
        """The selection block of the decision record, as the reference
        builds it: a single candidate scores 1.0, a looper's candidates
        their weights, any other decision its selector's
        ``score_breakdown`` (none for a selector without one).  Read-only
        and embed-free: the breakdown adds no device work."""
        try:
            algo_type = str((decision.algorithm or {}).get("type",
                                                           "static"))
            refs = decision.model_refs or []
            breakdown: List[dict] = []
            if len(refs) <= 1:
                breakdown = [{"model": r.model, "score": 1.0,
                              "components": {"single_candidate": True}}
                             for r in refs]
            elif algo_type in LOOPER_ALGORITHMS:
                breakdown = [{"model": r.model, "score": r.weight,
                              "components": {"weight": r.weight,
                                             "looper": algo_type}}
                             for r in refs]
            else:
                fn = getattr(self._selectors.get(decision.name),
                             "score_breakdown", None)
                if fn is not None:
                    breakdown = fn(refs, self._selection_ctx(
                        decision, ctx, signals))
            rec.capture_selection(algo_type, reason, ref.model, breakdown)
        except Exception:
            rec.capture_selection("", reason, ref.model, [])

    def _ranked_alternates(self, decision: Decision, chosen: ModelRef,
                           ctx: RequestContext,
                           signals: SignalMatches) -> List[str]:
        """Next-best candidate models after ``chosen``, best first: the
        selector's score (``score_breakdown``, else the configured
        weight) times the upstream health score, open circuits dropped,
        at most three.  Read-only and embed-free; fails open to none."""
        try:
            refs = [r for r in (decision.model_refs or [])
                    if r.model != chosen.model]
            if not refs:
                return []
            scores: Dict[str, float] = {}
            fn = getattr(self._selectors.get(decision.name),
                         "score_breakdown", None)
            if fn is not None:
                try:
                    for row in fn(decision.model_refs,
                                  self._selection_ctx(decision, ctx,
                                                      signals)):
                        scores[str(row.get("model", ""))] = \
                            float(row.get("score", 0.0))
                except Exception:
                    scores = {}
            up = self.upstream_health
            ranked = sorted(
                refs, key=lambda r: -(scores.get(r.model, r.weight)
                                      * up.health_score(r.model)))
            return [r.model for r in ranked
                    if not up.model_open(r.model)][:3]
        except Exception:
            return []

    def _upstream_mask(self, refs: List[ModelRef]) -> tuple:
        """Drop candidates whose every endpoint circuit is open: an
        unhealthy model is never chosen while alternatives exist.
        Masking never empties the candidate set, and a plane error never
        masks."""
        if self.upstream_health is None or len(refs) <= 1:
            return refs, ()
        try:
            masked = tuple(sorted({r.model for r in refs
                                   if self.upstream_health.model_open(
                                       r.model)}))
            if masked and len(masked) < len(refs):
                return [r for r in refs
                        if r.model not in masked], masked
        except Exception:
            pass
        return refs, ()

    # -- selection -----------------------------------------------------------

    def _selector(self, decision: Decision):
        """The decision's selector, built at its first request from
        ``algorithm`` (type + keyword arguments, or the trained
        ``artifact``); one the registry cannot build is ``static``.  Selectors that run torch (kmeans, mlp) run it
        on the engine's device, holding the engine's capture gate."""
        selector = self._selectors.get(decision.name)
        if selector is None:
            algo = dict(decision.algorithm or {})
            kwargs = {k: v for k, v in algo.items()
                      if k not in ("type", "on_error", "artifact")}
            if self.engine is not None:
                kwargs.update(device=self.engine.device,
                              gate=self.engine.device_work)
            artifact = str(algo.get("artifact") or "")
            if artifact:
                selector = self._artifact_selector(decision, artifact,
                                                   kwargs)
            if selector is None:
                try:
                    selector = selectors.create(
                        str(algo.get("type", "static")), **kwargs)
                except (KeyError, TypeError):
                    selector = selectors.create("static")
            # concurrent first requests keep one selector
            selector = self._selectors.setdefault(decision.name, selector)
        return selector

    @staticmethod
    def _artifact_selector(decision: Decision, artifact: str,
                           kwargs: Dict[str, Any]):
        """The selector an offline-trained artifact cold-starts
        (``training.selection_train.load_selector``; online learning goes
        on from it), or None after an ``artifact_load_failed`` event when
        the file is missing or does not load — the untrained algorithm
        serves then.  A flywheel artifact raises: it is refused, never
        served untrained."""
        from ..training.selection_train import (
            FlywheelArtifactError,
            load_selector,
        )

        try:
            return load_selector(artifact, device=kwargs.get("device"),
                                 gate=kwargs.get("gate"))
        except FlywheelArtifactError:
            raise
        except Exception as exc:
            component_event("selection", "artifact_load_failed",
                            decision=decision.name, artifact=artifact,
                            error=str(exc), level="warning")
            return None

    def _select_model(self, decision: Decision, ctx: RequestContext,
                      signals: SignalMatches) -> tuple:
        """(ref, reason): a single candidate as is, a looper algorithm's
        highest-weight ref (the reference's primary model; the server
        then runs the looper), else the decision's selector's
        choice (its query embedding taken lazily, on the
        ``EMBEDDING_TASK``).  A selector that raises routes to the first
        candidate.  With the upstream plane, models whose every endpoint
        circuit is open are masked first while others remain (the reason
        names them)."""
        refs = decision.model_refs or [
            ModelRef(model=self.cfg.default_model or ctx.model)]
        refs, masked = self._upstream_mask(refs)
        if len(refs) == 1:
            return refs[0], ("single candidate" if not masked else
                             "single healthy candidate (upstream mask: "
                             + ",".join(masked) + ")")
        algo_type = str((decision.algorithm or {}).get("type", "static"))
        if algo_type in LOOPER_ALGORITHMS:
            return max(refs, key=lambda r: r.weight), f"looper:{algo_type}"
        selector = self._selector(decision)
        sctx = self._selection_ctx(
            decision, ctx, signals,
            embed_fn=(lambda text: self._embed([text])[0])
            if self._embeds() else None)
        mask_note = (" (upstream mask: " + ",".join(masked) + ")") \
            if masked else ""
        try:
            res = selector.select(refs, sctx)
            return res.ref, res.reason + mask_note
        except Exception:
            log.warning("selector of %s failed", decision.name,
                        exc_info=True)
            return refs[0], "selector error → first candidate" + mask_note

    # -- request mutation ----------------------------------------------------

    def _apply_mutation_plugins(self, decision: Decision,
                                ctx: RequestContext,
                                result: RouteResult) -> None:
        """The decision's system prompt first (``replace`` / ``insert``
        act on the original system message), then retrieved memories and
        the RAG context ahead of it (the context first), then the
        tools."""
        body = result.body
        sp = decision.plugin("system_prompt")
        if sp is not None and sp.enabled:
            prompt = sp.configuration.get("system_prompt", "")
            mode = sp.configuration.get("mode", "insert")
            if prompt:
                messages = list(body.get("messages", []))
                has_system = messages and messages[0].get("role") == "system"
                if has_system and mode == "replace":
                    messages[0] = {"role": "system", "content": prompt}
                elif has_system and mode == "insert":
                    messages[0] = {
                        "role": "system",
                        "content": prompt + "\n"
                        + messages[0].get("content", "")}
                elif not has_system:
                    messages = [{"role": "system", "content": prompt}] \
                        + messages
                body["messages"] = messages
                result.headers[H.INJECTED_SYSTEM_PROMPT] = "true"

        mem = decision.plugin("memory")
        if mem is not None and mem.enabled \
                and self.memory_store is not None and ctx.user_id:
            try:
                items = self.memory_store.search(
                    ctx.user_id, ctx.user_text,
                    limit=int(mem.configuration.get("retrieval_limit", 5)),
                    threshold=float(
                        mem.configuration.get("similarity_threshold", 0.0)))
                if items:
                    facts = "; ".join(i.text for i in items)
                    body["messages"] = (
                        [{"role": "system",
                          "content": f"Known about this user: {facts}"}]
                        + list(body.get("messages", [])))
                    result.headers[H.MEMORIES_USED] = str(len(items))
            except Exception:
                log.warning("memory retrieval failed", exc_info=True)

        # RAG: the configured store's hits as a system message, first
        rag = decision.plugin("rag")
        if rag is not None and rag.enabled \
                and self.vectorstores is not None:
            try:
                conf = rag.configuration
                store = self.vectorstores.get(conf.get("store", "default"))
                if store is not None:
                    from ..vectorstore.store import format_rag_context

                    hits = store.search(
                        ctx.user_text, top_k=int(conf.get("top_k", 4)),
                        threshold=float(conf.get("threshold", 0.0)))
                    context = format_rag_context(
                        hits, max_chars=int(conf.get("max_chars", 4000)))
                    if context:
                        body["messages"] = (
                            [{"role": "system", "content": context}]
                            + list(body.get("messages", [])))
                        result.headers[H.RAG_CHUNKS] = str(len(hits))
            except Exception:
                log.warning("rag retrieval failed", exc_info=True)

        tools = decision.plugin("tools") or decision.plugin("tool_selection")
        if tools is not None and tools.enabled:
            conf = tools.configuration
            if body.get("tools"):
                body["tools"] = self._filter_tools(conf, ctx, body["tools"])
            elif conf.get("auto_select") and self._tools_db:
                selected = self._auto_select_tools(conf, ctx)
                if selected:
                    body["tools"] = selected
                    result.headers[H.TOOLS_INJECTED] = str(len(selected))

    def _filter_tools(self, conf: Dict[str, Any], ctx: RequestContext,
                      tools: List[dict]) -> List[dict]:
        """Allow / block lists, then (``semantic_selection``) the top-k
        by the similarity of each tool's description to the query."""
        allow = set(conf.get("allow_tools", []) or [])
        block = set(conf.get("block_tools", []) or [])
        out = [t for t in tools
               if (not allow or _tool_name(t) in allow)
               and _tool_name(t) not in block]
        if conf.get("semantic_selection") and self._embeds() and out:
            try:
                top_k = int(conf.get("top_k", 5))
                sims = self._embed([_tool_desc(t) for t in out]) \
                    @ self._embed([ctx.user_text])[0]
                thresh = float(conf.get("similarity_threshold", 0.0))
                ranked = sorted(zip(sims, range(len(out))), reverse=True)
                keep = [i for s, i in ranked[:top_k] if s >= thresh]
                if keep or not conf.get("fallback_to_empty", True):
                    out = [out[i] for i in sorted(keep)] if keep else out
                else:
                    out = []
            except Exception:
                log.warning("tool selection failed", exc_info=True)
        return out

    def _auto_select_tools(self, conf: Dict[str, Any],
                           ctx: RequestContext) -> List[dict]:
        """The top-k tools of the configured database by description
        similarity to the query (word overlap without an embedding
        task)."""
        top_k = int(conf.get("top_k", 3))
        thresh = float(conf.get("similarity_threshold", 0.1))
        try:
            if self._embeds():
                if self._tools_db_embs is None:
                    self._tools_db_embs = self._embed(
                        [_tool_desc(t) for t in self._tools_db])
                sims = self._tools_db_embs @ self._embed([ctx.user_text])[0]
            else:
                q_words = set(w.lower() for w in
                              re.findall(r"\w+", ctx.user_text))
                sims = np.asarray([
                    len(q_words & set(w.lower() for w in re.findall(
                        r"\w+", _tool_desc(t)))) / (len(q_words) or 1)
                    for t in self._tools_db])
            order = np.argsort(-sims)
            return [self._tools_db[i] for i in order[:top_k]
                    if sims[i] >= thresh]
        except Exception:
            log.warning("tool auto-selection failed", exc_info=True)
            return []

    def _apply_policy_plugins(self, decision: Decision,
                              signals: SignalMatches, result: RouteResult,
                              rec=None) -> Optional[RouteResult]:
        """``fast_response``: a ``blocked`` result whose answer is the
        plugin's response.  PII matches: ``x-vsr-pii-violation`` on the
        route, or a 403 ``blocked`` result when the decision's ``pii``
        plugin says ``action: block``."""
        fast = decision.plugin("fast_response")
        if fast is not None and fast.enabled:
            content = fast.configuration.get("response",
                                             "Request handled by policy.")
            self.M.jailbreak_blocks.inc(decision=decision.name)
            if rec is not None:
                rec.capture_plugin("fast_response", "blocked",
                                   decision=decision.name)
            return RouteResult(
                kind="blocked", request_id=result.request_id,
                decision=result.decision, signals=signals,
                report=result.report,
                response_body=_immediate_chat_completion(content),
                headers={H.JAILBREAK_BLOCKED: "true",
                         H.DECISION: decision.name})
        pii_hits = signals.matches.get("pii", [])
        if not pii_hits:
            return None
        self.M.pii_violations.inc(decision=decision.name)
        plugin = decision.plugin("pii")
        action = plugin.configuration.get("action", "header") \
            if plugin is not None else "header"
        if action == "block":
            if rec is not None:
                rec.capture_plugin("pii", "blocked", rules=list(pii_hits))
            return RouteResult(
                kind="blocked", status=403, request_id=result.request_id,
                decision=result.decision, signals=signals,
                report=result.report,
                response_body={"error": {
                    "message": "request contains disallowed PII",
                    "type": "pii_policy_violation"}},
                headers={H.PII_VIOLATION: ",".join(pii_hits)})
        result.headers[H.PII_VIOLATION] = ",".join(pii_hits)
        if rec is not None:
            rec.capture_plugin("pii", "annotated", rules=list(pii_hits))
        return None

    def _check_cache(self, decision: Decision, ctx: RequestContext,
                     result: RouteResult,
                     rec=None) -> Optional[RouteResult]:
        """A ``cache_hit`` result when the decision's semantic-cache plugin
        is on and the cache holds the query (at the plugin's
        ``similarity_threshold`` when it sets one).  A failing cache is a
        miss."""
        plugin = decision.plugin("semantic-cache")
        if self.cache is None or plugin is None or not plugin.enabled:
            return None
        threshold = plugin.configuration.get("similarity_threshold")
        try:
            hit = self.cache.find_similar(
                ctx.user_text,
                threshold=float(threshold) if threshold else None)
        except Exception:
            log.warning("semantic cache lookup failed", exc_info=True)
            self.M.cache_lookups.inc(outcome="error")
            if rec is not None:
                rec.capture_plugin("semantic-cache", "error")
            return None
        if hit is None:
            self.M.cache_lookups.inc(outcome="miss")
            if rec is not None:
                rec.capture_plugin("semantic-cache", "miss")
            return None
        self.M.cache_lookups.inc(outcome="hit")
        model = hit.model or "cache"
        if rec is not None:
            rec.capture_plugin("semantic-cache", "hit", model=model)
        return RouteResult(
            kind="cache_hit", request_id=result.request_id,
            decision=result.decision, signals=result.signals,
            report=result.report, model=model,
            response_body=_immediate_chat_completion(hit.response,
                                                     model=model),
            headers={H.CACHE_HIT: "true", H.DECISION: decision.name})

    # -- response path -------------------------------------------------------

    def process_response(self, route: RouteResult,
                         response_body: Dict[str, Any]) -> ResponseResult:
        """The response path of a routed request the backend answered:
        jailbreak screen, hallucination spans, warnings, the cache write,
        memory auto-store, then ``response_hooks`` (the replay recorder).
        Each stage fails open."""
        out = ResponseResult(body=response_body)
        content = _response_text(response_body)
        decision = route.decision.decision if route.decision else None
        eng = self.engine

        # the screen reads a sequence classifier's label (a generative
        # guard is no such task: the reference's classify raises there)
        if content and eng is not None \
                and eng.task_kind("jailbreak") == "sequence":
            try:
                r = eng.classify("jailbreak", content[:4000])
                if r.label.lower() in ("jailbreak", "unsafe") \
                        and r.confidence >= 0.8:
                    out.warnings.append("response_jailbreak")
                    out.headers[H.JAILBREAK_BLOCKED] = "response"
            except Exception:
                log.warning("response jailbreak screen failed",
                            exc_info=True)

        needs_check = bool(route.signals and "needs_fact_check" in
                           route.signals.matches.get("fact_check", ()))
        halu = decision.plugin("hallucination") if decision else None
        if content and needs_check and halu is not None and halu.enabled \
                and eng is not None and eng.has_task("hallucination"):
            t0 = time.perf_counter()
            try:
                spans = self._detect_hallucinations(
                    content,
                    use_nli=bool(halu.configuration.get("use_nli", True)))
                if spans:
                    out.hallucination_spans = spans
                    out.headers[H.HALLUCINATION] = "true"
                    if halu.configuration.get(
                            "include_hallucination_details"):
                        out.body.setdefault("vsr_annotations", {})[
                            "hallucination_spans"] = spans
            except Exception:
                log.warning("hallucination check failed", exc_info=True)
                out.headers[H.UNVERIFIED_FACTUAL] = "true"
            self.M.hallucination_latency.observe(time.perf_counter() - t0)

        if out.warnings:
            out.headers[H.WARNINGS] = ",".join(out.warnings)

        # cache writes are optional work: shed while the ladder is at L1+
        # (reads stay on — a hit still sheds load)
        shed_writes = self.resilience is not None \
            and self.resilience.shed_optional_active()
        if self.cache is not None and route.kind == "route" and content \
                and decision is not None and route.body and not shed_writes:
            plugin = decision.plugin("semantic-cache")
            if plugin is not None and plugin.enabled:
                try:
                    ctx = RequestContext.from_openai_body(route.body)
                    self.cache.add(ctx.user_text, content, model=route.model)
                except Exception:
                    log.warning("semantic cache write failed", exc_info=True)

        # usage / cost series
        usage = response_body.get("usage") or {}
        if usage and route.model:
            card = self.model_cards.get(route.model)
            if card is not None and card.pricing:
                self.M.model_cost.inc(usage_cost(usage, card.pricing),
                                      model=route.model)

        mem = decision.plugin("memory") if decision is not None else None
        if self.memory_store is not None and route.body and mem is not None \
                and mem.enabled and mem.configuration.get("auto_store"):
            try:
                ctx = RequestContext.from_openai_body(route.body)
                if ctx.user_id:
                    # the router's own system messages (retrieved
                    # memories) never feed back into extraction
                    convo = [m for m in route.body.get("messages", [])
                             if m.get("role") != "system"]
                    self.memory_store.auto_store(
                        ctx.user_id,
                        convo + [{"role": "assistant", "content": content}])
            except Exception:
                log.warning("memory auto-store failed", exc_info=True)

        # a hook's failure never reaches the response
        for hook in self.response_hooks:
            try:
                hook(route, response_body, out)
            except Exception:
                log.warning("response hook failed", exc_info=True)
        return out

    def _detect_hallucinations(self, content: str,
                               use_nli: bool = True) -> List[dict]:
        """Spans the ``hallucination`` token classifier flags; with
        ``use_nli`` each span is classified by ``nli``, one at a time, and
        the entailed ones are dropped."""
        res = self.engine.token_classify("hallucination", content,
                                         threshold=0.5)
        spans = [
            {"type": e.type, "start": e.start, "end": e.end,
             "text": e.text, "score": e.score}
            for e in res.entities if e.type.upper() not in ("O", "SUPPORTED")]
        if spans and use_nli and self.engine.has_task("nli"):
            kept = []
            for s in spans:
                r = self.engine.classify("nli", s["text"])
                if r.label.lower() != "entailment":
                    s["nli"] = r.label
                    kept.append(s)
            spans = kept
        return spans

    def _apply_learning(self, decision: Decision, ctx: RequestContext,
                        ref: ModelRef, reason: str) -> tuple:
        """(ref, reason) after router learning: outcome-driven adaptation
        may propose another of the decision's candidates (a proposal
        outside them never escapes), and the reason then gains
        `` → learning:<model>``."""
        if self.learning is None or not decision.model_refs:
            return ref, reason
        learned = self.learning.apply(
            decision.name, [r.model for r in decision.model_refs],
            ref.model, headers=ctx.headers, tier=decision.tier,
            mode=decision.adaptations.get("mode"))
        if learned != ref.model:
            new_ref = next((r for r in decision.model_refs
                            if r.model == learned), None)
            if new_ref is not None:
                return new_ref, f"{reason} → learning:{learned}"
        return ref, reason

    def record_feedback(self, route: RouteResult, success: bool = True,
                        quality: float = 0.0, latency_ms: float = 0.0,
                        ttft_ms: float = 0.0, verdict: str = "") -> None:
        """Feed a routed request's outcome to router learning's experience
        ledgers (``verdict``: good_fit | underpowered | overprovisioned |
        failed; empty derives it from ``success``) and to its decision's
        selector, with the query's embedding (one forward on the
        ``EMBEDDING_TASK``)."""
        if route.decision is None:
            return
        if self.learning is not None:
            self.learning.record_outcome(
                route.decision.decision.name, route.model,
                verdict=verdict, success=success, latency_ms=latency_ms,
                tier=route.decision.decision.tier)
        selector = self._selectors.get(route.decision.decision.name)
        if selector is None:
            return
        query, emb = "", None
        if route.body:
            try:
                query = RequestContext.from_openai_body(route.body).user_text
            except Exception:
                query = ""
            if self._embeds():
                try:
                    emb = self._embed([query])[0]
                except Exception:
                    log.warning("feedback embedding failed", exc_info=True)
        selector.update(Feedback(
            model=route.model, success=success, quality=quality,
            latency_ms=latency_ms, ttft_ms=ttft_ms,
            query=query, query_embedding=emb,
            session_id=(route.body or {}).get("user", "")))
        if latency_ms:
            self.M.completion_latency.observe(latency_ms / 1e3,
                                              model=route.model)
        if ttft_ms:
            self.M.ttft.observe(ttft_ms / 1e3, model=route.model)

    @staticmethod
    def _finalize_body(result: RouteResult, ref: Optional[ModelRef]) -> None:
        """Model rewrite + reasoning fields."""
        body = result.body
        if result.model:
            body["model"] = result.model
        if ref is not None and ref.lora_name:
            body["model"] = f"{ref.model}:{ref.lora_name}"
        if ref is not None and ref.use_reasoning:
            if ref.reasoning_effort:
                body["reasoning_effort"] = ref.reasoning_effort
        else:
            body.pop("reasoning_effort", None)

    def shutdown(self) -> None:
        self.dispatcher.shutdown()
        for disp, _eng in self._recipe_engines.values():
            disp.shutdown()
        if self.learning is not None:
            self.learning.close()


def _response_text(body: Dict[str, Any]) -> str:
    """The first choice's message content of a chat completion."""
    try:
        choices = body.get("choices") or []
        if choices:
            return (choices[0].get("message") or {}).get("content") or ""
    except AttributeError:
        pass
    return ""
