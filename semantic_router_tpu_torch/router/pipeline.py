"""The request routing pipeline, trimmed to the port's main path:

  parse → signal fan-out (heuristic families, fused classifier bank,
  embedding-scored and kb families) → complexity composers and
  projections → decision engine → policy plugins (``fast_response``
  answers without the backend; PII matches stamp
  ``x-vsr-pii-violation`` or, with the decision's ``pii`` plugin at
  ``action: block``, refuse with 403) → semantic cache (the decision's
  ``semantic-cache`` plugin) → static model selection (the decision's
  first modelRef; a looper algorithm's highest-weight one) → request
  rewrite (model, reasoning fields) → x-vsr-* headers; and on the
  response path, the cache write.

The dispatch report on the result carries the projection trace and the
kb family's metrics (``report.results["kb"].metrics``).

Signal families fail open: a dead engine degrades routing to the default
model, never to an outage.
"""

from __future__ import annotations

import logging
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..cache.semantic_cache import build_cache
from ..config.schema import Decision, ModelRef, RouterConfig
from ..decision.engine import DecisionEngine, DecisionResult, SignalMatches
from ..signals.base import RequestContext
from ..signals.dispatch import DispatchReport, build_dispatcher
from . import headers as H

log = logging.getLogger(__name__)

# the engine task the semantic cache (when its config names none) and the
# server's embeddings and similarity routes embed with
EMBEDDING_TASK = "embedding"


# decision algorithms that run several models downstream: the primary
# model is the highest-weight candidate
LOOPER_ALGORITHMS = ("confidence", "ratings", "remom", "fusion",
                     "workflows")


@dataclass
class RouteResult:
    kind: str  # "route" | "cache_hit" | "blocked"
    model: str = ""
    body: Optional[Dict[str, Any]] = None
    headers: Dict[str, str] = field(default_factory=dict)
    # the answer itself, when the router answers without the backend
    response_body: Optional[Dict[str, Any]] = None
    status: int = 200
    decision: Optional[DecisionResult] = None
    signals: Optional[SignalMatches] = None
    report: Optional[DispatchReport] = None
    routing_latency_s: float = 0.0
    request_id: str = ""


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


class Router:
    """The routing pipeline.  Embed directly, or serve via router.server.

    With ``semantic_cache.enabled`` the router keeps a semantic cache on
    the engine's ``semantic_cache.embedding_model`` task
    (``EMBEDDING_TASK`` when that is empty), provided the engine serves
    it."""

    def __init__(self, cfg: RouterConfig, engine=None) -> None:
        self.cfg = cfg
        self.engine = engine
        self.dispatcher = build_dispatcher(cfg, engine)
        self.decision_engine = DecisionEngine(cfg.decisions, cfg.strategy)
        cache_task = cfg.semantic_cache.embedding_model or EMBEDDING_TASK
        self.cache = None
        if cfg.semantic_cache.enabled and engine is not None \
                and engine.has_task(cache_task):
            self.cache = build_cache(
                cfg.semantic_cache,
                lambda text: engine.embed(cache_task, [text])[0])

    def route(self, body: Dict[str, Any],
              headers: Optional[Dict[str, str]] = None) -> RouteResult:
        start = time.perf_counter()
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        request_id = headers.get(H.REQUEST_ID, uuid.uuid4().hex[:16])
        ctx = RequestContext.from_openai_body(body, headers)
        signals, report = self.dispatcher.evaluate(ctx)
        decision_res = self.decision_engine.evaluate(signals)
        result = RouteResult(kind="route", request_id=request_id,
                             signals=signals, report=report,
                             decision=decision_res, body=dict(body))
        if decision_res is None:
            result.model = self.cfg.default_model or ctx.model
            result.headers = {H.SCHEMA: H.SCHEMA_VERSION,
                              H.MODEL: result.model}
            ref = None
        else:
            decision = decision_res.decision
            early = self._apply_policy_plugins(decision, signals, result) \
                or self._check_cache(decision, ctx, result)
            if early is not None:
                early.routing_latency_s = time.perf_counter() - start
                return early
            ref = self._select_model(decision, ctx)
            result.model = ref.model
            category = next(iter(signals.matches.get("domain", ())), "")
            result.headers.update(H.decision_headers(
                decision.name, ref.model, category=category,
                use_reasoning=ref.use_reasoning,
                reasoning_effort=ref.reasoning_effort,
                matched_rules=decision_res.matched_rules))
        self._finalize_body(result, ref)
        result.headers[H.REQUEST_ID] = request_id
        result.routing_latency_s = time.perf_counter() - start
        return result

    def _select_model(self, decision: Decision,
                      ctx: RequestContext) -> ModelRef:
        refs = decision.model_refs or [
            ModelRef(model=self.cfg.default_model or ctx.model)]
        if len(refs) > 1 and str((decision.algorithm or {}).get(
                "type", "static")) in LOOPER_ALGORITHMS:
            return max(refs, key=lambda r: r.weight)
        return refs[0]

    @staticmethod
    def _apply_policy_plugins(decision: Decision, signals: SignalMatches,
                              result: RouteResult) -> Optional[RouteResult]:
        """``fast_response``: a ``blocked`` result whose answer is the
        plugin's response.  PII matches: ``x-vsr-pii-violation`` on the
        route, or a 403 ``blocked`` result when the decision's ``pii``
        plugin says ``action: block``."""
        fast = decision.plugin("fast_response")
        if fast is not None and fast.enabled:
            content = fast.configuration.get("response",
                                             "Request handled by policy.")
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
        plugin = decision.plugin("pii")
        action = plugin.configuration.get("action", "header") \
            if plugin is not None else "header"
        if action == "block":
            return RouteResult(
                kind="blocked", status=403, request_id=result.request_id,
                decision=result.decision, signals=signals,
                report=result.report,
                response_body={"error": {
                    "message": "request contains disallowed PII",
                    "type": "pii_policy_violation"}},
                headers={H.PII_VIOLATION: ",".join(pii_hits)})
        result.headers[H.PII_VIOLATION] = ",".join(pii_hits)
        return None

    def _check_cache(self, decision: Decision, ctx: RequestContext,
                     result: RouteResult) -> Optional[RouteResult]:
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
            return None
        if hit is None:
            return None
        model = hit.model or "cache"
        return RouteResult(
            kind="cache_hit", request_id=result.request_id,
            decision=result.decision, signals=result.signals,
            report=result.report, model=model,
            response_body=_immediate_chat_completion(hit.response,
                                                     model=model),
            headers={H.CACHE_HIT: "true", H.DECISION: decision.name,
                     H.REQUEST_ID: result.request_id})

    def process_response(self, route: RouteResult,
                         response_body: Dict[str, Any]) -> None:
        """The response path of a routed request the backend answered: the
        semantic-cache write, when the decision's plugin is on and the
        answer has content.  A failing write is dropped."""
        content = _response_text(response_body)
        decision = route.decision.decision if route.decision else None
        if self.cache is None or route.kind != "route" or not content \
                or decision is None or not route.body:
            return
        plugin = decision.plugin("semantic-cache")
        if plugin is not None and plugin.enabled:
            try:
                ctx = RequestContext.from_openai_body(route.body)
                self.cache.add(ctx.user_text, content, model=route.model)
            except Exception:
                log.warning("semantic cache write failed", exc_info=True)

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


def _response_text(body: Dict[str, Any]) -> str:
    """The first choice's message content of a chat completion."""
    try:
        choices = body.get("choices") or []
        if choices:
            return (choices[0].get("message") or {}).get("content") or ""
    except AttributeError:
        pass
    return ""
