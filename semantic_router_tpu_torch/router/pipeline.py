"""The request routing pipeline, trimmed to the port's main path:

  parse → learned signal fan-out (fused classifier bank) → decision
  engine → static model selection (the decision's first modelRef) →
  request rewrite (model, reasoning fields) → x-vsr-* headers.

Signal families fail open: a dead engine degrades routing to the default
model, never to an outage.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..config.schema import ModelRef, RouterConfig
from ..decision.engine import DecisionEngine, DecisionResult, SignalMatches
from ..signals.base import RequestContext
from ..signals.dispatch import DispatchReport, build_dispatcher
from . import headers as H


@dataclass
class RouteResult:
    kind: str  # "route"
    model: str = ""
    body: Optional[Dict[str, Any]] = None
    headers: Dict[str, str] = field(default_factory=dict)
    decision: Optional[DecisionResult] = None
    signals: Optional[SignalMatches] = None
    report: Optional[DispatchReport] = None
    routing_latency_s: float = 0.0
    request_id: str = ""


class Router:
    """The routing pipeline.  Embed directly, or serve via router.server."""

    def __init__(self, cfg: RouterConfig, engine=None) -> None:
        self.cfg = cfg
        self.engine = engine
        self.dispatcher = build_dispatcher(cfg, engine)
        self.decision_engine = DecisionEngine(cfg.decisions, cfg.strategy)

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
            ref = decision.model_refs[0] if decision.model_refs else \
                ModelRef(model=self.cfg.default_model or ctx.model)
            result.model = ref.model
            category = next(iter(signals.matches.get("domain", ())), "")
            result.headers = H.decision_headers(
                decision.name, ref.model, category=category,
                use_reasoning=ref.use_reasoning,
                reasoning_effort=ref.reasoning_effort,
                matched_rules=decision_res.matched_rules)
        self._finalize_body(result, ref)
        result.headers[H.REQUEST_ID] = request_id
        result.routing_latency_s = time.perf_counter() - start
        return result

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
