"""The decision record's replay half.

``ReplayRecorder`` is a response hook (``Router.response_hooks``): each
routed request the backend answered records its decision, model,
matched rules, signal matches, confidence, routing latency and kind as a
``ReplayRecord`` in a store — ``ReplayStore`` (an in-memory ring,
optionally appended to a JSONL file and reloaded from it),
``sqlite_store.SQLiteReplayStore`` or ``postgres_store.
PostgresReplayStore``; all three answer ``add`` / ``list`` / ``get`` /
``len``.

The re-drive reads a decision record of ``observability/explain.py``:
``replay_decision`` re-runs the decision engine over the record's
signals under a config (the live one or a candidate), re-deriving the
complexity composers and the projections from the record's raw
per-family hits, and resolves the model without live selector state or
randomness; ``replay_diff`` compares the outcome with the record;
``rederive_cascade_skips`` re-checks a cascade record's skip certificate
with the three-valued winner proof.  Host code only.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ReplayRecord:
    record_id: str
    request_id: str
    timestamp: float
    decision: str = ""
    model: str = ""
    matched_rules: List[str] = field(default_factory=list)
    signals: Dict[str, List[str]] = field(default_factory=dict)
    confidence: float = 0.0
    routing_latency_ms: float = 0.0
    kind: str = "route"
    request_body: Optional[dict] = None
    response_excerpt: str = ""
    cost: float = 0.0
    tool_trace: List[dict] = field(default_factory=list)
    # the decision record of this request in the explain ring ("" when it
    # was not sampled)
    decision_record_id: str = ""


class ReplayStore:
    """In-memory ring of the newest ``max_records``; with ``path`` every
    record is appended to a JSONL file, which a new store reloads (a file
    that does not parse starts an empty ring)."""

    def __init__(self, max_records: int = 10_000,
                 path: Optional[str] = None) -> None:
        self.max_records = max_records
        self.path = path
        self._records: List[ReplayRecord] = []
        self._lock = threading.Lock()
        if path and os.path.exists(path):
            self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                for line in f:
                    if line.strip():
                        self._records.append(ReplayRecord(**json.loads(line)))
            self._records = self._records[-self.max_records:]
        except Exception:
            self._records = []

    def add(self, record: ReplayRecord) -> None:
        with self._lock:
            self._records.append(record)
            if len(self._records) > self.max_records:
                del self._records[:len(self._records) - self.max_records]
            if self.path:
                try:
                    with open(self.path, "a") as f:
                        f.write(json.dumps(asdict(record)) + "\n")
                except OSError:
                    pass

    def list(self, limit: int = 100, decision: str = "",
             model: str = "", since: float = 0.0) -> List[ReplayRecord]:
        """Newest first, filtered by decision, model and time."""
        with self._lock:
            out = [r for r in reversed(self._records)
                   if (not decision or r.decision == decision)
                   and (not model or r.model == model)
                   and r.timestamp >= since]
            return out[:limit]

    def get(self, record_id: str) -> Optional[ReplayRecord]:
        with self._lock:
            for r in self._records:
                if r.record_id == record_id:
                    return r
        return None

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


class ReplayRecorder:
    """The response hook that records a routed request (``Router.
    response_hooks`` calls it with the route, the backend's body and the
    response path's result).  The request body and the answer's first
    ``max_body_bytes`` characters are kept only when asked."""

    def __init__(self, store, capture_request_body: bool = False,
                 capture_response_body: bool = False,
                 max_body_bytes: int = 4096) -> None:
        self.store = store
        self.capture_request_body = capture_request_body
        self.capture_response_body = capture_response_body
        self.max_body_bytes = max_body_bytes

    def __call__(self, route, response_body: Dict[str, Any],
                 processed) -> None:
        dec = route.decision.decision.name if route.decision else ""
        conf = route.decision.confidence if route.decision else 0.0
        excerpt = ""
        if self.capture_response_body:
            try:
                excerpt = (response_body["choices"][0]["message"]["content"]
                           or "")[:self.max_body_bytes]
            except (KeyError, IndexError, TypeError):
                excerpt = ""
        self.store.add(ReplayRecord(
            record_id=uuid.uuid4().hex[:16],
            request_id=route.request_id,
            timestamp=time.time(),
            decision=dec,
            model=route.model,
            matched_rules=list(route.decision.matched_rules)
            if route.decision else [],
            signals={k: list(v) for k, v in
                     (route.signals.matches if route.signals else {}).items()},
            confidence=float(conf),
            routing_latency_ms=route.routing_latency_s * 1e3,
            kind=route.kind,
            request_body=(dict(route.body)
                          if self.capture_request_body and route.body
                          else None),
            response_excerpt=excerpt,
            decision_record_id=getattr(route, "decision_record_id", ""),
        ))


# -- the re-drive of a decision record ---------------------------------------


def signal_matches_from_record(record: Dict[str, Any]):
    """The SignalMatches the decision engine saw, from a decision record's
    ``replay`` block."""
    from ..decision.engine import SignalMatches

    payload = record.get("replay", {}) or {}
    return SignalMatches(
        matches={k: list(v) for k, v in
                 (payload.get("matches", {}) or {}).items()},
        confidences={k: float(v) for k, v in
                     (payload.get("confidences", {}) or {}).items()},
        details={k: dict(v) for k, v in
                 (payload.get("details", {}) or {}).items()},
    )


def raw_signal_matches_from_record(record: Dict[str, Any]):
    """(SignalMatches, kb_metrics) before the complexity composers and the
    projections ran: the record's per-family evaluator hits and kb metric
    outputs, with the recorded details."""
    from ..decision.engine import SignalMatches

    sm = SignalMatches()
    kb_metrics: Dict[str, Dict[str, float]] = {}
    for family, row in (record.get("signals") or {}).items():
        for h in (row or {}).get("hits", []) or []:
            sm.add(family, str(h.get("rule", "")),
                   float(h.get("confidence", 1.0)))
        for kb, metrics in ((row or {}).get("metrics", {}) or {}).items():
            kb_metrics.setdefault(str(kb), {}).update(
                {str(m): float(v) for m, v in (metrics or {}).items()})
    details = (record.get("replay", {}) or {}).get("details", {}) or {}
    sm.details = {k: dict(v) for k, v in details.items()}
    return sm, kb_metrics


def _reproject(record: Dict[str, Any], cfg):
    """(matches, projection trace) re-derived under ``cfg`` from the
    record's raw hits: composer escalation, then the projections, as the
    dispatcher runs them; None when the record has no raw rows."""
    if not record.get("signals"):
        return None
    from ..decision.projections import ProjectionEvaluator
    from ..signals.dispatch import apply_complexity_composers

    sm, kb_metrics = raw_signal_matches_from_record(record)
    apply_complexity_composers(sm, cfg.signals.complexity)
    trace = ProjectionEvaluator(cfg.projections).evaluate(
        sm, kb_metrics=kb_metrics)
    return sm, trace


def rederive_cascade_skips(record: Dict[str, Any], cfg) -> Dict[str, Any]:
    """Re-check a cascade record's skip certificate under ``cfg``: the
    final matches rebuilt from the raw hits, the neutral-skipped families
    (and the derived families they feed) unknown, the three-valued winner
    proof run again.  Truncated families (brownout, wave budget) are not
    unknown: the certificate never claimed them neutral."""
    from ..decision.engine import DecisionEngine
    from ..decision.projections import ProjectionEvaluator
    from ..engine.cascade import (
        NEUTRAL_SKIP_REASONS,
        PLANNER_VERSION,
        certain_winner,
    )
    from ..engine.cascade.planner import (
        _composer_feeders,
        _projection_feeders,
    )

    cert = record.get("cascade")
    if not isinstance(cert, dict) or cert.get("mode") != "cascade":
        return {"applicable": False}
    skipped = dict(cert.get("skipped", {}) or {})
    neutral = {f for f, why in skipped.items()
               if why in NEUTRAL_SKIP_REASONS}
    truncated = sorted(set(skipped) - neutral)
    try:
        redriven = _reproject(record, cfg)
    except Exception:
        redriven = None
    sm = redriven[0] if redriven is not None \
        else signal_matches_from_record(record)
    unknown = set(neutral)
    if unknown & _composer_feeders(cfg.signals.complexity):
        unknown.add("complexity")
    if unknown & _projection_feeders(ProjectionEvaluator(cfg.projections),
                                     cfg.signals):
        unknown.add("projection")
    engine = DecisionEngine(cfg.decisions, cfg.strategy)
    decided, winner, _ = certain_winner(engine.decisions, engine.strategy,
                                        sm, unknown)
    two_valued = engine.evaluate(sm)
    two_name = two_valued.decision.name if two_valued else None
    recorded_name = (record.get("decision") or {}).get("name")
    return {
        "applicable": True,
        "planner_version": cert.get("planner_version"),
        "planner_version_match":
            cert.get("planner_version") == PLANNER_VERSION,
        "skipped_families": sorted(skipped),
        "neutral_families": sorted(neutral),
        "truncated_families": truncated,
        "outcome_neutral": bool(decided),
        "winner": winner,
        "two_valued_winner": two_name,
        "matches_recorded_decision":
            bool(decided) and winner == two_name
            and (recorded_name is None or winner == recorded_name),
    }


def replay_decision(record: Dict[str, Any], cfg,
                    reproject: bool = True) -> Dict[str, Any]:
    """Re-drive a decision record under ``cfg`` (a RouterConfig): the
    counterfactual behind ``POST /debug/decisions/{id}/replay``.

    With ``reproject`` the projections are re-derived under ``cfg`` from
    the record's raw hits (a record without them replays its recorded
    matches).  The rules evaluate as the live engine does, the whole tree
    traced.  The model: a single candidate as is; the recorded model when
    the decision and its candidate list are the recorded ones; otherwise
    the argmax of a fresh selector's ``score_breakdown``, or the highest
    weight when the selector has none."""
    from ..decision.engine import DecisionEngine, DecisionTraceEntry
    from ..selection import SelectionContext
    from ..selection import registry as selectors

    sm = None
    projections = None
    if reproject:
        try:
            redriven = _reproject(record, cfg)
        except Exception:
            redriven = None
        if redriven is not None:
            sm, ptrace = redriven
            projections = {
                "partitions": {k: dict(v)
                               for k, v in ptrace.partitions.items()},
                "scores": dict(ptrace.scores),
                "mappings": dict(ptrace.mappings),
            }
    if sm is None:
        sm = signal_matches_from_record(record)
    engine = DecisionEngine(cfg.decisions, cfg.strategy)
    trace: List[DecisionTraceEntry] = []
    res = engine.evaluate(sm, trace=trace)

    recorded_decision = record.get("decision") or {}
    out: Dict[str, Any] = {
        "decision": res.decision.name if res else None,
        "confidence": round(res.confidence, 6) if res else 0.0,
        "matched_rules": list(res.matched_rules) if res else [],
        "projections": projections,
        "rule_trace": [
            {"decision": e.decision, "matched": e.matched,
             "confidence": round(e.confidence, 6),
             "matched_rules": list(e.matched_rules), "tree": e.tree}
            for e in trace],
    }
    if isinstance(record.get("cascade"), dict):
        try:
            out["cascade_rederive"] = rederive_cascade_skips(record, cfg)
        except Exception:
            out["cascade_rederive"] = {"applicable": False}
    if res is None:
        out["model"] = cfg.default_model or record.get("model", "")
        out["selection_basis"] = "no_decision_matched → default model"
        return out

    refs = res.decision.model_refs or []
    algo = dict(res.decision.algorithm or {})
    algo_type = str(algo.get("type", "static"))
    candidates = [r.model for r in refs]
    if len(refs) == 1:
        out["model"] = refs[0].model
        out["selection_basis"] = "single candidate"
    elif res.decision.name == recorded_decision.get("name") \
            and candidates == list(recorded_decision.get("candidates", [])):
        out["model"] = record.get("model", "")
        out["selection_basis"] = ("recorded choice (identical decision "
                                  "+ candidate set)")
    else:
        model, basis = _deterministic_choice(record, res.decision, refs,
                                             algo, algo_type, cfg,
                                             selectors, SelectionContext,
                                             sm)
        out["model"] = model
        out["selection_basis"] = basis
    out["candidates"] = candidates
    return out


def _deterministic_choice(record, decision, refs, algo, algo_type, cfg,
                          selectors, SelectionContext, sm):
    """(model, basis): the argmax of a fresh selector's score_breakdown
    (its artifact dropped), or the highest weight."""
    try:
        kwargs = {k: v for k, v in algo.items()
                  if k not in ("type", "on_error", "artifact")}
        selector = selectors.create(algo_type, **kwargs)
    except Exception:
        selector = None
    fn = getattr(selector, "score_breakdown", None)
    if fn is not None:
        try:
            cards = {m.name: m for m in cfg.model_cards}
            sctx = SelectionContext(query=record.get("query", ""),
                                    decision_name=decision.name,
                                    signals=sm, model_cards=cards)
            rows = fn(refs, sctx)
            if rows:
                best = max(rows, key=lambda r: r.get("score", 0.0))
                return best["model"], f"score_breakdown argmax ({algo_type})"
        except Exception:
            pass
    best = max(refs, key=lambda r: r.weight)
    return best.model, "highest weight"


def replay_diff(record: Dict[str, Any],
                replayed: Dict[str, Any]) -> Dict[str, Any]:
    """The fields (decision, model, matched rules) a re-drive changed."""
    recorded_decision = record.get("decision") or {}
    before = {
        "decision": recorded_decision.get("name"),
        "model": record.get("model", ""),
        "matched_rules": recorded_decision.get("matched_rules", []),
    }
    after = {
        "decision": replayed.get("decision"),
        "model": replayed.get("model", ""),
        "matched_rules": replayed.get("matched_rules", []),
    }
    changed = {k: {"recorded": before[k], "replayed": after[k]}
               for k in before if before[k] != after[k]}
    return {"identical": not changed, "changed": changed}
