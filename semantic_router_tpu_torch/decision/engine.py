"""Boolean decision engine.

Evaluates each configured decision's AND/OR/NOT rule tree against the
matched signal rules, then picks the best match by strategy ("priority" or
"confidence").  Leaf matching by "type:name" (a bare complexity rule name
matches any level the family reported; ``projection`` leaves match the
outputs the projections added); confidence aggregation AND=min,
OR=max over matched children, NOT=1.0 when no child matches.  A caller
that passes ``trace`` gets every decision's full rule tree
(``explain_rule_node``), the audit view decision records store.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..config.schema import Decision, RuleNode


@dataclass
class SignalMatches:
    """Matched rule names per signal family + confidences keyed
    "type:name" (default 1.0 when absent)."""

    matches: Dict[str, List[str]] = field(default_factory=dict)
    confidences: Dict[str, float] = field(default_factory=dict)
    # per-family payloads (PII types found, ...)
    details: Dict[str, dict] = field(default_factory=dict)

    def add(self, signal_type: str, rule_name: str,
            confidence: float = 1.0) -> None:
        self.matches.setdefault(signal_type, []).append(rule_name)
        self.confidences[f"{signal_type}:{rule_name}"] = float(confidence)

    def matched(self, signal_type: str, name: str) -> bool:
        names = self.matches.get(signal_type, ())
        if name in names:
            return True
        # complexity reports "rule:level": a bare rule name matches any level
        if signal_type == "complexity" and ":" not in name:
            return any(n.split(":", 1)[0] == name for n in names)
        return False

    def confidence(self, signal_type: str, name: str) -> float:
        key = f"{signal_type}:{name}"
        if key in self.confidences:
            return self.confidences[key]
        if signal_type == "complexity" and ":" not in name:
            for n in self.matches.get(signal_type, ()):
                if n.split(":", 1)[0] == name:
                    return self.confidences.get(f"{signal_type}:{n}", 1.0)
        return 1.0

    def all_matched_rules(self) -> List[str]:
        return [f"{t}:{n}" for t, names in sorted(self.matches.items())
                for n in names]


@dataclass
class DecisionResult:
    decision: Decision
    confidence: float
    matched_rules: List[str]
    # the keywords behind the winner's keyword leaves
    matched_keywords: List[str] = field(default_factory=list)


@dataclass
class DecisionTraceEntry:
    decision: str
    matched: bool
    confidence: float
    matched_rules: List[str]
    # full rule-evaluation tree (explain_rule_node): every node's outcome
    tree: Optional[dict] = None


def eval_rule_node(node: RuleNode, signals: SignalMatches
                   ) -> Tuple[bool, float, List[str]]:
    """(matched, confidence, matched leaf rules) of one rule tree."""
    if node.is_leaf():
        styp = node.signal_type.lower().strip()
        if not signals.matched(styp, node.name):
            return False, 0.0, []
        return True, signals.confidence(styp, node.name), \
            [f"{styp}:{node.name}"]
    op = node.operator.upper()
    if op == "AND":
        if not node.conditions:
            return False, 0.0, []
        min_conf = 1.0
        rules: List[str] = []
        for c in node.conditions:
            m, conf, r = eval_rule_node(c, signals)
            if not m:
                return False, 0.0, []
            min_conf = min(min_conf, conf)
            rules.extend(r)
        return True, min_conf, rules
    if op == "NOT":
        for c in node.conditions:
            if eval_rule_node(c, signals)[0]:
                return False, 0.0, []
        return True, 1.0, []
    # OR (default)
    best = 0.0
    rules = []
    matched = False
    for c in node.conditions:
        m, conf, r = eval_rule_node(c, signals)
        if m:
            matched = True
            best = max(best, conf)
            rules.extend(r)
    return matched, best, rules


def explain_rule_node(node: RuleNode, signals: SignalMatches) -> dict:
    """Full-fidelity rule-tree evaluation: the same (matched, confidence,
    matched_rules) as ``eval_rule_node``, with EVERY node's outcome
    captured — also the branches short-circuit evaluation never visits."""
    if node.is_leaf():
        styp = node.signal_type.lower().strip()
        matched = signals.matched(styp, node.name)
        conf = signals.confidence(styp, node.name) if matched else 0.0
        return {"node": "leaf", "signal": f"{styp}:{node.name}",
                "matched": matched, "confidence": conf,
                "matched_rules": [f"{styp}:{node.name}"] if matched
                else []}
    op = node.operator.upper()
    if op not in ("AND", "NOT"):
        op = "OR"
    children = [explain_rule_node(c, signals) for c in node.conditions]
    if op == "AND":
        matched = bool(children) and all(c["matched"] for c in children)
        conf = min((c["confidence"] for c in children), default=0.0) \
            if matched else 0.0
        rules = [r for c in children for r in c["matched_rules"]] \
            if matched else []
    elif op == "NOT":
        matched = not any(c["matched"] for c in children)
        conf = 1.0 if matched else 0.0
        rules = []
    else:  # OR
        hit = [c for c in children if c["matched"]]
        matched = bool(hit)
        conf = max((c["confidence"] for c in hit), default=0.0)
        rules = [r for c in hit for r in c["matched_rules"]]
    return {"node": op.lower(), "matched": matched, "confidence": conf,
            "matched_rules": rules, "children": children}


class DecisionEngine:
    """Evaluates decisions over signal matches."""

    def __init__(self, decisions: List[Decision],
                 strategy: str = "priority") -> None:
        self.decisions = list(decisions)
        self.strategy = strategy or "priority"
        self.last_eval_latency_s: float = 0.0

    def evaluate(self, signals: SignalMatches,
                 trace: Optional[List[DecisionTraceEntry]] = None
                 ) -> Optional[DecisionResult]:
        """The best matching decision, or None.  With ``trace`` (a list)
        every decision's full rule tree is appended to it."""
        start = time.perf_counter()
        try:
            results = self.evaluate_all(signals, trace=trace)
        finally:
            self.last_eval_latency_s = time.perf_counter() - start
        if not results:
            return None
        best = results[0]
        kw_detail = signals.details.get("keyword", {})
        best.matched_keywords = [
            kw for rule in best.matched_rules if rule.startswith("keyword:")
            for kw in kw_detail.get(rule.split(":", 1)[1], [])]
        return best

    def evaluate_all(self, signals: SignalMatches,
                     trace: Optional[List[DecisionTraceEntry]] = None
                     ) -> List[DecisionResult]:
        """All matching decisions, best first."""
        results = []
        for dec in self.decisions:
            if trace is not None:
                # one evaluation: the summary is read off the tree's root
                tree = explain_rule_node(dec.rules, signals)
                matched, conf, rules = (tree["matched"], tree["confidence"],
                                        tree["matched_rules"])
                trace.append(DecisionTraceEntry(dec.name, matched, conf,
                                                rules, tree=tree))
            else:
                matched, conf, rules = eval_rule_node(dec.rules, signals)
            if matched:
                results.append(DecisionResult(dec, conf, rules))
        results.sort(key=self._sort_key)
        return results

    def _sort_key(self, r: DecisionResult):
        if self.strategy == "confidence":
            return (-r.confidence, -r.decision.priority, r.decision.name)
        return (-r.decision.priority, -r.confidence, r.decision.name)
