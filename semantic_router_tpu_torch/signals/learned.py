"""Learned signal evaluators: each maps one engine task's output onto its
family's configured rules.

- domain     → the category (intent) classifier;
- jailbreak  → classifier / pattern / hybrid methods; a generative
  (Qwen3Guard) task's verdict maps through ``GUARD_SCORES``;
- pii        → the token classifier + allowed-types policy;
- fact_check, user_feedback, modality → a sequence classifier whose
  labels are the rule names.

All evaluators fail open: an engine error is recorded on the
SignalResult, never raised across the dispatch boundary.
"""

from __future__ import annotations

import time
from typing import Dict, List

from ..config.schema import DomainRule, JailbreakRule, NamedRule, PIIRule
from .base import RequestContext, SignalHit, SignalResult


class _EngineSignal:
    """Shared plumbing: classify through the request's memo and
    tokenize-once cache, fail open on errors."""

    signal_type = ""

    def __init__(self, engine, task: str) -> None:
        self.engine = engine
        self.task = task
        # sequence classification of ctx.user_text the dispatcher may
        # batch ahead of the fan-out; token evaluators blank this out
        self.prefetch_task = task

    def _classify(self, ctx: RequestContext, text: str):
        """The dispatcher-seeded memo first (the fused prefetch already
        paid the forward), else an engine call.  Memo keys carry the
        engine's identity."""
        key = (id(self.engine), self.task, text)
        hit = ctx.class_memo.get(key)
        if hit is not None:
            ctx.ext[("signal_source", id(self))] = "fused_bank"
            return hit
        out = self.engine.classify(self.task, text, enc_cache=ctx.enc_cache)
        ctx.class_memo[key] = out
        ctx.ext[("signal_source", id(self))] = "engine"
        return out

    def evaluate(self, ctx: RequestContext) -> SignalResult:
        start = time.perf_counter()
        res = SignalResult(self.signal_type)
        try:
            if self._needs_task() and not self.engine.has_task(self.task):
                res.error = f"task {self.task!r} not loaded"
            else:
                self._evaluate(ctx, res)
        except Exception as exc:
            res.error = f"{type(exc).__name__}: {exc}"
        res.latency_s = time.perf_counter() - start
        res.source = ctx.ext.pop(("signal_source", id(self)), "engine")
        return res

    def _needs_task(self) -> bool:
        return True

    def _evaluate(self, ctx: RequestContext, res: SignalResult) -> None:
        raise NotImplementedError


class DomainSignal(_EngineSignal):
    """Maps the category classifier's label onto the domain rules (by rule
    name or one of its mmlu_categories)."""

    signal_type = "domain"

    def __init__(self, engine, rules: List[DomainRule],
                 task: str = "intent") -> None:
        super().__init__(engine, task)
        self.rules = rules
        self._by_name = {r.name.lower(): r for r in rules}
        for r in rules:
            for cat in r.mmlu_categories:
                self._by_name.setdefault(cat.lower(), r)

    def _evaluate(self, ctx: RequestContext, res: SignalResult) -> None:
        out = self._classify(ctx, ctx.user_text)
        rule = self._by_name.get(out.label.lower())
        if rule is not None:
            detail = {"label": out.label}
            if out.truncated:
                detail["truncated"] = True
            res.hits.append(SignalHit(rule.name, out.confidence, detail))


class JailbreakSignal(_EngineSignal):
    """method: classifier | pattern | hybrid.  Pattern mode scores the text
    against jailbreak vs benign pattern sets lexically; hybrid takes the
    larger of both scores."""

    signal_type = "jailbreak"
    # classifier labels that count as a jailbreak
    POSITIVE = frozenset({"jailbreak", "injection", "unsafe", "malicious"})

    def __init__(self, engine, rules: List[JailbreakRule],
                 task: str = "jailbreak") -> None:
        super().__init__(engine, task)
        self.rules = rules

    # guard safety levels → jailbreak scores (Unsafe blocks outright;
    # Controversial lands at typical rule thresholds)
    GUARD_SCORES = {"Unsafe": 0.95, "Controversial": 0.6, "Safe": 0.0}

    def _needs_task(self) -> bool:
        return False  # pattern-only rules work with no model loaded

    def _classifier_score(self, ctx: RequestContext, text: str) -> float:
        if self.engine.task_kind(self.task) == "generative":
            # a Qwen3Guard-style generative safety classifier: structured
            # generation + parse instead of a softmax head
            verdict = self.engine.guard_classify(self.task, text)
            return self.GUARD_SCORES.get(verdict.safety, 0.6)
        out = self._classify(ctx, text)
        if out.label.lower() in self.POSITIVE:
            return out.confidence
        # positive-class probability even when benign wins
        return max((p for l, p in out.probs.items()
                    if l.lower() in self.POSITIVE), default=0.0)

    @staticmethod
    def _pattern_score(text: str, rule: JailbreakRule) -> float:
        """Fraction of jailbreak patterns present minus fraction of benign
        patterns present, clamped to [0, 1]."""
        t = text.lower()
        if not rule.jailbreak_patterns:
            return 0.0
        jb = sum(1 for p in rule.jailbreak_patterns if p.lower() in t)
        if jb == 0:
            return 0.0
        benign = sum(1 for p in rule.benign_patterns if p.lower() in t)
        score = 0.5 + 0.5 * jb / len(rule.jailbreak_patterns)
        if rule.benign_patterns:
            score -= 0.4 * benign / len(rule.benign_patterns)
        return max(0.0, min(1.0, score))

    def _evaluate(self, ctx: RequestContext, res: SignalResult) -> None:
        cls_cache: Dict[str, float] = {}
        for rule in self.rules:
            text = ctx.text_for(rule.include_history)
            score = 0.0
            if rule.method in ("classifier", "hybrid"):
                if not self.engine.has_task(self.task):
                    res.error = f"task {self.task!r} not loaded"
                elif text not in cls_cache:
                    cls_cache[text] = self._classifier_score(ctx, text)
                score = cls_cache.get(text, 0.0)
            if rule.method in ("pattern", "hybrid"):
                score = max(score, self._pattern_score(text, rule))
            if score >= rule.threshold:
                res.hits.append(SignalHit(rule.name, score))


class PIISignal(_EngineSignal):
    """Token-classifies the text and matches rules whose DISALLOWED PII
    types are present (pii_types_allowed is the allowlist)."""

    signal_type = "pii"

    def __init__(self, engine, rules: List[PIIRule],
                 task: str = "pii") -> None:
        super().__init__(engine, task)
        self.rules = rules
        self.prefetch_task = ""  # token task: not a sequence prefetch

    def _evaluate(self, ctx: RequestContext, res: SignalResult) -> None:
        cache: Dict[tuple, list] = {}
        for rule in self.rules:
            key = (rule.include_history, rule.threshold)
            if key not in cache:
                out = self.engine.token_classify(
                    self.task, ctx.text_for(rule.include_history),
                    threshold=rule.threshold, enc_cache=ctx.enc_cache)
                cache[key] = out.entities
            allowed = {t.upper() for t in rule.pii_types_allowed}
            denied = [e for e in cache[key] if e.type.upper() not in allowed]
            if denied:
                res.hits.append(SignalHit(
                    rule.name, min(e.score for e in denied),
                    {"types": sorted({e.type for e in denied}),
                     "entities": [{"type": e.type, "start": e.start,
                                   "end": e.end, "score": e.score}
                                  for e in denied]}))


class BinaryTaskSignal(_EngineSignal):
    """Classifier label → rule name (fact_check, user_feedback,
    modality): a rule matches when the classifier emits its name."""

    def __init__(self, engine, rules: List[NamedRule], task: str,
                 signal_type: str) -> None:
        super().__init__(engine, task)
        self.signal_type = signal_type
        self.rules = rules
        self._names = {r.name.lower(): r for r in rules}

    def _evaluate(self, ctx: RequestContext, res: SignalResult) -> None:
        out = self._classify(ctx, ctx.user_text)
        rule = self._names.get(out.label.lower())
        if rule is not None and out.confidence >= (rule.threshold or 0.0):
            res.hits.append(SignalHit(rule.name, out.confidence))


def build_learned_evaluators(engine, cfg) -> list:
    """Every learned family whose rules are configured, on the engine's
    default task names (intent / jailbreak / pii / fact_check /
    user_feedback / modality)."""
    s = cfg.signals
    evs: list = []
    if s.domains:
        evs.append(DomainSignal(engine, s.domains))
    if s.jailbreak:
        evs.append(JailbreakSignal(engine, s.jailbreak))
    if s.pii:
        evs.append(PIISignal(engine, s.pii))
    if s.fact_check:
        evs.append(BinaryTaskSignal(engine, s.fact_check, "fact_check",
                                    "fact_check"))
    if s.user_feedbacks:
        evs.append(BinaryTaskSignal(engine, s.user_feedbacks,
                                    "user_feedback", "user_feedback"))
    if s.modality:
        evs.append(BinaryTaskSignal(engine, s.modality, "modality",
                                    "modality"))
    return evs
