"""Heuristic (model-free) signal evaluators.

The port of ``semantic_router_tpu.signals.heuristic``:

- context      → token-length bands over every message;
- structure    → count / exists / sequence / density features of the
  user text;
- conversation → message shape: counts by role, tool definitions, an
  active tool loop;
- language     → script ranges and stopword votes;
- authz        → role bindings over the identity headers;
- event        → request event metadata;
- reask        → the current user turn repeating earlier ones.

All are threshold-gated, report per-rule confidences, and fail open.
"""

from __future__ import annotations

import re
import time
from difflib import SequenceMatcher
from typing import Dict, List

from ..config.schema import (
    AuthzRule,
    ContextRule,
    ConversationRule,
    EventRule,
    FeatureSource,
    NamedRule,
    Predicate,
    ReaskRule,
    StructureRule,
)
from .base import RequestContext, SignalHit, SignalResult, text_units


class _Heuristic:
    """Shared plumbing: time the rule loop."""

    signal_type = ""

    def __init__(self, rules: list) -> None:
        self.rules = rules

    def evaluate(self, ctx: RequestContext) -> SignalResult:
        start = time.perf_counter()
        res = SignalResult(self.signal_type)
        self._evaluate(ctx, res)
        res.latency_s = time.perf_counter() - start
        return res

    def _evaluate(self, ctx: RequestContext, res: SignalResult) -> None:
        raise NotImplementedError


class ContextSignal(_Heuristic):
    signal_type = "context"
    rules: List[ContextRule]

    def _evaluate(self, ctx: RequestContext, res: SignalResult) -> None:
        tokens = ctx.approx_token_count()
        for r in self.rules:
            if tokens >= r.min_tokens and (r.max_tokens == 0
                                           or tokens <= r.max_tokens):
                res.hits.append(SignalHit(r.name, 1.0, {"tokens": tokens}))


# --------------------------------------------------------------------------
# structure and conversation features
# --------------------------------------------------------------------------


def _source_occurrences(src: FeatureSource, text: str) -> int:
    if src.type == "regex":
        flags = 0 if src.case_sensitive else re.IGNORECASE
        return len(re.findall(src.pattern, text, flags))
    t = text if src.case_sensitive else text.lower()

    def fold(s: str) -> str:
        return s if src.case_sensitive else s.lower()

    if src.type == "keyword_set":
        return sum(t.count(fold(kw)) for kw in src.keywords)
    if src.type == "sequence":
        hits = 0
        for seq in src.sequences:
            pos = 0
            for item in seq:
                idx = t.find(fold(item), pos)
                if idx < 0:
                    break
                pos = idx + len(fold(item))
            else:
                hits += 1
        return hits
    return 0


def _eval_feature(feature_type: str, src: FeatureSource, pred: Predicate,
                  text: str) -> tuple:
    n = _source_occurrences(src, text)
    if feature_type == "exists":
        return n > 0, {"count": n}
    if feature_type == "sequence":
        return n > 0, {"sequences": n}
    value = n / max(text_units(text), 1) if feature_type == "density" \
        else float(n)
    return pred.check(value), {"value": value}


class StructureSignal(_Heuristic):
    signal_type = "structure"
    rules: List[StructureRule]

    def _evaluate(self, ctx: RequestContext, res: SignalResult) -> None:
        text = ctx.user_text
        for r in self.rules:
            ok, detail = _eval_feature(r.feature_type, r.source,
                                       r.predicate, text)
            if ok:
                res.hits.append(SignalHit(r.name, 1.0, detail))


class ConversationSignal(_Heuristic):
    """Message-shape rules: counts by role (``non_user`` counts every
    other role), tool definitions, an active tool loop."""

    signal_type = "conversation"
    rules: List[ConversationRule]

    @staticmethod
    def _feature_value(src: FeatureSource, ctx: RequestContext) -> float:
        if src.type == "message":
            if src.role == "non_user":
                return float(sum(1 for m in ctx.messages if m.role != "user"))
            return float(sum(1 for m in ctx.messages if m.role == src.role))
        if src.type == "tool_definition":
            return float(len(ctx.tools))
        if src.type == "active_tool_loop":
            # a tool result or an assistant tool call since the last
            # user turn
            for m in reversed(ctx.messages):
                if m.role == "tool" or m.tool_call_id \
                        or (m.role == "assistant" and m.tool_calls):
                    return 1.0
                if m.role == "user":
                    break
        return 0.0

    def _evaluate(self, ctx: RequestContext, res: SignalResult) -> None:
        for r in self.rules:
            v = self._feature_value(r.source, ctx)
            ok = v > 0 if r.feature_type == "exists" else r.predicate.check(v)
            if ok:
                res.hits.append(SignalHit(r.name, 1.0, {"value": v}))


# --------------------------------------------------------------------------
# language detection
# --------------------------------------------------------------------------

_STOPWORDS: Dict[str, frozenset] = {
    "en": frozenset("the a an and or of to in is are was were be have has i "
                    "you it this that with for on as at by not what how why "
                    "when can will would".split()),
    "es": frozenset("el la los las un una y o de en es son que con para por "
                    "no se su como cuando donde qué cómo está".split()),
    "fr": frozenset("le la les un une et ou de est sont que avec pour par ne "
                    "pas vous je il elle ce cette comment quand où".split()),
    "de": frozenset("der die das ein eine und oder von ist sind zu mit für "
                    "nicht ich sie es wie wann wo was warum".split()),
    "pt": frozenset("o a os as um uma e ou de em é são que com para por não "
                    "se como quando onde você".split()),
    "it": frozenset("il lo la i gli le un una e o di è sono che con per non "
                    "si come quando dove cosa".split()),
    "ru": frozenset("и в не на я что он она это как по но из у за мы вы они "
                    "быть".split()),
    "nl": frozenset("de het een en of van is zijn dat met voor niet ik je hoe "
                    "wat waar".split()),
}

# (script, inclusive code point ranges), first match wins
_SCRIPTS = (
    ("han", ((0x4E00, 0x9FFF), (0x3400, 0x4DBF))),
    ("hiragana", ((0x3040, 0x309F),)),
    ("katakana", ((0x30A0, 0x30FF),)),
    ("hangul", ((0xAC00, 0xD7AF),)),
    ("cyrillic", ((0x0400, 0x04FF),)),
    ("arabic", ((0x0600, 0x06FF),)),
    ("greek", ((0x0370, 0x03FF),)),
)

# script → language code when the script holds > 30% of the letters
_SCRIPT_LANG = (("hangul", "ko"), ("cyrillic", "ru"), ("arabic", "ar"),
                ("greek", "el"))


def detect_language(text: str) -> Dict[str, float]:
    """Language code → confidence: script shares for CJK, Hangul,
    Cyrillic, Arabic and Greek; stopword votes for Latin-script text
    (``en`` at 0.3 when no stopword matches)."""
    if not text:
        return {}
    counts = {name: 0 for name, _ in _SCRIPTS}
    counts["latin"] = 0
    total = 0
    for ch in text:
        o = ord(ch)
        for name, ranges in _SCRIPTS:
            if any(lo <= o <= hi for lo, hi in ranges):
                counts[name] += 1
                break
        else:
            if not ch.isalpha():
                continue
            counts["latin"] += 1
        total += 1
    if total == 0:
        return {}
    scores: Dict[str, float] = {}
    kana = counts["hiragana"] + counts["katakana"]
    if kana > 0.05 * total:
        scores["ja"] = (kana + counts["han"]) / total
    elif counts["han"] > 0.3 * total:
        scores["zh"] = counts["han"] / total
    for script, lang in _SCRIPT_LANG:
        if counts[script] > 0.3 * total:
            scores[lang] = counts[script] / total
    if counts["latin"] > 0.5 * total:
        words = [w for w in re.findall(r"[^\W\d_]+", text.lower())
                 if len(w) > 1]
        if words:
            votes = {lang: sum(1 for w in words if w in sw)
                     for lang, sw in _STOPWORDS.items()}
            best = max(votes.items(), key=lambda kv: kv[1])
            if best[1] > 0:
                scores[best[0]] = min(1.0, 0.3 + best[1] / len(words) * 2.0)
            else:
                scores["en"] = 0.3
    return scores


class LanguageSignal(_Heuristic):
    signal_type = "language"
    # a rule threshold of 0 means this built-in default
    DEFAULT_THRESHOLD = 0.3
    rules: List[NamedRule]

    def _evaluate(self, ctx: RequestContext, res: SignalResult) -> None:
        scores = detect_language(ctx.user_text)
        for r in self.rules:
            conf = scores.get(r.name, 0.0)
            if conf >= (r.threshold or self.DEFAULT_THRESHOLD):
                res.hits.append(SignalHit(r.name, conf))


class AuthzSignal(_Heuristic):
    """Role bindings: the request's user id and groups against each rule's
    subjects.  With ``fail_open`` False an evaluation error raises (the
    dispatcher records it) instead of passing as no match."""

    signal_type = "authz"
    rules: List[AuthzRule]

    def __init__(self, rules: List[AuthzRule],
                 fail_open: bool = True) -> None:
        super().__init__(rules)
        self.fail_open = fail_open

    def _evaluate(self, ctx: RequestContext, res: SignalResult) -> None:
        try:
            for r in self.rules:
                if self._matches(r, ctx):
                    res.hits.append(SignalHit(r.name, 1.0, {"role": r.role}))
        except Exception:
            if not self.fail_open:
                raise
            res.error = "authz evaluation failed (fail-open)"

    @staticmethod
    def _matches(rule: AuthzRule, ctx: RequestContext) -> bool:
        for subj in rule.subjects:
            kind = str(subj.get("kind", "")).lower()
            name = subj.get("name", "")
            if kind == "group" and name in ctx.user_groups:
                return True
            if kind == "user" and name == ctx.user_id:
                return True
        return False


class EventSignal(_Heuristic):
    """The request's event (``ctx.event`` or the ``x-vsr-event-type`` /
    ``-severity`` / ``-action`` headers) against each rule's allowed
    types, severities and action codes."""

    signal_type = "event"
    rules: List[EventRule]

    def _evaluate(self, ctx: RequestContext, res: SignalResult) -> None:
        ev = ctx.event or {}
        etype = ev.get("type") or ctx.headers.get("x-vsr-event-type", "")
        severity = ev.get("severity") \
            or ctx.headers.get("x-vsr-event-severity", "")
        action = ev.get("action_code") \
            or ctx.headers.get("x-vsr-event-action", "")
        if not (etype or severity or action):
            return
        for r in self.rules:
            if (r.event_types and etype not in r.event_types) \
                    or (r.severities and severity not in r.severities) \
                    or (r.action_codes and action not in r.action_codes):
                continue
            res.hits.append(SignalHit(r.name, 1.0, {
                "type": etype, "severity": severity, "action": action}))


class ReaskSignal(_Heuristic):
    """A rule matches when the current user turn is at least
    ``threshold`` similar (difflib ratio, case-folded) to each of the
    previous ``lookback_turns`` user turns."""

    signal_type = "reask"
    rules: List[ReaskRule]

    @staticmethod
    def _similarity(a: str, b: str) -> float:
        if not a or not b:
            return 0.0
        return SequenceMatcher(None, a.lower(), b.lower()).ratio()

    def _evaluate(self, ctx: RequestContext, res: SignalResult) -> None:
        turns = ctx.user_turns()
        if len(turns) < 2:
            return
        current = turns[-1]
        for r in self.rules:
            lookback = turns[-1 - r.lookback_turns:-1]
            if len(lookback) < r.lookback_turns:
                continue
            sims = [self._similarity(current, t) for t in lookback]
            if sims and min(sims) >= r.threshold:
                res.hits.append(SignalHit(r.name, min(sims),
                                          {"similarities": sims}))
