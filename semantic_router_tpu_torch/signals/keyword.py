"""Keyword signal: exact / regex / fuzzy / BM25 / n-gram scorers.

The port of ``semantic_router_tpu.signals.keyword``, pure Python: the
fuzzy ratio is the LCS-indel ratio (``2·LCS/(|a|+|b|)`` percent), BM25
scores the user text as one document against the rule's keywords with
neutral IDF weights, and the n-gram scorer is character n-gram
containment.  Each rule's regexes and scorers are compiled once.
"""

from __future__ import annotations

import re
import time
import unicodedata
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..config.schema import KeywordRule
from .base import RequestContext, SignalHit, SignalResult

_TOKEN_RE = re.compile(r"\w+", re.UNICODE)


def tokenize(text: str, lower: bool = True) -> List[str]:
    if lower:
        text = text.lower()
    return _TOKEN_RE.findall(text)


def _norm(text: str, case_sensitive: bool) -> str:
    text = unicodedata.normalize("NFKC", text)
    return text if case_sensitive else text.lower()


def fuzzy_ratio(a: str, b: str) -> float:
    """Similarity percent in [0, 100]: 2·LCS/(|a|+|b|)."""
    la, lb = len(a), len(b)
    if la == 0 and lb == 0:
        return 100.0
    if la == 0 or lb == 0:
        return 0.0
    prev = [0] * (lb + 1)
    for i in range(1, la + 1):
        cur = [0] * (lb + 1)
        ca = a[i - 1]
        for j in range(1, lb + 1):
            if ca == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = prev[j] if prev[j] >= cur[j - 1] else cur[j - 1]
        prev = cur
    return 200.0 * prev[lb] / (la + lb)


def fuzzy_partial_ratio(needle: str, haystack: str) -> float:
    """Best fuzzy match of ``needle`` against equal-length windows of
    ``haystack`` starting at word boundaries or on a stride of half the
    needle."""
    if not needle or not haystack:
        return 0.0
    if needle in haystack:
        return 100.0
    n = len(needle)
    if len(haystack) <= n:
        return fuzzy_ratio(needle, haystack)
    starts = {0}
    for m in re.finditer(r"\S+", haystack):
        starts.add(m.start())
    starts.update(range(0, len(haystack) - n + 1, max(1, n // 2)))
    best = 0.0
    for i in sorted(starts):
        if i + 1 >= len(haystack):
            break
        best = max(best, fuzzy_ratio(needle, haystack[i:i + n]))
        if best >= 99.9:
            break
    return best


class BM25Scorer:
    """BM25 saturation over the rule's keywords (the query) against the
    user text (the one document), neutral IDF, average document length
    64 tokens; a phrase keyword scores the min over its tokens.  Returns
    (score normalized by the keyword count, matched keywords)."""

    def __init__(self, keywords: Sequence[str], k1: float = 1.5,
                 b: float = 0.75, case_sensitive: bool = False) -> None:
        self.k1 = k1
        self.b = b
        self.keyword_tokens = [tokenize(k, lower=not case_sensitive)
                               for k in keywords]
        self.case_sensitive = case_sensitive
        self.avgdl = 64.0

    def score(self, text: str) -> Tuple[float, List[str]]:
        doc = tokenize(text, lower=not self.case_sensitive)
        if not doc:
            return 0.0, []
        tf: Dict[str, int] = {}
        for t in doc:
            tf[t] = tf.get(t, 0) + 1
        norm = self.k1 * (1.0 - self.b + self.b * len(doc) / self.avgdl)
        total, matched = 0.0, []
        for kw_tokens in self.keyword_tokens:
            if not kw_tokens:
                continue
            per_tok = []
            for t in kw_tokens:
                f = tf.get(t, 0)
                per_tok.append((f * (self.k1 + 1.0)) / (f + norm) if f
                               else 0.0)
            kw_score = min(per_tok)
            if kw_score > 0.0:
                matched.append(" ".join(kw_tokens))
            total += kw_score
        return total / max(len(self.keyword_tokens), 1), matched


class NGramScorer:
    """Character n-gram containment: the best fraction of one keyword's
    n-grams present in the text, and every keyword reaching it."""

    def __init__(self, keywords: Sequence[str], arity: int = 3,
                 case_sensitive: bool = False) -> None:
        self.arity = max(1, arity)
        self.case_sensitive = case_sensitive
        self.keyword_grams = [(k, frozenset(self._grams(
            _norm(k, case_sensitive)))) for k in keywords]

    def _grams(self, s: str) -> List[str]:
        s = f" {s} "
        n = self.arity
        if len(s) < n:
            return [s]
        return [s[i:i + n] for i in range(len(s) - n + 1)]

    def score(self, text: str) -> Tuple[float, List[str]]:
        text_grams = set(self._grams(_norm(text, self.case_sensitive)))
        best, matched = 0.0, []
        for kw, grams in self.keyword_grams:
            if not grams:
                continue
            containment = len(grams & text_grams) / len(grams)
            best = max(best, containment)
            matched.append((kw, containment))
        return best, [kw for kw, c in matched if c >= best and best > 0.0]


@dataclass
class _CompiledRule:
    rule: KeywordRule
    regexes: List[re.Pattern]
    bm25: Optional[BM25Scorer]
    ngram: Optional[NGramScorer]


def _all_or_any(rule: KeywordRule, matched: list, n: int) -> bool:
    return len(matched) == n if rule.operator == "AND" else bool(matched)


class KeywordSignal:
    signal_type = "keyword"

    def __init__(self, rules: List[KeywordRule]) -> None:
        self.compiled: List[_CompiledRule] = []
        for r in rules:
            flags = 0 if r.case_sensitive else re.IGNORECASE
            self.compiled.append(_CompiledRule(
                r,
                [re.compile(k, flags) for k in r.keywords]
                if r.method == "regex" else [],
                BM25Scorer(r.keywords, case_sensitive=r.case_sensitive)
                if r.method == "bm25" else None,
                NGramScorer(r.keywords, arity=r.ngram_arity,
                            case_sensitive=r.case_sensitive)
                if r.method == "ngram" else None))

    def evaluate(self, ctx: RequestContext) -> SignalResult:
        start = time.perf_counter()
        res = SignalResult(self.signal_type)
        text = ctx.user_text
        for c in self.compiled:
            hit = self._eval_rule(c, text)
            if hit is not None:
                res.hits.append(hit)
        res.latency_s = time.perf_counter() - start
        return res

    @staticmethod
    def _eval_rule(c: _CompiledRule, text: str) -> Optional[SignalHit]:
        r = c.rule
        if r.method == "bm25":
            score, matched = c.bm25.score(text)
            if score < r.bm25_threshold:
                return None
            conf = min(1.0, score / max(r.bm25_threshold * 4.0, 1e-9))
            return SignalHit(r.name, conf, {"keywords": matched,
                                            "score": score})
        if r.method == "ngram":
            score, matched = c.ngram.score(text)
            if score < r.ngram_threshold:
                return None
            return SignalHit(r.name, min(1.0, score),
                             {"keywords": matched, "score": score})
        if r.method == "regex":
            matched = [m.group(0) for m in (p.search(text) for p in c.regexes)
                       if m]
            return SignalHit(r.name, 1.0, {"keywords": matched}) \
                if _all_or_any(r, matched, len(c.regexes)) else None
        tn = _norm(text, r.case_sensitive)
        if r.method == "fuzzy" or r.fuzzy_match:
            matched, scores = [], []
            for kw in r.keywords:
                s = fuzzy_partial_ratio(_norm(kw, r.case_sensitive), tn)
                if s >= r.fuzzy_threshold:
                    matched.append(kw)
                    scores.append(s)
            if not _all_or_any(r, matched, len(r.keywords)):
                return None
            conf = min(1.0, (sum(scores) / len(scores)) / 100.0)
            return SignalHit(r.name, conf, {"keywords": matched})
        # exact substring
        matched = [kw for kw in r.keywords
                   if _norm(kw, r.case_sensitive) in tn]
        return SignalHit(r.name, 1.0, {"keywords": matched}) \
            if _all_or_any(r, matched, len(r.keywords)) else None
