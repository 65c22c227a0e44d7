"""Embedding-scored signal families: embedding similarity, preference
examples and complexity prototypes.

The port of ``semantic_router_tpu.signals.embedding_signal``:

- embedding rules: rule candidates embedded once, the query once per
  request, cosine aggregated by max | any | mean against the threshold;
- preference rules: the closest example against the threshold;
- complexity rules: hard/easy prototype banks, the margin decides
  hard/medium/easy; a rule's ``composer`` is applied after the fan-out by
  the dispatcher (it reads sibling families).

Candidate embeddings are computed on first use and kept per rule (the
prototype bank); the query embedding is memoized in ``ctx.ext`` so the
three families share one forward.  Scores are host numpy dots of unit
rows.  The port serves no multimodal (image) embedding task: an image
rule behaves as the reference does when that task is not loaded — the
error is recorded and the text rules' hits stand.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..config.schema import ComplexityRule
from .base import RequestContext, SignalHit, SignalResult


class _PrototypeBank:
    """Per-rule candidate embeddings, computed on first use."""

    def __init__(self, engine, task: str) -> None:
        self.engine = engine
        self.task = task
        self._cache: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()

    def get(self, key: str, texts: List[str]) -> np.ndarray:
        with self._lock:
            hit = self._cache.get(key)
        if hit is not None:
            return hit
        emb = self.engine.embed(self.task, texts)
        with self._lock:
            self._cache[key] = emb
        return emb

    def embed_query(self, text: str,
                    ctx: Optional[RequestContext] = None) -> np.ndarray:
        """The query's embedding, memoized per request so the embedding /
        preference / complexity families share one forward."""
        key = ("query_emb", self.task, text)
        if ctx is not None and key in ctx.ext:
            return ctx.ext[key]
        emb = self.engine.embed(self.task, [text])[0]
        if ctx is not None:
            ctx.ext[key] = emb
        return emb


def _aggregate(sims: np.ndarray, method: str, threshold: float
               ) -> tuple[bool, float]:
    if sims.size == 0:
        return False, 0.0
    if method == "mean":
        score = float(sims.mean())
        return score >= threshold, score
    if method == "any":
        return bool((sims >= threshold).any()), float(sims.max())
    score = float(sims.max())  # max (default)
    return score >= threshold, score


class _EmbeddingFamily:
    """Shared plumbing: one prototype bank on the engine's embedding task,
    fail-open evaluation, source attribution."""

    signal_type = ""

    def __init__(self, engine, rules: list, task: str = "embedding") -> None:
        self.rules = rules
        self.engine = engine
        self.task = task
        self.bank = _PrototypeBank(engine, task)

    def evaluate(self, ctx: RequestContext) -> SignalResult:
        start = time.perf_counter()
        res = SignalResult(self.signal_type, source="engine")
        try:
            if not self.engine.has_task(self.task):
                res.error = f"task {self.task!r} not loaded"
            else:
                self._evaluate(ctx, res)
        except Exception as exc:
            res.error = f"{type(exc).__name__}: {exc}"
        res.latency_s = time.perf_counter() - start
        return res

    def _evaluate(self, ctx: RequestContext, res: SignalResult) -> None:
        raise NotImplementedError


class EmbeddingSignal(_EmbeddingFamily):
    """Similarity routing over candidate prototypes.  Rules with
    ``query_modality: image`` need the multimodal task, which the port
    does not serve: when the request carries an image they record the
    error, and the text rules' hits stand."""

    signal_type = "embedding"
    MULTIMODAL_TASK = "multimodal"

    def evaluate(self, ctx: RequestContext) -> SignalResult:
        text_rules = [r for r in self.rules if r.query_modality != "image"]
        image_rules = [r for r in self.rules if r.query_modality == "image"]
        if text_rules:
            res = super().evaluate(ctx)
        else:
            res = SignalResult(self.signal_type, source="engine")
        if image_rules and ctx.has_images():
            res.error = f"task {self.MULTIMODAL_TASK!r} not loaded"
        return res

    def _evaluate(self, ctx: RequestContext, res: SignalResult) -> None:
        query = self.bank.embed_query(ctx.user_text, ctx)
        for rule in self.rules:
            if rule.query_modality == "image" or not rule.candidates:
                continue
            sims = self.bank.get(f"emb:{rule.name}", rule.candidates) @ query
            matched, score = _aggregate(sims, rule.aggregation_method,
                                        rule.threshold)
            if matched:
                res.hits.append(SignalHit(rule.name, score))


class PreferenceSignal(_EmbeddingFamily):
    signal_type = "preference"

    def _evaluate(self, ctx: RequestContext, res: SignalResult) -> None:
        query = self.bank.embed_query(ctx.user_text, ctx)
        for rule in self.rules:
            if not rule.examples:
                continue
            ex = self.bank.get(f"pref:{rule.name}", rule.examples)
            score = float((ex @ query).max())
            if score >= rule.threshold:
                res.hits.append(SignalHit(rule.name, score))


class ComplexitySignal(_EmbeddingFamily):
    """Prototype-margin difficulty scoring.  Reports "rule:level" hits
    (hard/medium/easy) the decision engine matches by exact or bare
    name."""

    signal_type = "complexity"
    MARGIN = 0.05

    def _evaluate(self, ctx: RequestContext, res: SignalResult) -> None:
        query = self.bank.embed_query(ctx.user_text, ctx)
        for rule in self.rules:
            level, conf = self._level(rule, query, ctx)
            if level is not None:
                res.hits.append(SignalHit(f"{rule.name}:{level}", conf))

    def _level(self, rule: ComplexityRule, query: np.ndarray,
               ctx: RequestContext) -> tuple[Optional[str], float]:
        hard_c = list(rule.hard_candidates)
        easy_c = list(rule.easy_candidates)
        variant = "txt"
        if ctx.has_images():
            hard_c += rule.hard_image_candidates
            easy_c += rule.easy_image_candidates
            variant = "img"  # a bank slot per candidate-set variant
        sim_hard = sim_easy = 0.0
        if hard_c:
            bank = self.bank.get(f"cx:{rule.name}:hard:{variant}", hard_c)
            sim_hard = float((bank @ query).max())
        if easy_c:
            bank = self.bank.get(f"cx:{rule.name}:easy:{variant}", easy_c)
            sim_easy = float((bank @ query).max())
        margin = sim_hard - sim_easy
        if sim_hard >= rule.threshold and margin > self.MARGIN:
            return "hard", sim_hard
        if sim_easy >= rule.threshold and margin < -self.MARGIN:
            return "easy", sim_easy
        if max(sim_hard, sim_easy) >= rule.threshold * 0.5:
            return "medium", max(sim_hard, sim_easy)
        return None, 0.0


def build_embedding_evaluators(engine, cfg) -> list:
    """The embedding-scored families whose rules are configured, on the
    engine's ``embedding`` task."""
    s = cfg.signals
    evs: list = []
    if s.embeddings:
        evs.append(EmbeddingSignal(engine, s.embeddings))
    if s.preferences:
        evs.append(PreferenceSignal(engine, s.preferences))
    if s.complexity:
        evs.append(ComplexitySignal(engine, s.complexity))
    return evs
