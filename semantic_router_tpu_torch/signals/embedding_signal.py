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
rows.  An embedding rule with ``query_modality: image`` embeds the
request's first image through the engine's ``multimodal`` task (SigLIP's
shared text/image space) and scores it against the rule's candidate
texts embedded in that same space; the text and image branches fail
open each on its own.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

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

    def get(self, key: str, texts: List[str],
            embed_fn: Optional[Callable] = None) -> np.ndarray:
        """The rule's candidate embeddings, embedded on first use by
        ``embed_fn`` (the image rules' shared space) or else by the
        bank's task."""
        with self._lock:
            hit = self._cache.get(key)
        if hit is not None:
            return hit
        emb = embed_fn(texts) if embed_fn is not None \
            else self.engine.embed(self.task, texts)
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
    """Similarity routing over candidate prototypes.  Text rules embed the
    query text with the ``task`` embedding model; rules with
    ``query_modality: image`` embed the request's first image through the
    ``multimodal_task`` shared space and score it against the rule's
    candidate texts embedded in that space.  The two branches fail open
    each on its own: a bad image records ``image: ...`` and the text
    rules' hits stand, and a missing text task does not stop the image
    rules."""

    signal_type = "embedding"

    def __init__(self, engine, rules: list, task: str = "embedding",
                 multimodal_task: str = "multimodal") -> None:
        super().__init__(engine, rules, task)
        self.multimodal_task = multimodal_task

    def _image_query(self, ctx: RequestContext) -> np.ndarray:
        """The first image's shared-space embedding, memoized per
        request (the image rules share one forward)."""
        key = ("query_img_emb", self.multimodal_task)
        if key in ctx.ext:
            return ctx.ext[key]
        ref = next(ref for m in ctx.messages for ref in m.images)
        emb = self.engine.embed_multimodal(
            self.multimodal_task, image_refs=[ref])["image"][0]
        ctx.ext[key] = emb
        return emb

    def _mm_candidates(self, rule) -> np.ndarray:
        """The rule's candidate texts in the shared space, kept in the
        bank."""
        return self.bank.get(
            f"mm_cands:{rule.name}", rule.candidates,
            embed_fn=lambda texts: self.engine.embed_multimodal(
                self.multimodal_task, texts=texts)["text"])

    def evaluate(self, ctx: RequestContext) -> SignalResult:
        start = time.perf_counter()
        res = SignalResult(self.signal_type, source="engine")
        text_rules = [r for r in self.rules if r.query_modality != "image"]
        image_rules = [r for r in self.rules if r.query_modality == "image"]
        try:
            if text_rules:
                if not self.engine.has_task(self.task):
                    res.error = f"task {self.task!r} not loaded"
                else:
                    query = self.bank.embed_query(ctx.user_text, ctx)
                    self._score(text_rules, query, res,
                                lambda r: self.bank.get(f"emb:{r.name}",
                                                        r.candidates))
        except Exception as exc:
            res.error = f"{type(exc).__name__}: {exc}"
        try:
            if image_rules and ctx.has_images():
                if not self.engine.has_task(self.multimodal_task):
                    res.error = f"task {self.multimodal_task!r} not loaded"
                else:
                    self._score(image_rules, self._image_query(ctx), res,
                                self._mm_candidates, {"modality": "image"})
        except Exception as exc:
            res.error = f"image: {type(exc).__name__}: {exc}"
        res.latency_s = time.perf_counter() - start
        return res

    @staticmethod
    def _score(rules: list, query: np.ndarray, res: SignalResult,
               candidates_of: Callable, detail: Optional[dict] = None
               ) -> None:
        for rule in rules:
            if not rule.candidates:
                continue
            sims = candidates_of(rule) @ query
            matched, score = _aggregate(sims, rule.aggregation_method,
                                        rule.threshold)
            if matched:
                res.hits.append(SignalHit(rule.name, score,
                                          dict(detail or {})))


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
    engine's ``embedding`` task; image rules go through the engine's
    first ``multimodal`` task (``multimodal`` when none is
    registered)."""
    s = cfg.signals
    evs: list = []
    if s.embeddings:
        mm = next((t for t in engine.tasks()
                   if engine.task_kind(t) == "multimodal"), "multimodal")
        evs.append(EmbeddingSignal(engine, s.embeddings,
                                   multimodal_task=mm))
    if s.preferences:
        evs.append(PreferenceSignal(engine, s.preferences))
    if s.complexity:
        evs.append(ComplexitySignal(engine, s.complexity))
    return evs
