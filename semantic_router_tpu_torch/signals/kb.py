"""Knowledge-base signal: exemplar-embedding classification and metrics.

The port of ``semantic_router_tpu.signals.kb``.  Each knowledge base
holds labels with exemplar texts and groups of labels; the query's
embedding (the engine's ``embedding`` task, one forward) scores against
every exemplar's, a label scores its best exemplar and a group its best
label.  Rules match a target label or group (``best``: it must also be
the top of its pool; ``any``: the threshold alone), and the metrics
(``best_score``, ``best_matched_score`` and each configured
``group_margin``) feed ``kb_metric`` projection inputs.  Exemplar
embeddings are computed once per knowledge base, on first use.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np

from ..config.schema import KBRule, KnowledgeBaseDef
from .base import RequestContext, SignalHit, SignalResult

KB_METRIC_BEST_SCORE = "best_score"
KB_METRIC_BEST_MATCHED_SCORE = "best_matched_score"


class KBSignal:
    signal_type = "kb"

    def __init__(self, engine, rules: List[KBRule],
                 kbs: List[KnowledgeBaseDef], task: str = "embedding",
                 default_threshold: float = 0.5) -> None:
        self.engine = engine
        self.task = task
        self.rules = rules
        self.default_threshold = default_threshold
        self.kbs = {kb.name: kb for kb in kbs}
        self._exemplars: Dict[str, Dict[str, np.ndarray]] = {}
        self._lock = threading.Lock()

    def _ensure_loaded(self, kb: KnowledgeBaseDef) -> Dict[str, np.ndarray]:
        """label → [n, dim] exemplar embeddings of one knowledge base."""
        with self._lock:
            cached = self._exemplars.get(kb.name)
        if cached is not None:
            return cached
        texts, spans = [], []
        for label, exemplars in kb.labels.items():
            spans.append((label, len(texts), len(texts) + len(exemplars)))
            texts.extend(exemplars)
        embs = self.engine.embed(self.task, texts) if texts else \
            np.zeros((0, 1), np.float32)
        table = {label: embs[a:b] for label, a, b in spans}
        with self._lock:
            self._exemplars[kb.name] = table
        return table

    def _score_kb(self, kb: KnowledgeBaseDef, query_emb: np.ndarray,
                  threshold: float) -> tuple:
        """(label scores, group scores, metrics) of one knowledge base."""
        table = self._ensure_loaded(kb)
        label_scores = {label: float((embs @ query_emb).max())
                        for label, embs in table.items() if len(embs)}
        group_scores = {
            g: max((label_scores.get(l, 0.0) for l in labels), default=0.0)
            for g, labels in kb.groups.items()}
        matched = [s for s in label_scores.values() if s >= threshold]
        metrics = {
            KB_METRIC_BEST_SCORE: max(label_scores.values(), default=0.0),
            KB_METRIC_BEST_MATCHED_SCORE: max(matched, default=0.0)}
        for m in kb.metrics:
            if m.get("type") == "group_margin":
                metrics[m["name"]] = (
                    group_scores.get(m.get("positive_group", ""), 0.0)
                    - group_scores.get(m.get("negative_group", ""), 0.0))
        return label_scores, group_scores, metrics

    def _threshold(self, rule: KBRule) -> float:
        return self.default_threshold if rule.threshold is None \
            else rule.threshold

    def evaluate(self, ctx: RequestContext) -> SignalResult:
        start = time.perf_counter()
        res = SignalResult(self.signal_type)
        try:
            self._evaluate(ctx, res)
        except Exception as exc:  # fail open
            res.error = f"{type(exc).__name__}: {exc}"
        res.latency_s = time.perf_counter() - start
        return res

    def _evaluate(self, ctx: RequestContext, res: SignalResult) -> None:
        if not self.engine.has_task(self.task):
            res.error = f"task {self.task!r} not loaded"
            return
        needed = {r.kb for r in self.rules if r.kb in self.kbs}
        if not needed:
            return
        query_emb = self.engine.embed(self.task, [ctx.user_text])[0]
        scored = {}
        for kb_name in needed:
            threshold = min(self._threshold(r) for r in self.rules
                            if r.kb == kb_name)
            scored[kb_name] = self._score_kb(self.kbs[kb_name], query_emb,
                                             threshold)
            res.metrics[kb_name] = scored[kb_name][2]
        for rule in self.rules:
            if rule.kb not in scored:
                continue
            label_scores, group_scores, _ = scored[rule.kb]
            kind = rule.target.get("kind", "label")
            value = rule.target.get("value", "")
            pool = group_scores if kind == "group" else label_scores
            score = pool.get(value, 0.0)
            hit = score >= self._threshold(rule)
            if rule.match == "best":
                best = max(pool, key=pool.get) if pool else ""
                hit = hit and best == value
            if hit:
                res.hits.append(SignalHit(rule.name, score,
                                          {"kb": rule.kb, kind: value}))
