"""Selection algorithms that run on the host: static, elo, latency_aware,
multi_factor, automix, hybrid, rl_driven, session_aware, lookup_table.

static (weighted), elo (Bradley-Terry pairwise ratings), latency_aware
(latency percentiles + quality trade-off), multi_factor (weighted
quality / cost / latency / context fit / load), automix (small → large
escalation on a belief over query difficulty), hybrid (blend), rl_driven
(epsilon-greedy bandit per category), session_aware (sticky session
affinity), lookup_table (query → model table with auto-save).  The port's
copy of the JAX package's ``selection/algorithms.py``: host numpy there,
host numpy here, the same draws from the same seeds.  Each selector's
``score_breakdown`` is the per-candidate audit view a decision record's
``selection.candidates`` carries (and the upstream plane ranks failover
alternates by): each model's score with the components that produced it,
read-only — no draw, no state change.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..config.schema import ModelRef
from ..observability.inflight import default_tracker as inflight
from .base import (
    Feedback,
    PercentileTracker,
    SelectionContext,
    SelectionResult,
    registry,
    weighted_choice,
)


class StaticSelector:
    """Weight-proportional choice; deterministic when a seed is given."""

    name = "static"

    def __init__(self, seed: Optional[int] = None, **_):
        self.rng = np.random.default_rng(seed)

    def select(self, candidates: List[ModelRef], ctx: SelectionContext
               ) -> SelectionResult:
        if len(candidates) == 1:
            return SelectionResult(candidates[0], 1.0, "single candidate")
        ref = weighted_choice(candidates, self.rng)
        return SelectionResult(ref, ref.weight, "weighted static")

    def score_breakdown(self, candidates: List[ModelRef],
                        ctx: SelectionContext) -> List[dict]:
        total = sum(max(c.weight, 0.0) for c in candidates) or 1.0
        return [{"model": c.model, "score": round(c.weight / total, 6),
                 "components": {"weight": c.weight,
                                "probability": round(
                                    max(c.weight, 0.0) / total, 6)}}
                for c in candidates]

    def update(self, fb: Feedback) -> None:
        pass


class EloSelector:
    """Bradley-Terry/Elo ratings updated from pairwise outcomes; selection
    is softmax-greedy over ratings with light exploration."""

    name = "elo"

    def __init__(self, k: float = 24.0, initial: float = 1500.0,
                 exploration: float = 0.05, seed: Optional[int] = None, **_):
        self.k = k
        self.initial = initial
        self.exploration = exploration
        self.ratings: Dict[str, float] = {}
        self.rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

    def rating(self, model: str) -> float:
        return self.ratings.get(model, self.initial)

    def select(self, candidates: List[ModelRef], ctx: SelectionContext
               ) -> SelectionResult:
        if self.rng.random() < self.exploration:
            ref = candidates[int(self.rng.integers(len(candidates)))]
            return SelectionResult(ref, self.rating(ref.model), "explore")
        best = max(candidates, key=lambda c: self.rating(c.model))
        return SelectionResult(best, self.rating(best.model), "highest elo")

    def score_breakdown(self, candidates: List[ModelRef],
                        ctx: SelectionContext) -> List[dict]:
        return [{"model": c.model, "score": round(self.rating(c.model), 3),
                 "components": {"elo_rating": round(self.rating(c.model),
                                                    3),
                                "exploration": self.exploration}}
                for c in candidates]

    def update(self, fb: Feedback) -> None:
        with self._lock:
            if fb.winner and fb.loser:
                rw, rl = self.rating(fb.winner), self.rating(fb.loser)
                expected = 1.0 / (1.0 + 10 ** ((rl - rw) / 400.0))
                self.ratings[fb.winner] = rw + self.k * (1.0 - expected)
                self.ratings[fb.loser] = rl - self.k * (1.0 - expected)
            elif fb.model:
                # solo outcome: nudge toward/away using quality as score
                r = self.rating(fb.model)
                score = fb.quality if fb.quality else (1.0 if fb.success else 0.0)
                self.ratings[fb.model] = r + self.k * (score - 0.5)


class LatencyAwareSelector:
    """Minimize predicted latency subject to a quality floor; predictions
    from rolling latency percentiles."""

    name = "latency_aware"

    def __init__(self, percentile: float = 90.0,
                 quality_weight: float = 0.3, **_):
        self.percentile = percentile
        self.quality_weight = quality_weight
        self.tracker = PercentileTracker()

    def _scored(self, candidates: List[ModelRef], ctx: SelectionContext
                ) -> List[tuple]:
        """(score, components, ref) per candidate: the one scoring path
        select() and score_breakdown() share."""
        latencies = []
        for c in candidates:
            lat = self.tracker.percentile(c.model, self.percentile,
                                          default=0.0)
            latencies.append(lat if lat > 0 else None)
        known = [l for l in latencies if l is not None]
        max_lat = max(known) if known else 1.0
        out = []
        for c, lat in zip(candidates, latencies):
            card = ctx.card(c.model)
            quality = card.quality_score if card else 0.5
            lat_score = 1.0 - (lat / max_lat if lat else 0.5)
            score = ((1 - self.quality_weight) * lat_score
                     + self.quality_weight * quality)
            out.append((score, {"latency_p_ms": lat or 0.0,
                                "latency_score": round(lat_score, 6),
                                "quality": quality,
                                "quality_weight": self.quality_weight},
                        c))
        return out

    def select(self, candidates: List[ModelRef], ctx: SelectionContext
               ) -> SelectionResult:
        score, _, best = max(self._scored(candidates, ctx),
                             key=lambda t: t[0])
        return SelectionResult(best, score,
                               f"latency p{self.percentile:.0f} blend")

    def score_breakdown(self, candidates: List[ModelRef],
                        ctx: SelectionContext) -> List[dict]:
        return [{"model": c.model, "score": round(s, 6), "components": comp}
                for s, comp, c in self._scored(candidates, ctx)]

    def update(self, fb: Feedback) -> None:
        if fb.latency_ms > 0:
            self.tracker.record(fb.model, fb.latency_ms)
        if fb.ttft_ms > 0:
            self.tracker.record(f"{fb.model}:ttft", fb.ttft_ms)


class MultiFactorSelector:
    """Weighted quality/cost/latency/context-fit/load score; the load
    factor reads the in-flight tracker the server feeds."""

    name = "multi_factor"

    def __init__(self, weights: Optional[Dict[str, float]] = None, **_):
        self.weights = {"quality": 0.4, "cost": 0.25, "latency": 0.2,
                        "context_fit": 0.15, "load": 0.0,
                        **(weights or {})}
        self.tracker = PercentileTracker()

    def _scored(self, candidates: List[ModelRef], ctx: SelectionContext
                ) -> List[tuple]:
        """(score, components, ref) per candidate."""
        w = self.weights
        out = []
        costs, lats, loads = [], [], []
        for c in candidates:
            card = ctx.card(c.model)
            pricing = (card.pricing if card else {}) or {}
            costs.append(pricing.get("completion", 0.0)
                         + pricing.get("prompt", 0.0))
            lats.append(self.tracker.percentile(c.model, 90.0, 0.0))
            loads.append(float(inflight.count(c.model)))
        max_cost = max(costs) or 1.0
        max_lat = max(lats) or 1.0
        max_load = max(loads) or 1.0
        for c, cost, lat, load in zip(candidates, costs, lats, loads):
            card = ctx.card(c.model)
            quality = card.quality_score if card else 0.5
            cost_score = 1.0 - cost / max_cost
            lat_score = 1.0 - lat / max_lat if lat else 0.5
            load_score = 1.0 - load / max_load if load else 1.0
            if card and card.context_window_size:
                fit = 1.0 if ctx.token_count <= card.context_window_size \
                    else 0.0
            else:
                fit = 0.5
            score = (w["quality"] * quality + w["cost"] * cost_score
                     + w["latency"] * lat_score + w["context_fit"] * fit
                     + w["load"] * load_score)
            out.append((score, {"quality": quality,
                                "cost_score": round(cost_score, 6),
                                "latency_score": round(lat_score, 6),
                                "context_fit": fit,
                                "load_score": round(load_score, 6),
                                "weights": dict(w)}, c))
        return out

    def select(self, candidates: List[ModelRef], ctx: SelectionContext
               ) -> SelectionResult:
        score, _, best = max(self._scored(candidates, ctx),
                             key=lambda t: t[0])
        return SelectionResult(best, score, "multi-factor")

    def score_breakdown(self, candidates: List[ModelRef],
                        ctx: SelectionContext) -> List[dict]:
        return [{"model": c.model, "score": round(s, 6), "components": comp}
                for s, comp, c in self._scored(candidates, ctx)]

    def update(self, fb: Feedback) -> None:
        if fb.latency_ms > 0:
            self.tracker.record(fb.model, fb.latency_ms)


class AutoMixSelector:
    """Escalation policy: a belief over query difficulty from signal
    confidences; route to the cheapest model whose expected quality clears
    the belief-adjusted bar, escalating when the belief says 'hard'."""

    name = "automix"

    def __init__(self, cost_quality_tradeoff: float = 0.5, **_):
        self.tradeoff = cost_quality_tradeoff
        # per-model Beta posterior of success (feedback carries no belief
        # bucket, so the posterior is model-global; belief modulates the
        # acceptance bar instead)
        self._posteriors: Dict[str, List[float]] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _belief(ctx: SelectionContext) -> float:
        """P(hard) from complexity/context signals."""
        sm = ctx.signals
        if sm is None:
            return 0.5
        belief = 0.3
        for name in sm.matches.get("complexity", ()):
            level = name.split(":")[-1]
            conf = sm.confidence("complexity", name)
            belief = max(belief, {"hard": 0.6 + 0.4 * conf,
                                  "medium": 0.5,
                                  "easy": 0.2}.get(level, 0.4))
        if "long_context" in sm.matches.get("context", ()):
            belief = min(1.0, belief + 0.15)
        return belief

    def _success_rate(self, model: str) -> float:
        a, b = self._posteriors.get(model, [1.0, 1.0])
        return a / (a + b)

    def select(self, candidates: List[ModelRef], ctx: SelectionContext
               ) -> SelectionResult:
        belief = self._belief(ctx)

        def size(c: ModelRef) -> float:
            card = ctx.card(c.model)
            return card.param_size_billions() if card else 0.0

        ordered = sorted(candidates, key=size)  # small → large
        for c in ordered:
            card = ctx.card(c.model)
            quality = card.quality_score if card else 0.5
            expected = 0.5 * quality + 0.5 * self._success_rate(c.model)
            bar = 0.35 + belief * (0.55 - 0.25 * self.tradeoff)
            if expected >= bar:
                return SelectionResult(
                    c, expected, f"automix belief={belief:.2f}")
        return SelectionResult(ordered[-1], belief, "automix escalated")

    def score_breakdown(self, candidates: List[ModelRef],
                        ctx: SelectionContext) -> List[dict]:
        belief = self._belief(ctx)
        bar = 0.35 + belief * (0.55 - 0.25 * self.tradeoff)
        out = []
        for c in candidates:
            card = ctx.card(c.model)
            quality = card.quality_score if card else 0.5
            rate = self._success_rate(c.model)
            expected = 0.5 * quality + 0.5 * rate
            out.append({"model": c.model, "score": round(expected, 6),
                        "components": {"quality": quality,
                                       "success_rate": round(rate, 6),
                                       "belief_hard": round(belief, 6),
                                       "acceptance_bar": round(bar, 6),
                                       "clears_bar": expected >= bar}})
        return out

    def update(self, fb: Feedback) -> None:
        with self._lock:
            a, b = self._posteriors.get(fb.model, [1.0, 1.0])
            if fb.success:
                a += 1.0
            else:
                b += 1.0
            self._posteriors[fb.model] = [a, b]


class RLDrivenSelector:
    """Epsilon-greedy contextual bandit per category: running mean reward
    per (category, model) with decayed exploration."""

    name = "rl_driven"

    def __init__(self, epsilon: float = 0.1, decay: float = 0.999,
                 seed: Optional[int] = None, **_):
        self.epsilon = epsilon
        self.decay = decay
        self.rng = np.random.default_rng(seed)
        self._q: Dict[tuple, List[float]] = {}  # (cat, model) → [mean, n]
        self._lock = threading.Lock()

    def _qval(self, cat: str, model: str) -> float:
        return self._q.get((cat, model), [0.5, 0.0])[0]

    def select(self, candidates: List[ModelRef], ctx: SelectionContext
               ) -> SelectionResult:
        self.epsilon *= self.decay
        if self.rng.random() < self.epsilon:
            ref = candidates[int(self.rng.integers(len(candidates)))]
            return SelectionResult(ref, self._qval(ctx.category, ref.model),
                                   "bandit explore")
        best = max(candidates,
                   key=lambda c: self._qval(ctx.category, c.model))
        return SelectionResult(best, self._qval(ctx.category, best.model),
                               "bandit exploit")

    def score_breakdown(self, candidates: List[ModelRef],
                        ctx: SelectionContext) -> List[dict]:
        return [{"model": c.model,
                 "score": round(self._qval(ctx.category, c.model), 6),
                 "components": {"q_value": round(
                     self._qval(ctx.category, c.model), 6),
                     "category": ctx.category,
                     "epsilon": round(self.epsilon, 6)}}
                for c in candidates]

    def update(self, fb: Feedback) -> None:
        reward = fb.quality if fb.quality else (1.0 if fb.success else 0.0)
        with self._lock:
            mean, n = self._q.get((fb.category, fb.model), [0.5, 0.0])
            n += 1
            mean += (reward - mean) / n
            self._q[(fb.category, fb.model)] = [mean, n]


class SessionAwareSelector:
    """Sticky session → model affinity (a backend's KV cache stays warm):
    a session keeps its model while feedback stays positive; broken by
    failures or TTL."""

    name = "session_aware"

    def __init__(self, ttl_seconds: float = 1800.0, fallback: str = "static",
                 **kwargs):
        self.ttl = ttl_seconds
        self._affinity: Dict[str, tuple] = {}  # session → (model, t)
        self._fallback = registry.create(fallback, **kwargs) \
            if fallback != "session_aware" else StaticSelector()
        self._lock = threading.Lock()

    def select(self, candidates: List[ModelRef], ctx: SelectionContext
               ) -> SelectionResult:
        now = time.time()
        with self._lock:
            aff = self._affinity.get(ctx.session_id)
            if aff and now - aff[1] < self.ttl:
                for c in candidates:
                    if c.model == aff[0]:
                        self._affinity[ctx.session_id] = (aff[0], now)
                        return SelectionResult(c, 1.0, "session affinity")
        res = self._fallback.select(candidates, ctx)
        if ctx.session_id:
            with self._lock:
                self._affinity[ctx.session_id] = (res.ref.model, now)
        return res

    def _fallback_rows(self, candidates: List[ModelRef],
                       ctx: SelectionContext) -> Dict[str, dict]:
        breakdown = getattr(self._fallback, "score_breakdown", None)
        if breakdown is None:
            return {}
        try:
            return {row["model"]: row for row in breakdown(candidates, ctx)}
        except Exception:
            return {}

    def score_breakdown(self, candidates: List[ModelRef],
                        ctx: SelectionContext) -> List[dict]:
        now = time.time()
        with self._lock:
            aff = self._affinity.get(ctx.session_id)
        sticky = aff[0] if aff and now - aff[1] < self.ttl else ""
        fb_scores = self._fallback_rows(candidates, ctx)
        out = []
        for c in candidates:
            row = fb_scores.get(c.model,
                                {"score": 0.0, "components": {}})
            comp = dict(row.get("components", {}))
            comp["session_affinity"] = c.model == sticky
            out.append({"model": c.model,
                        "score": 1.0 if c.model == sticky
                        else row.get("score", 0.0),
                        "components": comp})
        return out

    def update(self, fb: Feedback) -> None:
        if not fb.success and fb.session_id:
            with self._lock:
                self._affinity.pop(fb.session_id, None)
        self._fallback.update(fb)


class HybridSelector:
    """Blend of elo rating, latency score, and static weights."""

    name = "hybrid"

    def __init__(self, **kwargs):
        self.elo = EloSelector(**kwargs)
        self.latency = LatencyAwareSelector()

    def _scored(self, candidates: List[ModelRef], ctx: SelectionContext
                ) -> List[tuple]:
        """(score, components, ref) per candidate."""
        ratings = {c.model: self.elo.rating(c.model) for c in candidates}
        lo, hi = min(ratings.values()), max(ratings.values())
        span = (hi - lo) or 1.0
        out = []
        for c in candidates:
            elo_score = (ratings[c.model] - lo) / span
            lat = self.latency.tracker.percentile(c.model, 90.0, 0.0)
            lat_score = 1.0 / (1.0 + lat / 1000.0)
            out.append((0.5 * elo_score + 0.3 * lat_score
                        + 0.2 * c.weight,
                        {"elo_score": round(elo_score, 6),
                         "elo_rating": round(ratings[c.model], 3),
                         "latency_score": round(lat_score, 6),
                         "weight": c.weight}, c))
        return out

    def select(self, candidates: List[ModelRef], ctx: SelectionContext
               ) -> SelectionResult:
        score, _, best = max(self._scored(candidates, ctx),
                             key=lambda t: t[0])
        return SelectionResult(best, score, "hybrid blend")

    def score_breakdown(self, candidates: List[ModelRef],
                        ctx: SelectionContext) -> List[dict]:
        return [{"model": c.model, "score": round(s, 6), "components": comp}
                for s, comp, c in self._scored(candidates, ctx)]

    def update(self, fb: Feedback) -> None:
        self.elo.update(fb)
        self.latency.update(fb)


class LookupTableSelector:
    """Query → model table with periodic auto-save.  Keys are query
    hashes; misses defer to a fallback selector and are learned on
    feedback."""

    name = "lookup_table"

    def __init__(self, path: Optional[str] = None, fallback: str = "static",
                 auto_save_every: int = 32, **kwargs):
        self.path = path
        self.table: Dict[str, str] = {}
        self.auto_save_every = auto_save_every
        self._dirty = 0
        self._fallback = registry.create(fallback, **kwargs)
        self._lock = threading.Lock()
        self._last_query_hash: Optional[str] = None
        if path and os.path.exists(path):
            with open(path) as f:
                self.table = json.load(f)

    @staticmethod
    def _key(query: str) -> str:
        return hashlib.sha1(query.lower().strip().encode()).hexdigest()[:16]

    def select(self, candidates: List[ModelRef], ctx: SelectionContext
               ) -> SelectionResult:
        key = self._key(ctx.query)
        self._last_query_hash = key  # fallback attribution only
        with self._lock:
            model = self.table.get(key)
        if model:
            for c in candidates:
                if c.model == model:
                    return SelectionResult(c, 1.0, "lookup hit")
        return self._fallback.select(candidates, ctx)

    def _fallback_rows(self, candidates: List[ModelRef],
                       ctx: SelectionContext) -> Dict[str, dict]:
        breakdown = getattr(self._fallback, "score_breakdown", None)
        if breakdown is None:
            return {}
        try:
            return {row["model"]: row for row in breakdown(candidates, ctx)}
        except Exception:
            return {}

    def score_breakdown(self, candidates: List[ModelRef],
                        ctx: SelectionContext) -> List[dict]:
        key = self._key(ctx.query)
        with self._lock:
            model = self.table.get(key)
        hit = model if any(c.model == model for c in candidates) else ""
        fb_scores = self._fallback_rows(candidates, ctx)
        out = []
        for c in candidates:
            row = fb_scores.get(c.model,
                                {"score": 0.0, "components": {}})
            comp = dict(row.get("components", {}))
            comp["lookup_hit"] = c.model == hit
            out.append({"model": c.model,
                        "score": 1.0 if c.model == hit
                        else row.get("score", 0.0),
                        "components": comp})
        return out

    def update(self, fb: Feedback) -> None:
        # Feedback.query gives exact attribution under concurrency; the
        # last-select hash is only a single-threaded fallback.
        key = self._key(fb.query) if fb.query else self._last_query_hash
        if fb.success and key:
            with self._lock:
                self.table[key] = fb.model
                self._dirty += 1
                if self.path and self._dirty >= self.auto_save_every:
                    self.save()
        self._fallback.update(fb)

    def save(self) -> None:
        if self.path:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.table, f)
            os.replace(tmp, self.path)
            self._dirty = 0


for _cls in (StaticSelector, EloSelector, LatencyAwareSelector,
             MultiFactorSelector, AutoMixSelector, RLDrivenSelector,
             SessionAwareSelector, HybridSelector, LookupTableSelector):
    registry.register(_cls.name, _cls)
