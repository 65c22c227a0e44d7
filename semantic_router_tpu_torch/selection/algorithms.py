"""Selection algorithms that run on the host: static, elo, latency_aware,
multi_factor, automix, hybrid, rl_driven, session_aware, lookup_table.

static (weighted), elo (Bradley-Terry pairwise ratings), latency_aware
(latency percentiles + quality trade-off), multi_factor (weighted
quality / cost / latency / context fit / load), automix (small → large
escalation on a belief over query difficulty), hybrid (blend), rl_driven
(epsilon-greedy bandit per category), session_aware (sticky session
affinity), lookup_table (query → model table with auto-save).  The port's
copy of the JAX package's ``selection/algorithms.py``: host numpy there,
host numpy here, the same draws from the same seeds.
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
        """(score, ref) per candidate."""
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
            out.append((score, c))
        return out

    def select(self, candidates: List[ModelRef], ctx: SelectionContext
               ) -> SelectionResult:
        score, best = max(self._scored(candidates, ctx),
                          key=lambda t: t[0])
        return SelectionResult(best, score,
                               f"latency p{self.percentile:.0f} blend")

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
        """(score, ref) per candidate."""
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
            out.append((score, c))
        return out

    def select(self, candidates: List[ModelRef], ctx: SelectionContext
               ) -> SelectionResult:
        score, best = max(self._scored(candidates, ctx),
                          key=lambda t: t[0])
        return SelectionResult(best, score, "multi-factor")

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
        """(score, ref) per candidate."""
        ratings = {c.model: self.elo.rating(c.model) for c in candidates}
        lo, hi = min(ratings.values()), max(ratings.values())
        span = (hi - lo) or 1.0
        out = []
        for c in candidates:
            elo_score = (ratings[c.model] - lo) / span
            lat = self.latency.tracker.percentile(c.model, 90.0, 0.0)
            lat_score = 1.0 / (1.0 + lat / 1000.0)
            out.append((0.5 * elo_score + 0.3 * lat_score
                        + 0.2 * c.weight, c))
        return out

    def select(self, candidates: List[ModelRef], ctx: SelectionContext
               ) -> SelectionResult:
        score, best = max(self._scored(candidates, ctx),
                          key=lambda t: t[0])
        return SelectionResult(best, score, "hybrid blend")

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
