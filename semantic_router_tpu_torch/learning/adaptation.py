"""Routing-sampling adaptation: outcome-driven online model choice.

Reference parity: ``pkg/extproc/router_learning_adaptation.go`` — the
default ``routing_sampling`` strategy scores every candidate model from
its experience ledger with a Beta-posterior quality estimate (Thompson
sampling when exploration is allowed, posterior mean when a protected
session suppresses it), adjusted by cost / overuse / reliability /
latency / cache terms, and proposes the winner when it beats the base
selection by the candidate-set margin. Modes per decision
(``adaptations.mode``): apply | observe | bypass — observe computes the
diagnostics but never changes the selection; bypass skips entirely.
The port's own copy of ``semantic_router_tpu.learning.adaptation``."""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .experience import ExperienceStore, ModelExperience

# minimum score advantage over the base model before a switch is
# proposed — wider candidate sets need stronger evidence
MARGINS = {"decision": 0.01, "tier": 0.03, "global": 0.05}


def _clamp01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


@dataclass
class CandidateScore:
    model: str
    score: float
    posterior_mean: float
    predicted: float
    cost_penalty: float
    overuse_penalty: float
    reliability_penalty: float
    latency_adjustment: float
    cache_adjustment: float


@dataclass
class AdaptationDecision:
    model: str                     # final proposal (may equal base)
    action: str                    # propose_switch | keep_base | bypass
    reason: str
    mode: str = "apply"
    used_sampling: bool = False
    scores: List[CandidateScore] = field(default_factory=list)


def score_candidates(store: ExperienceStore, decision: str, tier: int,
                     candidates: List[str], base_model: str,
                     costs: Optional[Dict[str, float]] = None,
                     quality_seeds: Optional[Dict[str, float]] = None,
                     use_sampling: bool = True,
                     rng: Optional[random.Random] = None
                     ) -> List[CandidateScore]:
    costs = costs or {}
    quality_seeds = quality_seeds or {}
    max_cost = max((costs.get(m, 0.0) for m in candidates), default=0.0)
    rng = rng or random.Random()
    out: List[CandidateScore] = []
    for model in candidates:
        if not model:
            continue
        exp = store.snapshot(decision, tier, model)
        seed = quality_seeds.get(model)
        if seed is not None and exp.good_fit + exp.underpowered == 0:
            exp.quality_seed = _clamp01(seed)
            exp.seed_weight = 2.0
        alpha = exp.seed_weight * exp.quality_seed + exp.good_fit + 1
        beta = exp.seed_weight * (1 - exp.quality_seed) \
            + exp.underpowered + 1
        mean = alpha / (alpha + beta)
        predicted = rng.betavariate(alpha, beta) if use_sampling else mean
        cost_penalty = 0.0
        if max_cost > 0:
            cost_penalty = 0.05 * costs.get(model, 0.0) / max_cost
        cost_penalty += 0.03 * _clamp01(exp.cost_ewma)
        total = float(exp.total + 1)
        overuse = 0.03 * exp.overprovisioned / total
        reliability = 0.10 * exp.failed / total
        latency_adj = -0.02 * _clamp01(exp.latency_ewma)
        cache_adj = 0.02 * _clamp01(exp.cache_hit_ewma)
        score = (predicted - cost_penalty - overuse - reliability
                 + latency_adj + cache_adj)
        if model == base_model:
            score += 0.001  # stability tiebreak toward the base
        out.append(CandidateScore(
            model=model, score=score, posterior_mean=mean,
            predicted=predicted, cost_penalty=cost_penalty,
            overuse_penalty=overuse, reliability_penalty=reliability,
            latency_adjustment=latency_adj, cache_adjustment=cache_adj))
    out.sort(key=lambda s: (-s.score, s.model))
    return out


def adapt(store: ExperienceStore, decision: str, tier: int,
          candidates: List[str], base_model: str, *,
          mode: str = "apply", candidate_set: str = "decision",
          use_sampling: bool = True,
          costs: Optional[Dict[str, float]] = None,
          quality_seeds: Optional[Dict[str, float]] = None,
          rng: Optional[random.Random] = None) -> AdaptationDecision:
    if mode == "bypass":
        return AdaptationDecision(base_model, "bypass",
                                  "decision_bypass", mode=mode)
    if not candidates:
        return AdaptationDecision(base_model, "keep_base",
                                  "candidate_set_empty", mode=mode)
    scores = score_candidates(store, decision, tier, candidates,
                              base_model, costs=costs,
                              quality_seeds=quality_seeds,
                              use_sampling=use_sampling, rng=rng)
    if not scores:
        return AdaptationDecision(base_model, "keep_base",
                                  "scores_missing", mode=mode)
    winner = scores[0]
    margin = MARGINS.get(candidate_set, MARGINS["decision"])
    base_score = next((s.score for s in scores
                       if s.model == base_model), None)
    switch = (winner.model != base_model and
              (base_score is None or
               winner.score - base_score >= margin))
    if mode == "observe" or not switch:
        action = "keep_base"
        reason = "observe_only" if mode == "observe" and switch else (
            "winner_is_base" if winner.model == base_model
            else "margin_not_met")
        return AdaptationDecision(base_model, action, reason, mode=mode,
                                  used_sampling=use_sampling,
                                  scores=scores)
    return AdaptationDecision(winner.model, "propose_switch",
                              "sampled_winner" if use_sampling
                              else "posterior_winner",
                              mode=mode, used_sampling=use_sampling,
                              scores=scores)
