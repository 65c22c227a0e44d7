"""Router learning: outcome-driven routing adaptation (the port's own
copy of ``semantic_router_tpu.learning``, which imports no JAX; the
reference's ``pkg/extproc/router_learning*.go``), the cross-request
routing loop:

  outcome verdicts → experience ledgers (durable) → routing-sampling
  adaptation (Thompson over Beta posteriors) → session protection →
  final model

``RouterLearning`` is the facade the pipeline calls: ``apply()`` after
base selection (may propose a different candidate), ``record_outcome()``
from the response path. Everything fails open — missing state, a dead
durable store, or disabled config leaves the base selection untouched.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from .adaptation import AdaptationDecision, adapt
from .experience import VERDICTS, ExperienceStore, ModelExperience
from .protection import ProtectionVerdict, SessionProtection

__all__ = [
    "RouterLearning",
    "ExperienceStore",
    "ModelExperience",
    "SessionProtection",
    "AdaptationDecision",
    "ProtectionVerdict",
    "VERDICTS",
    "adapt",
]

# latency normalization ceiling for the EWMA term (30 s ≈ 1.0)
_LATENCY_NORM_MS = 30_000.0


class RouterLearning:
    """Facade wiring experience + adaptation + protection to config."""

    def __init__(self, cfg: Dict, model_costs: Optional[Dict] = None,
                 quality_seeds: Optional[Dict] = None,
                 rng: Optional[random.Random] = None) -> None:
        cfg = cfg or {}
        self.enabled = bool(cfg.get("enabled", False))
        self.store = ExperienceStore(cfg.get("store"))
        ad = cfg.get("adaptation", {}) or {}
        self.adaptation_enabled = bool(ad.get("enabled", True))
        self.candidate_set = str(ad.get("candidate_set", "decision"))
        self.default_mode = str(ad.get("mode", "apply"))
        pr = cfg.get("protection", {}) or {}
        headers = (pr.get("identity", {}) or {}).get("headers", {}) or {}
        tuning = pr.get("tuning", {}) or {}
        self.protection_enabled = bool(pr.get("enabled", True))
        self.protection = SessionProtection(
            scope=str(pr.get("scope", "conversation")),
            session_header=headers.get("session", "x-session-id"),
            conversation_header=headers.get("conversation",
                                            "x-conversation-id"),
            idle_timeout_s=float(tuning.get("idle_timeout_seconds",
                                            900)),
            min_turns_before_switch=int(
                tuning.get("min_turns_before_switch", 2)),
            switch_margin=float(tuning.get("switch_margin", 0.05)))
        self.model_costs = dict(model_costs or {})
        self.quality_seeds = dict(quality_seeds or {})
        self.rng = rng or random.Random()

    # -- selection-time hook --------------------------------------------

    def apply(self, decision: str, candidates: List[str],
              base_model: str, headers: Optional[Dict[str, str]] = None,
              tier: int = 0, mode: Optional[str] = None) -> str:
        """Final model for this request (== base_model when learning is
        off, bypassed, observing, or unconvinced)."""
        if not self.enabled or not self.adaptation_enabled:
            return base_model
        mode = mode or self.default_mode
        headers = headers or {}
        pre = self.protection.preflight(headers) \
            if self.protection_enabled else ProtectionVerdict()
        decision_out = adapt(
            self.store, decision, tier, candidates, base_model,
            mode=mode, candidate_set=self.candidate_set,
            use_sampling=not pre.suppress_sampling,
            costs=self.model_costs, quality_seeds=self.quality_seeds,
            rng=self.rng)
        if not self.protection_enabled:
            return decision_out.model
        verdict = self.protection.apply(headers, decision_out,
                                        base_model)
        return verdict.final_model or decision_out.model

    # -- outcome hook ----------------------------------------------------

    def record_outcome(self, decision: str, model: str,
                       verdict: str = "", success: bool = True,
                       latency_ms: float = 0.0,
                       cache_hit: Optional[bool] = None,
                       tier: int = 0, count: int = 1) -> None:
        if not self.enabled:
            return
        if not verdict:
            verdict = "good_fit" if success else "failed"
        self.store.record(
            decision, tier, model, verdict, count=count,
            latency_norm=(latency_ms / _LATENCY_NORM_MS)
            if latency_ms else None,
            cache_hit=cache_hit,
            quality_seed=self.quality_seeds.get(model))

    def close(self) -> None:
        self.store.close()
