"""Cost-aware contextual bandit routing policy (LinUCB over signal
features); the port's copy of ``semantic_router_tpu.flywheel.policy``,
float64 numpy on the host.

The ~13 hand-written selectors score candidates from configured weights
and online feedback; this policy is *trained from recorded traffic*:
each candidate model is a bandit arm with a per-arm ridge regression
(LinUCB: Li et al., WWW'10) over the flywheel's deterministic signal
features, and the arm score is

    exploit  θ_a·x           (expected reward given the signals)
  + explore  α·√(xᵀA_a⁻¹x)   (uncertainty bonus; 0 after offline fit
                              unless explicitly re-enabled)
  - cost     λ·cost_norm(a)  (the arm's measured cost share — reward
                              per device-second, not reward at any
                              price)

It implements the full ``selection`` Selector protocol (select /
update / score_breakdown) and the trained-artifact JSON round-trip the
other ML selectors use, so a JSON artifact emitted by the flywheel
trainer loads through ``decision.algorithm: {type: cost_bandit,
artifact: ...}`` exactly like a knn/mlp artifact.

Online updates only apply when the caller supplies a feature vector of
the trained width (the flywheel's shadow/canary paths do); the router's
engine-embedding feedback is a different space and is ignored rather
than corrupting the arms — retraining from the next corpus export is
the flywheel's own update loop.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from ..config.schema import ModelRef
from ..selection.base import (
    Feedback,
    SelectionContext,
    SelectionResult,
    registry,
)
from .features import DEFAULT_DIM, FEATURE_KIND, feature_dim


class _Arm:
    """One candidate model's ridge state: A = λI + Σ x xᵀ, b = Σ r x.

    θ = A⁻¹b only changes when the arm updates, so it is cached — the
    shadow/canary/serving hot path pays one d-length dot product per
    arm, not an O(d³) solve per request (the explore bonus, off by
    default, is the only per-request solve)."""

    __slots__ = ("A", "b", "n", "_theta")

    def __init__(self, d: int, ridge: float = 1.0) -> None:
        self.A = np.eye(d, dtype=np.float64) * float(ridge)
        self.b = np.zeros((d,), np.float64)
        self.n = 0
        self._theta: Optional[np.ndarray] = None

    def update(self, x: np.ndarray, reward: float) -> None:
        self.A += np.outer(x, x)
        self.b += float(reward) * x
        self.n += 1
        self._theta = None

    def theta(self) -> np.ndarray:
        if self._theta is None:
            self._theta = np.linalg.solve(self.A, self.b)
        return self._theta

    def score(self, x: np.ndarray, alpha: float) -> tuple:
        exploit = float(self.theta() @ x)
        explore = 0.0
        if alpha > 0:
            explore = float(alpha * np.sqrt(
                max(x @ np.linalg.solve(self.A, x), 0.0)))
        return exploit, explore


class CostAwareBanditSelector:
    """LinUCB arms per candidate model with a device-cost penalty."""

    name = "cost_bandit"

    def __init__(self, dim: int = DEFAULT_DIM, alpha: float = 0.0,
                 cost_weight: float = 0.1, ridge: float = 1.0,
                 **_ignored) -> None:
        self.dim = int(dim)
        self.d = feature_dim(self.dim)
        self.alpha = float(alpha)
        self.cost_weight = float(cost_weight)
        self.ridge = float(ridge)
        self.arms: Dict[str, _Arm] = {}
        # per-model cost share in [0, 1] (max-normalized mean
        # device-seconds / latency observed in the training corpus)
        self.model_costs: Dict[str, float] = {}
        self._lock = threading.Lock()

    # -- features ---------------------------------------------------------

    def _features(self, ctx: SelectionContext) -> Optional[np.ndarray]:
        if ctx.signals is None:
            return None
        from .features import signals_obj_features

        try:
            return np.asarray(
                signals_obj_features(ctx.signals, dim=self.dim),
                np.float64)
        except Exception:
            return None

    def _scored(self, candidates: List[ModelRef],
                ctx: SelectionContext) -> List[tuple]:
        """(score, components, ref) per candidate — the ONE scoring path
        select() and score_breakdown() share."""
        x = self._features(ctx)
        out = []
        with self._lock:
            for c in candidates:
                arm = self.arms.get(c.model)
                if x is None or arm is None or arm.n == 0:
                    # untrained arm / featureless context: configured
                    # weight keeps the ordering deterministic
                    out.append((float(c.weight),
                                {"untrained": True, "weight": c.weight},
                                c))
                    continue
                exploit, explore = arm.score(x, self.alpha)
                cost = self.cost_weight * float(
                    self.model_costs.get(c.model, 0.0))
                out.append((exploit + explore - cost,
                            {"exploit": round(exploit, 6),
                             "explore": round(explore, 6),
                             "cost_penalty": round(cost, 6),
                             "observations": arm.n},
                            c))
        return out

    # -- Selector protocol -------------------------------------------------

    def select(self, candidates: List[ModelRef],
               ctx: SelectionContext) -> SelectionResult:
        if not candidates:
            raise ValueError("cost_bandit: no candidates")
        score, comp, best = max(self._scored(candidates, ctx),
                                key=lambda t: t[0])
        reason = "cost_bandit untrained → weight argmax" \
            if comp.get("untrained") else \
            f"cost_bandit exploit={comp['exploit']} " \
            f"cost={comp['cost_penalty']}"
        return SelectionResult(best, score, reason)

    def score_breakdown(self, candidates: List[ModelRef],
                        ctx: SelectionContext) -> List[dict]:
        return [{"model": c.model, "score": round(s, 6),
                 "components": comp}
                for s, comp, c in self._scored(candidates, ctx)]

    def update(self, fb: Feedback) -> None:
        """Online update ONLY from flywheel-space features (trained
        width); engine-embedding feedback is a foreign space and is
        skipped — see module docstring."""
        if fb.query_embedding is None:
            return
        x = np.asarray(fb.query_embedding, np.float64)
        if x.shape[-1] != self.d:
            return
        reward = fb.quality if fb.quality else (1.0 if fb.success else 0.0)
        with self._lock:
            arm = self.arms.get(fb.model)
            if arm is None:
                arm = self.arms[fb.model] = _Arm(self.d, self.ridge)
            arm.update(x, reward)

    # -- offline training --------------------------------------------------

    def fit_offline(self, rows: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Fit the arms from corpus rows (flywheel/corpus.py shape);
        rebuilds model costs from the rows' device-second / latency
        observations.  Deterministic: row order is the corpus order."""
        from .features import row_features

        cost_sum: Dict[str, float] = {}
        cost_n: Dict[str, int] = {}
        with self._lock:
            self.arms = {}
            for row in rows:
                x = np.asarray(row_features(row, dim=self.dim),
                               np.float64)
                model = row["chosen"]
                arm = self.arms.get(model)
                if arm is None:
                    arm = self.arms[model] = _Arm(self.d, self.ridge)
                arm.update(x, float(row["reward"]))
                c = float(row.get("cost_device_s", 0.0)) \
                    + float(row["outcome"].get("latency_ms", 0.0)) / 1e3
                cost_sum[model] = cost_sum.get(model, 0.0) + c
                cost_n[model] = cost_n.get(model, 0) + 1
            means = {m: cost_sum[m] / cost_n[m] for m in cost_sum}
            peak = max(means.values()) if means else 0.0
            self.model_costs = {
                m: round(v / peak, 6) if peak > 0 else 0.0
                for m, v in means.items()}
        return {"arms": {m: a.n for m, a in self.arms.items()},
                "model_costs": dict(self.model_costs)}

    # -- artifact round-trip ----------------------------------------------

    def to_json(self) -> str:
        with self._lock:
            return json.dumps({
                "algorithm": self.name,
                "dim": self.dim,
                "alpha": self.alpha,
                "cost_weight": self.cost_weight,
                "ridge": self.ridge,
                "features": {"kind": FEATURE_KIND, "dim": self.dim},
                "model_costs": dict(self.model_costs),
                "arms": {m: {"A": a.A.tolist(), "b": a.b.tolist(),
                             "n": a.n}
                         for m, a in self.arms.items()},
            })

    @classmethod
    def from_json(cls, blob: str, **kwargs) -> "CostAwareBanditSelector":
        data = json.loads(blob)
        feats = data.get("features", {}) or {}
        if feats.get("kind", FEATURE_KIND) != FEATURE_KIND:
            raise ValueError(
                f"cost_bandit artifact feature kind "
                f"{feats.get('kind')!r} != {FEATURE_KIND!r}")
        sel = cls(dim=int(data.get("dim", DEFAULT_DIM)),
                  alpha=float(data.get("alpha", 0.0)),
                  cost_weight=float(data.get("cost_weight", 0.1)),
                  ridge=float(data.get("ridge", 1.0)), **kwargs)
        sel.model_costs = {str(m): float(v) for m, v in
                           (data.get("model_costs", {}) or {}).items()}
        for model, arm_d in (data.get("arms", {}) or {}).items():
            arm = _Arm(sel.d, sel.ridge)
            arm.A = np.asarray(arm_d["A"], np.float64)
            arm.b = np.asarray(arm_d["b"], np.float64)
            arm.n = int(arm_d.get("n", 0))
            sel.arms[str(model)] = arm
        return sel


registry.register(CostAwareBanditSelector.name, CostAwareBanditSelector)
