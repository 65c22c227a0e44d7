"""Counterfactual policy evaluation over the recorded corpus (the port's
copy of ``semantic_router_tpu.flywheel.evaluator``, float64 numpy on the
host).

A candidate policy never touches live traffic until it has *beaten the
incumbent on the traffic the incumbent already served*.  For every
corpus row the evaluator re-asks the candidate ("given these recorded
signals and candidates, which model?") and scores both choices against
a reward model estimated from the corpus itself:

- rows where the candidate agrees with the logged choice use the row's
  OWN reward (on-policy, exact);
- disagreeing rows fall back to the direct-method estimate: the mean
  recorded reward for (decision, model), then (model), then the global
  mean (the standard DM estimator — honest about its bias, which is why
  the promotion gate also demands the bootstrap CI clear zero).

Outputs: mean reward for policy and incumbent, their per-row delta with
a seeded bootstrap confidence interval, per-row regret vs the
corpus-best arm, per-decision device-second cost for both, and the
**per-decision value estimates** (reward per device-second) that feed
the L3 admission controller (resilience/costmodel.py value weights).
Everything is deterministic given (rows, policy, seed).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class RewardModel:
    """Direct-method reward lookup: (decision, model) → mean recorded
    reward, with (model) and global fallbacks."""

    def __init__(self, rows: List[Dict[str, Any]]) -> None:
        pair_sum: Dict[Tuple[str, str], float] = {}
        pair_n: Dict[Tuple[str, str], int] = {}
        model_sum: Dict[str, float] = {}
        model_n: Dict[str, int] = {}
        total = 0.0
        for row in rows:
            key = (row["decision"], row["chosen"])
            r = float(row["reward"])
            pair_sum[key] = pair_sum.get(key, 0.0) + r
            pair_n[key] = pair_n.get(key, 0) + 1
            model_sum[row["chosen"]] = model_sum.get(row["chosen"],
                                                     0.0) + r
            model_n[row["chosen"]] = model_n.get(row["chosen"], 0) + 1
            total += r
        self.pair = {k: pair_sum[k] / pair_n[k] for k in pair_sum}
        self.model = {m: model_sum[m] / model_n[m] for m in model_sum}
        self.global_mean = total / len(rows) if rows else 0.5

    def reward(self, decision: str, model: str) -> float:
        v = self.pair.get((decision, model))
        if v is None:
            v = self.model.get(model)
        return self.global_mean if v is None else v

    def best(self, decision: str, candidates: List[str]) -> float:
        return max((self.reward(decision, m) for m in candidates),
                   default=self.global_mean)


def _policy_choice(policy, row: Dict[str, Any]) -> str:
    """Ask the policy which of the row's recorded candidates it would
    route — replay-grade: the exact SignalMatches the live request
    produced, rebuilt from the row (replay/recorder.py semantics), no
    selector state, no RNG.  Candidate refs carry the default weight
    (rows don't record configured weights), so a policy's
    untrained-arm weight fallback may diverge from live — such a
    policy can't clear the CI gate anyway."""
    from ..config.schema import ModelRef
    from ..decision.engine import SignalMatches
    from ..selection.base import SelectionContext

    sm = SignalMatches()
    for family, hits in (row.get("signals") or {}).items():
        for rule, conf in hits:
            sm.add(family, str(rule), float(conf))
    refs = [ModelRef(model=m) for m in row["candidates"]]
    domain_hits = row["signals"].get("domain") or []
    ctx = SelectionContext(
        query=row.get("query", ""),
        decision_name=row["decision"],
        category=str(domain_hits[0][0]) if domain_hits else "",
        signals=sm)
    try:
        return policy.select(refs, ctx).ref.model
    except Exception:
        return refs[0].model if refs else row["chosen"]


def bootstrap_ci(deltas: np.ndarray, n_boot: int = 200,
                 seed: int = 0, level: float = 0.95
                 ) -> Tuple[float, float]:
    """Percentile bootstrap CI over per-row deltas (seeded, so the
    promotion decision is reproducible)."""
    if len(deltas) == 0:
        return 0.0, 0.0
    rng = np.random.default_rng(seed)
    means = np.empty((n_boot,), np.float64)
    n = len(deltas)
    for i in range(n_boot):
        means[i] = deltas[rng.integers(0, n, size=n)].mean()
    lo = (1.0 - level) / 2.0
    return (float(np.quantile(means, lo)),
            float(np.quantile(means, 1.0 - lo)))


def counterfactual_eval(rows: List[Dict[str, Any]], policy,
                        n_boot: int = 200, seed: int = 0,
                        min_rows: int = 1) -> Dict[str, Any]:
    """Score ``policy`` against the incumbent (the logged choices) over
    the corpus.  Returns the evaluation report the promotion gate
    reads; ``report["win"]`` is True when the reward-delta bootstrap CI
    clears zero."""
    if len(rows) < max(1, int(min_rows)):
        return {"rows": len(rows), "evaluated": False,
                "reason": f"corpus has {len(rows)} rows < "
                          f"min_rows={min_rows}"}
    rm = RewardModel(rows)
    pol_r, inc_r, regret_p, regret_i = [], [], [], []
    agreements = 0
    cost_by_decision: Dict[str, Dict[str, float]] = {}
    value_num: Dict[str, float] = {}
    value_den: Dict[str, float] = {}
    for row in rows:
        decision = row["decision"]
        choice = _policy_choice(policy, row)
        logged = row["chosen"]
        if choice == logged:
            agreements += 1
            p_reward = float(row["reward"])  # exact on-policy reward
        else:
            p_reward = rm.reward(decision, choice)
        i_reward = float(row["reward"])
        best = rm.best(decision, row["candidates"])
        pol_r.append(p_reward)
        inc_r.append(i_reward)
        regret_p.append(best - p_reward)
        regret_i.append(best - i_reward)
        cost = float(row.get("cost_device_s", 0.0))
        cd = cost_by_decision.setdefault(
            decision, {"rows": 0.0, "cost_s": 0.0})
        cd["rows"] += 1
        cd["cost_s"] += cost
        value_num[decision] = value_num.get(decision, 0.0) + i_reward
        value_den[decision] = value_den.get(decision, 0.0) + cost

    pol = np.asarray(pol_r)
    inc = np.asarray(inc_r)
    deltas = pol - inc
    lo, hi = bootstrap_ci(deltas, n_boot=n_boot, seed=seed)

    # per-decision value: mean reward per device-second under live
    # traffic — the admission controller's "measured value" signal.
    # Zero-cost corpora (no telemetry yet) fall back to mean reward so
    # the weights still order by usefulness.
    decision_values: Dict[str, float] = {}
    for d in value_num:
        n = cost_by_decision[d]["rows"]
        if value_den.get(d, 0.0) > 0:
            decision_values[d] = round(value_num[d] / value_den[d], 6)
        else:
            decision_values[d] = round(value_num[d] / max(n, 1.0), 6)

    return {
        "rows": len(rows),
        "evaluated": True,
        "policy": {
            "reward_mean": round(float(pol.mean()), 6),
            "regret_mean": round(float(np.mean(regret_p)), 6),
        },
        "incumbent": {
            "reward_mean": round(float(inc.mean()), 6),
            "regret_mean": round(float(np.mean(regret_i)), 6),
        },
        "reward_delta": round(float(deltas.mean()), 6),
        "reward_delta_ci": [round(lo, 6), round(hi, 6)],
        "agreement": round(agreements / len(rows), 4),
        # the promotion gate: the CI must CLEAR zero — a lower bound
        # touching 0.0 is exactly the unproven case the gate exists for
        "win": bool(lo > 0.0),
        "cost_by_decision": {
            d: {"rows": int(v["rows"]),
                "mean_cost_s": round(v["cost_s"] / max(v["rows"], 1.0),
                                     9)}
            for d, v in cost_by_decision.items()},
        "decision_values": decision_values,
        "seed": seed,
        "n_boot": n_boot,
    }
