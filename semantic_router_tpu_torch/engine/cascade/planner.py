"""Cascade planning: which learned forwards can the decision spare?

The planner runs once per (decision engine, dispatcher) pair and
answers three static questions the per-request dispatcher then combines
with live tri-state evaluation (tristate.py):

- **relevance sets** — for each decision, the signal families whose
  outcome can still flip any branch of its rule tree.  Direct leaves
  come from ``RuleNode.leaves()``; two families are *derived* and pull
  their feeders in transitively: ``complexity`` (composers re-level
  rules from sibling-family matches) and ``projection`` (partitions /
  scores / mappings read arbitrary families plus kb metrics).
- **pinned families** — never skippable regardless of what the rule
  tree says, because something OUTSIDE the decision fold consumes them:
  jailbreak (``SAFETY_FAMILIES`` — a safety control, not a quality
  optimization), pii (policy plugins redact from its details), domain
  (category header + selection context + flywheel features), fact_check
  (response-phase hallucination screen), and complexity whenever any
  decision selects via automix (``AutoMixSelector._belief`` reads the
  raw matches).
- **skippable families** — engine-backed evaluators minus the pinned
  set; only these ever enter the cost-ordered waves.

A configuration where a safety family would end up skippable is a
planner bug, not a tuning choice — ``CascadePlan`` refuses to build
(see ``_check_safety_floor``), mirroring the brownout keep-families
contract in resilience/controller.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List

from ...config.schema import ALL_SIGNAL_TYPES
from ...signals.dispatch import SAFETY_FAMILIES

# bump when relevance/pinning semantics change: replayed certificates
# carry the version so a re-derivation against newer semantics is
# flagged instead of silently disagreeing
PLANNER_VERSION = 1

# families consumed outside the decision fold (pipeline.py): skipping
# them would change responses even when the selected decision is
# provably identical
_PIPELINE_CONSUMED = ("pii", "domain", "fact_check")


class CascadePlanError(RuntimeError):
    """A plan that would violate the safety floor refuses to build."""


@dataclass(frozen=True)
class CascadePlan:
    """Static relevance/pinning analysis for one engine+dispatcher pair."""

    version: int
    # decision name → every family whose outcome can still change the
    # decision's matched/confidence result (leaves + derived feeders)
    relevance: Dict[str, FrozenSet[str]] = field(default_factory=dict)
    pinned: FrozenSet[str] = frozenset()
    skippable: FrozenSet[str] = frozenset()
    # feeders of the two derived families; when any of these is still
    # pending the derived family itself must be treated as unresolved
    complexity_feeders: FrozenSet[str] = frozenset()
    projection_feeders: FrozenSet[str] = frozenset()

    def families(self, decision_name: str) -> FrozenSet[str]:
        return self.relevance.get(decision_name, frozenset())


def _leaf_families(node) -> set:
    return {leaf.signal_type.lower().strip() for leaf in node.leaves()}


def _composer_feeders(complexity_rules) -> set:
    feeders: set = set()
    for rule in complexity_rules or ():
        if rule.composer is not None:
            feeders |= _leaf_families(rule.composer)
    return feeders


def _projection_feeders(projections, signals_cfg) -> set:
    """Families feeding any partition member, score input, or kb metric.

    Partition members are bare rule names from arbitrary families;
    resolve them through the signals config exactly the way
    ``used_signal_types`` does.  Without a signals config every family
    is conservatively a potential feeder."""
    if projections is None:
        return set()
    cfg = projections.cfg
    feeders: set = set()
    for score in cfg.scores:
        for inp in score.inputs:
            if inp.type == "kb_metric":
                feeders.add("kb")
            elif inp.type:
                feeders.add(inp.type.lower())
    member_names = {m for p in cfg.partitions for m in p.members}
    if member_names:
        if signals_cfg is None:
            feeders |= {t for t in ALL_SIGNAL_TYPES if t}
        else:
            for styp in ALL_SIGNAL_TYPES:
                if member_names & set(signals_cfg.rule_names(styp)):
                    feeders.add(styp)
    return feeders


def _check_safety_floor(pinned: FrozenSet[str],
                        skippable: FrozenSet[str]) -> None:
    for fam in SAFETY_FAMILIES:
        if fam in skippable or fam not in pinned:
            raise CascadePlanError(
                f"safety family {fam!r} must be pinned, never cascade-"
                f"skipped (pinned={sorted(pinned)}, "
                f"skippable={sorted(skippable)})")


def build_plan(decision_engine, dispatcher, signals_cfg=None) -> CascadePlan:
    """Analyze one (decision engine, dispatcher) pair into a CascadePlan.

    ``signals_cfg`` is the SignalsConfig the dispatcher was built from
    (per-recipe when recipes route through alternate engines); None
    falls back to conservative all-family projection feeding."""
    complexity_feeders = frozenset(
        _composer_feeders(dispatcher.complexity_rules))
    projection_feeders = frozenset(
        _projection_feeders(dispatcher.projections, signals_cfg))

    relevance: Dict[str, FrozenSet[str]] = {}
    automix = False
    for dec in decision_engine.decisions:
        fams = _leaf_families(dec.rules)
        if "complexity" in fams:
            fams |= complexity_feeders
        if "projection" in fams:
            fams |= projection_feeders
            if "kb_metric" in fams:
                fams.discard("kb_metric")
        relevance[dec.name] = frozenset(fams)
        if str(dec.algorithm.get("type", "")).lower() == "automix":
            automix = True

    pinned = set(SAFETY_FAMILIES) | set(_PIPELINE_CONSUMED)
    if automix:
        pinned.add("complexity")

    learned = {t for t, e in dispatcher.evaluators.items()
               if getattr(e, "engine", None) is not None}
    active = {e.signal_type for e in dispatcher.active_evaluators()}
    skippable = frozenset((learned & active) - pinned)
    plan = CascadePlan(
        version=PLANNER_VERSION,
        relevance=relevance,
        pinned=frozenset(pinned),
        skippable=skippable,
        complexity_feeders=complexity_feeders,
        projection_feeders=projection_feeders,
    )
    _check_safety_floor(plan.pinned, plan.skippable)
    return plan


def plan_order(plan: CascadePlan, cost_ms: Dict[str, float],
               decision_values: Dict[str, float],
               default_cost_ms: float, value_blend: float) -> List[str]:
    """Cheap→expensive submission order over the skippable families.

    Cost is the runtimestats warm EWMA per family (default for families
    never measured); a family feeding high-value decisions (flywheel
    ``decision_values``) is discounted so information the learned policy
    weights heavily resolves earlier — an early high-value resolution
    decides the winner sooner and skips more of the tail."""
    def family_value(fam: str) -> float:
        best = 0.0
        for name, fams in plan.relevance.items():
            if fam in fams:
                best = max(best, float(decision_values.get(name, 0.0)))
        return best

    def utility(fam: str) -> float:
        cost = float(cost_ms.get(fam, default_cost_ms))
        return cost / (1.0 + max(value_blend, 0.0) * family_value(fam))

    return sorted(plan.skippable, key=lambda f: (utility(f), f))
