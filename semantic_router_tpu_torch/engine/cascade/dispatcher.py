"""Cost-ordered wave dispatch with decision-aware early exit.

Drop-in replacement for ``SignalDispatcher.evaluate`` when
``engine.cascade.enabled`` is set: instead of fanning out every active
family at once, the evaluator runs

1. **wave 0** — every heuristic family, every pinned family, and any
   learned family whose fused-bank result is already memoized (a
   prefetched forward is paid for; skipping it saves nothing), then
2. **cost-ordered waves** of the remaining learned families
   (cheap→expensive per runtimestats warm EWMAs blended with flywheel
   decision values), re-running the three-valued fold (tristate.py)
   after wave 0 and after every completed forward.  A family is skipped
   — never submitted, or its still-queued future cancelled — the moment
   the fold proves its outcome cannot change the selected decision.

Skip reasons, and what they certify:

- ``decided``    — a winner is certain: its rule tree is definitely
  matched with pinned confidence/rules, and its sort key beats every
  other non-false decision's best-achievable key.  All resolutions of
  the pending families select the same decision.
- ``irrelevant`` — the family appears only in decisions already
  definitely false; no resolution revives them.
- ``cancelled``  — same proofs as above, applied to a queued future
  that had not started (``Future.cancel`` succeeded mid-wave).
- ``truncated``  — brownout/wave-budget cut the cascade short.  NOT
  outcome-neutral: like an L2 family drop, it trades routing quality
  for capacity, and the certificate marks it so replay never treats it
  as proven.

Both skip proofs are monotone under later resolutions (a definite
status under unknown-set P stays definite under any subset of P fixed
to its actual values), so the union of neutral-skipped families is
itself outcome-neutral against the FINAL match set — the property a
replay of the decision record re-checks.

The port's copy of ``semantic_router_tpu.engine.cascade.dispatcher``.
With the flywheel policy live (canary/promoted), the cascade passes
through to the plain fan-out: policy features hash every family's
matches, so a skip — however decision-neutral — could move live model
choice.  The order blends in the flywheel's per-decision values
(``value_blend``) once its evaluation has measured them.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import as_completed
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ...decision.engine import SignalMatches
from ...signals.dispatch import DispatchReport, apply_complexity_composers
from .planner import (
    PLANNER_VERSION,
    CascadePlan,
    CascadePlanError,
    build_plan,
    plan_order,
)
from .tristate import FALSE, TRUE, tri_eval_node

# reasons whose skips are provably outcome-neutral (vs. load-shedding)
NEUTRAL_SKIP_REASONS = ("decided", "irrelevant", "cancelled")


@dataclass
class Assessment:
    """One tri-state pass over the decisions at a wave boundary."""

    decided: bool
    winner: Optional[str]
    # pending families some still-contending decision can read
    needed: Set[str] = field(default_factory=set)


def _clone_signals(signals: SignalMatches) -> SignalMatches:
    out = SignalMatches()
    out.matches = {k: list(v) for k, v in signals.matches.items()}
    out.confidences = dict(signals.confidences)
    out.details = {k: dict(v) for k, v in signals.details.items()}
    return out


def _key_bounds(dec, tri, strategy: str):
    """(worst, best) sort keys a decision can end up with, in
    ``DecisionEngine._sort_key`` shape — min() selects the smallest
    tuple, so "worst" is the key at conf_lo and "best" at conf_hi."""
    if strategy == "confidence":
        return ((-tri.conf_lo, -dec.priority, dec.name),
                (-tri.conf_hi, -dec.priority, dec.name))
    return ((-dec.priority, -tri.conf_lo, dec.name),
            (-dec.priority, -tri.conf_hi, dec.name))


def certain_winner(decisions, strategy: str, signals: SignalMatches,
                   unknown) -> tuple:
    """(decided, winner, contending) under the unknown-family set.

    decided=True with winner=None means every decision is definitely
    unmatched (the fallback path is taken regardless of how the unknown
    families resolve); with a winner name, that decision is definitely
    matched with pinned confidence/rules and its sort key beats every
    rival's best-achievable key under ALL resolutions.  ``contending``
    lists (decision, TriResult) pairs still not definitely false —
    empty when nothing can match."""
    frozen = frozenset(unknown)
    contending = []
    for dec in decisions:
        tri = tri_eval_node(dec.rules, signals, frozen)
        if tri.status != FALSE:
            contending.append((dec, tri))
    if not contending:
        return True, None, contending

    for dec, tri in contending:
        if tri.status != TRUE or not tri.pinned:
            continue
        worst, _ = _key_bounds(dec, tri, strategy)
        # names are unique so tuple comparison is strict: the winner's
        # worst key must beat every rival's best-achievable key
        if all(_key_bounds(dec2, tri2, strategy)[1] > worst
               for dec2, tri2 in contending if dec2.name != dec.name):
            return True, dec.name, contending
    return False, None, contending


def assess(decision_engine, signals: SignalMatches, pending: Set[str],
           plan: CascadePlan) -> Assessment:
    """Tri-state fold over every decision with ``pending`` unresolved.

    The derived families re-enter the unknown set transitively: while
    any composer feeder is pending the composers may still re-level
    complexity rules, and while any projection feeder is pending the
    partitions/scores/mappings may still move — the view passed in has
    both applied over the PARTIAL matches, so their outputs are only
    trustworthy once their feeders are settled."""
    unknown = set(pending)
    if pending & plan.complexity_feeders:
        unknown.add("complexity")
    if pending & plan.projection_feeders:
        unknown.add("projection")

    decided, winner, contending = certain_winner(
        decision_engine.decisions, decision_engine.strategy, signals,
        unknown)
    if decided:
        return Assessment(decided=True, winner=winner)
    needed: Set[str] = set()
    for dec, _tri in contending:
        needed |= plan.families(dec.name) & pending
    return Assessment(decided=False, winner=None, needed=needed)


class CascadeEvaluator:
    """Owns plans, counters and knobs; per-request work happens in
    ``evaluate`` using the dispatcher's own pool and runner."""

    def __init__(self, metrics=None, runtime_stats=None,
                 flywheel_provider=None) -> None:
        self.metrics = metrics
        self.runtime_stats = runtime_stats
        self.flywheel_provider = flywheel_provider
        self.knobs: Dict = {}
        self._lock = threading.Lock()
        self._plans: Dict[tuple, CascadePlan] = {}
        self._skips: Dict[str, int] = {}
        self._waves_total = 0
        self._decided_total = 0
        self._requests = 0
        self._last_order: List[str] = []

    def configure(self, knobs: Dict) -> None:
        with self._lock:
            self.knobs = dict(knobs)
            self._plans.clear()  # relevance may depend on reloaded config

    def plan_for(self, decision_engine, dispatcher,
                 signals_cfg=None) -> CascadePlan:
        key = (id(decision_engine), id(dispatcher))
        with self._lock:
            plan = self._plans.get(key)
        if plan is None:
            plan = build_plan(decision_engine, dispatcher, signals_cfg)
            with self._lock:
                if len(self._plans) >= 32:  # default + recipes; bounded
                    self._plans.clear()
                self._plans[key] = plan
        return plan

    # -- per-request evaluation -------------------------------------------

    def evaluate(self, ctx, dispatcher, decision_engine, signals_cfg=None,
                 brownout: bool = False,
                 skip_signals: Optional[List[str]] = None
                 ) -> tuple[SignalMatches, DispatchReport]:
        try:
            plan = self.plan_for(decision_engine, dispatcher, signals_cfg)
        except CascadePlanError:
            # a plan that cannot honor the safety floor never dispatches
            # cascaded — fall open to the plain full fan-out
            return dispatcher.evaluate(ctx, skip_signals=skip_signals)

        fw = self.flywheel_provider() if self.flywheel_provider else None
        fw_state = str(getattr(fw, "state", "idle") or "idle")
        if fw_state in ("canary", "promoted"):
            signals, report = dispatcher.evaluate(
                ctx, skip_signals=skip_signals)
            report.cascade = {"mode": "passthrough",
                              "reason": f"flywheel_{fw_state}",
                              "planner_version": plan.version}
            return signals, report

        start = time.perf_counter()
        report = DispatchReport()
        skip = set(skip_signals or ())
        active = [e for e in dispatcher.active_evaluators()
                  if e.signal_type not in skip]
        run = dispatcher._runner(ctx)

        # partition: wave 0 takes heuristics, pinned families, and any
        # learned family whose forward is already memoized by the
        # streamed prefetch (resolves free — skipping saves nothing)
        memo = ctx.class_memo
        text = ctx.user_text
        wave0, deferrable = [], []
        for e in active:
            engine = getattr(e, "engine", None)
            task = getattr(e, "prefetch_task", "")
            prefetched = (engine is not None and bool(task)
                          and (id(engine), task, text) in memo)
            if e.signal_type in plan.skippable and not prefetched:
                deferrable.append(e)
            else:
                wave0.append(e)

        dispatcher._prefetch_fused(ctx, wave0)
        if len(wave0) <= 1:
            results0 = [run(e) for e in wave0]
        else:
            results0 = list(dispatcher.pool.map(run, wave0))
        signals = SignalMatches()
        kb_metrics: dict = {}
        for r in results0:
            dispatcher._fold_result(r, signals, report, kb_metrics)

        pending = {e.signal_type for e in deferrable}
        by_family = {e.signal_type: e for e in deferrable}
        order = self._order(plan)
        queue = [f for f in order if f in pending]
        # families active but outside the static order (should not
        # happen; belt-and-braces) run in a final wave
        queue += sorted(pending - set(queue))

        wave_size = max(1, int(self.knobs.get("wave_size", 2)))
        max_waves = int(self.knobs.get("brownout_max_waves", 1) if brownout
                        else self.knobs.get("max_waves", 0))

        skipped: Dict[str, str] = {}
        waves_run: List[List[str]] = []
        decided_after: Optional[int] = None
        winner: Optional[str] = None

        def fold(r) -> None:
            dispatcher._fold_result(r, signals, report, kb_metrics)
            pending.discard(r.signal_type)
            if self.runtime_stats is not None and not r.error:
                self.runtime_stats.note_family_cost(r.signal_type,
                                                    r.latency_s)

        while pending:
            a = assess(decision_engine,
                       self._assess_view(dispatcher, signals, kb_metrics),
                       pending, plan)
            if a.decided:
                for f in pending:
                    skipped[f] = "decided"
                decided_after = len(waves_run)
                winner = a.winner
                pending.clear()
                break
            for f in list(pending):
                if f not in a.needed:
                    skipped[f] = "irrelevant"
                    pending.discard(f)
            if not pending:
                break
            if max_waves and len(waves_run) >= max_waves:
                # brownout L2 / wave budget: shed the cascade tail
                # instead of whole families — quality degradation the
                # certificate does NOT claim neutral
                for f in pending:
                    skipped[f] = "truncated"
                pending.clear()
                break
            wave = [f for f in queue if f in pending][:wave_size]
            evals = [by_family[f] for f in wave]
            # skip-aware fused prefetch: only THIS wave's tasks enter
            # the packed fused forward — a skipped family never
            # occupies a segment
            dispatcher._prefetch_fused(ctx, evals)
            ran: List[str] = []
            if len(evals) == 1:
                fold(run(evals[0]))
                ran.append(evals[0].signal_type)
            else:
                futs = {dispatcher.pool.submit(run, e): e for e in evals}
                for fut in as_completed(futs):
                    e = futs[fut]
                    if fut.cancelled():
                        continue  # recorded at cancel time below
                    fold(fut.result())
                    ran.append(e.signal_type)
                    still_queued = [(f2, e2) for f2, e2 in futs.items()
                                    if not f2.done()]
                    if not still_queued:
                        continue
                    a2 = assess(decision_engine,
                                self._assess_view(dispatcher, signals,
                                                  kb_metrics),
                                pending, plan)
                    for f2, e2 in still_queued:
                        fam2 = e2.signal_type
                        if (a2.decided or fam2 not in a2.needed) \
                                and f2.cancel():
                            skipped[fam2] = ("decided" if a2.decided
                                             else "cancelled")
                            pending.discard(fam2)
                    if a2.decided and decided_after is None:
                        # mid-wave decision: the running wave still counts
                        decided_after = len(waves_run) + 1
                        winner = a2.winner
            waves_run.append(ran)

        dispatcher._finalize(signals, report, kb_metrics)
        report.cascade = {
            "mode": "cascade",
            "planner_version": plan.version,
            "strategy": decision_engine.strategy,
            "order": list(order),
            "pinned": sorted(plan.pinned),
            "waves": waves_run,
            "skipped": dict(sorted(skipped.items())),
            "decided_after_wave": decided_after,
            "winner": winner,
        }
        self._account(skipped, waves_run, decided_after is not None, order)
        report.wall_s = time.perf_counter() - start
        return signals, report

    # -- internals ---------------------------------------------------------

    def _assess_view(self, dispatcher, signals: SignalMatches,
                     kb_metrics: dict) -> SignalMatches:
        """Derived-family view for assessment: composers + projections
        applied to a CLONE of the partial matches, so the real fold at
        finalize time starts from raw family results exactly like the
        plain fan-out does."""
        view = _clone_signals(signals)
        if dispatcher.complexity_rules:
            apply_complexity_composers(view, dispatcher.complexity_rules)
        if dispatcher._needs_projection():
            dispatcher.projections.evaluate(view, kb_metrics=kb_metrics)
        return view

    def _order(self, plan: CascadePlan) -> List[str]:
        cost_ms: Dict[str, float] = {}
        if self.runtime_stats is not None:
            cost_ms = {f: s * 1000.0 for f, s in
                       self.runtime_stats.family_costs().items()}
        decision_values: Dict[str, float] = {}
        fw = self.flywheel_provider() if self.flywheel_provider else None
        if fw is not None:
            try:
                last = getattr(fw, "last_eval", None) or {}
                decision_values = {str(k): float(v) for k, v in
                                   (last.get("decision_values") or {}).items()}
            except Exception:
                decision_values = {}
        order = plan_order(
            plan, cost_ms, decision_values,
            float(self.knobs.get("cost_default_ms", 5.0)),
            float(self.knobs.get("value_blend", 0.25)))
        with self._lock:
            self._last_order = list(order)
        return order

    def _account(self, skipped: Dict[str, str], waves_run: List[List[str]],
                 decided: bool, order: List[str]) -> None:
        with self._lock:
            self._requests += 1
            self._waves_total += len(waves_run)
            if decided:
                self._decided_total += 1
            for f in skipped:
                self._skips[f] = self._skips.get(f, 0) + 1
        if self.metrics is not None:
            for f in skipped:
                self.metrics.cascade_skipped.inc(family=f)
            if waves_run:
                self.metrics.cascade_waves.inc(float(len(waves_run)))

    def report(self) -> dict:
        """/debug/runtime ``cascade`` block."""
        cost_ms: Dict[str, float] = {}
        if self.runtime_stats is not None:
            cost_ms = {f: round(s * 1000.0, 4) for f, s in
                       self.runtime_stats.family_costs().items()}
        with self._lock:
            return {
                "enabled": True,
                "planner_version": PLANNER_VERSION,
                "order": list(self._last_order),
                "cost_ms": cost_ms,
                "skipped_forwards": dict(sorted(self._skips.items())),
                "waves_total": self._waves_total,
                "decided_early_total": self._decided_total,
                "requests_total": self._requests,
                "wave_size": int(self.knobs.get("wave_size", 2)),
                "brownout_max_waves": int(
                    self.knobs.get("brownout_max_waves", 1)),
            }
