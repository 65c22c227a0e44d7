"""Concurrent signal dispatch over the learned and embedding-scored
families.

Only families referenced by decisions (or complexity composers) are
evaluated; each active family runs on its own worker and the join is the
wall clock of the slowest one.  Before the fan-out, the sequence tasks one
fused trunk group can serve classify the user text together (one
tokenization, one trunk forward) and seed the request's memo.  After it,
complexity composers escalate their rules.  Evaluator exceptions are
contained and recorded (fail-open: a dead family never kills routing).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..decision.engine import SignalMatches, eval_rule_node
from .base import RequestContext, SignalEvaluator, SignalResult

# serial prefetch budget: past it the evaluators classify on their own
PREFETCH_TIMEOUT_S = 10.0


@dataclass
class DispatchReport:
    results: Dict[str, SignalResult] = field(default_factory=dict)
    wall_s: float = 0.0


def apply_complexity_composers(signals: SignalMatches,
                               complexity_rules) -> None:
    """Composer escalation: a matched composer forces its rule to
    ":hard", dropping any lower level the family evaluator reported.  A
    composer leaf naming a family the port does not evaluate has no hits,
    so it does not match."""
    for rule in complexity_rules:
        if rule.composer is None:
            continue
        matched, conf, _ = eval_rule_node(rule.composer, signals)
        hard = f"{rule.name}:hard"
        if matched and hard not in signals.matches.get("complexity", ()):
            levels = signals.matches.get("complexity", [])
            signals.matches["complexity"] = [
                n for n in levels if n.split(":", 1)[0] != rule.name]
            signals.add("complexity", hard, max(conf, 0.5))


class SignalDispatcher:
    def __init__(self, evaluators: List[SignalEvaluator],
                 used_types: Optional[List[str]] = None,
                 complexity_rules: Optional[list] = None) -> None:
        self.evaluators = {e.signal_type: e for e in evaluators}
        self.used_types = set(used_types) if used_types is not None else None
        self.complexity_rules = list(complexity_rules or [])
        # one worker per learned family
        self.pool = ThreadPoolExecutor(max_workers=max(1, len(evaluators)),
                                       thread_name_prefix="signal")

    def active_evaluators(self) -> List[SignalEvaluator]:
        if self.used_types is None:
            return list(self.evaluators.values())
        return [e for t, e in self.evaluators.items() if t in self.used_types]

    def evaluate(self, ctx: RequestContext
                 ) -> "tuple[SignalMatches, DispatchReport]":
        start = time.perf_counter()
        active = self.active_evaluators()
        self._prefetch_fused(ctx, active)
        if len(active) <= 1:
            results = [self._run(e, ctx) for e in active]
        else:
            results = list(self.pool.map(lambda e: self._run(e, ctx), active))
        signals = SignalMatches()
        report = DispatchReport()
        for r in results:
            report.results[r.signal_type] = r
            for h in r.hits:
                signals.add(r.signal_type, h.rule, h.confidence)
                if h.detail:
                    signals.details.setdefault(r.signal_type, {})[h.rule] = \
                        h.detail
        apply_complexity_composers(signals, self.complexity_rules)
        report.wall_s = time.perf_counter() - start
        return signals, report

    @staticmethod
    def _run(e: SignalEvaluator, ctx: RequestContext) -> SignalResult:
        t0 = time.perf_counter()
        try:
            return e.evaluate(ctx)
        except Exception as exc:  # fail open per family
            return SignalResult(signal_type=e.signal_type,
                                latency_s=time.perf_counter() - t0,
                                error=f"{type(exc).__name__}: {exc}")

    def _prefetch_fused(self, ctx: RequestContext, active: list) -> None:
        """Tokenize-once + trunk-once for the learned fan-out: when ≥2
        active sequence evaluators target tasks of one trunk group,
        classify the user text for all of them in one classify_multi call
        and seed the memo — their own classify calls become lookups.
        Prefetch errors fall open to per-evaluator calls."""
        text = ctx.user_text
        if not text:
            return
        by_engine: Dict[int, tuple] = {}
        for e in active:
            task = getattr(e, "prefetch_task", "")
            engine = getattr(e, "engine", None)
            if not task or engine is None or not engine.has_task(task) \
                    or engine.task_kind(task) != "sequence" \
                    or (id(engine), task, text) in ctx.class_memo:
                continue
            by_engine.setdefault(id(engine), (engine, []))[1].append(task)
        for engine, tasks in by_engine.values():
            tasks = sorted(set(tasks))
            if len(tasks) < 2 or not engine.fused_covers(tasks):
                continue
            try:
                out = engine.classify_multi(tasks, [text],
                                            timeout=PREFETCH_TIMEOUT_S,
                                            enc_cache=ctx.enc_cache)
            except Exception:
                continue  # evaluators classify individually (fail open)
            for task, results in out.items():
                if results:
                    ctx.class_memo[(id(engine), task, text)] = results[0]

    def shutdown(self) -> None:
        self.pool.shutdown(wait=False, cancel_futures=True)


def build_dispatcher(cfg, engine=None) -> SignalDispatcher:
    """The learned and embedding-scored evaluators the config needs,
    restricted to the families its decisions and composers reference."""
    from .embedding_signal import build_embedding_evaluators
    from .learned import build_learned_evaluators

    evaluators = build_learned_evaluators(engine, cfg) \
        + build_embedding_evaluators(engine, cfg) \
        if engine is not None else []
    return SignalDispatcher(evaluators,
                            used_types=cfg.used_signal_types() or None,
                            complexity_rules=cfg.signals.complexity)
