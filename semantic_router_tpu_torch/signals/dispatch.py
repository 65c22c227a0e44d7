"""Concurrent signal dispatch over every signal family.

Only families referenced by decisions, complexity composers or
projections are evaluated (less the request's ``skip_signals``); each
active family runs on its own worker and the join is the wall clock of
the slowest one.  Before the fan-out, the
sequence tasks one fused trunk group can serve classify the user text
together (one tokenization, one trunk forward) and seed the request's
memo.  After it, complexity composers escalate their rules, then the
projections derive their outputs (with the kb family's metrics).
Evaluator exceptions are contained and recorded (fail-open: a dead family
never kills routing).  The decision-aware cascade (``engine/cascade``)
drives the same per-family call, prefetch, fold and derivations in
waves instead of all at once.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..config.schema import SIGNAL_PROJECTION
from ..observability import batchtrace
from ..decision.engine import SignalMatches, eval_rule_node
from ..decision.projections import ProjectionEvaluator, ProjectionTrace
from .base import RequestContext, SignalEvaluator, SignalResult

# serial prefetch budget: past it the evaluators classify on their own
PREFETCH_TIMEOUT_S = 10.0

# families that are a safety control, not a quality optimization: the
# cascade pins them (never skipped), as the reference's brownout keeps them
SAFETY_FAMILIES = ("jailbreak",)


@dataclass
class DispatchReport:
    results: Dict[str, SignalResult] = field(default_factory=dict)
    wall_s: float = 0.0
    projection_trace: Optional[ProjectionTrace] = None
    # set by Router.evaluate_signals: whether the evaluated view was
    # prompt-compressed; route() keeps a prefetch's decision, so a ladder
    # move between the prefetch and the route cannot make ctx.user_text
    # differ from the text the signals saw.  None = not recorded
    compressed_view: Optional[bool] = None
    # the cascade's skip certificate (engine/cascade): the waves, the
    # forwards never submitted or cancelled and why; None = full fan-out
    cascade: Optional[dict] = None


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
                 projections: Optional[ProjectionEvaluator] = None,
                 used_types: Optional[List[str]] = None,
                 complexity_rules: Optional[list] = None) -> None:
        self.evaluators = {e.signal_type: e for e in evaluators}
        self.projections = projections
        self.used_types = set(used_types) if used_types is not None else None
        self.complexity_rules = list(complexity_rules or [])
        # one worker per family
        self.pool = ThreadPoolExecutor(max_workers=max(1, len(evaluators)),
                                       thread_name_prefix="signal")

    def active_evaluators(self) -> List[SignalEvaluator]:
        if self.used_types is None:
            return list(self.evaluators.values())
        return [e for t, e in self.evaluators.items() if t in self.used_types]

    def learned_types(self, keep=None) -> List[str]:
        """Families backed by an inference engine (device work), minus
        ``keep``."""
        keep_set = set(keep or ())
        return sorted(t for t, e in self.evaluators.items()
                      if getattr(e, "engine", None) is not None
                      and t not in keep_set)

    def evaluate(self, ctx: RequestContext,
                 skip_signals: Optional[List[str]] = None
                 ) -> "tuple[SignalMatches, DispatchReport]":
        """Every active family but ``skip_signals``, at once."""
        start = time.perf_counter()
        skip = set(skip_signals or ())
        active = [e for e in self.active_evaluators()
                  if e.signal_type not in skip]
        run = self._runner(ctx)
        self._prefetch_fused(ctx, active)
        if len(active) <= 1:
            results = [run(e) for e in active]
        else:
            results = list(self.pool.map(run, active))
        signals = SignalMatches()
        report = DispatchReport()
        kb_metrics: dict = {}
        for r in results:
            self._fold_result(r, signals, report, kb_metrics)
        self._finalize(signals, report, kb_metrics)
        report.wall_s = time.perf_counter() - start
        return signals, report

    @staticmethod
    def _runner(ctx: RequestContext):
        """The per-family call the full fan-out and the cascade's waves
        share: one family, failing open, under a ``signal.<family>`` span
        of the request's trace (captured here, on the request's thread:
        the engine calls under it carry it into the batcher; no open
        trace costs one thread-local read); a result with no source says
        ``engine`` when the evaluator holds one, else ``heuristic``."""
        parent = batchtrace.capture()

        def run(e: SignalEvaluator) -> SignalResult:
            source = "engine" if getattr(e, "engine", None) is not None \
                else "heuristic"
            t0 = time.perf_counter()
            try:
                with batchtrace.activate(parent, f"signal.{e.signal_type}"):
                    out = e.evaluate(ctx)
            except Exception as exc:  # fail open per family
                out = SignalResult(signal_type=e.signal_type,
                                   latency_s=time.perf_counter() - t0,
                                   error=f"{type(exc).__name__}: {exc}")
            out.source = out.source or source
            return out

        return run

    @staticmethod
    def _fold_result(r: SignalResult, signals: SignalMatches,
                     report: DispatchReport, kb_metrics: dict) -> None:
        """Fold one family's result into the match set: hits, their
        details (a keyword hit's detail is its matched keywords), and the
        kb family's metrics."""
        report.results[r.signal_type] = r
        for h in r.hits:
            signals.add(r.signal_type, h.rule, h.confidence)
            if h.detail:
                signals.details.setdefault(r.signal_type, {})[h.rule] = \
                    h.detail.get("keywords", h.detail)
        kb_metrics.update(r.metrics)

    def _needs_projection(self) -> bool:
        return self.projections is not None and (
            self.used_types is None or SIGNAL_PROJECTION in self.used_types
            or bool(self.projections.cfg.scores)
            or bool(self.projections.cfg.partitions))

    def _finalize(self, signals: SignalMatches, report: DispatchReport,
                  kb_metrics: dict) -> None:
        """After the fan-out: complexity composers, then projections."""
        if self.complexity_rules:
            apply_complexity_composers(signals, self.complexity_rules)
        if self._needs_projection():
            report.projection_trace = self.projections.evaluate(
                signals, kb_metrics=kb_metrics)

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


def build_dispatcher(cfg, engine=None, learned_cfg=None, extra=(),
                     replaced=()) -> SignalDispatcher:
    """Every model-free evaluator, plus the learned, embedding-scored and
    kb evaluators when an engine is given, then ``extra`` (the router's
    MCP classifiers and external-model evaluators), restricted to the
    families the config's decisions, composers and projections
    reference.  The engine-backed evaluators read ``learned_cfg``'s rules
    (default ``cfg``): a recipe's dispatcher takes its heuristic rules
    from the recipe and its learned ones from the top-level config, as
    the reference's does; those whose class is named in ``replaced`` are
    left out (an external model serves their family).  Evaluators are
    keyed by family, so the last of a family wins: an MCP classifier
    replaces the bank's ``domain`` head, and of several the last one
    serves."""
    from .embedding_signal import build_embedding_evaluators
    from .heuristic import (
        AuthzSignal,
        ContextSignal,
        ConversationSignal,
        EventSignal,
        LanguageSignal,
        ReaskSignal,
        StructureSignal,
    )
    from .keyword import KeywordSignal
    from .learned import build_learned_evaluators

    s = cfg.signals
    evaluators: List[SignalEvaluator] = [
        KeywordSignal(s.keywords),
        ContextSignal(s.context),
        StructureSignal(s.structure),
        ConversationSignal(s.conversation),
        LanguageSignal(s.language),
        AuthzSignal(s.role_bindings,
                    fail_open=bool(cfg.authz.get("fail_open", True))),
        EventSignal(s.events),
        ReaskSignal(s.reasks),
    ]
    if engine is not None:
        lcfg = learned_cfg or cfg
        learned = build_learned_evaluators(engine, lcfg)
        if lcfg.signals.kb and lcfg.knowledge_bases:
            from .kb import KBSignal

            learned.append(KBSignal(engine, lcfg.signals.kb,
                                    lcfg.knowledge_bases))
        learned += build_embedding_evaluators(engine, lcfg)
        evaluators += [e for e in learned
                       if type(e).__name__ not in replaced]
    evaluators += list(extra)
    return SignalDispatcher(evaluators,
                            projections=ProjectionEvaluator(cfg.projections),
                            used_types=cfg.used_signal_types() or None,
                            complexity_rules=s.complexity)
