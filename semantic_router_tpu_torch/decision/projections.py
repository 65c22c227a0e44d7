"""Projections: signal matches → derived routing outputs.

The port of ``semantic_router_tpu.decision.projections``:

- partitions: a group of mutually exclusive rule names normalized into a
  distribution (temperature softmax over the members' confidences); the
  winner (``exclusive``) or every live member (``overlapping``) is added
  as a ``projection`` match, the default when no member matched;
- scores: weighted sums over match / confidence values and kb metrics;
- mappings: a score mapped to the first band whose predicate holds, with
  optional ``sigmoid_distance`` calibration of its confidence.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..config.schema import SIGNAL_PROJECTION, ProjectionsConfig
from .engine import SignalMatches


@dataclass
class ProjectionTrace:
    partitions: Dict[str, Dict[str, float]] = field(default_factory=dict)
    scores: Dict[str, float] = field(default_factory=dict)
    mappings: Dict[str, str] = field(default_factory=dict)


class ProjectionEvaluator:
    def __init__(self, cfg: ProjectionsConfig) -> None:
        self.cfg = cfg

    def evaluate(self, signals: SignalMatches,
                 kb_metrics: Optional[Dict[str, Dict[str, float]]] = None
                 ) -> ProjectionTrace:
        """Evaluate every projection, adding its matches to ``signals``
        under the ``projection`` type, and return the trace."""
        trace = ProjectionTrace()
        self._eval_partitions(signals, trace)
        self._eval_scores(signals, trace, kb_metrics or {})
        self._eval_mappings(signals, trace)
        return trace

    @staticmethod
    def _member_confidence(signals: SignalMatches, member: str) -> float:
        """A member is a rule name of any family: its best confidence
        where it matched."""
        best = 0.0
        for styp, names in signals.matches.items():
            if member in names:
                best = max(best, signals.confidence(styp, member))
        return best

    def _eval_partitions(self, signals: SignalMatches,
                         trace: ProjectionTrace) -> None:
        for part in self.cfg.partitions:
            live = {m: c for m in part.members
                    if (c := self._member_confidence(signals, m)) > 0.0}
            if not live:
                if part.default:
                    signals.add(SIGNAL_PROJECTION, part.default, 1.0)
                    trace.partitions[part.name] = {part.default: 1.0}
                continue
            temp = max(part.temperature, 1e-6)
            mx = max(live.values())
            exps = {m: math.exp((c - mx) / temp) for m, c in live.items()}
            z = sum(exps.values())
            dist = {m: e / z for m, e in exps.items()}
            trace.partitions[part.name] = dist
            if part.semantics == "exclusive":
                winner, p = max(dist.items(), key=lambda kv: kv[1])
                signals.add(SIGNAL_PROJECTION, winner, p)
            else:
                for m, p in dist.items():
                    signals.add(SIGNAL_PROJECTION, m, p)

    def _eval_scores(self, signals: SignalMatches, trace: ProjectionTrace,
                     kb_metrics: Dict[str, Dict[str, float]]) -> None:
        for score in self.cfg.scores:
            total = 0.0
            for inp in score.inputs:
                if inp.type == "kb_metric":
                    val = kb_metrics.get(inp.kb, {}).get(inp.metric, 0.0)
                else:
                    styp = inp.type.lower()
                    hit = signals.matched(styp, inp.name)
                    if inp.value_source in ("confidence", "score"):
                        val = signals.confidence(styp, inp.name) if hit \
                            else inp.miss
                    else:
                        val = inp.match if hit else inp.miss
                total += inp.weight * val
            trace.scores[score.name] = total

    def _eval_mappings(self, signals: SignalMatches,
                       trace: ProjectionTrace) -> None:
        for mapping in self.cfg.mappings:
            value = trace.scores.get(mapping.source)
            if value is None:
                continue
            for out in mapping.outputs:
                if out.predicate.check(value):
                    signals.add(SIGNAL_PROJECTION, out.name,
                                _calibrate(mapping.calibration, value, out))
                    trace.mappings[mapping.name] = out.name
                    break


def _calibrate(calibration: Dict, value: float, out) -> float:
    """``sigmoid_distance``: sigmoid(slope × the distance to the band's
    nearest edge); 1.0 otherwise."""
    if calibration.get("method") != "sigmoid_distance":
        return 1.0
    slope = float(calibration.get("slope", 10.0))
    p = out.predicate
    edges = [e for e in (p.gt, p.gte, p.lt, p.lte) if e is not None]
    if not edges:
        return 1.0
    dist = min(abs(value - e) for e in edges)
    return 1.0 / (1.0 + math.exp(-slope * dist))
