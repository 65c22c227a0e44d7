"""Classifier evaluation harness (the port's own copy of
``semantic_router_tpu.training.evaluate``, which imports no JAX):

- sequence tasks: accuracy + per-label precision/recall/F1 + macro-F1
- token tasks: span-level precision/recall/F1 (exact-type overlap match)

Drives ``InferenceEngine.classify`` / ``token_classify``, so the same
harness evaluates converted checkpoints, fresh fine-tunes and the
serving path: on the card, the fused bank's flash-attention trunk and
head epilogue.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from .datasets import TokenRow


@dataclass
class SeqEvalReport:
    accuracy: float
    macro_f1: float
    per_label: Dict[str, Dict[str, float]]
    n: int

    def to_dict(self) -> Dict:
        return {"accuracy": round(self.accuracy, 4),
                "macro_f1": round(self.macro_f1, 4),
                "per_label": self.per_label, "n": self.n}


def _prf(tp: int, fp: int, fn: int) -> Tuple[float, float, float]:
    p = tp / (tp + fp) if tp + fp else 0.0
    r = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    return p, r, f1


def evaluate_sequence(engine, task: str,
                      data: Sequence[Tuple[str, str]]) -> SeqEvalReport:
    if not data:
        raise ValueError("empty evaluation dataset")
    labels = sorted({l for _, l in data})
    tp = {l: 0 for l in labels}
    fp = {l: 0 for l in labels}
    fn = {l: 0 for l in labels}
    correct = 0
    for text, gold in data:
        pred = engine.classify(task, text).label
        if pred == gold:
            correct += 1
            tp[gold] += 1
        else:
            fn[gold] += 1
            if pred in fp:
                fp[pred] += 1
    per_label = {}
    f1s = []
    for l in labels:
        p, r, f1 = _prf(tp[l], fp[l], fn[l])
        per_label[l] = {"precision": round(p, 4), "recall": round(r, 4),
                        "f1": round(f1, 4)}
        f1s.append(f1)
    return SeqEvalReport(accuracy=correct / len(data),
                         macro_f1=sum(f1s) / len(f1s) if f1s else 0.0,
                         per_label=per_label, n=len(data))


@dataclass
class SpanEvalReport:
    precision: float
    recall: float
    f1: float
    per_type: Dict[str, Dict[str, float]]
    n: int

    def to_dict(self) -> Dict:
        return {"precision": round(self.precision, 4),
                "recall": round(self.recall, 4), "f1": round(self.f1, 4),
                "per_type": self.per_type, "n": self.n}


def _span_match(pred: Dict, gold: Dict) -> bool:
    """Same type + character overlap (lenient boundary matching — the
    serving path merges subword spans, so exact boundaries over-penalize)."""
    return (pred["type"] == gold["type"]
            and pred["start"] < gold["end"]
            and gold["start"] < pred["end"])


def evaluate_token(engine, task: str, rows: Sequence[TokenRow],
                   threshold: float = 0.5) -> SpanEvalReport:
    types = sorted({e["type"] for r in rows for e in r.entities})
    counts = {t: {"tp": 0, "fp": 0, "fn": 0} for t in types}
    extra_fp = 0
    for row in rows:
        res = engine.token_classify(task, row.text, threshold=threshold)
        preds = [{"start": e.start, "end": e.end, "type": e.type}
                 for e in res.entities]
        matched_gold = set()
        for pred in preds:
            hit = None
            for gi, gold in enumerate(row.entities):
                if gi not in matched_gold and _span_match(pred, gold):
                    hit = gi
                    break
            if hit is not None:
                matched_gold.add(hit)
                counts[pred["type"]]["tp"] += 1
            elif pred["type"] in counts:
                counts[pred["type"]]["fp"] += 1
            else:
                extra_fp += 1
        for gi, gold in enumerate(row.entities):
            if gi not in matched_gold:
                counts[gold["type"]]["fn"] += 1
    tp = sum(c["tp"] for c in counts.values())
    fp = sum(c["fp"] for c in counts.values()) + extra_fp
    fn = sum(c["fn"] for c in counts.values())
    p, r, f1 = _prf(tp, fp, fn)
    per_type = {}
    for t, c in counts.items():
        tp_, tr, tf1 = _prf(c["tp"], c["fp"], c["fn"])
        per_type[t] = {"precision": round(tp_, 4),
                       "recall": round(tr, 4), "f1": round(tf1, 4)}
    return SpanEvalReport(precision=p, recall=r, f1=f1,
                          per_type=per_type, n=len(rows))
