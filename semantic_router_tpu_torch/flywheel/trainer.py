"""Flywheel policy trainer: corpus rows → loadable selector artifacts
(the port's copy of ``semantic_router_tpu.flywheel.trainer``).

Two trainer families behind one call:

- the existing offline ML trainers (training/selection_train.py —
  knn / kmeans / svm / mlp / gmtrouter) fit on the corpus converted to
  RoutingRecords (reward as quality, domain hit as category), exactly
  the artifact contract ``decision.algorithm.artifact`` already loads;
- the cost-aware contextual bandit (flywheel/policy.py) fits its LinUCB
  arms straight on the corpus rows' signal features.

Every artifact is JSON on disk; the report carries enough for the
promotion pipeline to pick a candidate (per-algorithm in-corpus
accuracy / mean predicted reward).  Training is deterministic given the
rows (fixed seeds, corpus order).  The torch selectors (kmeans, mlp,
gmtrouter) fit and load on ``device`` (``cuda`` unless given) inside
``gate`` — the controller passes its router's engine device and capture
gate; the bandit is host numpy.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

BANDIT_ALGORITHMS = ("cost_bandit",)
ML_ALGORITHMS = ("knn", "kmeans", "svm", "mlp", "gmtrouter")
DEFAULT_ALGORITHMS = ("cost_bandit", "knn")


def train_bandit(rows: List[Dict[str, Any]], dim: int = 64,
                 alpha: float = 0.0, cost_weight: float = 0.1) -> str:
    """Fit the cost-aware bandit; returns its JSON artifact blob."""
    from .policy import CostAwareBanditSelector

    sel = CostAwareBanditSelector(dim=dim, alpha=alpha,
                                  cost_weight=cost_weight)
    sel.fit_offline(rows)
    return sel.to_json()


def load_policy(path_or_blob: str, **kwargs):
    """Load a trained artifact (path or raw JSON blob) back into its
    serving selector — cost_bandit natively, everything else through
    the selection trainer's loader (category-feature wrapping
    included); ``kwargs`` (``device``, ``gate``) go to that loader."""
    blob = path_or_blob
    if os.path.exists(path_or_blob):
        with open(path_or_blob) as f:
            blob = f.read()
    data = json.loads(blob)
    if data.get("algorithm") == "cost_bandit":
        from .policy import CostAwareBanditSelector

        return CostAwareBanditSelector.from_json(blob)
    # ML artifacts round-trip through the selection trainer's loader;
    # it wants a file path, so materialize blobs arriving inline
    if os.path.exists(path_or_blob):
        from ..training.selection_train import load_selector

        return load_selector(path_or_blob, **kwargs)
    import tempfile

    from ..training.selection_train import load_selector

    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        f.write(blob)
        tmp = f.name
    try:
        return load_selector(tmp, **kwargs)
    finally:
        os.unlink(tmp)


def train_policies(rows: List[Dict[str, Any]],
                   algorithms: Sequence[str] = DEFAULT_ALGORITHMS,
                   out_dir: Optional[str] = None,
                   dim: int = 64, alpha: float = 0.0,
                   cost_weight: float = 0.1, device=None,
                   gate=None) -> Dict[str, Any]:
    """Train every requested algorithm; returns ``{algorithm:
    {"artifact": path-or-None, "blob": json, ...metrics}}`` plus a
    ``corpus`` summary block.  The selection trainers fit, and their
    artifacts are scored, on ``device`` inside ``gate``."""
    from ..training.selection_train import (
        evaluate_artifact,
        featurize,
        train_selector,
    )
    from .corpus import rows_to_routing_records

    report: Dict[str, Any] = {
        "corpus": {
            "rows": len(rows),
            "decisions": sorted({r["decision"] for r in rows}),
            "models": sorted({r["chosen"] for r in rows}),
        }
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    records = rows_to_routing_records(rows)
    feats = labels = None
    for algo in algorithms:
        algo = algo.strip()
        entry: Dict[str, Any] = {"artifact": None}
        try:
            if algo in BANDIT_ALGORITHMS:
                blob = train_bandit(rows, dim=dim, alpha=alpha,
                                    cost_weight=cost_weight)
                data = json.loads(blob)
                entry["arms"] = {m: a["n"]
                                 for m, a in data["arms"].items()}
                entry["model_costs"] = data["model_costs"]
            else:
                if feats is None:
                    feats, labels, _counts = featurize(records)
                blob = train_selector(algo, feats, labels,
                                      records=records, device=device,
                                      gate=gate)
            entry["blob"] = blob
            if out_dir:
                path = os.path.join(out_dir, f"{algo}.json")
                with open(path, "w") as f:
                    f.write(blob)
                entry["artifact"] = path
                if algo in ML_ALGORITHMS:
                    entry["accuracy"] = round(
                        evaluate_artifact(path, records, device=device,
                                          gate=gate), 4)
        except Exception as exc:
            entry["error"] = f"{type(exc).__name__}: {exc}"[:200]
        report[algo] = entry
    return report
