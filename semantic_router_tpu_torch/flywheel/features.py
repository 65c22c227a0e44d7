"""Deterministic featurization of routing signals (the port's copy of
``semantic_router_tpu.flywheel.features``).

The flywheel's policies must score a request at three very different
times — offline training over corpus rows, counterfactual replay, and
live shadow/canary scoring on the routing thread — and the feature
vector has to mean the same thing at all three, in any process.  So the
recipe is self-contained and versioned (``signal-hash-v1``):

- **signal buckets** (``dim`` wide): every matched ``family:rule`` pair
  crc32-hashes into a signed bucket weighted by its confidence (the same
  crc32-not-hash() reasoning as training/selection_train.hash_embed —
  PYTHONHASHSEED salts str hashing per interpreter);
- **category one-hot**: the winning domain-family hit through the
  trainer's shared ``category_onehot`` (scaled so category distance
  dominates bucket noise);
- **scalars**: degradation level / 4 and projection-score values hashed
  into the last bucket region would cost stability — instead the two
  live in the signal buckets already (projection outputs are matched
  rules like any family).

No embedding forward anywhere: live shadow scoring must never add
device work to the hot path.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, List, Mapping, Sequence

import numpy as np

FEATURE_KIND = "signal-hash-v1"
DEFAULT_DIM = 64


def feature_dim(dim: int = DEFAULT_DIM) -> int:
    """Total vector width for a given signal-bucket width."""
    from ..training.selection_train import CATEGORIES

    return int(dim) + len(CATEGORIES)


def _bucket(vec: np.ndarray, key: str, weight: float, dim: int) -> None:
    h = zlib.crc32(key.encode("utf-8"))
    vec[h % dim] += weight if (h >> 1) % 2 else -weight


def signal_features(matches: Mapping[str, Sequence[str]],
                    confidences: Mapping[str, float],
                    dim: int = DEFAULT_DIM) -> np.ndarray:
    """Features from a live ``SignalMatches``-shaped view (matches +
    "family:rule" confidences)."""
    from ..training.selection_train import category_onehot

    vec = np.zeros((int(dim),), np.float32)
    category = ""
    for family, names in sorted(matches.items()):
        for name in names:
            conf = float(confidences.get(f"{family}:{name}", 1.0))
            _bucket(vec, f"{family}:{name}", conf, dim)
        if family == "domain" and names and not category:
            category = str(names[0])
    norm = float(np.linalg.norm(vec))
    if norm > 0:
        vec /= norm
    return np.concatenate([vec, category_onehot(category or "other")])


def row_features(row: Dict[str, Any],
                 dim: int = DEFAULT_DIM) -> np.ndarray:
    """Features from one corpus row (flywheel/corpus.py shape: family →
    [[rule, confidence], ...]) — bit-identical to what
    ``signal_features`` produces for the live request that generated the
    row."""
    matches: Dict[str, List[str]] = {}
    confidences: Dict[str, float] = {}
    for family, hits in (row.get("signals") or {}).items():
        names = []
        for rule, conf in hits:
            names.append(str(rule))
            confidences[f"{family}:{rule}"] = float(conf)
        matches[family] = names
    return signal_features(matches, confidences, dim=dim)


def signals_obj_features(signals, dim: int = DEFAULT_DIM) -> np.ndarray:
    """Features straight from a decision.engine.SignalMatches (the live
    routing-thread path)."""
    return signal_features(signals.matches, signals.confidences, dim=dim)
