"""Model-selection framework: context, feedback, registry.

A decision's ``algorithm: {type: ...}`` names a selector in ``registry``;
the router builds one per decision and feeds it each routed request's
outcome (``Feedback``).  The port's copy of the JAX package's
``selection/base.py``: the same classes, fields and arithmetic.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Protocol

import numpy as np

from ..config.schema import ModelCard, ModelRef


@dataclass
class SelectionContext:
    """Everything a selector may use for one decision."""

    query: str = ""
    decision_name: str = ""
    category: str = ""
    session_id: str = ""
    user_id: str = ""
    signals: Any = None  # decision.SignalMatches
    token_count: int = 0
    model_cards: Dict[str, ModelCard] = field(default_factory=dict)
    embed_fn: Optional[Callable[[str], np.ndarray]] = None
    _embedding: Optional[np.ndarray] = None

    def embedding(self) -> Optional[np.ndarray]:
        if self._embedding is None and self.embed_fn is not None:
            self._embedding = np.asarray(self.embed_fn(self.query),
                                         dtype=np.float32)
        return self._embedding

    def card(self, model: str) -> Optional[ModelCard]:
        return self.model_cards.get(model)


@dataclass
class SelectionResult:
    ref: ModelRef
    score: float = 0.0
    reason: str = ""


@dataclass
class Feedback:
    """Outcome of a routed request, fed back to learning selectors."""

    model: str
    success: bool = True
    quality: float = 0.0       # 0-1 rating when available
    latency_ms: float = 0.0
    ttft_ms: float = 0.0
    cost: float = 0.0
    category: str = ""
    session_id: str = ""
    query: str = ""            # original query text (lookup-table keying)
    query_embedding: Optional[np.ndarray] = None
    winner: str = ""           # pairwise: winning model (elo)
    loser: str = ""


class Selector(Protocol):
    name: str

    def select(self, candidates: List[ModelRef],
               ctx: SelectionContext) -> SelectionResult: ...

    def update(self, fb: Feedback) -> None: ...


class SelectorRegistry:
    """Method-name → constructor registry."""

    def __init__(self) -> None:
        self._factories: Dict[str, Callable[..., Selector]] = {}
        self._lock = threading.Lock()

    def register(self, name: str, factory: Callable[..., Selector]) -> None:
        with self._lock:
            self._factories[name] = factory

    def create(self, name: str, **kwargs) -> Selector:
        with self._lock:
            factory = self._factories.get(name)
        if factory is None:
            raise KeyError(f"unknown selection algorithm {name!r} "
                           f"(known: {sorted(self._factories)})")
        return factory(**kwargs)

    def known(self) -> List[str]:
        with self._lock:
            return sorted(self._factories)


registry = SelectorRegistry()


def weighted_choice(candidates: List[ModelRef],
                    rng: Optional[np.random.Generator] = None) -> ModelRef:
    rng = rng or np.random.default_rng()
    weights = np.asarray([max(c.weight, 0.0) for c in candidates])
    if weights.sum() <= 0:
        return candidates[0]
    probs = weights / weights.sum()
    return candidates[int(rng.choice(len(candidates), p=probs))]


class PercentileTracker:
    """Rolling latency percentile tracker (the latency windows that
    latency-aware selection reads)."""

    def __init__(self, window: int = 256) -> None:
        self.window = window
        self._samples: Dict[str, List[float]] = {}
        self._lock = threading.Lock()

    def record(self, key: str, value_ms: float) -> None:
        with self._lock:
            buf = self._samples.setdefault(key, [])
            buf.append(value_ms)
            if len(buf) > self.window:
                del buf[:len(buf) - self.window]

    def percentile(self, key: str, p: float, default: float = 0.0) -> float:
        with self._lock:
            buf = self._samples.get(key)
            if not buf:
                return default
            return float(np.percentile(buf, p))
