"""Continuous-admission packing scheduler — the packed batch composer.

The port's copy of ``semantic_router_tpu.engine.packing.scheduler``.
``PackingBatcher`` subclasses the engine's ``DynamicBatcher`` and
overrides ONLY its composition hooks, so ``engine.packing.enabled:
false`` (``self.enabled = False``) delegates every decision to the base
class: the port's fixed-row batching, unchanged.

Enabled behavior, per packable group (the engine names the row length of
a packable group through ``bucket_of``):

- **Length-aware take** (``packer.plan_take``): instead of a FIFO prefix
  of ``max_batch_size`` items, the step takes up to ``max_items_per_step``
  items chosen to fill whole rows — FIFO with bounded lookahead,
  deferral-counted, starvation-bounded (an item is deferred at most
  ``starvation_steps`` steps before it heads the next one).
- **Continuous admission**: up to ``max_inflight_steps`` steps of one
  group may be in flight, and a group with a step already executing is
  ready IMMEDIATELY: the device's execution time is the accumulation
  window, so newly arrived items join the next step the moment a
  dispatch worker frees instead of waiting for max_wait.

Non-packable groups (per-task, embedding, a fused group on flash or
chunked attention) keep the base behavior even when enabled.  There is no
serving mesh in the port: one step carries at most ``max_batch_size``
rows.
"""

from __future__ import annotations

from typing import Callable, Hashable, List, Optional

from ..batcher import BatchItem, DynamicBatcher
from .packer import RowPlan, plan_take


class PackingBatcher(DynamicBatcher):
    """Drop-in DynamicBatcher whose take/readiness hooks compose packed
    steps.  ``bucket_of(key) -> int|None`` names the row length of a
    group (None = not packable); all knobs are plain attributes read
    per decision, so a config reload retunes them live."""

    def __init__(self, runner, *, bucket_of: Callable[[Hashable],
                                                      Optional[int]],
                 max_batch_size: int = 32, max_wait_ms: float = 2.0,
                 name: str = "batcher", dispatch_workers: int = 4,
                 metrics=None, enabled: bool = True,
                 max_segments_per_row: int = 8,
                 max_items_per_step: int = 0,
                 max_inflight_steps: int = 2,
                 starvation_steps: int = 4,
                 segment_cap_of: Optional[Callable[[Hashable],
                                                   int]] = None) -> None:
        # knobs must exist BEFORE the base class starts the picker
        # thread (it may call the hooks immediately)
        self.enabled = bool(enabled)
        self.bucket_of = bucket_of
        self.segment_cap_of = segment_cap_of
        self.max_segments_per_row = max(1, int(max_segments_per_row))
        self.max_items_per_step = int(max_items_per_step)
        self.max_inflight_steps = max(1, int(max_inflight_steps))
        self.starvation_steps = max(0, int(starvation_steps))
        super().__init__(runner, max_batch_size=max_batch_size,
                         max_wait_ms=max_wait_ms, name=name,
                         dispatch_workers=dispatch_workers,
                         metrics=metrics)

    # -- knob application --------------------------------------------------

    def configure(self, knobs: dict) -> None:
        """Apply the normalized engine.packing block (hot reload):
        unknown/malformed values keep their previous setting."""
        def _int(key: str, attr: str, lo: int) -> None:
            try:
                setattr(self, attr, max(lo, int(knobs[key])))
            except (KeyError, TypeError, ValueError):
                pass

        if "enabled" in knobs:
            self.enabled = bool(knobs["enabled"])
        _int("max_segments_per_row", "max_segments_per_row", 1)
        _int("max_inflight_steps", "max_inflight_steps", 1)
        _int("starvation_steps", "starvation_steps", 0)
        if "max_items_per_step" in knobs:
            # single atomic publish (no read-modify-write of the live
            # value: the picker thread reads this concurrently)
            try:
                self.max_items_per_step = int(knobs["max_items_per_step"])
            except (TypeError, ValueError):
                pass

    def _item_budget(self) -> int:
        """Items one packed step may carry.  0 (the default knob) means
        2× max_batch_size: packed rows hold several segments each, so a
        step can serve more items than rows without growing the device
        batch; the padded SEGMENT axis stays a power of two ≤ this."""
        return self.max_items_per_step or 2 * self.max_batch_size

    def _row_budget(self) -> int:
        """Rows one packed step may fill."""
        return self.max_batch_size

    def _packable(self, key: Hashable) -> bool:
        if not self.enabled:
            return False
        try:
            return self.bucket_of(key) is not None
        except Exception:
            return False

    # -- composition hooks -------------------------------------------------

    def _inflight_cap(self, key: Hashable) -> int:
        if not self._packable(key):
            return super()._inflight_cap(key)
        return self.max_inflight_steps

    def _ready_immediately(self, key: Hashable,
                           items: List[BatchItem]) -> bool:
        # continuous admission: a step already in flight IS the
        # accumulation window — compose the next one now so it starts
        # the moment a dispatch worker frees
        if not self._packable(key):
            return False
        return bool(items) and self._inflight.get(key, 0) > 0

    def _seg_cap(self, key: Hashable) -> int:
        """Per-group segment cap: the auto-tuner's live policy when the
        engine provides one (segment_cap_of), else the global knob —
        the SAME value the fused runner packs with, so a planned take
        always re-plans identically at pack time."""
        fn = self.segment_cap_of
        if fn is not None:
            try:
                cap = fn(key)
                if cap:
                    return max(1, int(cap))
            except Exception:
                pass
        return self.max_segments_per_row

    def _group_full(self, key: Hashable, items: List[BatchItem]) -> bool:
        # re-fetch the bucket: a concurrent auto-tuner demotion between
        # _packable and here flips bucket_of to None — delegate rather
        # than crash the ONE picker thread everything dispatches on
        bucket = self.bucket_of(key) if self._packable(key) else None
        if bucket is None:
            return super()._group_full(key, items)
        if len(items) >= self._item_budget():
            return True
        # full when the pending lengths already fill the row budget
        plan = RowPlan(bucket, self._row_budget(), self._seg_cap(key))
        for item in items:
            if plan.add(len(item.payload.encoding)) is None:
                return True
        return False

    def _take_batch(self, key: Hashable, items: List[BatchItem]) -> tuple:
        bucket = self.bucket_of(key) if self._packable(key) else None
        if bucket is None:
            return super()._take_batch(key, items)
        lengths = [len(item.payload.encoding) for item in items]
        budget = self._item_budget()
        take, deferred = plan_take(
            lengths, bucket, max_rows=self._row_budget(),
            max_segments_per_row=self._seg_cap(key),
            max_items=budget,
            deferrals=[item.deferred for item in items],
            starvation_steps=self.starvation_steps,
            backlog_beyond=len(items) > budget)
        chosen = set(take)
        batch = [items[i] for i in take]
        rest = [item for i, item in enumerate(items) if i not in chosen]
        # deferral accounting: only items the LOOKAHEAD jumped past age
        # toward the starvation bound (plan_take reports them); items
        # dropped by the pow2 backlog trim refill next step untouched
        for i in deferred:
            items[i].deferred += 1
        return batch, rest
