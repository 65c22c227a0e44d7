"""Online shape auto-tuner: runtimestats fill series → live pack knobs.

The port's copy of ``semantic_router_tpu.engine.packing.autotuner``.
Every device step lands rows_real / rows_padded and tokens_real /
tokens_padded per (group, bucket, variant) in runtimestats (packed steps
under ``packed``, unpacked fused ones under ``fused``).  The tuner reads
those series periodically and retunes the packing scheduler's shape
knobs per batch group:

- **segments per row**: chronic token-level under-fill on packed steps
  while rows run at the segment cap means the cap, not the traffic,
  bounds fill: double it (up to ``max_segments_cap``);
- **pack eligibility per bucket**: a bucket whose PACKED execute time per
  item exceeds its UNPACKED one (attention is quadratic in the row) is
  demoted: the runner keeps that bucket unpacked until the lease expires
  and packing is measured again.

Decisions are deterministic functions of the observed snapshot, published
as one atomic ``policy()`` dict the engine's fused runner reads per step.
The tuner thread is started by the bootstrap (``engine.packing.autotune``),
never by bare engine construction: tests drive ``step()`` directly.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional


class ShapeAutoTuner:
    """One per engine; reads ``runtime_stats.programs()`` and maintains
    {group: {"max_segments_per_row": int, "blocked_buckets": [int]}}."""

    def __init__(self, runtime_stats, scheduler=None, *,
                 target_fill: float = 0.85, min_samples: int = 50,
                 segments_floor: int = 8, max_segments_cap: int = 32,
                 interval_s: float = 30.0,
                 unblock_after_steps: int = 10) -> None:
        self.runtime_stats = runtime_stats
        self.scheduler = scheduler  # PackingBatcher (segment knob sink)
        self.target_fill = float(target_fill)
        self.min_samples = max(1, int(min_samples))
        self.segments_floor = max(1, int(segments_floor))
        self.max_segments_cap = max(self.segments_floor,
                                    int(max_segments_cap))
        self.interval_s = max(0.5, float(interval_s))
        # a demotion is a LEASE, not a verdict: blocking stops the
        # packed samples that could ever un-block the bucket, so after
        # this many tuner passes the bucket re-packs and re-measures
        self.unblock_after_steps = max(1, int(unblock_after_steps))
        self._policy: Dict[str, Dict[str, Any]] = {}
        self._blocked_at: Dict[tuple, int] = {}  # (group, bucket) → step
        # writer lock only.  READS go through the immutable published
        # snapshot below: the scheduler calls blocked()/policy() from
        # inside the batcher's composition regions (under the batcher
        # lock), so a read must not take a foreign lock.  Writers build
        # fresh dicts and swap ONE reference (atomic under the GIL);
        # readers never block and never see a half-applied policy.
        self._lock = threading.Lock()
        self._published: Dict[str, Dict[str, Any]] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.steps = 0
        self.retunes = 0

    # -- the decision ------------------------------------------------------

    def policy(self, group: str) -> Dict[str, Any]:
        """The live policy for one batch group (empty = defaults).
        Lock-free: reads the published snapshot (callers sit inside
        batcher-lock regions)."""
        return dict(self._published.get(group, {}))

    def blocked(self, group: str, bucket: int) -> bool:
        return bucket in self._published.get(group, {}).get(
            "blocked_buckets", ())

    def step(self) -> Dict[str, Dict[str, Any]]:
        """One tuning pass over the program registry; returns the new
        policy map.  Deterministic given the snapshot — tests feed a
        synthetic RuntimeStats and assert the retune."""
        try:
            programs = self.runtime_stats.programs()
        except Exception:
            return self.policy_map()
        # (group, bucket) → {variant: snapshot}
        by_shape: Dict[tuple, Dict[str, dict]] = {}
        for p in programs:
            by_shape.setdefault((p["group"], p["bucket"]), {})[
                p["variant"]] = p
        new_segments: Dict[str, int] = {}
        new_blocked: Dict[str, set] = {}
        for (group, bucket), variants in by_shape.items():
            packed = variants.get("packed")
            if packed is None or packed["executes"] < self.min_samples:
                continue
            fill = packed.get("token_fill_ratio",
                              packed.get("fill_ratio_mean", 0.0))
            segs_per_row = (packed.get("segments_real", 0)
                            / max(1, packed["rows_real"]))
            cur = self._current_segments(group)
            # raise the cap only when rows actually RUN at it — traffic
            # too light to fill rows is not a cap problem, and doubling
            # happens at most once per group per pass (never compounding
            # across this group's buckets)
            if fill < self.target_fill and segs_per_row >= 0.9 * cur:
                new_segments[group] = min(self.max_segments_cap, cur * 2)
            unpacked = variants.get("fused")
            if unpacked is not None and unpacked["executes"] >= \
                    self.min_samples and packed["rows_real"] > 0 \
                    and unpacked["rows_real"] > 0:
                packed_per_item = packed["execute_s_total"] \
                    / max(1, packed.get("segments_real",
                                        packed["rows_real"]))
                unpacked_per_item = unpacked["execute_s_total"] \
                    / unpacked["rows_real"]
                if packed_per_item > unpacked_per_item:
                    # packing LOSES here: longer effective rows cost
                    # more than the rows they saved — demote the bucket
                    new_blocked.setdefault(group, set()).add(bucket)
        with self._lock:
            self.steps += 1
            for group, segs in new_segments.items():
                pol = self._policy.setdefault(group, {})
                if pol.get("max_segments_per_row") != segs:
                    pol["max_segments_per_row"] = segs
                    self.retunes += 1
            for group, buckets in new_blocked.items():
                pol = self._policy.setdefault(group, {})
                before = set(pol.get("blocked_buckets", ()))
                merged = before | buckets
                for b in buckets:
                    self._blocked_at[(group, b)] = self.steps
                if merged != before:
                    pol["blocked_buckets"] = sorted(merged)
                    self.retunes += 1
            # expire demotion leases: a blocked bucket produces no new
            # packed samples, so only re-packing can ever re-judge it
            for (group, b), at in list(self._blocked_at.items()):
                if self.steps - at >= self.unblock_after_steps:
                    del self._blocked_at[(group, b)]
                    pol = self._policy.get(group)
                    if pol and b in pol.get("blocked_buckets", ()):
                        pol["blocked_buckets"] = [
                            x for x in pol["blocked_buckets"] if x != b]
                        self.retunes += 1
            self._publish_locked()
        return self.policy_map()

    def _publish_locked(self) -> None:
        """Swap in a fresh immutable snapshot of the policy map (caller
        holds ``_lock``).  One reference assignment — readers observe
        either the whole old policy or the whole new one."""
        self._published = {g: dict(p) for g, p in self._policy.items()}

    def _current_segments(self, group: str) -> int:
        """The group's LIVE cap: its own policy, else the configured
        floor — never another group's raised cap (the scheduler reads
        the same per-group value through the engine's segment_cap_of,
        so take-time and pack-time plans can't diverge)."""
        pol = self._published.get(group, {})
        try:
            return max(1, int(pol.get("max_segments_per_row",
                                      self.segments_floor)))
        except (TypeError, ValueError):
            return self.segments_floor

    def policy_map(self) -> Dict[str, Dict[str, Any]]:
        return {g: dict(p) for g, p in self._published.items()}

    def report(self) -> Dict[str, Any]:
        return {"steps": self.steps, "retunes": self.retunes,
                "interval_s": self.interval_s,
                "target_fill": self.target_fill,
                "policy": self.policy_map()}

    # -- lifecycle (bootstrap-only) ----------------------------------------

    def start(self, interval_s: Optional[float] = None
              ) -> "ShapeAutoTuner":
        if interval_s is not None:
            self.interval_s = max(0.5, float(interval_s))
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.step()
                except Exception:
                    pass  # telemetry-driven tuning must never die loudly

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="packing-autotuner")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None
