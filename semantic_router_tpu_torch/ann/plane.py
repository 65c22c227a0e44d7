"""ANN plane facade: named indexes + the maintenance thread.

The port's copy of ``semantic_router_tpu.ann.plane``, on one device (the
engine's, or ``device``).  ``AnnPlane`` is the registry-slotted subsystem
(``registry.ann``): bootstrap builds it when ``ann.enabled`` resolves
true, hands it the observability sinks (metrics registry, program
catalog, runtimestats), and owns its lifecycle: ONE maintenance thread
drives every index's compaction / promotion cycle and state-plane sync,
and ``close()`` joins it bounded.

An ``AnnIndex`` merges its device bank's top-k with the host tier's
exact scan, so entries are findable the moment they are added; hot knob
flips (capacity / quant) republish the device view atomically while
lookups in flight finish on their snapshot.  The ``llm_ann_*`` series
carry the reference's names and labels.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..observability.logging import component_event
from ..utils.device import DeviceLike, resolve_device
from .bank import DeviceBank
from .knobs import normalize_ann
from .search import AnnSearcher, TopKPrograms
from .sync import VersionedRowSync, cache_index_sync
from .tiering import HostTier, TierPolicy


class AnnIndex:
    """One named embedding index: device bank + host tier + policy."""

    def __init__(self, name: str, knobs: Dict, programs: TopKPrograms,
                 metrics=None, device: DeviceLike = None) -> None:
        self.name = name
        self.metrics = metrics
        self.bank = DeviceBank(
            dim=knobs["dim"], min_capacity=knobs["min_capacity"],
            max_capacity=knobs["max_capacity"], mode=knobs["quant"],
            recall_floor=knobs["recall_floor"],
            calibration_queries=knobs["calibration_queries"],
            name=name, device=device)
        self.host = HostTier()
        self.policy = TierPolicy(
            self.bank, self.host,
            promote_ewma=knobs["promote_ewma"],
            promote_min_hits=knobs["promote_min_hits"],
            evict_watermark=knobs["evict_watermark"],
            tombstone_ratio=knobs["tombstone_ratio"])
        self.searcher = AnnSearcher(self.bank.view, programs, name=name)
        self.searcher.configure_batching(knobs["batch"])
        self.default_k = knobs["top_k"]
        self.sync: Optional[VersionedRowSync] = None
        self._deleted: set = set()
        self._lock = threading.Lock()

    # -- data path -----------------------------------------------------------

    def add(self, entry_id: str, vec: np.ndarray) -> None:
        """New entries land in the host tier (exact, immediately
        findable); an id already device-resident overwrites in place
        and republishes on the next maintenance cycle."""
        with self._lock:
            self._deleted.discard(entry_id)
        if entry_id in self.bank:
            self.bank.add(entry_id, vec)
        else:
            self.host.add(entry_id, vec)

    def delete(self, entry_id: str) -> None:
        """Host rows drop now; device rows tombstone now (masked out of
        the merge immediately via the deleted set — the stale view
        reclaims at the next compaction rewrite)."""
        self.host.delete(entry_id)
        if self.bank.delete(entry_id):
            with self._lock:
                self._deleted.add(entry_id)
        self.policy.forget(entry_id)

    def ids(self) -> List[str]:
        return self.bank.entry_ids() + self.host.ids()

    def __len__(self) -> int:
        return len(self.bank) + len(self.host)

    def lookup(self, query: np.ndarray, k: Optional[int] = None
               ) -> Tuple[List[str], List[float]]:
        """Merged top-k: device bank program + host-tier exact scan,
        deleted ids filtered, best score wins on duplicates."""
        k = k or self.default_k
        dev_ids, dev_scores = self.searcher.search(query, k)
        host_ids, host_scores = self.host.scan(query, k)
        with self._lock:
            deleted = set(self._deleted)
        merged: Dict[str, float] = {}
        for entry_id, score in zip(dev_ids + host_ids,
                                   dev_scores + host_scores):
            if entry_id in deleted:
                continue
            if score > merged.get(entry_id, -np.inf):
                merged[entry_id] = score
        ranked = sorted(merged.items(), key=lambda kv: -kv[1])[:k]
        out_ids = [i for i, _ in ranked]
        # hit accounting feeds promotion (host) and eviction LRU (bank)
        self.policy.mark_hits(out_ids)
        if self.metrics is not None:
            path = "device" if dev_ids else (
                "host" if host_ids else "empty")
            self.metrics.m_lookups.inc(1.0, index=self.name, path=path)
        return out_ids, [s for _, s in ranked]

    # -- maintenance ---------------------------------------------------------

    def maintain(self) -> Dict[str, int]:
        counts = dict(self.policy.run_cycle())
        if counts["published"]:
            # the fresh view excludes compacted tombstones: retire any
            # deleted markers no longer backing a live slot anywhere
            with self._lock:
                self._deleted = {i for i in self._deleted
                                 if i in self.bank or i in self.host}
        sync = self.sync
        if sync is not None and sync.due():
            counts["synced"] = int(sync.sync_once())
        # every maintenance path stamps the per-index surface — the
        # plane's thread, a synchronous flush(), and test/bench cycles
        # all leave the gauges current
        if self.metrics is not None:
            if counts.get("promoted"):
                self.metrics.m_promotions.inc(counts["promoted"],
                                              index=self.name)
            if counts.get("evicted"):
                self.metrics.m_evictions.inc(counts["evicted"],
                                             index=self.name)
            view = self.bank.view()
            fill = (len(self.bank) / view.tier) if view is not None \
                and view.tier else 0.0
            self.metrics.m_fill.set(fill, index=self.name)
            self.metrics.m_host.set(float(len(self.host)),
                                    index=self.name)
        return counts

    def reconfigure(self, knobs: Dict) -> None:
        """Hot flip: retune bank storage / capacity, batching, and policy;
        republish when storage changed so the NEXT lookup serves the new
        posture while lookups in flight finish on their snapshot."""
        changed = self.bank.configure(
            mode=knobs["quant"],
            min_capacity=knobs["min_capacity"],
            max_capacity=knobs["max_capacity"])
        self.bank.recall_floor = knobs["recall_floor"]
        self.bank.calibration_queries = knobs["calibration_queries"]
        self.searcher.configure_batching(knobs["batch"])
        self.default_k = knobs["top_k"]
        self.policy.promote_ewma = knobs["promote_ewma"]
        self.policy.promote_min_hits = knobs["promote_min_hits"]
        self.policy.evict_watermark = knobs["evict_watermark"]
        self.policy.tombstone_ratio = knobs["tombstone_ratio"]
        if self.sync is not None:
            self.sync.interval_s = knobs["sync_interval_s"]
        if changed and len(self.bank):
            self.bank.publish()

    def flush(self) -> Dict[str, int]:
        """Synchronous promote-everything + publish (tests, bench, and
        warm paths that cannot wait a maintenance interval)."""
        self.policy.mark_hits(self.host.ids())
        return self.maintain()

    def report(self) -> Dict[str, object]:
        rep = self.bank.report()
        rep["host_entries"] = len(self.host)
        rep["deleted_pending"] = len(self._deleted)
        if self.sync is not None:
            rep["sync"] = self.sync.report()
        return rep

    def close(self) -> None:
        self.searcher.close()
        if self.sync is not None:
            self.sync.close()


class AnnPlane:
    """Named AnnIndex registry + the single maintenance thread."""

    def __init__(self, registry, programstats=None,
                 runtime_stats=None, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.m_fill = registry.gauge(
            "llm_ann_bank_fill",
            "Device-bank fill fraction (entries / capacity tier) per "
            "ANN index")
        self.m_host = registry.gauge(
            "llm_ann_host_entries",
            "Host-tier overflow entries per ANN index")
        self.m_lookups = registry.counter(
            "llm_ann_lookups_total",
            "ANN lookups by index and serving path "
            "(device|host|empty)")
        self.m_promotions = registry.counter(
            "llm_ann_promotions_total",
            "Host-to-device promotions per ANN index")
        self.m_evictions = registry.counter(
            "llm_ann_evictions_total",
            "Device-to-host LRU evictions per ANN index")
        self.m_fallback = registry.gauge(
            "llm_ann_local_fallback",
            "1 when an index's stateplane sync is degraded to "
            "local-only serving")
        self.m_maint_failures = registry.counter(
            "llm_ann_maintenance_failures_total",
            "ANN maintenance-cycle crashes per index (caught and "
            "retried next cycle — a climbing rate means compaction/"
            "promotion/sync is persistently failing)")
        m_topk = registry.histogram(
            "llm_ann_topk_step_seconds",
            "Device top-k program step latency")
        self.programs = TopKPrograms(
            catalog=programstats, runtime_stats=runtime_stats,
            step_observer=m_topk.observe)
        self.knobs = normalize_ann({"enabled": True})
        self._indexes: Dict[str, AnnIndex] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closed = False

    # -- configuration -------------------------------------------------------

    def configure(self, knobs: Dict) -> None:
        """Apply a normalized ``ann`` block: hot-flip every index and
        (re)arm the maintenance thread.  An enabled ``mesh`` is refused
        at load; here it raises too."""
        if knobs["mesh"]["enabled"]:
            raise ValueError("ann.mesh: the sharded bank is not served by "
                             "this port yet")
        with self._lock:
            self.knobs = dict(knobs)
            indexes = list(self._indexes.values())
        for index in indexes:
            index.reconfigure(knobs)
        self._ensure_thread()

    def index(self, name: str) -> AnnIndex:
        with self._lock:
            idx = self._indexes.get(name)
            if idx is None:
                idx = AnnIndex(name, self.knobs, self.programs,
                               metrics=self, device=self.device)
                self._indexes[name] = idx
        self._ensure_thread()
        return idx

    def bind_cache_sync(self, stateplane) -> AnnIndex:
        """Attach (or rebind) the semantic-cache index to a state
        plane's cache keyspace — idempotent per plane."""
        idx = self.index("cache")
        if idx.sync is None or idx.sync.plane is not stateplane:
            old, idx.sync = idx.sync, cache_index_sync(
                stateplane, idx,
                interval_s=self.knobs["sync_interval_s"])
            if old is not None:  # unhook the superseded sync's
                old.close()      # recovery callback (no accumulation)
        return idx

    # -- maintenance thread --------------------------------------------------

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._closed or not self._indexes:
                return
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="ann-maintain", daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.maintain_once()
            except Exception as exc:
                # maintenance must never die — but it must not fail
                # invisibly either: stamp the counter + event so a
                # persistently crashing cycle shows up on the dashboard
                # instead of silently serving an ever-staler view
                self._note_maintenance_failure("_plane", exc)
            with self._lock:
                interval = self.knobs["compact_interval_s"]
            self._stop.wait(interval)

    def _note_maintenance_failure(self, index: str,
                                  exc: Exception) -> None:
        try:
            self.m_maint_failures.inc(1.0, index=index)
            component_event("ann", "maintenance_failed", level="error",
                            index=index, error=f"{type(exc).__name__}: "
                                               f"{exc}")
        except Exception:
            pass  # observability never takes the maintenance loop down

    def maintain_once(self) -> Dict[str, Dict[str, int]]:
        """One maintenance pass over every index (also the test/bench
        entry point for deterministic cycles).  A crashing index stamps
        the failure counter and does NOT starve the other indexes'
        compaction/promotion/sync."""
        with self._lock:
            indexes = dict(self._indexes)
        out = {}
        fallback = 0.0
        for name, idx in indexes.items():
            try:
                out[name] = idx.maintain()  # stamps per-index gauges
            except Exception as exc:
                self._note_maintenance_failure(name, exc)
                out[name] = {"failed": 1}
            if idx.sync is not None and idx.sync.local_only:
                fallback = 1.0
        self.m_fallback.set(fallback)
        return out

    # -- reporting / lifecycle -----------------------------------------------

    def report(self) -> Dict[str, object]:
        with self._lock:
            indexes = dict(self._indexes)
            knobs = dict(self.knobs)
        return {
            "enabled": knobs["enabled"],
            "quant": knobs["quant"],
            "mesh": None,
            "device": str(self.device),
            "indexes": {n: i.report() for n, i in indexes.items()},
        }

    def close(self) -> None:
        with self._lock:
            self._closed = True
            thread = self._thread
            self._thread = None
            indexes = list(self._indexes.values())
        self._stop.set()
        if thread is not None:
            thread.join(timeout=5.0)
        for idx in indexes:
            idx.close()
        self.programs.purge()
