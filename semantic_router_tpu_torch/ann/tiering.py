"""Host-RAM overflow tier + the compaction/promotion policy.

The port's copy of ``semantic_router_tpu.ann.tiering`` (host code only).

Every add lands in the host tier first (exact numpy scan — immediately
visible, no device placement on the write path); the maintenance cycle
(the AnnPlane's single bootstrap-owned thread) then:

1. promotes hot entries — EWMA hit rate over maintenance cycles — into
   the device bank's free slots and republishes the view;
2. LRU-evicts cold device entries back to host when the bank crosses
   its fill watermark at the max capacity tier;
3. rewrites the device bank when tombstones (deletes) pass the
   configured ratio — delete is tombstone-now, reclaim-at-compaction,
   so the serving view's slot map stays frozen between publishes.

Lookups merge device top-k with the host scan, so tiering is a
performance policy, never a correctness cliff: an entry is findable
the moment it is added, wherever it lives.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .bank import DeviceBank, normalize_rows


class HostTier:
    """Exact overflow store: dict of id → normalized vector with a
    cached scan matrix (invalidated on mutation, rebuilt lazily)."""

    def __init__(self) -> None:
        self._entries: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()
        self._matrix: Optional[np.ndarray] = None
        self._matrix_ids: List[str] = []

    def add(self, entry_id: str, vec: np.ndarray) -> None:
        row = normalize_rows(vec)[0]
        with self._lock:
            self._entries[entry_id] = row
            self._matrix = None

    def extend(self, ids: List[str], vecs: np.ndarray) -> None:
        """Bulk insert (ingest/bench path): one normalize for the
        whole block instead of per-row add() calls."""
        rows = normalize_rows(vecs)
        with self._lock:
            for i, entry_id in enumerate(ids):
                self._entries[entry_id] = rows[i]
            self._matrix = None

    def delete(self, entry_id: str) -> bool:
        with self._lock:
            if self._entries.pop(entry_id, None) is None:
                return False
            self._matrix = None
            return True

    def pop(self, entry_id: str) -> Optional[np.ndarray]:
        with self._lock:
            vec = self._entries.pop(entry_id, None)
            if vec is not None:
                self._matrix = None
            return vec

    def get(self, entry_id: str) -> Optional[np.ndarray]:
        with self._lock:
            return self._entries.get(entry_id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, entry_id: str) -> bool:
        with self._lock:
            return entry_id in self._entries

    def ids(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def scan(self, query: np.ndarray, k: int
             ) -> Tuple[List[str], List[float]]:
        """Exact brute-force cosine top-k over the host tier."""
        with self._lock:
            if self._matrix is None and self._entries:
                self._matrix_ids = list(self._entries)
                self._matrix = np.stack(
                    [self._entries[i] for i in self._matrix_ids])
            matrix, ids = self._matrix, self._matrix_ids
        if matrix is None or not ids:
            return [], []
        q = normalize_rows(query)[0]
        scores = matrix @ q
        k = min(k, len(ids))
        top = np.argpartition(-scores, k - 1)[:k]
        top = top[np.argsort(-scores[top])]
        return [ids[i] for i in top], [float(scores[i]) for i in top]


class TierPolicy:
    """EWMA hit tracking + the promotion/eviction/compaction decisions
    for one (bank, host tier) pair.  ``run_cycle`` is the maintenance
    entry point — called off the lookup path, on the plane thread."""

    def __init__(self, bank: DeviceBank, host: HostTier,
                 promote_ewma: float = 0.2,
                 promote_min_hits: float = 0.0,
                 evict_watermark: float = 0.9,
                 tombstone_ratio: float = 0.25) -> None:
        self.bank = bank
        self.host = host
        self.promote_ewma = float(promote_ewma)
        self.promote_min_hits = float(promote_min_hits)
        self.evict_watermark = float(evict_watermark)
        self.tombstone_ratio = float(tombstone_ratio)
        self._ewma: Dict[str, float] = {}
        self._hits: Dict[str, int] = {}  # hits since last cycle
        self._lock = threading.Lock()

    # -- hit tracking (lookup path: one dict bump) --------------------------

    def mark_hits(self, entry_ids: List[str]) -> None:
        with self._lock:
            for entry_id in entry_ids:
                self._hits[entry_id] = self._hits.get(entry_id, 0) + 1

    def forget(self, entry_id: str) -> None:
        with self._lock:
            self._ewma.pop(entry_id, None)
            self._hits.pop(entry_id, None)

    def _roll_ewma(self) -> Dict[str, float]:
        """Fold the per-cycle hit counts into the EWMA rates."""
        with self._lock:
            hits, self._hits = self._hits, {}
            a = self.promote_ewma
            for entry_id in set(self._ewma) | set(hits):
                prev = self._ewma.get(entry_id, 0.0)
                self._ewma[entry_id] = (1 - a) * prev \
                    + a * hits.get(entry_id, 0)
            # drop entries that have fully cooled (bounded state)
            cold = [i for i, e in self._ewma.items() if e < 1e-6]
            for i in cold:
                del self._ewma[i]
            return dict(self._ewma)

    # -- the cycle -----------------------------------------------------------

    def run_cycle(self) -> Dict[str, int]:
        """One maintenance pass; returns counts for the metric bumps."""
        ewma = self._roll_ewma()
        promoted = self._promote(ewma)
        evicted = self._evict(ewma)
        compacted = 0
        # compact on the ratio, but ALSO whenever delete + promote
        # churn left more allocated slots than the max capacity tier
        # can hold — publish() would otherwise have to reclaim inline
        if self.bank.tombstone_ratio() >= self.tombstone_ratio \
                or self.bank.used_slots() > self.bank.max_capacity:
            compacted = self.bank.compact()
        published = 0
        if self.bank.dirty():
            self.bank.publish()
            published = 1
        return {"promoted": promoted, "evicted": evicted,
                "compacted": compacted, "published": published}

    def _promote(self, ewma: Dict[str, float]) -> int:
        """Hot host entries move into the device bank, hottest first.
        Entries below ``promote_min_hits`` EWMA stay host-side; a bank
        at max capacity refuses and the overflow simply stays exact."""
        host_ids = set(self.host.ids())
        if not host_ids:
            return 0
        ranked = sorted(
            (i for i in host_ids
             if ewma.get(i, 0.0) >= self.promote_min_hits),
            key=lambda i: ewma.get(i, 0.0), reverse=True)
        promoted = 0
        for entry_id in ranked:
            vec = self.host.get(entry_id)
            if vec is None:
                continue
            if not self.bank.add(entry_id, vec):
                break  # max tier full — eviction may free room later
            self.host.pop(entry_id)
            promoted += 1
        return promoted

    def _evict(self, ewma: Dict[str, float]) -> int:
        """Past the fill watermark at the MAX tier, the coldest device
        entries (lowest EWMA — LRU under a decaying rate) move back to
        the host tier: device capacity stays bounded, the entries stay
        findable via the exact scan."""
        n = len(self.bank)
        cap = self.bank.max_capacity
        if n < self.evict_watermark * cap:
            return 0
        target = max(1, n - int(self.evict_watermark * cap))
        device_ids = self.bank.entry_ids()
        coldest = sorted(device_ids,
                         key=lambda i: ewma.get(i, 0.0))[:target]
        evicted = 0
        for entry_id in coldest:
            vec = self.bank.get_vector(entry_id)
            if vec is None:
                continue
            self.host.add(entry_id, vec)
            self.bank.delete(entry_id)
            evicted += 1
        return evicted
