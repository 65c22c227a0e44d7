"""Consistent-hash ring over the live replica set.

The port's copy of ``semantic_router_tpu.stateplane.ring``: the same
hash, points and owners, so a mixed fleet agrees on every key.

Affinity, not partitioning: cache entries and decision records are
SHARED through the plane, but the per-process hot state that cannot be
shared cheaply — EncodingCache rows, fused-bank classify memos, captured
step graphs — only pays off when the same prompt keeps landing on the same
replica.  The ring gives every replica (and any affinity-aware LB in
front of the fleet) the same deterministic key→replica map, and keeps
reassignment minimal when membership changes: joining or losing one of
N replicas moves ~1/N of the keyspace, not all of it.

Standard construction: each member hashes onto the ring at ``vnodes``
points (blake2b over ``member#i``); a key maps to the first member
clockwise from its own hash.  Pure stdlib, deterministic across
processes and Python runs (no PYTHONHASHSEED dependence).
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple


def _h(data: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(data.encode(), digest_size=8).digest(), "big")


class HashRing:
    def __init__(self, members: Sequence[str] = (),
                 vnodes: int = 64) -> None:
        self.vnodes = max(1, int(vnodes))
        self._points: List[Tuple[int, str]] = []
        self._hashes: List[int] = []
        self._members: List[str] = []
        self.rebuild(members)

    def rebuild(self, members: Sequence[str]) -> None:
        members = sorted(set(members))
        points: List[Tuple[int, str]] = []
        for m in members:
            for i in range(self.vnodes):
                points.append((_h(f"{m}#{i}"), m))
        points.sort()
        self._points = points
        self._hashes = [p[0] for p in points]
        self._members = members

    def members(self) -> List[str]:
        return list(self._members)

    def __len__(self) -> int:
        return len(self._members)

    def node_for(self, key: str) -> Optional[str]:
        if not self._points:
            return None
        i = bisect.bisect_right(self._hashes, _h(key))
        if i == len(self._points):
            i = 0
        return self._points[i][1]

    def distribution(self, sample: int = 4096) -> Dict[str, float]:
        """Fraction of a uniform key sample owned per member — the
        /debug/stateplane balance view (and the ring's own test)."""
        if not self._members:
            return {}
        counts: Dict[str, int] = {m: 0 for m in self._members}
        for i in range(sample):
            counts[self.node_for(f"sample:{i}")] += 1
        return {m: round(c / sample, 4) for m, c in counts.items()}
