"""In-process HNSW approximate-nearest-neighbor index.

The port's own copy of ``semantic_router_tpu.cache.hnsw``: the same
seeded ``random.Random`` level draw, so the same inserts give the same
graph and the same answers.  Distances are numpy BLAS dots over
normalized vectors.

Standard HNSW (Malkov & Yashunin): exponentially-decaying layer assignment,
greedy descent on upper layers, beam search (ef) on layer 0, bidirectional
links pruned to M per node.
"""

from __future__ import annotations

import math
import random
import threading
from typing import Dict, List, Optional, Set, Tuple

import numpy as np


class HNSWIndex:
    def __init__(self, dim: int, m: int = 16, ef_construction: int = 200,
                 ef_search: int = 50, seed: int = 0) -> None:
        self.dim = dim
        self.m = m
        self.m0 = 2 * m
        self.ef_construction = ef_construction
        self.ef_search = ef_search
        self._ml = 1.0 / math.log(m)
        self._rng = random.Random(seed)
        self._vectors: List[np.ndarray] = []
        self._ids: List[int] = []  # external ids
        self._levels: List[int] = []
        self._links: List[List[Dict[int, None]]] = []  # node → level → neighbor set
        self._entry: Optional[int] = None
        self._max_level = -1
        self._deleted: Set[int] = set()
        self._lock = threading.RLock()

    def __len__(self) -> int:
        return len(self._vectors) - len(self._deleted)

    # -- distance ----------------------------------------------------------

    def _prep(self, v: np.ndarray) -> np.ndarray:
        v = np.asarray(v, dtype=np.float32)
        n = np.linalg.norm(v)
        return v / n if n > 0 else v

    def _dist(self, a: np.ndarray, b: np.ndarray) -> float:
        return 1.0 - float(a @ b)  # normalized → cosine distance

    def _dists(self, q: np.ndarray, nodes: List[int]) -> np.ndarray:
        mat = np.stack([self._vectors[i] for i in nodes])
        return 1.0 - mat @ q

    # -- insert ------------------------------------------------------------

    def add(self, external_id: int, vector: np.ndarray) -> None:
        with self._lock:
            q = self._prep(vector)
            node = len(self._vectors)
            level = int(-math.log(max(self._rng.random(), 1e-12)) * self._ml)
            self._vectors.append(q)
            self._ids.append(external_id)
            self._levels.append(level)
            self._links.append([dict() for _ in range(level + 1)])

            if self._entry is None:
                self._entry = node
                self._max_level = level
                return

            ep = self._entry
            # greedy descent above the new node's level
            for lvl in range(self._max_level, level, -1):
                ep = self._greedy(q, ep, lvl)
            # beam insert at each level ≤ min(level, max_level)
            for lvl in range(min(level, self._max_level), -1, -1):
                cands = self._search_layer(q, [ep], lvl, self.ef_construction)
                m_max = self.m0 if lvl == 0 else self.m
                selected = self._select(q, [c for _, c in cands], m_max)
                for nb in selected:
                    self._links[node][lvl][nb] = None
                    self._links[nb][lvl][node] = None
                    if len(self._links[nb][lvl]) > m_max:
                        self._shrink(nb, lvl, m_max)
                if cands:
                    ep = cands[0][1]
            if level > self._max_level:
                self._max_level = level
                self._entry = node

    def _shrink(self, node: int, lvl: int, m_max: int) -> None:
        nbrs = list(self._links[node][lvl])
        d = self._dists(self._vectors[node], nbrs)
        keep = [nbrs[i] for i in np.argsort(d)[:m_max]]
        self._links[node][lvl] = dict.fromkeys(keep)

    def _select(self, q: np.ndarray, cands: List[int], m: int) -> List[int]:
        if len(cands) <= m:
            return cands
        d = self._dists(q, cands)
        return [cands[i] for i in np.argsort(d)[:m]]

    def _greedy(self, q: np.ndarray, ep: int, lvl: int) -> int:
        cur = ep
        cur_d = self._dist(q, self._vectors[cur])
        improved = True
        while improved:
            improved = False
            nbrs = list(self._links[cur][lvl]) if lvl < len(self._links[cur]) else []
            if not nbrs:
                break
            d = self._dists(q, nbrs)
            best = int(np.argmin(d))
            if d[best] < cur_d:
                cur, cur_d = nbrs[best], float(d[best])
                improved = True
        return cur

    def _search_layer(self, q: np.ndarray, eps: List[int], lvl: int,
                      ef: int) -> List[Tuple[float, int]]:
        """Beam search; returns [(dist, node)] sorted ascending."""
        import heapq

        visited = set(eps)
        cand_heap = []  # min-heap by dist
        result = []     # max-heap via negative dist
        for ep in eps:
            d = self._dist(q, self._vectors[ep])
            heapq.heappush(cand_heap, (d, ep))
            heapq.heappush(result, (-d, ep))
        while cand_heap:
            d, c = heapq.heappop(cand_heap)
            worst = -result[0][0]
            if d > worst and len(result) >= ef:
                break
            nbrs = [n for n in (self._links[c][lvl]
                                if lvl < len(self._links[c]) else ())
                    if n not in visited]
            visited.update(nbrs)
            if not nbrs:
                continue
            dists = self._dists(q, nbrs)
            for nd, nb in zip(dists, nbrs):
                nd = float(nd)
                if len(result) < ef or nd < -result[0][0]:
                    heapq.heappush(cand_heap, (nd, nb))
                    heapq.heappush(result, (-nd, nb))
                    if len(result) > ef:
                        heapq.heappop(result)
        out = sorted([(-nd, nb) for nd, nb in result])
        return out

    # -- search ------------------------------------------------------------

    def search(self, vector: np.ndarray, k: int = 5,
               ef: Optional[int] = None) -> List[Tuple[int, float]]:
        """Top-k [(external_id, similarity)] by cosine/dot, best first."""
        with self._lock:
            if self._entry is None or len(self) == 0:
                return []
            q = self._prep(vector)
            ep = self._entry
            for lvl in range(self._max_level, 0, -1):
                ep = self._greedy(q, ep, lvl)
            cands = self._search_layer(q, [ep], 0,
                                       max(ef or self.ef_search, k))
            out = []
            for d, node in cands:
                if node in self._deleted:
                    continue
                out.append((self._ids[node], 1.0 - d))
                if len(out) >= k:
                    break
            return out

    def remove(self, external_id: int) -> None:
        """Soft delete (links remain as routing waypoints — the standard
        HNSW deletion strategy)."""
        with self._lock:
            for node, ext in enumerate(self._ids):
                if ext == external_id:
                    self._deleted.add(node)
