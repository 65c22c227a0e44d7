"""Batched top-k scoring programs.

The port's copy of ``semantic_router_tpu.ann.search``.  One lookup is
``top_k(Q @ bank_t, k)`` over a view on the bank's device: a torch
product and a top-k, not a kernel of this repo (the reference runs it
outside any Pallas kernel too).  Query batches pad to pow2 rows and k
pads to pow2, so the program cache is closed over ``(tier, q_rows, k,
mode)``; each fresh key registers with the program-cost catalog (group
``ann``) and every step is recorded in runtimestats, as the engine's
steps are.

Scores come out in float32 in every mode.  bf16 rounds the query and
the bank to bf16 and int8 rounds the query to bf16 against the int8
bank (exact in bf16) times its per-row scale, as the reference's
``preferred_element_type=float32`` programs do: on the card a bf16 GEMM
with float32 output (``torch.mm(..., out_dtype=torch.float32)``); on the
CPU the rounded operands upcast, in column chunks.  The products are
exact either way.  Equal scores rank the lower slot first, as
``lax.top_k`` does, also where a tie straddles the k-th place.

Query batching rides the engine's ``DynamicBatcher``: concurrent probes
coalesce into one step, and the runner resolves the bank view once per
batch, so every rider finishes on one consistent snapshot.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..engine.batcher import DynamicBatcher
from .bank import _DeviceView, normalize_rows

MAX_QUERY_BATCH = 64
# bank columns upcast (or int8 → bf16 converted) at a time
CHUNK_COLS = 1 << 17


def _pow2(n: int, cap: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return min(p, cap)


def _f32_product(q: torch.Tensor, bank_t: torch.Tensor) -> torch.Tensor:
    """``q [qb, D] bf16 @ bank_t [D, tier] (bf16 | int8)`` with float32
    products and accumulation, returned in float32."""
    if q.device.type == "cuda" and bank_t.dtype == torch.bfloat16:
        return torch.mm(q, bank_t, out_dtype=torch.float32)
    tier = bank_t.shape[1]
    out = torch.empty((q.shape[0], tier), dtype=torch.float32,
                      device=q.device)
    for s in range(0, tier, CHUNK_COLS):
        cols = bank_t[:, s:s + CHUNK_COLS]
        if q.device.type == "cuda":
            out[:, s:s + cols.shape[1]] = torch.mm(
                q, cols.to(torch.bfloat16), out_dtype=torch.float32)
        else:
            out[:, s:s + cols.shape[1]] = q.float() @ cols.float()
    return out


def score(view: _DeviceView, q: torch.Tensor) -> torch.Tensor:
    """Float32 scores ``[qb, tier]`` of the queries ``q [qb, D]`` (f32,
    on the view's device) in the view's mode; invalid slots are -inf."""
    if view.mode == "int8":
        scores = _f32_product(q.to(torch.bfloat16), view.qbank) * view.scale
    elif view.mode == "bf16":
        scores = _f32_product(q.to(torch.bfloat16), view.bank_t)
    else:
        scores = q @ view.bank_t
    return scores.masked_fill_(~view.valid, float("-inf"))


def _by_score_then_slot(vals: torch.Tensor, idx: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    order = torch.argsort(idx, dim=1)
    idx, vals = idx.gather(1, order), vals.gather(1, order)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return vals.gather(1, order), idx.gather(1, order)


def topk_candidates(scores: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``top_k`` of each row, equal scores ranked by the lower index
    first (``torch.topk`` promises no order), with no host sync: (vals,
    idx, straddle), where ``straddle`` marks the rows whose k-th score
    ties a score left out; ``reselect_ties`` fixes those rows."""
    vals, idx = torch.topk(scores, k, dim=1)
    thr = vals[:, -1:]
    straddle = ((scores == thr).sum(1) > (vals == thr).sum(1)) \
        & torch.isfinite(thr[:, 0])
    return _by_score_then_slot(vals, idx) + (straddle,)


def reselect_ties(scores: torch.Tensor, vals: torch.Tensor,
                  idx: torch.Tensor, rows: List[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selections of ``rows`` rebuilt with the lower slots among the
    scores tied at the k-th place, as ``lax.top_k`` keeps them (rare:
    exact duplicates)."""
    k = idx.shape[1]
    vals, idx = vals.clone(), idx.clone()
    for r in rows:
        row, t = scores[r], vals[r, -1]
        above = (row > t).nonzero().flatten()
        tied = (row == t).nonzero().flatten()[:k - above.numel()]
        pick = torch.cat([above, tied])
        idx[r] = pick
        vals[r] = row[pick]
    return _by_score_then_slot(vals, idx)


class _TopKCost:
    """A step's count for the program catalog, in closed form: the
    product's flops and the bytes the step must move (the bank once, the
    queries, the k scores and slots)."""

    def __init__(self, view: _DeviceView, qb: int, k: int) -> None:
        self.flops = 2.0 * qb * view.dim * view.tier
        self.bytes_accessed = float(view.nbytes() + qb * view.dim * 4
                                    + qb * k * 12)
        self.kernels: Dict[str, Dict[str, float]] = {}


class TopKPrograms:
    """Program cache keyed on the closed shape set; owns the census hooks
    (the catalog's ``note_compile`` and runtimestats' ``record_step``)."""

    def __init__(self, catalog=None, runtime_stats=None,
                 step_observer: Optional[Callable[[float], None]] = None
                 ) -> None:
        self.catalog = catalog
        self.runtime_stats = runtime_stats
        self.step_observer = step_observer
        self._programs: Dict[Tuple, Callable] = {}
        self._lock = threading.Lock()

    def _build(self, key: Tuple, view: _DeviceView, qb: int,
               k: int) -> Callable:
        def score_topk(v: _DeviceView, q: torch.Tensor):
            scores = score(v, q)
            return (scores,) + topk_candidates(scores, k)

        if self.catalog is not None:
            tier, _qb, _k, mode = key
            try:
                self.catalog.note_compile(
                    "ann", tier, f"topk:q{qb}:k{k}:{mode}",
                    (qb, view.dim), _TopKCost(view, qb, k),
                    quant=mode if mode != "f32" else "off",
                    argument_bytes=view.nbytes() + qb * view.dim * 4,
                    output_bytes=qb * k * 12)
            except Exception:
                pass  # the census is observability, never the lookup path
        return score_topk

    def program(self, view: _DeviceView, nq: int, k: int
                ) -> Tuple[Callable, int, int, bool]:
        """(program, padded query rows, padded k, freshly built) for
        ``nq`` queries at ``k`` against ``view``.  A program enqueues its
        step with no host sync and returns device tensors: (scores,
        vals, slots, straddle) — ``run`` reads them back."""
        qb = _pow2(nq, MAX_QUERY_BATCH) if nq <= MAX_QUERY_BATCH \
            else nq  # oversize batches run unpadded
        kk = min(_pow2(k, view.tier), view.tier)
        key = (view.tier, qb, kk, view.mode)
        with self._lock:
            fn = self._programs.get(key)
            built = fn is None
            if fn is None:
                fn = self._build(key, view, qb, kk)
                self._programs[key] = fn
        return fn, qb, kk, built

    def run(self, view: _DeviceView, queries: np.ndarray, k: int
            ) -> Tuple[np.ndarray, np.ndarray]:
        """Score ``queries [nq, D]`` against the view; returns (scores
        [nq, k'], slot indices [nq, k']) with k' = min(k, tier), the
        padded query rows sliced off."""
        nq = queries.shape[0]
        fn, qb, kk, built = self.program(view, nq, k)
        qpad = np.zeros((qb, view.dim), np.float32)
        qpad[:nq] = queries
        t0 = time.perf_counter()
        full, vals, idx, straddle = fn(
            view, torch.from_numpy(qpad).to(view.device))
        # the readback ends the step: the view stays referenced until here
        rows = np.nonzero(straddle[:nq].cpu().numpy())[0].tolist()
        if rows:
            vals, idx = reselect_ties(full, vals, idx, rows)
        scores = vals[:nq, :k].cpu().numpy()
        idx = idx[:nq, :k].cpu().numpy()
        dt = time.perf_counter() - t0
        if self.runtime_stats is not None:
            try:
                self.runtime_stats.record_step(
                    "ann", view.tier, f"topk:q{qb}:k{kk}:{view.mode}",
                    rows=nq, padded_rows=qb, seconds=dt, compiled=built)
            except Exception:
                pass
        if self.step_observer is not None:
            try:
                self.step_observer(dt)
            except Exception:
                pass
        return scores, idx

    def purge(self) -> None:
        with self._lock:
            self._programs.clear()


class AnnSearcher:
    """Lookup front end: direct steps, or coalesced through a
    ``DynamicBatcher`` when ``ann.batch.enabled`` (concurrent probes then
    share one top-k step)."""

    def __init__(self, view_provider: Callable[[], Optional[_DeviceView]],
                 programs: TopKPrograms, name: str = "ann") -> None:
        self.view_provider = view_provider
        self.programs = programs
        self.name = name
        self._batcher: Optional[DynamicBatcher] = None
        self._lock = threading.Lock()

    def configure_batching(self, knobs: Dict) -> None:
        with self._lock:
            old, self._batcher = self._batcher, None
            if knobs.get("enabled"):
                self._batcher = DynamicBatcher(
                    self._run_batch,
                    max_batch_size=int(knobs["max_batch"]),
                    max_wait_ms=float(knobs["max_wait_ms"]),
                    name=f"{self.name}-lookup", dispatch_workers=1)
        if old is not None:
            old.shutdown(timeout=2.0)

    def _run_batch(self, group_key, items):
        k = int(group_key)
        view = self.view_provider()  # ONE snapshot for the whole batch
        if view is None:
            return [([], []) for _ in items]
        queries = np.stack([normalize_rows(i.payload)[0]
                            for i in items])
        scores, idx = self.programs.run(view, queries, k)
        return [self._resolve(view, scores[i], idx[i])
                for i in range(len(items))]

    @staticmethod
    def _resolve(view: _DeviceView, scores: np.ndarray,
                 idx: np.ndarray) -> Tuple[List[str], List[float]]:
        ids: List[str] = []
        out_scores: List[float] = []
        for s, slot in zip(scores, idx):
            if not np.isfinite(s):
                continue  # -inf = tombstone / pad slot
            entry_id = view.ids[slot] if slot < len(view.ids) else None
            if entry_id is None:
                continue
            ids.append(entry_id)
            out_scores.append(float(s))
        return ids, out_scores

    def search(self, query: np.ndarray, k: int
               ) -> Tuple[List[str], List[float]]:
        """Top-k (ids, scores) over the device bank; empty while no view
        is published."""
        with self._lock:
            batcher = self._batcher
        if batcher is not None:
            try:
                return batcher.submit(
                    k, np.asarray(query)).result(timeout=30)
            except Exception:
                # a stalled dispatch worker or a step that failed: a
                # missed lookup degrades to a cache miss up the probe
                # path, never an error
                return [], []
        view = self.view_provider()
        if view is None:
            return [], []
        q = normalize_rows(query)
        scores, idx = self.programs.run(view, q, k)
        return self._resolve(view, scores[0], idx[0])

    def close(self) -> None:
        with self._lock:
            batcher, self._batcher = self._batcher, None
        if batcher is not None:
            batcher.shutdown(timeout=2.0)
