"""Device-resident embedding bank.

The port's copy of ``semantic_router_tpu.ann.bank``, on one device.  The
host owns the authoritative float32 ``[N, D]`` store (with the id ↔ slot
maps and the tombstone mask); the device serves an immutable *view* of
it: the bank as ``[D, tier]`` (a transposed view of its rows, so a
batched lookup is one ``Q @ bank_t``), in float32 or bfloat16, or int8
with a per-row scale,
and a ``valid`` mask.  Capacities round up to a pow2 *tier*, so a growing
bank walks a small ladder of shapes.

``publish()`` builds a fresh ``_DeviceView`` off the lock and swaps one
reference: lookups in flight keep the view they read (its tensors stay
alive while they hold it), and no tensor a published view holds is ever
written again.  A quantized view must clear a calibrated recall@10 gate
against the float32 reference before it publishes; a bank whose geometry
quantizes badly falls back to f32 and says so (``quant_fallback``).

The reference's row sharding over a device mesh (``ann.mesh``) is not
served by this port; the config refuses it at load.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

MIN_TIER = 16


def tier_for(n: int, min_capacity: int, max_capacity: int) -> int:
    """Smallest pow2 capacity tier holding ``n`` rows (clamped)."""
    t = max(int(min_capacity), MIN_TIER)
    while t < n and t < max_capacity:
        t <<= 1
    return min(t, int(max_capacity))


def normalize_rows(vecs: np.ndarray) -> np.ndarray:
    """L2-normalize rows so scores are cosine similarities."""
    vecs = np.asarray(vecs, dtype=np.float32)
    if vecs.ndim == 1:
        vecs = vecs[None, :]
    norms = np.linalg.norm(vecs, axis=-1, keepdims=True)
    return vecs / np.maximum(norms, 1e-12)


class _DeviceView:
    """Immutable placed snapshot: everything a lookup needs, so a hot
    capacity or quant flip never mutates what a lookup in flight reads.
    ``ids`` maps device slot → entry id (a host tuple)."""

    __slots__ = ("tier", "dim", "mode", "device", "ids", "bank_t", "qbank",
                 "scale", "valid", "n_valid", "version", "recall",
                 "quant_fallback")

    def __init__(self, tier: int, dim: int, mode: str, device, ids,
                 bank_t, qbank, scale, valid, n_valid: int, version: int,
                 recall: float, quant_fallback: bool) -> None:
        self.tier = tier
        self.dim = dim
        self.mode = mode
        self.device = device
        self.ids = ids
        # [D, tier] views of [tier, D] rows
        self.bank_t = bank_t      # f32 / bf16 (None in int8 mode)
        self.qbank = qbank        # int8 (int8 mode only)
        self.scale = scale        # [tier] f32 per-row scale (int8 only)
        self.valid = valid        # [tier] bool: False = tombstone / pad
        self.n_valid = n_valid
        self.version = version
        self.recall = recall
        self.quant_fallback = quant_fallback

    def nbytes(self) -> int:
        """Bytes the view holds on its device."""
        return sum(t.numel() * t.element_size()
                   for t in (self.bank_t, self.qbank, self.scale, self.valid)
                   if t is not None)


def _int8_levels(bank: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 levels over the embedding axis, still in
    float32: (levels [N, D], scale f32 [N]), rounded half to even as the
    reference's numpy is."""
    absmax = bank.abs().amax(dim=1)
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    return torch.clamp(torch.round(bank / scale[:, None]), -127, 127), scale


def quantize_rows(bank: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 over the embedding axis: (q int8 [N, D],
    scale f32 [N])."""
    levels, scale = _int8_levels(bank)
    return levels.to(torch.int8), scale


def _emulate_int8_scores(q: np.ndarray, bank: np.ndarray) -> np.ndarray:
    """Host oracle of the int8 program (per-row symmetric over the
    embedding axis): the calibration gate's, never the lookup path's.
    The rows quantize through torch on the CPU (threaded; the same IEEE
    values as numpy's), the product is numpy's."""
    qb, scale = _int8_levels(torch.from_numpy(
        np.ascontiguousarray(bank, np.float32)))
    return (q @ qb.numpy().T) * scale.numpy()[None, :]


def _emulate_bf16_scores(q: np.ndarray, bank: np.ndarray) -> np.ndarray:
    """Host oracle of the bf16 program: both operands rounded to bf16
    (to nearest even), products accumulated in float32."""
    qb = torch.from_numpy(np.ascontiguousarray(bank, np.float32)) \
        .to(torch.bfloat16).float()
    qq = torch.from_numpy(np.ascontiguousarray(q, np.float32)) \
        .to(torch.bfloat16).float()
    return (qq @ qb.T).numpy()


def _top_sets(scores: np.ndarray, k: int) -> np.ndarray:
    """The slots ``np.argsort(-scores, axis=1)[:, :k]`` selects, as sets
    (row order aside): a partition, and the full sort only for a row
    whose k-th score ties a score left out."""
    part = np.argpartition(-scores, k - 1, axis=1)[:, :k]
    sel = np.take_along_axis(scores, part, 1)
    kth = sel.min(axis=1, keepdims=True)
    ties = (scores == kth).sum(1) > (sel == kth).sum(1)
    for r in np.nonzero(ties)[0]:
        part[r] = np.argsort(-scores[r])[:k]
    return part


def measure_recall(bank: np.ndarray, mode: str, k: int = 10,
                   n_queries: int = 64, seed: int = 0) -> float:
    """Calibrated recall@k of the quantized scoring path against the
    float32 brute-force reference, probed with perturbed bank rows (the
    queries a semantic cache sees: near-duplicates of stored entries)."""
    n = bank.shape[0]
    if n == 0 or mode == "f32":
        return 1.0
    k = min(k, n)
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=min(n_queries, n), replace=False)
    queries = normalize_rows(
        bank[idx] + 0.05 * rng.standard_normal((len(idx),
                                                bank.shape[1])))
    ref = _top_sets(queries @ bank.T, k)
    if mode == "int8":
        approx_scores = _emulate_int8_scores(queries, bank)
    else:
        approx_scores = _emulate_bf16_scores(queries, bank)
    approx = _top_sets(approx_scores, k)
    hits = sum(len(set(r) & set(a)) for r, a in zip(ref, approx))
    return hits / float(ref.size)


def place_view(dense: np.ndarray, valid_host: np.ndarray, ids: tuple,
               tier: int, mode: str, device: torch.device,
               version: int = 0, recall: float = 1.0,
               quant_fallback: bool = False) -> _DeviceView:
    """The rows ``dense [n, D]`` (and their validity) padded to ``tier``
    and placed on ``device`` in ``mode``: fresh tensors, rows contiguous;
    ``bank_t`` / ``qbank`` are their ``[D, tier]`` transposed views (the
    products read the rows as they lie, with no transposed copy)."""
    n, dim = dense.shape
    rows = torch.zeros((tier, dim), dtype=torch.float32, device=device)
    if n:
        rows[:n] = torch.from_numpy(np.ascontiguousarray(dense)).to(device)
    valid = torch.zeros(tier, dtype=torch.bool, device=device)
    if n:
        valid[:n] = torch.from_numpy(np.ascontiguousarray(valid_host)) \
            .to(device)
    bank_t = qbank = scale = None
    if mode == "int8":
        q, scale = quantize_rows(rows)
        qbank = q.t()
    elif mode == "bf16":
        bank_t = rows.to(torch.bfloat16).t()
    else:
        bank_t = rows.t()
    return _DeviceView(tier, dim, mode, device, ids, bank_t, qbank, scale,
                       valid, int(valid_host.sum()), version, recall,
                       quant_fallback)


class DeviceBank:
    """Fixed-capacity device bank over a host-authoritative store."""

    def __init__(self, dim: int = 0, min_capacity: int = 1024,
                 max_capacity: int = 1 << 20, mode: str = "f32",
                 recall_floor: float = 0.99,
                 calibration_queries: int = 64,
                 name: str = "bank", device: DeviceLike = None) -> None:
        self.name = name
        self.device = resolve_device(device)
        self.dim = int(dim)
        self.min_capacity = int(min_capacity)
        self.max_capacity = int(max_capacity)
        self.mode = mode
        self.recall_floor = float(recall_floor)
        self.calibration_queries = int(calibration_queries)
        self._lock = threading.Lock()
        self._vecs: Optional[np.ndarray] = None   # [alloc, D] f32
        self._valid: Optional[np.ndarray] = None  # [alloc] bool
        self._ids: List[Optional[str]] = []       # slot → id
        self._id2slot: Dict[str, int] = {}
        self._used = 0        # rows allocated (valid + tombstoned)
        self._tombstones = 0
        self._dirty = False
        self._version = 0
        self._view: Optional[_DeviceView] = None

    # -- host-side mutation (callers publish() when ready) ------------------

    def _ensure_alloc(self, dim: int, need: int) -> None:
        if self._vecs is None:
            self.dim = self.dim or dim
            if dim != self.dim:
                raise ValueError(f"ann bank {self.name!r}: dim {dim} != "
                                 f"configured {self.dim}")
            alloc = max(MIN_TIER, need)
            self._vecs = np.zeros((alloc, self.dim), np.float32)
            self._valid = np.zeros(alloc, bool)
            return
        if need > self._vecs.shape[0]:
            alloc = max(need, self._vecs.shape[0] * 2)
            grown = np.zeros((alloc, self.dim), np.float32)
            grown[:self._used] = self._vecs[:self._used]
            self._vecs = grown
            v = np.zeros(alloc, bool)
            v[:self._used] = self._valid[:self._used]
            self._valid = v

    def add(self, entry_id: str, vec: np.ndarray) -> bool:
        """Insert or overwrite one row; False when the bank is at its max
        capacity tier (the caller's host tier keeps the overflow)."""
        row = normalize_rows(vec)[0]
        with self._lock:
            slot = self._id2slot.get(entry_id)
            if slot is not None:
                self._vecs[slot] = row
                self._valid[slot] = True
                self._dirty = True
                return True
            if len(self._id2slot) >= self.max_capacity:
                return False
            self._ensure_alloc(row.shape[0], self._used + 1)
            slot = self._used
            self._used += 1
            self._vecs[slot] = row
            self._valid[slot] = True
            if slot < len(self._ids):
                self._ids[slot] = entry_id
            else:
                self._ids.append(entry_id)
            self._id2slot[entry_id] = slot
            self._dirty = True
            return True

    def extend(self, ids: List[str], vecs: np.ndarray) -> int:
        """Bulk insert: one normalize and one allocation for the block;
        ids already resident overwrite in place.  Returns the number of
        NEW rows (capacity-capped: the overflow stays with the caller)."""
        rows = normalize_rows(vecs)
        with self._lock:
            fresh: List[int] = []
            for i, entry_id in enumerate(ids):
                slot = self._id2slot.get(entry_id)
                if slot is not None:
                    self._vecs[slot] = rows[i]
                    self._valid[slot] = True
                else:
                    fresh.append(i)
            room = self.max_capacity - len(self._id2slot)
            fresh = fresh[:max(room, 0)]
            if fresh:
                self._ensure_alloc(rows.shape[1],
                                   self._used + len(fresh))
                base = self._used
                self._vecs[base:base + len(fresh)] = rows[fresh]
                self._valid[base:base + len(fresh)] = True
                for j, i in enumerate(fresh):
                    slot = base + j
                    if slot < len(self._ids):
                        self._ids[slot] = ids[i]
                    else:
                        self._ids.append(ids[i])
                    self._id2slot[ids[i]] = slot
                self._used = base + len(fresh)
            self._dirty = True
            return len(fresh)

    def delete(self, entry_id: str) -> bool:
        """Tombstone (valid=False): the slot is reclaimed by the next
        ``compact()`` rewrite, not in place (the serving view's slot → id
        map stays frozen)."""
        with self._lock:
            slot = self._id2slot.pop(entry_id, None)
            if slot is None:
                return False
            self._valid[slot] = False
            self._ids[slot] = None
            self._tombstones += 1
            self._dirty = True
            return True

    def compact(self) -> int:
        """Rewrite the host store without its tombstoned rows; returns
        the number reclaimed.  The view republishes on the next
        ``publish()``."""
        with self._lock:
            if self._tombstones == 0:
                return 0
            keep = [s for s in range(self._used) if self._valid[s]]
            vecs = self._vecs[keep].copy()
            ids = [self._ids[s] for s in keep]
            reclaimed = self._used - len(keep)
            self._vecs[:len(keep)] = vecs
            self._valid[:] = False
            self._valid[:len(keep)] = True
            self._ids = list(ids)
            self._id2slot = {i: s for s, i in enumerate(ids)}
            self._used = len(keep)
            self._tombstones = 0
            self._dirty = True
            return reclaimed

    # -- stats ---------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._id2slot)

    def __contains__(self, entry_id: str) -> bool:
        with self._lock:
            return entry_id in self._id2slot

    def tombstone_ratio(self) -> float:
        with self._lock:
            return self._tombstones / self._used if self._used else 0.0

    def used_slots(self) -> int:
        """Allocated slots (live + tombstoned): what must fit a capacity
        tier, not the live-entry count ``len()``."""
        with self._lock:
            return self._used

    def dirty(self) -> bool:
        with self._lock:
            return self._dirty

    def entry_ids(self) -> List[str]:
        with self._lock:
            return [i for i in self._ids[:self._used] if i is not None]

    def get_vector(self, entry_id: str) -> Optional[np.ndarray]:
        with self._lock:
            slot = self._id2slot.get(entry_id)
            if slot is None:
                return None
            return self._vecs[slot].copy()

    def _snapshot_locked(self) -> Tuple[np.ndarray, np.ndarray, tuple]:
        n = self._used
        return (self._vecs[:n].copy(), self._valid[:n].copy(),
                tuple(self._ids[:n]))

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray, tuple]:
        """Copies of the host store as ``publish`` places it: rows
        [used, D] f32, their validity, and the slot → id map."""
        with self._lock:
            if self._vecs is None:
                return (np.zeros((0, self.dim), np.float32),
                        np.zeros(0, bool), ())
            return self._snapshot_locked()

    # -- view publication ----------------------------------------------------

    def view(self) -> Optional[_DeviceView]:
        with self._lock:
            return self._view

    def configure(self, mode: Optional[str] = None,
                  min_capacity: Optional[int] = None,
                  max_capacity: Optional[int] = None) -> bool:
        """Retune storage knobs; returns True when a republish is due."""
        changed = False
        with self._lock:
            if mode is not None and mode != self.mode:
                self.mode = mode
                changed = True
            if min_capacity is not None \
                    and int(min_capacity) != self.min_capacity:
                self.min_capacity = int(min_capacity)
                changed = True
            if max_capacity is not None \
                    and int(max_capacity) != self.max_capacity:
                self.max_capacity = int(max_capacity)
                changed = True
            if changed:
                self._dirty = True
        return changed

    def publish(self) -> Optional[_DeviceView]:
        """Build and swap a fresh device view of the host store.  The
        recall gate and the device transfer run off the lock; lookups keep
        serving the previous view until the one reference swap at the
        end."""
        with self._lock:
            # add() caps LIVE entries at max_capacity, but _used also
            # counts tombstoned slots: delete + add churn at the max tier
            # can push _used past every tier.  Reclaim before padding.
            over_tier = self._vecs is not None and self._used > tier_for(
                self._used, self.min_capacity, self.max_capacity)
        if over_tier:
            self.compact()
        with self._lock:
            if self._vecs is None:
                self._dirty = False
                self._view = None
                return None
            dense, valid_host, ids = self._snapshot_locked()
            n = len(ids)
            mode = self.mode
            min_cap, max_cap = self.min_capacity, self.max_capacity
            version = self._version + 1

        tier = tier_for(n, min_cap, max_cap)
        while tier < n:  # churn between compact and snapshot: cover n
            tier <<= 1
        recall, fallback = 1.0, False
        if mode in ("bf16", "int8"):
            live = dense if valid_host.all() else dense[valid_host]
            recall = measure_recall(live, mode,
                                    n_queries=self.calibration_queries)
            if recall < self.recall_floor:
                mode, fallback = "f32", True
        view = place_view(dense, valid_host, ids, tier, mode, self.device,
                          version, recall, fallback)
        with self._lock:
            self._view = view
            self._version = version
            self._dirty = False
        return view

    def report(self) -> Dict[str, object]:
        with self._lock:
            view = self._view
            return {
                "entries": len(self._id2slot),
                "used_slots": self._used,
                "tombstones": self._tombstones,
                "dirty": self._dirty,
                "mode": self.mode,
                "tier": view.tier if view is not None else 0,
                "view_version": view.version if view is not None else 0,
                "view_mode": view.mode if view is not None else "none",
                "quant_fallback": bool(view.quant_fallback)
                if view is not None else False,
                "recall": round(view.recall, 4)
                if view is not None else 1.0,
                "mesh": None,
            }
