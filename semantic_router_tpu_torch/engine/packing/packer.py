"""Sequence packer: bin-pack short prompts into shared device rows.

The port's copy of ``semantic_router_tpu.engine.packing.packer``.  A
packed device batch is ``ids`` / ``mask`` of shape [R, bucket] exactly
like an unpacked one, plus the packing planes:

- ``position_ids`` [R, S]: RoPE positions restart at 0 per segment, so
  every segment rotates exactly as it would alone in a row;
- ``segment_ids`` [R, S]: global segment index (0..K-1), -1 on padding;
  the block-diagonal attention mask derives from equality;
- ``seg_row`` / ``seg_start`` / ``seg_len`` [K_pad]: the demux map, where
  each segment's tokens (and its CLS position) live.  K_pad is the
  segment count padded to a power of two (padding segments point at
  (0, 0) and their logits are dropped at demux).

Packing is FIRST-FIT over rows in arrival order: deterministic, stable
(an item's logits demux by segment index, never by sort position), and
within one planned step every selected item fits: the scheduler's
``plan_take`` runs the same ``RowPlan`` arithmetic before committing
items to the step, so ``pack_items`` never overflows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class Segment:
    """One packed prompt: where its tokens landed."""

    item_index: int   # index into the step's item list
    row: int
    start: int
    length: int       # tokens actually placed (after bucket clip)
    clipped: bool     # encoding exceeded the bucket and was clipped


@dataclass
class PackedBatch:
    ids: np.ndarray            # [R_pad, bucket] int32
    mask: np.ndarray           # [R_pad, bucket] int32, 1 = real token
    position_ids: np.ndarray   # [R_pad, bucket] int32, per-segment 0..L−1
    segment_ids: np.ndarray    # [R_pad, bucket] int32, −1 = padding
    seg_row: np.ndarray        # [K_pad] int32
    seg_start: np.ndarray      # [K_pad] int32
    seg_len: np.ndarray        # [K_pad] int32
    segments: List[Segment] = field(default_factory=list)
    rows_used: int = 0         # rows holding at least one segment
    tokens_real: int = 0       # sum of placed segment lengths

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    @property
    def tokens_padded(self) -> int:
        return int(self.ids.shape[0] * self.ids.shape[1])

    def fill_ratio(self) -> float:
        padded = self.tokens_padded
        return self.tokens_real / padded if padded else 0.0


class RowPlan:
    """First-fit row arithmetic shared by the scheduler's take decision
    and the packer's layout — one implementation, so "it planned" always
    implies "it fits"."""

    def __init__(self, bucket: int, max_rows: int,
                 max_segments_per_row: int) -> None:
        self.bucket = int(bucket)
        self.max_rows = max(1, int(max_rows))
        self.max_segs = max(1, int(max_segments_per_row))
        self.row_fill: List[int] = []   # tokens used per open row
        self.row_segs: List[int] = []   # segments per open row

    def placement(self, length: int) -> Optional[int]:
        """Row index where a ``length``-token segment would land, or
        None when no open row has room AND opening another would exceed
        max_rows.  Lengths clip at the bucket (a clipped segment fills a
        whole row's budget — same clamp-never-silent rule as unpacked
        bucket overflow)."""
        length = min(max(1, int(length)), self.bucket)
        for r, used in enumerate(self.row_fill):
            if used + length <= self.bucket \
                    and self.row_segs[r] < self.max_segs:
                return r
        if len(self.row_fill) < self.max_rows:
            return len(self.row_fill)
        return None

    def add(self, length: int) -> Optional[int]:
        """Commit a segment; returns its row or None (no room)."""
        length = min(max(1, int(length)), self.bucket)
        r = self.placement(length)
        if r is None:
            return None
        if r == len(self.row_fill):
            self.row_fill.append(0)
            self.row_segs.append(0)
        self.row_fill[r] += length
        self.row_segs[r] += 1
        return r

    @property
    def rows_used(self) -> int:
        return len(self.row_fill)


def plan_take(lengths: Sequence[int], bucket: int, *, max_rows: int,
              max_segments_per_row: int, max_items: int,
              deferrals: Optional[Sequence[int]] = None,
              starvation_steps: int = 4,
              backlog_beyond: bool = False,
              row_align: int = 1
              ) -> "tuple[List[int], List[int]]":
    """Select which queued items join the next packed step.

    FIFO with bounded lookahead: items are considered in arrival order;
    one that does not fit the current plan is SKIPPED (deferred) so
    later, shorter items can top rows off — unless its deferral count
    has reached ``starvation_steps``, in which case selection STOPS at
    it (it becomes the head of the next step: an item is never deferred
    more than ``starvation_steps`` steps, the continuous-admission
    fairness bound).

    ``backlog_beyond``: more items remain queued than this step can
    take — then the take trims back to a full power-of-two row count so
    the padded device shape carries no all-padding rows (the backlog
    refills next step immediately; trimmed items are NOT deferrals).

    ``row_align``: the padder's row alignment (1 on one device; the
    reference's serving mesh pads rows to its dp degree) — the trim only
    targets a count that pads to ITSELF (a power of two that is also an
    align multiple); any other target would be rounded back up,
    re-growing the device shape with all-padding rows.

    Returns ``(take, deferred)``: indices into ``lengths`` in arrival
    order, and the indices the LOOKAHEAD jumped past (whose deferral
    counts the caller must age) — trim-dropped and never-considered
    items are deliberately absent from ``deferred``.
    """
    plan = RowPlan(bucket, max_rows, max_segments_per_row)
    take: List[int] = []
    rows_of: List[int] = []
    skipped: List[int] = []
    for i, length in enumerate(lengths):
        if len(take) >= max(1, int(max_items)):
            backlog_beyond = True
            break
        row = plan.add(length)
        if row is None:
            if deferrals is not None and \
                    deferrals[i] >= max(0, int(starvation_steps)):
                # starving item: nothing may jump past it again
                break
            skipped.append(i)  # jumped by lookahead: ages one deferral
            continue
        take.append(i)
        rows_of.append(row)
    # the deferral horizon is the PRE-trim planning frontier: an item
    # skipped beyond the last planned take was never actually jumped
    horizon = take[-1] if take else -1
    if backlog_beyond and plan.rows_used > 1:
        # trim only to a row count that pads to ITSELF (a power of two
        # that is also a row_align multiple): a target that the padder
        # would round back up just re-grows the device shape with
        # all-padding rows.  With no such count below rows_used (e.g.
        # a non-power-of-two dp), keep the full take.
        align = max(1, int(row_align))
        target = plan.rows_used
        t = 1 << (plan.rows_used.bit_length() - 1)
        while t >= 1:
            padded = max(align, ((t + align - 1) // align) * align)
            if padded == t:
                target = t
                break
            t >>= 1
        if target < plan.rows_used:
            take = [i for i, r in zip(take, rows_of) if r < target]
    return take, [i for i in skipped if i < horizon]


def pack_items(encodings: Sequence, bucket: int, pad_id: int, *,
               max_rows: int, max_segments_per_row: int,
               pad_rows_to: Optional[int] = None,
               pad_segments_to: Optional[int] = None) -> PackedBatch:
    """Lay selected encodings out as a packed device batch.

    ``encodings`` expose ``ids``/``attention_mask`` and ``len()`` like
    utils.tokenization.Encoding.  An encoding longer than the bucket
    clips at the bucket edge (Segment.clipped — the caller attributes
    overflow counts per task, same contract as the unpacked stacker).
    """
    plan = RowPlan(bucket, max_rows, max_segments_per_row)
    segments: List[Segment] = []
    for i, enc in enumerate(encodings):
        L = min(len(enc), bucket)
        row = plan.add(L)
        if row is None:
            raise ValueError(
                f"pack_items: item {i} (len {L}) does not fit the plan "
                f"(bucket={bucket}, max_rows={max_rows}) — the scheduler "
                f"must plan_take before packing")
        start = plan.row_fill[row] - L
        segments.append(Segment(i, row, start, L, clipped=len(enc) > bucket))

    rows_used = plan.rows_used
    n_rows = max(1, int(pad_rows_to or rows_used))
    ids = np.full((n_rows, bucket), pad_id, dtype=np.int32)
    mask = np.zeros((n_rows, bucket), dtype=np.int32)
    pos = np.zeros((n_rows, bucket), dtype=np.int32)
    seg = np.full((n_rows, bucket), -1, dtype=np.int32)
    tokens_real = 0
    for k, s in enumerate(segments):
        enc = encodings[s.item_index]
        sl = slice(s.start, s.start + s.length)
        ids[s.row, sl] = np.asarray(enc.ids[:s.length])
        mask[s.row, sl] = np.asarray(enc.attention_mask[:s.length])
        pos[s.row, sl] = np.arange(s.length)
        seg[s.row, sl] = k
        tokens_real += s.length

    k_pad = max(1, int(pad_segments_to or len(segments)))
    seg_row = np.zeros(k_pad, dtype=np.int32)
    seg_start = np.zeros(k_pad, dtype=np.int32)
    seg_len = np.zeros(k_pad, dtype=np.int32)
    for k, s in enumerate(segments):
        seg_row[k] = s.row
        seg_start[k] = s.start
        seg_len[k] = s.length
    return PackedBatch(ids, mask, pos, seg, seg_row, seg_start, seg_len,
                       segments=segments, rows_used=rows_used,
                       tokens_real=tokens_real)
