"""Stateplane convergence for replica banks.

The port's copy of ``semantic_router_tpu.ann.sync``: the same keys and
float32 little-endian embedding bytes, so a port replica's index
converges on rows a JAX replica's cache wrote, and the other way round.

The ANN bank is an INDEX over rows that already live on the state
plane (the semantic cache's ``{ns}:cache:entry:*`` hashes carry their
embeddings; the shared vector store's chunk rows likewise) — so fleet
convergence is the shared cache's mirror pattern, not a second storage system:
poll the namespace version counter, and only when siblings actually
wrote, diff the keyspace against the local index and adopt the delta.

Plane death fails open to local-only serving (stamped in the report +
the ``llm_ann_local_fallback`` gauge, never an error up the lookup
path); the backend's ``on_recover`` hook forces a full resync, so a
restarted plane reconverges the bank within one sync interval.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from ..stateplane.backend import StateBackendUnavailable


class VersionedRowSync:
    """Generic versioned-keyspace → index convergence: ``prefix`` +
    ``ver_key`` name the plane rows, ``extract`` pulls an embedding out
    of one row hash (rows without one are skipped)."""

    def __init__(self, plane, index, prefix: str, ver_key: str,
                 extract: Optional[Callable[[Dict[str, bytes]],
                                            Optional[np.ndarray]]] = None,
                 interval_s: float = 2.0) -> None:
        self.plane = plane
        self.backend = plane.backend
        self.index = index
        self.prefix = prefix
        self.ver_key = ver_key
        self.extract = extract or self._default_extract
        self.interval_s = float(interval_s)
        self._seen_ver = -1
        self._last_sync_t = 0.0
        self._lock = threading.Lock()
        self.local_only = False
        self.syncs = 0
        self._closed = False
        self.backend.on_recover(self.mark_stale)

    def close(self) -> None:
        """Unhook from the backend's recovery list — a superseded sync
        (rebind, index close) must not stay alive firing mark_stale on
        every plane recovery."""
        if self._closed:
            return
        self._closed = True
        off = getattr(self.backend, "off_recover", None)
        if off is not None:
            try:
                off(self.mark_stale)
            except Exception:
                pass

    @staticmethod
    def _default_extract(h: Dict[str, bytes]) -> Optional[np.ndarray]:
        emb = h.get("emb")
        if not emb:
            return None
        return np.frombuffer(emb, dtype=np.float32)

    def mark_stale(self) -> None:
        """Recovery hook: force a FULL resync on the next cycle (the
        plane may have compacted/expired anything while we were away)."""
        with self._lock:
            self._seen_ver = -1
            self._last_sync_t = 0.0

    def due(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            return now - self._last_sync_t >= self.interval_s

    def sync_once(self, force: bool = False) -> bool:
        """One convergence step; returns True when the index changed.
        Every plane failure degrades to local-only serving — the index
        keeps answering from whatever it already holds."""
        with self._lock:
            self._last_sync_t = time.monotonic()
            seen = self._seen_ver
        try:
            ver_raw = self.backend.get(self.ver_key)
            ver = int(ver_raw) if ver_raw else 0
            if not force and ver == seen:
                self.local_only = False
                return False
            keys = self.backend.scan(self.prefix)
            plane_ids = {k[len(self.prefix):] for k in keys}
            local_ids = set(self.index.ids())
            changed = False
            for entry_id in plane_ids - local_ids:
                h = self.backend.get_hash(self.prefix + entry_id)
                vec = self.extract(h) if h else None
                if vec is None:
                    continue
                self.index.add(entry_id, vec)
                changed = True
            for entry_id in local_ids - plane_ids:
                self.index.delete(entry_id)
                changed = True
        except StateBackendUnavailable:
            self.local_only = True
            return False
        with self._lock:
            self._seen_ver = ver
            self.syncs += 1
        self.local_only = False
        return changed

    def report(self) -> Dict[str, object]:
        with self._lock:
            seen, syncs = self._seen_ver, self.syncs
        return {"seen_ver": seen, "local_only": self.local_only,
                "syncs": syncs, "interval_s": self.interval_s}


def cache_index_sync(plane, index,
                     interval_s: float = 2.0) -> VersionedRowSync:
    """Bind an ANN index to the shared semantic cache's keyspace: the
    same ``{ns}:cache:entry:*`` rows + ``{ns}:cache:ver`` counter
    SharedSemanticCache writes — the bank converges on what the FLEET
    cached, with zero extra plane storage."""
    return VersionedRowSync(
        plane, index,
        prefix=plane.key("cache", "entry", ""),
        ver_key=plane.key("cache", "ver"),
        interval_s=interval_s)
