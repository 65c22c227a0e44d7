"""Per-model in-flight request tracking with self-healing expiry.

Each ``begin`` records a start time; entries older than ``max_age_s`` are
treated as abandoned (an ``end`` lost to an error) and dropped, so the
count corrects itself instead of leaking.  The HTTP server feeds it
around each backend call; the ``multi_factor`` selector's load factor
reads it.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict

DEFAULT_MAX_AGE_S = 600.0


class InflightTracker:
    def __init__(self, max_age_s: float = DEFAULT_MAX_AGE_S) -> None:
        self.max_age_s = max_age_s
        self._entries: Dict[str, Dict[int, float]] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def begin(self, model: str) -> int:
        """Record a request start; returns a token for :meth:`end`."""
        token = next(self._ids)
        with self._lock:
            self._entries.setdefault(model, {})[token] = time.monotonic()
        return token

    def end(self, model: str, token: int) -> None:
        with self._lock:
            entries = self._entries.get(model)
            if entries is not None:
                entries.pop(token, None)
                if not entries:
                    self._entries.pop(model, None)

    def count(self, model: str) -> int:
        with self._lock:
            return self._count_locked(model)

    def total(self) -> int:
        """Requests in flight over every model."""
        with self._lock:
            return sum(self._count_locked(m) for m in list(self._entries))

    def _count_locked(self, model: str) -> int:
        entries = self._entries.get(model)
        if not entries:
            return 0
        cutoff = time.monotonic() - self.max_age_s
        for t in [t for t, ts in entries.items() if ts < cutoff]:
            del entries[t]
        return len(entries)


# process-global tracker: selectors read it without a handle threaded
# through SelectionContext
default_tracker = InflightTracker()
