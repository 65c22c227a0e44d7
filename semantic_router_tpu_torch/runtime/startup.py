"""Startup and readiness: the phases a server passes through while it
boots (starting → loading_config → loading_models → warming → ready, or
failed), each with its notes, thread-safe, and written as JSON to a
status file when the tracker has a path (so a readiness monitor outside
the process can read it).  ``GET /startup-status`` serves the snapshot.
The port's copy of the JAX package's ``runtime/startup.py``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

PHASES = ("starting", "loading_config", "loading_models", "warming",
          "ready", "failed")


@dataclass
class StartupStatus:
    phase: str = "starting"
    started_t: float = field(default_factory=time.time)
    updated_t: float = field(default_factory=time.time)
    notes: List[str] = field(default_factory=list)
    error: str = ""

    def to_dict(self) -> Dict:
        return {
            "phase": self.phase,
            "ready": self.phase == "ready",
            "failed": self.phase == "failed",
            "uptime_s": round(time.time() - self.started_t, 1),
            "notes": self.notes[-20:],
            "error": self.error,
        }


class StartupTracker:
    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        self.status = StartupStatus()
        self._lock = threading.Lock()
        self._persist()

    def advance(self, phase: str, note: str = "") -> None:
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase!r}")
        with self._lock:
            self.status.phase = phase
            self.status.updated_t = time.time()
            if note:
                self.status.notes.append(f"{phase}: {note}")
            self._persist()

    def note(self, note: str) -> None:
        with self._lock:
            self.status.notes.append(note)
            self._persist()

    def fail(self, error: str) -> None:
        with self._lock:
            self.status.phase = "failed"
            self.status.error = error
            self.status.updated_t = time.time()
            self._persist()

    @property
    def ready(self) -> bool:
        return self.status.phase == "ready"

    def snapshot(self) -> Dict:
        with self._lock:
            return self.status.to_dict()

    def _persist(self) -> None:
        if not self.path:
            return
        try:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.status.to_dict(), f)
            os.replace(tmp, self.path)
        except OSError:
            pass
