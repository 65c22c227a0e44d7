"""Profiler hooks: ``torch.profiler`` traces and named regions.

The port's counterpart of ``semantic_router_tpu.observability.profiler``:
``ProfilerControl`` owns the process-wide profiler state (the management
API exposes it at ``/debug/profiler/*``).  A trace records the host's
operators and, on the card, every kernel the device ran (CUPTI), and is
written as a Chrome trace (``trace.json``, viewable in Perfetto) under
``base_dir``.  ``trace_span`` names a region of that timeline: a
``record_function`` range, plus an NVTX range when the work runs on the
card.

A trace starts and stops holding ``TRACE_GATE`` alone, and every engine
step on the card (``engine/graphs.py``: a capture or a replay) holds it
shared: the profiler's start and stop synchronize the device and switch
CUPTI's tracing on or off, and neither may overlap a step.  Toggled
mid-capture, a trace ends the capture with an error and leaves the
profiler half-stopped; stopped while another thread launches a graph,
both can block for good.

The reference's ``configure_xla_dump`` (``POST /debug/profiler/xla-dump``)
has no counterpart on this backend: the server answers that route 501.
"""

from __future__ import annotations

import contextlib
import glob
import os
import threading
import time
from typing import Any, Dict, Optional

from ..utils.rwgate import RWGate

# engine steps on the card hold it shared, a trace's start and stop alone;
# one for the process: the profiler is process-wide, and so is CUPTI
TRACE_GATE = RWGate()


@contextlib.contextmanager
def gated_trace():
    """A ``torch.profiler.profile`` over the block (the host's operators,
    and the card's kernels when there is one), started and stopped
    holding ``TRACE_GATE`` alone; yields the profile."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    with TRACE_GATE.exclusive():
        prof.start()
    try:
        yield prof
    finally:
        with TRACE_GATE.exclusive():
            prof.stop()


def _default_base_dir() -> str:
    import tempfile

    return os.path.join(tempfile.gettempdir(), "srt-torch-profiles")


class _Session:
    """One trace on a thread of its own: the profiler is entered and left
    on that thread whichever request thread starts or stops it."""

    def __init__(self, target: str) -> None:
        self.target = target
        self.started = threading.Event()
        self.finish = threading.Event()
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="torch-profiler")

    def _run(self) -> None:
        try:
            with gated_trace() as prof:
                self.started.set()
                self.finish.wait()
            prof.export_chrome_trace(os.path.join(self.target,
                                                  "trace.json"))
        except BaseException as exc:  # reported by stop()
            self.error = exc
        finally:
            self.started.set()


class ProfilerControl:
    """Serialized start/stop around one ``torch.profiler.profile``."""

    def __init__(self, base_dir: str = "") -> None:
        self.base_dir = base_dir or _default_base_dir()
        self._lock = threading.Lock()
        self._active_dir: Optional[str] = None
        self._session: Optional[_Session] = None
        self._started_at = 0.0

    def start(self, log_dir: str = "") -> Dict[str, Any]:
        with self._lock:
            if self._active_dir is not None:
                return {"error": "profiler already running",
                        "dir": self._active_dir, "status": 409}
            target = log_dir or os.path.join(
                self.base_dir, time.strftime("%Y%m%d-%H%M%S"))
            os.makedirs(target, exist_ok=True)
            session = _Session(target)
            session.thread.start()
            session.started.wait()
            if session.error is not None:
                session.thread.join()
                return {"error": f"start failed: {session.error}"[:300],
                        "status": 500}
            self._session = session
            self._active_dir = target
            self._started_at = time.time()
            return {"started": True, "dir": target}

    def stop(self, force: bool = False) -> Dict[str, Any]:
        """End the trace and write ``trace.json`` under its directory.  A
        failed stop keeps the session marked active so it can be retried;
        ``force`` clears it whatever happened."""
        with self._lock:
            if self._active_dir is None:
                return {"error": "profiler not running", "status": 409}
            target = self._active_dir
            session = self._session
            session.finish.set()
            session.thread.join(timeout=120.0)
            if session.thread.is_alive() and not force:
                return {"error": "stop failed: the trace is still being "
                                 "written", "dir": target,
                        "retryable": True,
                        "hint": "retry stop, or stop?force=1 to clear",
                        "status": 500}
            self._active_dir, self._session = None, None
            if session.error is not None:
                return {"error": f"stop failed: {session.error}"[:300],
                        "dir": target, "cleared": True, "status": 500}
            files = sorted(
                os.path.relpath(p, target)
                for p in glob.glob(os.path.join(target, "**", "*"),
                                   recursive=True) if os.path.isfile(p))
            return {"stopped": True, "dir": target, "files": files,
                    "duration_s": round(time.time() - self._started_at, 3)}

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "running": self._active_dir is not None,
                "dir": self._active_dir,
                "elapsed_s": round(time.time() - self._started_at, 3)
                if self._active_dir else 0.0,
                "xla_dump": None,
            }


# the answer of POST /debug/profiler/xla-dump on this backend
XLA_DUMP_UNSUPPORTED = {
    "error": "no XLA on this backend: the engine's steps are CUDA graphs "
             "of hand-written kernels and cuBLAS calls; take a trace "
             "with /debug/profiler/start and /debug/profiler/stop",
    "status": 501}


@contextlib.contextmanager
def trace_span(name: str, cuda: bool = False):
    """Named region in the profiler timeline (``record_function``), and
    an NVTX range when ``cuda``: engine steps annotate with
    ``with trace_span('engine.classify.fused.trunk0', cuda=True)`` so the
    trace lines up with router semantics.  Around a graph replay the
    range covers the replay call: the replayed kernels have no host-side
    ranges of their own."""
    import torch

    with torch.profiler.record_function(name):
        if not cuda:
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


default_profiler = ProfilerControl()
