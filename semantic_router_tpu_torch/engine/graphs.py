"""The compiled-step cache: each engine step shape captured once as a CUDA
graph and replayed.

The port's counterpart of the JAX engine's compiled programs: ``jax.jit``
compiles a step once per shape and re-executes the program afterwards;
on the card a ``torch.cuda.CUDAGraph`` is that program.  A ``StepGraphs``
holds one owner's steps (a trunk group's demux snapshot, a per-task task
or an embedding task) keyed by (group, variant, bucket, padded rows, ...),
with one graph memory pool and one lock:

- the first execution of a key runs the step eagerly on the capture
  stream, and that run's result is served: every first-use setup (a
  kernel's function attributes, RoPE tables, library handles on that
  stream) happens there, outside the capture.  Then the step is captured
  into the owner's pool, with the engine-wide ``CaptureGate`` held alone
  (no other thread launches onto the card meanwhile) and
  ``capture_error_mode="thread_local"``;
- every later execution copies its host inputs into the graph's static
  buffers, replays, and copies the outputs to the host, all under the
  owner's lock, with the gate held shared;
- both hold the process-wide ``observability.profiler.TRACE_GATE``
  shared, so no profiler trace starts or stops during a step (either
  synchronizes the device and toggles CUPTI, which a capture does not
  allow and a concurrent graph launch can deadlock with);
- the kernel wrappers run during the capture but the card runs nothing:
  their launches are recorded (``ops._cuda.recording_launches``) and
  added on every replay, so the launch counts stay counts of kernels run;
- inside ``on_first_execution(fn)`` the first execution of a key is
  counted (``observability.programstats.StepCost``, the FLOPs and bytes
  of the step) and handed to ``fn``: on the card that is the served
  eager run the graph is captured after, never the capture;
- ``evict`` drops the graphs of some keys (the generator's least
  recently used shapes); a snapshot that is rebuilt or flipped retires
  its cache: the graphs are dropped (they hold the addresses of the bank and trunk tensors they
  were captured with) and a step on a retired cache raises
  ``SnapshotRetired``.

There is no fallback: a capture that fails (a host sync inside the step,
a call the capture does not allow, a kernel that does not launch) raises,
and so does a replay.  On the CPU a step runs eagerly, with no graph.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Dict, Hashable, Optional, Sequence, Tuple

import torch

from ..observability.profiler import TRACE_GATE
from ..observability.programstats import StepCost
from ..ops import _cuda
from ..utils.rwgate import RWGate

Outputs = Tuple[Optional[torch.Tensor], ...]

# per thread: the callback a step's first execution is counted for
_FIRST = threading.local()


@contextlib.contextmanager
def on_first_execution(fn: Callable):
    """Inside the block, a ``StepGraphs.run`` on this thread that is the
    first execution of its key counts the step and calls
    ``fn(cost, info)`` after it (``info``: argument, output and
    graph-pool bytes, capture seconds)."""
    prev = getattr(_FIRST, "fn", None)
    _FIRST.fn = fn
    try:
        yield
    finally:
        _FIRST.fn = prev


class SnapshotRetired(RuntimeError):
    """A step ran on a graph cache that a rebuild, a quant flip or a
    kernels flip retired."""


class CaptureGate(RWGate):
    """The engine-wide reader/writer gate: replays hold it shared, a
    capture holds it alone (a waiting capture stops new replays from
    entering).  Also owns the side stream captures run on."""

    def __init__(self) -> None:
        super().__init__()
        self._streams: Dict[str, torch.cuda.Stream] = {}

    def stream(self, device: torch.device) -> "torch.cuda.Stream":
        """The capture stream of ``device`` (taken under ``exclusive``)."""
        key = str(device)
        if key not in self._streams:
            self._streams[key] = torch.cuda.Stream(device)
        return self._streams[key]


class CapturedStep:
    """One captured step: its graph, static input buffers, output tensors
    (in the owner's pool), the launches its capture recorded, and the
    seconds the capture took."""

    def __init__(self, graph, inputs: Tuple[torch.Tensor, ...],
                 outputs: Outputs, launches: Dict[str, Dict[str, int]],
                 capture_s: float, pool_bytes: int) -> None:
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.capture_s = capture_s
        self.pool_bytes = pool_bytes

    def load(self, host_inputs: Sequence[torch.Tensor]) -> None:
        """Copy host inputs into the static buffers (same shapes)."""
        for dst, src in zip(self.inputs, host_inputs):
            dst.copy_(src, non_blocking=True)

    def replay(self) -> None:
        """Run the graph on the current stream and count its launches."""
        self.graph.replay()
        _cuda.add_launches(self.launches)


def _to_host(outs: Outputs) -> Outputs:
    return tuple(None if o is None else o.float().cpu() for o in outs)


class StepGraphs:
    """One owner's captured steps, its graph memory pool and its lock."""

    def __init__(self, device: torch.device, gate: CaptureGate,
                 name: str = "") -> None:
        self.device = torch.device(device)
        self.gate = gate
        self.name = name
        self.lock = threading.Lock()
        self.steps: Dict[Hashable, CapturedStep] = {}
        self._eager: set = set()  # keys run eagerly (the CPU)
        self.retired = False
        self._pool = None

    def retire(self) -> None:
        """Drop every graph; a later step on this cache raises.  The graphs
        are destroyed with the gate held alone: destroying one while
        another thread captures would end that capture."""
        with self.lock:
            self.retired = True
            dropped = list(self.steps.values())
            self.steps.clear()
            self._eager.clear()
        if dropped:
            with self.gate.exclusive():
                del dropped

    def evict(self, drop: Callable[[Hashable], bool]) -> int:
        """Drop the graphs of every key ``drop`` accepts, as ``retire``
        drops all of them (destroyed with the gate held alone); the cache
        stays live and such a key is captured again at its next
        execution.  Returns how many keys went.  When no graph is left,
        the next capture takes a fresh pool: the caching allocator frees
        a private pool once its last graph is destroyed, and capturing
        into that pool's handle again fails."""
        with self.lock:
            gone = [k for k in self.steps if drop(k)]
            dropped = [self.steps.pop(k) for k in gone]
            eager = [k for k in self._eager if drop(k)]
            self._eager.difference_update(eager)
            if dropped and not self.steps:
                self._pool = None
        if dropped:
            with self.gate.exclusive():
                del dropped
        return len(gone) + len(eager)

    def captured(self) -> int:
        return len(self.steps)

    def keys(self) -> set:
        """The step keys this cache has executed: captured on the card,
        run eagerly on the CPU."""
        with self.lock:
            return set(self.steps) | self._eager

    def pool_bytes(self) -> int:
        """Bytes the card reserved while this owner's graphs captured."""
        return sum(s.pool_bytes for s in list(self.steps.values()))

    def capture_seconds(self) -> float:
        return sum(s.capture_s for s in list(self.steps.values()))

    def run(self, key: Hashable, fn: Callable[..., Outputs],
            inputs: Sequence[torch.Tensor]) -> Tuple[Outputs, str]:
        """Execute the step ``fn`` (device tensors in, a tuple of tensors
        or None out) on host ``inputs``.  Returns (host float32 outputs,
        how): ``eager`` on the CPU, else ``captured`` for the first
        execution of ``key`` and ``replayed`` after it.  Inside
        ``on_first_execution`` the first execution is counted."""
        on_first = getattr(_FIRST, "fn", None)
        if self.device.type != "cuda":
            with self.lock:
                if self.retired:
                    raise SnapshotRetired(f"step cache {self.name!r} is "
                                          f"retired")
                first = key not in self._eager
                self._eager.add(key)
            with torch.inference_mode():
                if not (first and on_first is not None):
                    return _to_host(fn(*inputs)), "eager"
                with StepCost() as cost:
                    outs = _to_host(fn(*inputs))
            on_first(cost, {"argument_bytes": _cuda.nbytes(*inputs),
                            "output_bytes": _cuda.nbytes(*outs),
                            "temp_bytes": 0, "capture_s": 0.0})
            return outs, "eager"
        with self.lock:
            if self.retired:
                raise SnapshotRetired(f"step cache {self.name!r} is retired")
            step = self.steps.get(key)
            if step is None:
                with self.gate.exclusive(), TRACE_GATE.shared():
                    outs, self.steps[key], cost = self._capture(
                        fn, inputs, count=on_first is not None)
                if on_first is not None:
                    new = self.steps[key]
                    on_first(cost, {
                        "argument_bytes": _cuda.nbytes(*inputs),
                        "output_bytes": _cuda.nbytes(*outs),
                        "temp_bytes": new.pool_bytes,
                        "capture_s": new.capture_s})
                return outs, "captured"
            with self.gate.shared(), TRACE_GATE.shared():
                step.load(inputs)
                step.replay()
                return _to_host(step.outputs), "replayed"

    def _abandon(self, graph, dev: torch.device) -> None:
        """End a capture that failed.  Ending an invalidated capture
        raises before the caching allocator stops routing the capture
        stream's allocations into the pool; stop it here, so the next
        capture can begin, and give later captures a fresh pool.  The
        caller raises the capture's own error."""
        try:
            graph.capture_end()
        except Exception:
            end = getattr(torch._C, "_cuda_endAllocateToPool", None)
            if end is not None:
                index = dev.index if dev.index is not None \
                    else torch.cuda.current_device()
                try:
                    end(index, self._pool)
                except Exception:
                    pass  # the allocator had already stopped
        self._pool = None

    def _capture(self, fn, inputs, count: bool = False
                 ) -> Tuple[Outputs, CapturedStep, object]:
        """The served eager run on the capture stream (counted with
        ``count``), then the capture.  Returns (outputs, step, the
        count or None).  Raises whatever the run or the capture
        raises."""
        dev = self.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static = tuple(torch.empty(x.shape, dtype=x.dtype, device=dev)
                       for x in inputs)
        for dst, src in zip(static, inputs):
            dst.copy_(src)
        stream = self.gate.stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        cost = None
        with torch.cuda.stream(stream), torch.inference_mode():
            if count:
                with StepCost() as cost:
                    served = _to_host(fn(*static))
            else:
                served = _to_host(fn(*static))
            torch.cuda.synchronize(dev)
            reserved = torch.cuda.memory_reserved(dev)
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            # a dead graph that the collector frees mid-capture would
            # destroy its executable on this thread: not allowed while
            # the stream captures, and it ends the capture.  Only one
            # capture runs at a time (the gate), so no thread collects
            # until it ends.
            was_enabled = gc.isenabled()
            gc.disable()
            try:
                with _cuda.recording_launches() as launches:
                    graph.capture_begin(self._pool,
                                        capture_error_mode="thread_local")
                    try:
                        outs = fn(*static)
                        graph.capture_end()
                    except BaseException:
                        self._abandon(graph, dev)
                        raise
            finally:
                if was_enabled:
                    gc.enable()
            capture_s = time.perf_counter() - t0
        torch.cuda.current_stream(dev).wait_stream(stream)
        grown = torch.cuda.memory_reserved(dev) - reserved
        step = CapturedStep(graph, static, tuple(outs), launches, capture_s,
                            grown)
        return served, step, cost
