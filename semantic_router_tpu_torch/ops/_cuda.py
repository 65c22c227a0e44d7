"""Build, load and count the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries land in ``_build/`` beside
this package, named by a digest of their source, the ``csrc/*.cuh``
headers they may include, and the flags, so an edited source or header
never loads a stale build.  Nothing builds at import time: a
kernel compiles at its first launch, or all at once, in parallel, through
``build_all``.

Every ``CudaKernel`` keeps a plain launch counter that its wrapper bumps
once per launch; ``reset_launch_counts``/``launch_counts`` let a run show
that its main path went through the kernels.  A CUDA graph capture runs
the wrappers but launches nothing: inside ``recording_launches`` the
wrappers' launches are recorded instead of counted, and every replay of
the graph adds that record (``add_launches``).

Each wrapper also reports the cost of its call (FLOPs, and bytes with
each input read once and each output written once) through
``note_cost`` — the same cost whether it launches its kernel or runs its
plain version — and runs its plain version inside ``plain_region``, so a
step's cost count (``observability.programstats.StepCost``) does not
count the plain version's own aten work again.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Optional, Sequence

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

# dtype codes shared with the C entry points
DTYPE_F32 = 0
DTYPE_BF16 = 1


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build from "
                       "csrc/ with the CUDA toolkit")


class CudaKernel:
    """One ``csrc/<name>.cu`` source: its build, its C entry point and its
    launch counter."""

    def __init__(self, name: str, symbol: str, argtypes: Sequence,
                 csrc_dir: str = CSRC_DIR) -> None:
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.source = os.path.join(csrc_dir, f"{name}.cu")
        self.launches = 0
        # the same launches by input dtype ("float32", "bfloat16")
        self.launches_by_dtype: Dict[str, int] = {}
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()

    def library_path(self) -> str:
        """``_build/lib<name>-<digest>.so``: the digest covers the source,
        every ``*.cuh`` header beside it (a header edit must not load a
        stale build) and the compiler flags."""
        src_dir = os.path.dirname(self.source)
        headers = sorted(glob.glob(os.path.join(src_dir, "*.cuh")))
        h = hashlib.blake2b(digest_size=8)
        for path in [self.source, *headers]:
            with open(path, "rb") as f:
                h.update(os.path.basename(path).encode() + b"\0" + f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR, f"lib{self.name}-{h.hexdigest()}.so")

    def build_command(self, out: str) -> List[str]:
        return [nvcc_path(), *NVCC_FLAGS, "-o", out, self.source]

    def _load(self, path: str):
        lib = ctypes.CDLL(path)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def function(self):
        """The loaded C entry point, building the library first if needed."""
        fn = self._fn
        if fn is None:
            with self._lock:
                if self._fn is None:
                    path = self.library_path()
                    if not os.path.exists(path):
                        build_all([self])
                    self._fn = self._load(path)
                fn = self._fn
        return fn

    def count(self, key: str, n: int = 1) -> None:
        """Add ``n`` launches under the dtype name ``key``."""
        with self._lock:
            self.launches += n
            self.launches_by_dtype[key] = \
                self.launches_by_dtype.get(key, 0) + n


def _dtype_key(dtype: Optional[torch.dtype]) -> str:
    return str(dtype).replace("torch.", "") if dtype is not None else "?"


# per thread: the launch record of a graph capture in progress, or None
_RECORDING = threading.local()
# per thread: the cost record of a step being counted, or None
_COSTS = threading.local()


def build_all(kernels: Iterable[CudaKernel]) -> Dict[str, str]:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all started together.  Returns {name: compiler output}; raises
    with the compiler's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for k in kernels:
        path = k.library_path()
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.Popen(k.build_command(tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append((k, proc, tmp, path))
    logs: Dict[str, str] = {}
    failed: List[str] = []
    for k, proc, tmp, path in procs:
        out, _ = proc.communicate()
        k.build_log = logs[k.name] = out
        if proc.returncode != 0:
            failed.append(f"{k.name} (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def check_launch(kernel: CudaKernel, rc: int,
                 dtype: Optional[torch.dtype] = None) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a C entry point;
    count the launch (under the dtype it ran in), or record it when this
    thread is capturing a graph."""
    if rc != 0:
        raise RuntimeError(f"{kernel.name} launch failed: CUDA error {rc}")
    key = _dtype_key(dtype)
    log = getattr(_RECORDING, "log", None)
    if log is None:
        kernel.count(key)
        return
    by_dtype = log.setdefault(kernel.name, {})
    by_dtype[key] = by_dtype.get(key, 0) + 1


@contextlib.contextmanager
def recording_launches():
    """Inside the block, this thread's launches are recorded in the
    yielded {kernel: {dtype: n}} and not counted: a graph capture runs
    the wrappers, the card runs nothing."""
    prev = getattr(_RECORDING, "log", None)
    log: Dict[str, Dict[str, int]] = {}
    _RECORDING.log = log
    try:
        yield log
    finally:
        _RECORDING.log = prev


@contextlib.contextmanager
def recording_costs():
    """Inside the block, this thread's wrappers append (kernel, flops,
    bytes) to the yielded list (observability.programstats.StepCost)."""
    prev = getattr(_COSTS, "log", None)
    log: List[tuple] = []
    _COSTS.log = log
    try:
        yield log
    finally:
        _COSTS.log = prev


def note_cost(kernel: CudaKernel, flops: float, nbytes: float) -> None:
    """Report one wrapper call's cost when this thread is counting a
    step; nothing otherwise (one thread-local read)."""
    log = getattr(_COSTS, "log", None)
    if log is not None:
        log.append((kernel.name, float(flops), float(nbytes)))


def counting_costs() -> bool:
    return getattr(_COSTS, "log", None) is not None


@contextlib.contextmanager
def plain_region():
    """Run a wrapper's plain version: while this thread counts a step,
    the counting dispatch modes are off inside (the wrapper reported the
    call's cost already)."""
    if not counting_costs():
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def add_launches(log: Dict[str, Dict[str, int]]) -> None:
    """Count the launches of one graph replay: the record its capture
    made."""
    kernels = registry()
    for name, by_dtype in log.items():
        for key, n in by_dtype.items():
            kernels[name].count(key, n)


def registry() -> Dict[str, CudaKernel]:
    """Every kernel of the port, by name (imports the op modules)."""
    from .bgmv import BGMV
    from .epilogue import HEAD_EPILOGUE
    from .flash_attention import FLASH_ATTENTION

    return {k.name: k for k in (FLASH_ATTENTION, HEAD_EPILOGUE, BGMV)}


def reset_launch_counts() -> None:
    for k in registry().values():
        with k._lock:
            k.launches = 0
            k.launches_by_dtype = {}


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in registry().items()}


def launch_counts_by_dtype() -> Dict[str, Dict[str, int]]:
    return {name: dict(k.launches_by_dtype)
            for name, k in registry().items()}
