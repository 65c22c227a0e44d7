"""PyTorch + CUDA port of the semantic router for NVIDIA Hopper (H100).

The JAX package ``semantic_router_tpu`` stays the numerics reference; this
package re-implements its main path — a routed chat request whose learned
signals run one fused ModernBERT classifier bank — with the two Pallas
kernels on that path (flash attention, head-bank epilogue) written by hand
in CUDA C++ for ``sm_90a`` (``csrc/``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
a CPU tensor every kernel wrapper runs its plain PyTorch version instead.
Importing this package starts nothing and builds nothing: kernels compile
with ``nvcc`` at their first launch (``ops/_cuda.py``).
"""

__all__ = ["__version__"]

__version__ = "0.1.0"
