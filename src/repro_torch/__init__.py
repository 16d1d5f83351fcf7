"""repro_torch — the PyTorch/CUDA port of the HYLU reproduction.

The JAX package ``repro`` stays the reference; this package runs the same
analysis and the batched repeated-solve path on an NVIDIA GPU, with the
Pallas kernels of that path written by hand in CUDA C++
(``repro_torch/csrc``).  It imports neither JAX nor ``repro``.  Entry
points run on ``device="cuda"`` unless ``HyluOptions(device="cpu")`` asks
for the plain PyTorch path.
"""
from .core import (CSR, HyluOptions, analyze, factor_batched, solve_batched,
                   solve_sequence)

__all__ = ["CSR", "HyluOptions", "analyze", "factor_batched",
           "solve_batched", "solve_sequence"]
