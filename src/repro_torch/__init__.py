"""repro_torch — the PyTorch/CUDA port of the HYLU reproduction.

The JAX package ``repro`` stays the reference; this package runs the same
analysis, the one-system lifecycle (factor → refactor → solve) and the
batched repeated-solve path on an NVIDIA GPU, with the Pallas kernels of
those paths written by hand in CUDA C++ (``repro_torch/csrc``).  It
imports neither JAX nor ``repro``.  Entry
points run on ``device="cuda"`` unless ``HyluOptions(device="cpu")`` asks
for the plain PyTorch path.
"""
from .core import (CSR, FactorState, HyluOptions, analyze, factor,
                   factor_batched, refactor, solve, solve_batched,
                   solve_sequence, solve_system)

__all__ = ["CSR", "FactorState", "HyluOptions", "analyze", "factor",
           "refactor", "solve", "solve_system", "factor_batched",
           "solve_batched", "solve_sequence"]
