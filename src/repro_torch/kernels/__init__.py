"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors; ``launch_counts`` / ``reset_launch_counts`` read
and clear the per-wrapper launch counters (a run proves it went through the
kernels by its counts)."""
from __future__ import annotations

from .panel import ops as panel_ops
from .suprow import ops as suprow_ops
from .supsup import ops as supsup_ops
from .trisolve import ops as trisolve_ops

#: wrapper name → wrapper, for every kernel entry point (``suprow_update``
#: has no caller on an engine path, as in the JAX package)
WRAPPERS = {
    "panel_lu_batched": panel_ops.panel_lu_batched,
    "panel_lu": panel_ops.panel_lu,
    "trsm_batched": trisolve_ops.trsm_batched,
    "trsm_left_unit_lower_batched": trisolve_ops.trsm_left_unit_lower_batched,
    "trsm_left_upper_batched": trisolve_ops.trsm_left_upper_batched,
    "gemm_batched": supsup_ops.gemm_batched,
    "gemm_update": supsup_ops.gemm_update,
    "suprow_update": suprow_ops.suprow_update,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
