"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors; ``launch_counts`` / ``reset_launch_counts`` read
and clear the per-wrapper launch counters (a run proves it went through the
kernels by its counts)."""
from __future__ import annotations

from .flashattn import ops as flashattn_ops
from .panel import ops as panel_ops
from .suprow import ops as suprow_ops
from .supsup import ops as supsup_ops
from .trisolve import ops as trisolve_ops
from .wkv import ops as wkv_ops

#: wrapper name → wrapper, for every kernel entry point (``suprow_update``
#: and ``suprow_update_grouped`` have no caller on an engine path, as in
#: the JAX package;
#: ``panel_lu_batched`` none in the engine, which runs K1 in place;
#: the ``*_wide`` entries are K1's, K2's and K3's paths
#: for supernodes of more than 128 rows, which the engine reaches through
#: the entry above each;
#: ``gemm_update`` none since the unrolled schedule runs K5 as one
#: ``node_edges_inplace`` launch per node, ``node_edges_wide`` for a node
#: with an edge source of more than 128 rows; ``flash_attention`` and
#: ``wkv`` run in the models' prefill)
WRAPPERS = {
    "panel_lu_bucket_inplace": panel_ops.panel_lu_bucket_inplace,
    "panel_lu_bucket_wide": panel_ops.panel_lu_bucket_wide,
    "panel_lu_batched": panel_ops.panel_lu_batched,
    "panel_lu": panel_ops.panel_lu,
    "panel_lu_wide": panel_ops.panel_lu_wide,
    "trsm_batched": trisolve_ops.trsm_batched,
    "trsm_right_wide": trisolve_ops.trsm_right_wide,
    "trsm_left_unit_lower_batched": trisolve_ops.trsm_left_unit_lower_batched,
    "trsm_left_unit_lower_wide": trisolve_ops.trsm_left_unit_lower_wide,
    "trsm_left_upper_batched": trisolve_ops.trsm_left_upper_batched,
    "trsm_left_upper_wide": trisolve_ops.trsm_left_upper_wide,
    "gemm_batched": supsup_ops.gemm_batched,
    "gemm_update": supsup_ops.gemm_update,
    "node_edges_inplace": supsup_ops.node_edges_inplace,
    "node_edges_wide": supsup_ops.node_edges_wide,
    "suprow_update": suprow_ops.suprow_update,
    "suprow_update_grouped": suprow_ops.suprow_update_grouped,
    "flash_attention": flashattn_ops.flash_attention,
    "wkv": wkv_ops.wkv,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
