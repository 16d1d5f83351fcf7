"""Roofline terms of a per-device cost on the NVIDIA H100: the counterpart
of ``src/repro/roofline/analysis.py``, whose constants are a TPU v5e's.

    compute term    = Σ_dtype FLOPs_dtype / peak_dtype
    memory term     = bytes / HBM bandwidth
    collective term = collective bytes / link bandwidth

The counts are per device (``op_cost`` counts one rank's program), so each
term is a per-device quantity over a per-card rate.  MODEL_FLOPS = 6·N·D
(dense) or 6·N_active·D (MoE) for train; 2·N·D for inference steps.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ArchConfig

# NVIDIA H100 SXM (80 GB HBM3), per card
PEAK_FLOPS = {
    # dense bf16 tensor cores, no sparsity (H100 SXM data sheet)
    "bfloat16": 989e12,
    # float32 and float64 outside the tensor cores (data sheet: 67 TFLOP/s
    # FP32, 67 TFLOP/s FP64 tensor core); TF32 off, as the training runs it
    "float32": 67e12,
    "float64": 67e12,
}
HBM_BW = 3.35e12             # bytes/s, HBM3 (H100 SXM data sheet)
# bytes/s per GPU across nodes: one 400 Gb/s NDR InfiniBand NIC per GPU in
# a DGX H100; both production meshes' axes span more than one 8-GPU node,
# so the slowest link sets the pace
LINK_BW = 50e9


def peak_of(dtype: str) -> float:
    """The peak for FLOPs of ``dtype``; integer and other types count at
    the float32 rate."""
    return PEAK_FLOPS.get(dtype, PEAK_FLOPS["float32"])


def compute_seconds(flops_by_dtype: dict) -> float:
    return sum(f / peak_of(dt) for dt, f in flops_by_dtype.items())


def terms(flops_by_dtype: dict, nbytes: float, coll_bytes: float = 0.0):
    """{"compute", "memory", "collective"} seconds and the bottleneck."""
    t = {"compute": compute_seconds(flops_by_dtype),
         "memory": nbytes / HBM_BW, "collective": coll_bytes / LINK_BW}
    return t, max(t, key=t.get)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device quantities counted by op_cost
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_by_kind: dict
    flops_by_dtype: dict
    # terms (seconds)
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float           # 6·N·D (or inference 2·N·D), global
    counted_flops_total: float
    useful_ratio: float          # model_flops / counted_flops_total

    def to_dict(self):
        return dataclasses.asdict(self)


def model_flops(cfg: ArchConfig, shape_kind: str, n_tokens: float) -> float:
    n = cfg.active_param_count()
    if shape_kind == "train":
        return 6.0 * n * n_tokens
    return 2.0 * n * n_tokens


def compute(arch: ArchConfig, shape_name: str, shape_kind: str,
            mesh_name: str, chips: int, cost, n_tokens: float) -> Roofline:
    """The roofline of one cell from its ``op_cost.OpCost``."""
    t, bott = terms(cost.flops, cost.bytes, cost.coll_bytes)
    mf = model_flops(arch, shape_kind, n_tokens)
    total = cost.total_flops * chips
    return Roofline(
        arch=arch.name, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_device=cost.total_flops, bytes_per_device=cost.bytes,
        coll_bytes_per_device=cost.coll_bytes,
        coll_by_kind=dict(cost.coll_by_kind),
        flops_by_dtype=dict(cost.flops),
        t_compute=t["compute"], t_memory=t["memory"],
        t_collective=t["collective"], bottleneck=bott, model_flops=mf,
        counted_flops_total=total,
        useful_ratio=mf / total if total else 0.0)
