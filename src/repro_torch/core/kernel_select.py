# Copy of src/repro/core/kernel_select.py (numpy only), kept so that repro_torch never
# imports the JAX package.  Keep the two in step.
"""HYLU's smart kernel-selection strategy (§2.1/§2.2).

"The number of floating-point operations is calculated during symbolic
factorization, and supernodes are also detected. HYLU will select the
numerical kernel based on these numbers and other information."

Modes (each is a complete execution plan flavor):

  rowrow      — ordinary up-looking, no supernodes at all (KLU-style).
                Best for extremely sparse matrices (circuits): panels of
                width 1, no padding waste, no TRSM/GEMM overhead.
  hybrid      — the paper's default: fundamental supernodes (+light relaxed
                amalgamation) processed with sup-sup TRSM+GEMM, standalone
                rows with row-row/sup-row updates. One data structure.
  supernodal  — aggressive amalgamation, everything forced into supernodes
                (PARDISO/SuperLU-like); used as internal baseline.

The selector mirrors the paper's statistics: symbolic FLOPs per LU nonzero
(arithmetic intensity), supernode coverage and mean width.
"""
from __future__ import annotations

import dataclasses

from .matrix import CSR
from .symbolic import symbolic_factorize, symbolic_stats, Symbolic


@dataclasses.dataclass
class KernelChoice:
    mode: str            # rowrow | hybrid | supernodal
    relax: int
    max_super: int
    stats: dict
    reason: str


# thresholds (tuned on the synthetic suite; same *shape* as NICSLU/HYLU's
# flops/nnz criterion)
FLOPS_PER_NNZ_ROWROW = 40.0     # below → matrix is circuit-like (NICSLU-style criterion)
COVERAGE_ROWROW = 0.15          # almost no supernode structure
COVERAGE_DENSE = 0.60
FLOPS_PER_NNZ_DENSE = 150.0


def select_kernel(pat_sym: CSR, force_mode: str | None = None,
                  relax: int = 8, max_super: int = 128) -> tuple[KernelChoice, Symbolic]:
    """Run symbolic analysis, compute statistics, pick the kernel mode.

    Returns the choice and the symbolic analysis matching it (rowrow mode
    re-runs symbolic with supernodes disabled so the plan has width-1 nodes).
    """
    sym = symbolic_factorize(pat_sym, relax=relax, max_super=max_super)
    st = symbolic_stats(sym)

    if force_mode is not None:
        mode = force_mode
        reason = "forced"
    elif (st["flops_per_nnz"] < FLOPS_PER_NNZ_ROWROW
            or st["supernode_coverage"] < COVERAGE_ROWROW):
        mode = "rowrow"
        reason = (f"flops/nnz={st['flops_per_nnz']:.1f} "
                  f"coverage={st['supernode_coverage']:.2f} → row-row kernel")
    elif (st["supernode_coverage"] > COVERAGE_DENSE
            and st["flops_per_nnz"] > FLOPS_PER_NNZ_DENSE):
        mode = "hybrid"   # still hybrid: standalone rows keep row kernels
        reason = (f"dense-ish (coverage={st['supernode_coverage']:.2f}) → "
                  f"hybrid with wide supernodes")
    else:
        mode = "hybrid"
        reason = (f"flops/nnz={st['flops_per_nnz']:.1f} "
                  f"coverage={st['supernode_coverage']:.2f} → hybrid kernels")

    if mode == "rowrow":
        sym = symbolic_factorize(pat_sym, relax=0, max_super=1,
                                 do_supernodes=False)
    elif mode == "supernodal":
        sym = symbolic_factorize(pat_sym, relax=max(relax, 16),
                                 max_super=max_super)
    return KernelChoice(mode=mode, relax=relax, max_super=max_super,
                        stats=st, reason=reason), sym
