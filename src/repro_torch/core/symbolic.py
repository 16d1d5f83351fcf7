# Copy of src/repro/core/symbolic.py (numpy only), kept so that repro_torch never
# imports the JAX package.  Keep the two in step.
"""Symbolic factorization (HYLU preprocessing step 3).

Given the statically-pivoted, reordered matrix B (pattern symmetrized to
B+Bᵀ+I — the discipline of every static-pivoting solver: numeric pivoting is
then restricted to supernode diagonal blocks plus pivot perturbation, so the
symbolic structure "will not change during numerical factorization" exactly
as HYLU §2.1 requires), compute:

  - the elimination tree (Liu's algorithm with path compression),
  - per-row structures of L  (== per-column structures of U transposed),
  - per-column structures of L (== U row structures; supernodes share these),
  - FLOP counts per row/total (drives HYLU's kernel selection),
  - the supernode partition: maximal runs of consecutive rows with identical
    U-structure (fundamental supernodes: parent[j]==j+1 ∧ cc[j]==cc[j+1]+1),
    with optional relaxed amalgamation and a width cap (MXU panel geometry).
"""
from __future__ import annotations

import dataclasses
import numpy as np

from .matrix import CSR


# --------------------------------------------------------------------------
# elimination tree + column counts
# --------------------------------------------------------------------------
def etree(pat: CSR) -> np.ndarray:
    """Elimination tree of a symmetric pattern (diag included), parent[-1]=-1
    for roots. Liu's algorithm with path compression."""
    n = pat.n
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        idx, _ = pat.row(i)
        for j in idx:
            j = int(j)
            if j >= i:
                continue
            # walk from j to the root of its current subtree
            while True:
                a = ancestor[j]
                ancestor[j] = i
                if a < 0:
                    if parent[j] < 0 and j != i:
                        parent[j] = i
                    break
                if a == i:
                    break
                j = a
    return parent


def etree_col_counts(pat: CSR, abort_nnz: float | None = None) -> np.ndarray:
    """Column counts of L (incl. diagonal) via row-subtree walks. O(|L|).
    abort_nnz: stop early once total fill exceeds this budget (ordering
    selection prunes hopeless candidates without paying their full fill)."""
    n = pat.n
    parent = etree(pat)
    mark = np.full(n, -1, dtype=np.int64)
    cc = np.ones(n, dtype=np.int64)  # diagonal
    total = n
    for i in range(n):
        mark[i] = i
        idx, _ = pat.row(i)
        for j in idx:
            j = int(j)
            if j >= i:
                continue
            while j != -1 and mark[j] != i:
                cc[j] += 1          # l_{i,j} is structurally nonzero
                total += 1
                mark[j] = i
                j = int(parent[j])
        if abort_nnz is not None and total > abort_nnz:
            cc[:] = n              # pessimize: candidate is hopeless
            return cc
    return cc


@dataclasses.dataclass
class Symbolic:
    n: int
    parent: np.ndarray            # etree
    # L row structures (strictly below diag), CSR-style:
    lrow_ptr: np.ndarray          # (n+1,)
    lrow_idx: np.ndarray          # column ids, ascending per row
    # L column structures (strictly below diag) == U row structures:
    lcol_ptr: np.ndarray          # (n+1,)
    lcol_idx: np.ndarray          # row ids, ascending per column
    cc: np.ndarray                # |L col j| incl diag
    flops: float                  # total factorization flops (2*cc^2 sum)
    row_flops: np.ndarray         # per-row update flops
    # supernode partition:
    snode_of: np.ndarray          # (n,) node id per row
    snode_start: np.ndarray       # (n_nodes,)
    snode_end: np.ndarray         # (n_nodes,) exclusive
    nnz_l: int

    @property
    def n_nodes(self) -> int:
        return len(self.snode_start)

    def node_rows(self, t: int):
        return int(self.snode_start[t]), int(self.snode_end[t])

    def urow_struct(self, j: int) -> np.ndarray:
        """struct(U row j) beyond the diagonal == struct(L col j)."""
        s, e = self.lcol_ptr[j], self.lcol_ptr[j + 1]
        return self.lcol_idx[s:e]

    def lrow_struct(self, i: int) -> np.ndarray:
        s, e = self.lrow_ptr[i], self.lrow_ptr[i + 1]
        return self.lrow_idx[s:e]


def symbolic_factorize(pat: CSR, relax: int = 8, max_super: int = 128,
                       do_supernodes: bool = True) -> Symbolic:
    """Full symbolic analysis on a symmetric pattern.

    relax: a supernode may absorb its parent run if the union structure adds
           at most `relax` fill rows per column (relaxed amalgamation).
    max_super: supernode width cap (panels are padded to MXU tiles on TPU;
           capping bounds padding waste and VMEM footprint).
    do_supernodes: False → every row is a standalone node (row-row plan).
    """
    n = pat.n
    parent = etree(pat)

    # --- row structures via etree walks; also collect column structures
    mark = np.full(n, -1, dtype=np.int64)
    lrow_lists: list[list[int]] = [None] * n  # type: ignore
    col_counts = np.zeros(n, dtype=np.int64)
    for i in range(n):
        mark[i] = i
        acc: list[int] = []
        idx, _ = pat.row(i)
        for j in idx:
            j = int(j)
            if j >= i:
                continue
            while j != -1 and mark[j] != i:
                acc.append(j)
                mark[j] = i
                j = int(parent[j])
        acc.sort()
        lrow_lists[i] = acc
        col_counts[np.array(acc, dtype=np.int64)] += 1 if acc else 0

    lrow_ptr = np.zeros(n + 1, dtype=np.int64)
    lrow_ptr[1:] = np.cumsum([len(x) for x in lrow_lists])
    lrow_idx = np.concatenate([np.array(x, dtype=np.int64) for x in lrow_lists]) \
        if lrow_ptr[-1] else np.empty(0, np.int64)

    # --- column structures by bucketing rows (ascending row id per col)
    lcol_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(lcol_ptr, lrow_idx + 1, 1)
    lcol_ptr = np.cumsum(lcol_ptr)
    lcol_idx = np.empty(lrow_ptr[-1], dtype=np.int64)
    fill_pos = lcol_ptr[:-1].copy()
    rows_of = np.repeat(np.arange(n), np.diff(lrow_ptr))
    for k in range(len(lrow_idx)):      # rows visited ascending → sorted cols
        j = lrow_idx[k]
        lcol_idx[fill_pos[j]] = rows_of[k]
        fill_pos[j] += 1

    cc = np.diff(lcol_ptr) + 1          # incl diagonal
    # per-row update flops: row i costs sum over j in lrow(i) of 2*|U row j ∩ (j, n)|
    urow_len = np.diff(lcol_ptr)        # |struct(U row j)| beyond diag
    row_flops = np.zeros(n, dtype=np.float64)
    if len(lrow_idx):
        np.add.at(row_flops, rows_of, 2.0 * (urow_len[lrow_idx] + 1))
    flops = float(row_flops.sum())

    # --- supernodes
    if do_supernodes:
        snode_start, snode_end = _detect_supernodes(
            parent, cc, n, relax=relax, max_super=max_super,
            lcol_ptr=lcol_ptr, lcol_idx=lcol_idx)
    else:
        snode_start = np.arange(n, dtype=np.int64)
        snode_end = snode_start + 1
    snode_of = np.zeros(n, dtype=np.int64)
    for t in range(len(snode_start)):
        snode_of[snode_start[t]:snode_end[t]] = t

    return Symbolic(n=n, parent=parent, lrow_ptr=lrow_ptr, lrow_idx=lrow_idx,
                    lcol_ptr=lcol_ptr, lcol_idx=lcol_idx, cc=cc, flops=flops,
                    row_flops=row_flops, snode_of=snode_of,
                    snode_start=np.asarray(snode_start, dtype=np.int64),
                    snode_end=np.asarray(snode_end, dtype=np.int64),
                    nnz_l=int(lrow_ptr[-1]))


def _detect_supernodes(parent, cc, n, relax, max_super, lcol_ptr, lcol_idx):
    """Fundamental supernodes + relaxed amalgamation + width cap."""
    starts = [0]
    for j in range(1, n):
        fundamental = (parent[j - 1] == j) and (cc[j - 1] == cc[j] + 1)
        width = j - starts[-1]
        if fundamental and width < max_super:
            continue
        # relaxed amalgamation: allow tiny structure mismatch
        if (relax > 0 and parent[j - 1] == j and width < max_super
                and 0 <= cc[j - 1] - cc[j] - 1 <= relax
                and width <= 4 * relax):
            continue
        starts.append(j)
    starts = np.array(starts, dtype=np.int64)
    ends = np.append(starts[1:], n)
    return starts, ends


# --------------------------------------------------------------------------
# statistics (drive kernel selection)
# --------------------------------------------------------------------------
def symbolic_stats(sym: Symbolic) -> dict:
    widths = (sym.snode_end - sym.snode_start)
    in_super = widths[widths >= 2].sum()
    nnz_lu = 2 * sym.nnz_l + sym.n
    return dict(
        n=sym.n,
        nnz_l=sym.nnz_l,
        nnz_lu=nnz_lu,
        flops=sym.flops,
        flops_per_nnz=sym.flops / max(nnz_lu, 1),
        n_nodes=sym.n_nodes,
        n_supernodes=int((widths >= 2).sum()),
        supernode_coverage=float(in_super) / max(sym.n, 1),
        mean_supernode_width=float(widths[widths >= 2].mean()) if (widths >= 2).any() else 0.0,
        mean_urow_len=float(np.diff(sym.lcol_ptr).mean()) if sym.n else 0.0,
    )
