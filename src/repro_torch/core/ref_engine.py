# Copy of src/repro/core/ref_engine.py (numpy only), kept so that repro_torch never
# imports the JAX package.  Keep the two in step.
"""Reference numeric engine (numpy, float64).

Executes a FactorPlan exactly as the JAX/Pallas engine does (same panels,
same edge semantics, same pivoting) but in plain vectorized numpy.  Serves
as (a) the correctness oracle for the JAX engine and every Pallas kernel,
and (b) the measurable CPU engine for the paper-figure benchmarks.

The three hybrid kernels appear here as shape specializations of one edge
update (see plan.py): k==1 → row-row / sup-row (divide + axpy/GEMV),
k>1 → sup-sup (TRSM + GEMM).
"""
from __future__ import annotations

import dataclasses
import numpy as np

from .matrix import CSR
from .plan import FactorPlan

__all__ = ["Factors", "SolvePlan", "LevelSched", "factor", "refactor",
           "factor_value_loop", "extract_lu", "build_solve_plan", "solve_lu"]


@dataclasses.dataclass
class Factors:
    plan: FactorPlan
    vals: np.ndarray           # flat panel values
    inode_perm: np.ndarray     # (n,) factored row g holds original row inode_perm[g]
    n_perturb: int
    perturb_eps: float         # relative threshold used (× max|B|)


def _trsm_upper(u: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Solve Y @ U = X for Y, with U (k,k) upper-triangular (non-unit diag).
    Vectorized over the rows of X. k is a supernode width (small)."""
    k = u.shape[0]
    y = np.empty_like(x)
    for j in range(k):
        y[:, j] = (x[:, j] - y[:, :j] @ u[:j, j]) / u[j, j]
    return y


def factor(plan: FactorPlan, b: CSR,
           perturb_eps: float | None = 1e-8) -> Factors:
    """Numeric factorization. b is the preprocessed matrix (scaled, matched,
    reordered); its max |entry| is ~1 after MC64 scaling, so the pivot
    perturbation threshold is perturb_eps * max|B| ≈ perturb_eps.
    ``perturb_eps=None`` (the HyluOptions dtype-aware sentinel) resolves to
    the fp64 literal 1e-8 — this engine is float64-only."""
    if perturb_eps is None:
        perturb_eps = 1e-8
    vals = np.zeros(plan.total_slots, dtype=np.float64)
    vals[plan.a_scatter] = b.data
    amax = float(np.max(np.abs(b.data))) if b.nnz else 1.0
    eps_p = perturb_eps * amax
    inode_perm = np.arange(plan.n, dtype=np.int64)
    n_perturb = 0

    for nd in plan.nodes:
        off = plan.panel_offset[nd.nid]
        nr, w = nd.nr, nd.width
        panel = vals[off:off + nr * w].reshape(nr, w)
        # ---------------- edge updates (ascending source) ------------------
        for e in nd.edges:
            snd = plan.nodes[e.src]
            soff = plan.panel_offset[snd.nid]
            sp = vals[soff:soff + snd.nr * snd.width].reshape(snd.nr, snd.width)
            src = sp[:, snd.lsize:]                    # (k, k+m)
            k = snd.nr
            x = panel[:, e.col_map]                    # gather (nr, k+m)
            if k == 1:
                lts = x[:, :1] / src[0, 0]             # row-row / sup-row
                x = x[:, 1:] - lts * src[:, 1:]
                panel[:, e.col_map[:1]] = lts
                panel[:, e.col_map[1:]] = x
            else:
                lts = _trsm_upper(src[:, :k], x[:, :k])  # sup-sup: TRSM
                xr = x[:, k:] - lts @ src[:, k:]         #          GEMM
                panel[:, e.col_map[:k]] = lts
                panel[:, e.col_map[k:]] = xr
        # ---------------- internal factorization (diag-block pivoting) -----
        ls = nd.lsize
        blk = panel[:, ls:ls + nr]                     # view
        for j in range(nr):
            p = j + int(np.argmax(np.abs(blk[j:, j])))
            if p != j:                                 # supernode diagonal pivoting
                panel[[j, p]] = panel[[p, j]]
                gj, gp = nd.r0 + j, nd.r0 + p
                inode_perm[gj], inode_perm[gp] = inode_perm[gp], inode_perm[gj]
            piv = blk[j, j]
            if abs(piv) < eps_p:                       # pivot perturbation
                piv = eps_p if piv >= 0 else -eps_p
                blk[j, j] = piv
                n_perturb += 1
            if j + 1 < nr:
                l = blk[j + 1:, j] / piv
                blk[j + 1:, j] = l
                panel[j + 1:, ls + j + 1:] -= np.outer(l, panel[j, ls + j + 1:])
        vals[off:off + nr * w] = panel.reshape(-1)
    return Factors(plan=plan, vals=vals, inode_perm=inode_perm,
                   n_perturb=n_perturb, perturb_eps=eps_p)


# --------------------------------------------------------------------------
# L/U extraction (also defines the static solve structure)
# --------------------------------------------------------------------------
def extract_lu(f: Factors) -> tuple[CSR, CSR]:
    """Assemble CSR L (unit diagonal stored) and U from the panels.
    Row/column ids are in the *factored* ordering (panel positions)."""
    plan = f.plan
    lr, lc, lv = [], [], []
    ur, uc, uv = [], [], []
    for nd in plan.nodes:
        off = plan.panel_offset[nd.nid]
        nr, w, ls = nd.nr, nd.width, nd.lsize
        panel = f.vals[off:off + nr * w].reshape(nr, w)
        pat = nd.pattern
        for q in range(nr):
            g = nd.r0 + q
            # L: cols < r0 (panel prefix) + in-block strictly lower + unit diag
            lr.extend([g] * ls); lc.extend(pat[:ls].tolist())
            lv.extend(panel[q, :ls].tolist())
            lr.extend([g] * q); lc.extend(range(nd.r0, nd.r0 + q))
            lv.extend(panel[q, ls:ls + q].tolist())
            lr.append(g); lc.append(g); lv.append(1.0)
            # U: diag + in-block strictly upper + suffix
            cols_u = list(range(g, nd.r0 + nr)) + pat[ls + nr:].tolist()
            vals_u = panel[q, ls + q:].tolist()
            ur.extend([g] * len(cols_u)); uc.extend(cols_u); uv.extend(vals_u)
    n = plan.n
    l = CSR.from_coo(n, lr, lc, lv, sum_dup=False)
    u = CSR.from_coo(n, ur, uc, uv, sum_dup=False)
    return l, u


# --------------------------------------------------------------------------
# refactorization (repeated-solve path): same pattern, new values
# --------------------------------------------------------------------------
def refactor(f: Factors, b_new: CSR) -> Factors:
    """HYLU's repeated-solve optimization: the entire analysis (plan) is
    reused; only the numeric phase runs. b_new must share b's pattern."""
    return factor(f.plan, b_new, perturb_eps=f.perturb_eps)


def factor_value_loop(plan: FactorPlan, pattern: tuple, m_data_batch,
                      perturb_eps: float = 1e-8) -> list:
    """K independent factorizations of one pattern, as a Python loop.

    pattern is (indptr, indices) of the preprocessed matrix M; m_data_batch
    is (K, nnz).  This is the looped-reference baseline that the batched JAX
    path (jax_engine.RepeatedSolveEngine.refactor_batched) is measured
    against, and the parity oracle for its results."""
    indptr, indices = pattern
    return [factor(plan, CSR(plan.n, indptr, indices, np.asarray(d)),
                   perturb_eps=perturb_eps)
            for d in m_data_batch]


# --------------------------------------------------------------------------
# level-scheduled triangular solves (paper §2.3, dual-mode bulk/sequential)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class LevelSched:
    """Flattened per-level schedule for one triangular solve.

    Per level k: rows[k] (the unknowns finalized this level), and the
    flattened dependency lists cols[k]/vals[k]/seg[k] (seg maps each nnz to
    its position within rows[k]).  Wide levels = bulk mode (one vectorized
    gather+bincount per level); narrow levels form the sequential tail —
    the paper's bulk-sequential dual mode."""
    rows: list
    cols: list
    vals: list
    seg: list
    n_bulk: int


@dataclasses.dataclass
class SolvePlan:
    n: int
    l_sched: LevelSched
    u_sched: LevelSched
    u_diag: np.ndarray


def build_solve_plan(f: Factors, bulk_min_width: int = 8) -> SolvePlan:
    l, u = extract_lu(f)
    n = l.n
    # strip unit diag from L
    li, lx, lp = [], [], [0]
    for i in range(n):
        idx, val = l.row(i)
        keep = idx != i
        li.append(idx[keep]); lx.append(val[keep]); lp.append(lp[-1] + keep.sum())
    l_indptr = np.array(lp, dtype=np.int64)
    l_indices = np.concatenate(li) if n else np.empty(0, np.int64)
    l_vals = np.concatenate(lx) if n else np.empty(0)
    # split U diag
    u_diag = np.empty(n)
    ui, ux, up = [], [], [0]
    for i in range(n):
        idx, val = u.row(i)
        dmask = idx == i
        u_diag[i] = val[dmask][0]
        keep = ~dmask
        ui.append(idx[keep]); ux.append(val[keep]); up.append(up[-1] + keep.sum())
    u_indptr = np.array(up, dtype=np.int64)
    u_indices = np.concatenate(ui) if n else np.empty(0, np.int64)
    u_vals = np.concatenate(ux) if n else np.empty(0)

    def sched_of(indptr, indices, vals, reverse=False) -> LevelSched:
        lev = np.zeros(n, dtype=np.int64)
        rng = range(n - 1, -1, -1) if reverse else range(n)
        for i in rng:
            s, e = indptr[i], indptr[i + 1]
            if e > s:
                lev[i] = 1 + lev[indices[s:e]].max()
        nl = int(lev.max()) + 1 if n else 0
        rows_l, cols_l, vals_l, seg_l = [], [], [], []
        n_bulk = 0
        for k in range(nl):
            rows = np.where(lev == k)[0]
            cnt = (indptr[rows + 1] - indptr[rows]).astype(np.int64)
            seg = np.repeat(np.arange(len(rows)), cnt)
            take = np.concatenate([np.arange(indptr[i], indptr[i + 1])
                                   for i in rows]) if cnt.sum() else np.empty(0, np.int64)
            rows_l.append(rows)
            cols_l.append(indices[take])
            vals_l.append(vals[take])
            seg_l.append(seg)
            if len(rows) >= bulk_min_width:
                n_bulk += 1
        return LevelSched(rows_l, cols_l, vals_l, seg_l, n_bulk)

    l_sched = sched_of(l_indptr, l_indices, l_vals)
    u_sched = sched_of(u_indptr, u_indices, u_vals, reverse=True)
    return SolvePlan(n, l_sched, u_sched, u_diag)


def solve_lu(sp: SolvePlan, c: np.ndarray) -> np.ndarray:
    """Solve L U w = c with level-scheduled substitution (one vectorized
    gather + bincount per level — bulk mode; narrow levels are the
    sequential tail, matching the paper's bulk-sequential dual mode)."""
    y = c.astype(np.float64).copy()
    ls = sp.l_sched
    for rows, cols, vals, seg in zip(ls.rows, ls.cols, ls.vals, ls.seg):
        if len(cols):
            acc = np.bincount(seg, weights=vals * y[cols], minlength=len(rows))
            y[rows] -= acc
    w = y
    us = sp.u_sched
    for rows, cols, vals, seg in zip(us.rows, us.cols, us.vals, us.seg):
        if len(cols):
            acc = np.bincount(seg, weights=vals * w[cols], minlength=len(rows))
            w[rows] = (w[rows] - acc) / sp.u_diag[rows]
        else:
            w[rows] = w[rows] / sp.u_diag[rows]
    return w
