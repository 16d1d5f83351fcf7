# Copy of src/repro/core/matching.py (numpy only), kept so that repro_torch never
# imports the JAX package.  Keep the two in step.
"""Static pivoting: maximum-weight bipartite matching + two-sided scaling.

This is the MC64 job (Duff & Koster, "On Algorithms For Permuting Large
Entries to the Diagonal of a Sparse Matrix", SIAM J. Matrix Anal. 2001),
HYLU preprocessing step 1.  We maximize prod |a_{i,sigma(i)}| which is the
assignment problem with costs

    c_ij = log(max_j' |a_ij'|) - log |a_ij|   >= 0        (row-wise maxima)

solved by shortest augmenting paths (Dijkstra) with dual potentials — the
same algorithm family as MC64.  The optimal duals (u, v) give the scaling

    r_i = exp(-u_i) / max_i          s_j = exp(-v_j)

such that B = diag(r) A diag(s) has |b_{i,sigma(i)}| = 1 and |b_ij| <= 1.

A vectorized greedy pre-pass matches the (very common) rows whose maximum
entry sits in an unclaimed column, so well-conditioned circuit matrices cost
O(nnz) here and only degenerate rows pay for Dijkstra.
"""
from __future__ import annotations

import dataclasses
import heapq
import numpy as np

from .matrix import CSR

_BIG = 1e100


@dataclasses.dataclass
class MatchResult:
    col_of_row: np.ndarray   # sigma: row i matched to column sigma[i] (-1 none)
    row_scale: np.ndarray    # r
    col_scale: np.ndarray    # s
    structurally_singular: bool


def _log_costs(a: CSR):
    """c_ij = log(row_max) - log|a_ij|, +inf for (structural) zeros."""
    absval = np.abs(a.data)
    seg = np.repeat(np.arange(a.n), np.diff(a.indptr))
    row_max = np.zeros(a.n)
    np.maximum.at(row_max, seg, absval)
    with np.errstate(divide="ignore"):
        logv = np.where(absval > 0.0, np.log(absval), -_BIG)
        logmax = np.where(row_max > 0.0, np.log(row_max), 0.0)
    return logmax[seg] - logv, logmax


def max_weight_matching(a: CSR) -> MatchResult:
    """MC64-style maximum product matching with dual-based scaling."""
    n = a.n
    cost, row_logmax = _log_costs(a)

    row_of_col = np.full(n, -1, dtype=np.int64)
    col_of_row = np.full(n, -1, dtype=np.int64)
    u = np.zeros(n)  # row duals
    v = np.zeros(n)  # col duals

    # --- greedy pass: claim the cheapest (cost==0 → max-abs) entry per row
    for i in range(n):
        s, e = a.indptr[i], a.indptr[i + 1]
        if s == e:
            continue
        local = np.argmin(cost[s:e])
        j = a.indices[s + local]
        if row_of_col[j] < 0 and cost[s + local] < _BIG / 2:
            col_of_row[i] = j
            row_of_col[j] = i
            u[i] = cost[s + local]  # u_i + v_j == c_ij with v_j = 0

    # --- shortest augmenting path (Dijkstra with potentials) for the rest
    for i0 in range(n):
        if col_of_row[i0] >= 0:
            continue
        dist = np.full(n, np.inf)     # tentative distance per column
        pred_row = np.full(n, -1, dtype=np.int64)
        visited_cols = []
        heap = []
        # relax edges out of i0
        s, e = a.indptr[i0], a.indptr[i0 + 1]
        for t in range(s, e):
            j = int(a.indices[t])
            d = cost[t] - u[i0] - v[j]
            if d < dist[j]:
                dist[j] = d
                pred_row[j] = i0
                heapq.heappush(heap, (d, j))
        final = np.zeros(n, dtype=bool)
        j_end = -1
        while heap:
            d, j = heapq.heappop(heap)
            if final[j] or d > dist[j]:
                continue
            final[j] = True
            visited_cols.append(j)
            if row_of_col[j] < 0:
                j_end = j
                break
            i = int(row_of_col[j])
            s, e = a.indptr[i], a.indptr[i + 1]
            for t in range(s, e):
                j2 = int(a.indices[t])
                if final[j2]:
                    continue
                d2 = d + (cost[t] - u[i] - v[j2])
                if d2 < dist[j2] - 1e-300:
                    dist[j2] = d2
                    pred_row[j2] = i
                    heapq.heappush(heap, (d2, j2))
        if j_end < 0:
            continue  # structurally singular row; leave unmatched
        # update duals (standard JV update)
        d_end = dist[j_end]
        for j in visited_cols:
            if j == j_end:
                continue
            v[j] += dist[j] - d_end
            u[int(row_of_col[j])] -= dist[j] - d_end
        u[i0] += d_end
        # augment along predecessor chain
        j = j_end
        while True:
            i = int(pred_row[j])
            row_of_col[j] = i
            col_of_row[i], j = j, col_of_row[i]
            if j < 0:
                break

    singular = bool(np.any(col_of_row < 0))
    if singular:
        # complete arbitrarily with unused columns so perms stay valid
        free_cols = np.setdiff1d(np.arange(n), col_of_row[col_of_row >= 0])
        col_of_row[col_of_row < 0] = free_cols

    # --- scaling from duals: with invariant c_ij - u_i - v_j >= 0 (== 0 on
    # matched edges) and c_ij = logmax_i - log|a_ij|:
    #   log(r_i s_j |a_ij|) = -(c_ij - u_i - v_j)  for  r_i = e^{u_i - logmax_i},
    #   s_j = e^{v_j}  →  product == 1 on matched edges, <= 1 elsewhere.
    r = np.exp(np.clip(u - row_logmax, -700, 700))
    s = np.exp(np.clip(v, -700, 700))
    # guard: any zero row maxima
    r[~np.isfinite(r)] = 1.0
    s[~np.isfinite(s)] = 1.0
    return MatchResult(col_of_row, r, s, singular)


def apply_static_pivoting(a: CSR, match: MatchResult):
    """Return B = P_match( diag(r) A diag(s) ) with matched entries on the
    diagonal (|diag| == 1 where the matching succeeded), plus the column
    permutation q (B[:, :] = scaled_A[:, q])."""
    scaled = a.scale(match.row_scale, match.col_scale)
    # column permutation: new column k = old column col_of_row[k] would put
    # entry (i, sigma(i)) at (i, i) if we permute columns by sigma:
    q = match.col_of_row.copy()
    b = scaled.permute(np.arange(a.n), q)
    return b, q
