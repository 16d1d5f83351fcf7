# Copy of src/repro/core/matrix.py (numpy only), kept so that repro_torch never
# imports the JAX package.  Keep the two in step.
"""Host-side sparse matrix container (CSR) used by the analysis phase.

All preprocessing (matching, ordering, symbolic factorization) is host/graph
work and runs in numpy — this mirrors production TPU deployments where the
analysis phase runs on the host CPU and only the numeric phase runs on the
accelerator.
"""
from __future__ import annotations

import dataclasses
import numpy as np


@dataclasses.dataclass
class CSR:
    """Compressed-sparse-row matrix. indices within each row are sorted."""

    n: int
    indptr: np.ndarray   # (n+1,) int64
    indices: np.ndarray  # (nnz,) int32/int64, sorted per row
    data: np.ndarray     # (nnz,) float64

    # ---------------------------------------------------------------- build
    @staticmethod
    def from_coo(n: int, rows, cols, vals, sum_dup: bool = True) -> "CSR":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_dup and len(rows):
            key = rows * n + cols
            uniq, inv = np.unique(key, return_inverse=True)
            out = np.zeros(len(uniq), dtype=np.float64)
            np.add.at(out, inv, vals)
            rows, cols, vals = uniq // n, uniq % n, out
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return CSR(n, indptr, cols.astype(np.int64), vals)

    @staticmethod
    def from_dense(a: np.ndarray) -> "CSR":
        a = np.asarray(a, dtype=np.float64)
        n = a.shape[0]
        rows, cols = np.nonzero(a)
        return CSR.from_coo(n, rows, cols, a[rows, cols], sum_dup=False)

    @staticmethod
    def from_scipy(a) -> "CSR":
        a = a.tocsr()
        a.sort_indices()
        return CSR(a.shape[0], a.indptr.astype(np.int64),
                   a.indices.astype(np.int64), a.data.astype(np.float64))

    # ---------------------------------------------------------------- props
    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def row(self, i: int):
        s, e = self.indptr[i], self.indptr[i + 1]
        return self.indices[s:e], self.data[s:e]

    def to_dense(self) -> np.ndarray:
        a = np.zeros((self.n, self.n))
        for i in range(self.n):
            idx, val = self.row(i)
            a[i, idx] = val
        return a

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix((self.data, self.indices, self.indptr),
                             shape=(self.n, self.n))

    def matvec(self, x: np.ndarray) -> np.ndarray:
        seg = np.repeat(np.arange(self.n), np.diff(self.indptr))
        out = np.zeros(self.n)
        np.add.at(out, seg, self.data * x[self.indices])
        return out

    # ----------------------------------------------------------- transforms
    def transpose(self) -> "CSR":
        seg = np.repeat(np.arange(self.n), np.diff(self.indptr))
        return CSR.from_coo(self.n, self.indices, seg, self.data, sum_dup=False)

    def permute(self, p_row: np.ndarray, p_col: np.ndarray) -> "CSR":
        """Return B with B[i, j] = A[p_row[i], p_col[j]]."""
        inv_col = np.empty(self.n, dtype=np.int64)
        inv_col[p_col] = np.arange(self.n)
        seg = np.repeat(np.arange(self.n), np.diff(self.indptr))
        inv_row = np.empty(self.n, dtype=np.int64)
        inv_row[p_row] = np.arange(self.n)
        return CSR.from_coo(self.n, inv_row[seg], inv_col[self.indices],
                            self.data, sum_dup=False)

    def scale(self, dr: np.ndarray, dc: np.ndarray) -> "CSR":
        """Return diag(dr) @ A @ diag(dc)."""
        seg = np.repeat(np.arange(self.n), np.diff(self.indptr))
        return CSR(self.n, self.indptr.copy(), self.indices.copy(),
                   self.data * dr[seg] * dc[self.indices])

    def sym_pattern(self) -> "CSR":
        """Pattern of A + A^T + I (data = 1.0)."""
        seg = np.repeat(np.arange(self.n), np.diff(self.indptr))
        rows = np.concatenate([seg, self.indices, np.arange(self.n)])
        cols = np.concatenate([self.indices, seg, np.arange(self.n)])
        return CSR.from_coo(self.n, rows, cols, np.ones(len(rows)), sum_dup=True)
