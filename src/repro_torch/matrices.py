"""Seeded matrix generators the port's smoke run needs: copies of
``fem2d`` and ``circuit_like`` from ``benchmarks/matrices.py`` (which
imports the JAX package, so the port keeps its own).  Same seeds give the
same matrices."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .core.matrix import CSR


def _laplacian_of_edges(n, rows, cols, vals, diag_jitter, rng):
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    a = a + a.T
    d = np.abs(a).sum(axis=1).A.ravel() + rng.uniform(0.1, 1.0, n) * diag_jitter
    return (sp.diags(d) - a).tocsr()


def circuit_like(n, seed, avg_deg=3.0, locality=16, long_frac=0.005):
    """Local circuit-netlist graph Laplacian plus a few long wires."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg / 2)
    rows = rng.integers(0, n, m)
    delta = rng.geometric(1.0 / locality, m)
    cols = np.clip(rows + rng.choice([-1, 1], m) * delta, 0, n - 1)
    ml = int(m * long_frac)
    rows = np.concatenate([rows, rng.integers(0, n, ml)])
    cols = np.concatenate([cols, rng.integers(0, n, ml)])
    vals = rng.uniform(0.1, 10.0, len(rows))
    keep = rows != cols
    return _laplacian_of_edges(n, rows[keep], cols[keep], vals[keep], 1.0, rng)


def fem2d(nx, ny, seed=0):
    """5-point Poisson stencil on an nx × ny grid plus a diagonal jitter."""
    rng = np.random.default_rng(seed)
    ex = np.ones(nx)
    ey = np.ones(ny)
    tx = sp.diags([-ex[:-1], 2 * ex, -ex[:-1]], [-1, 0, 1])
    ty = sp.diags([-ey[:-1], 2 * ey, -ey[:-1]], [-1, 0, 1])
    a = sp.kronsum(tx, ty).tocsr()
    a = a + sp.diags(rng.uniform(0.0, 0.1, a.shape[0]))
    return a


def to_csr(a) -> CSR:
    """A scipy matrix as the port's CSR, indices sorted (as the corpus
    loader of the benchmarks does)."""
    a = a.tocsr()
    a.sort_indices()
    return CSR.from_scipy(a)
