"""Differentiable sparse solve: ``x = A(a_data)⁻¹ b`` with its adjoint.

Adapted from ``src/repro/core/autodiff.py`` (``make_sparse_solve``, a
``jax.custom_vjp``) as a ``torch.autograd.Function``.  The forward pass is
the engine's one-system ``refactor`` (on the card, K1–K4 under the
bucketed schedule) and ``apply``; the backward pass reuses those factors
for the transpose solve (``lut_solve``), so a training step through the
solver pays one factorization and two pairs of triangular solves:

    b̄        = A⁻ᵀ x̄
    ā_(i,j)  = −(A⁻ᵀ x̄)_i · x_j          (one gather per nonzero)

``b`` is (n,) or (n, m): the columns of an (n, m) right-hand side are
solved together (the JAX tests ``vmap`` over them), and ā sums over them.
"""
from __future__ import annotations

import numpy as np
import torch

from .analysis import Analysis, torch_repeated_engine
from .options import dtype_name


def _original_coords(an: Analysis):
    """(rows, cols) of each nonzero of the original A, by inverting
    ``src_map``: M's entry e is A's entry ``src_map[e]``; M's row i is B2's
    row ``p[i]`` (B2 = A with its columns permuted by q), which is A's row,
    and M's column j is A's column ``q[p[j]]`` (``autodiff.py:74–91``)."""
    indptr, indices = an.m_pattern
    n, nnz = an.n, len(an.src_map)
    m_rows = np.repeat(np.arange(n), np.diff(indptr))
    rows = np.empty(nnz, np.int64)
    cols = np.empty(nnz, np.int64)
    rows[an.src_map] = an.p[m_rows]
    cols[an.src_map] = an.q[an.p[np.asarray(indices)]]
    return rows, cols


def make_sparse_solve(an: Analysis, dtype=torch.float64, device=None,
                      use_kernels=None):
    """The differentiable solver of ``an``'s sparsity pattern:
    ``f(a_data, b) -> x`` with a_data (nnz,) the values of A in the
    original pattern and b (n,) or (n, m), tensors on any device (they are
    moved to the engine's, and the gradients come back to theirs).
    ``dtype`` is the factor and solve precision; ``device`` (default
    ``an.opts.device``) and ``use_kernels`` (default
    ``an.opts.use_kernels``) choose the engine, as
    :func:`~repro_torch.core.analysis.torch_repeated_engine` does."""
    name = dtype_name(dtype)
    eng = torch_repeated_engine(an, dtype=name, refine_dtype=name,
                                device=device, use_kernels=use_kernels)
    dev, dt = eng.device, eng.dtype
    p = torch.from_numpy(np.asarray(an.p, np.int64)).to(dev)
    q = torch.from_numpy(np.asarray(an.q, np.int64)).to(dev)
    r = torch.as_tensor(np.asarray(an.match.row_scale, np.float64),
                        device=dev).to(dt)
    s = torch.as_tensor(np.asarray(an.match.col_scale, np.float64),
                        device=dev).to(dt)
    rows, cols = (torch.from_numpy(a).to(dev) for a in _original_coords(an))
    n = an.n

    class SparseSolve(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a_data, b):
            f = eng.refactor(a_data.to(dt))
            x = eng.apply(f.vals, f.inode_perm, b.to(dt))
            ctx.save_for_backward(f.vals, f.inode_perm, x)
            return x

        @staticmethod
        def backward(ctx, g):
            vals, inode, x = ctx.saved_tensors
            multi = g.ndim == 2
            sc = s[:, None] if multi else s
            t = (sc * g.to(dt))[q][p]
            t = eng.lut_solve(vals, t)
            z = torch.zeros_like(t)
            z[inode] = t
            y = torch.zeros_like(t)
            y[p] = z
            lam = (r[:, None] if multi else r) * y
            a_bar = b_bar = None
            if ctx.needs_input_grad[0]:
                a_bar = -(lam[rows] * x[cols])
                a_bar = a_bar.sum(dim=1) if multi else a_bar
            if ctx.needs_input_grad[1]:
                b_bar = lam
            return a_bar, b_bar

    def sparse_solve(a_data: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """x solving A(a_data) x = b; differentiable in a_data and b."""
        if a_data.shape != (len(an.src_map),) or b.shape[0] != n \
                or b.ndim not in (1, 2):
            raise ValueError(f"need a_data ({len(an.src_map)},) and b "
                             f"({n},) or ({n}, m), got "
                             f"{tuple(a_data.shape)} and {tuple(b.shape)}")
        return SparseSolve.apply(a_data.to(dev), b.to(dev))

    return sparse_solve
