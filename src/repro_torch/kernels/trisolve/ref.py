"""Plain PyTorch versions of the triangular solves (the counterparts of
``src/repro/kernels/trisolve/ref.py``), batched over a leading dim."""
from __future__ import annotations

import torch


def trsm_plain(u: torch.Tensor, x: torch.Tensor,
               unit_diag: bool = False) -> torch.Tensor:
    """Solve Y @ U = X: u (B, k, k) upper-triangular (only the upper
    triangle is read), x (B, nr, k)."""
    k = u.shape[-1]
    y = torch.zeros_like(x)
    for j in range(k):
        acc = x[..., j] - torch.einsum("bnk,bk->bn", y[..., :j], u[:, :j, j])
        if not unit_diag:
            acc = acc / u[:, j, j][:, None]
        y[..., j] = acc
    return y


def trsm_left_unit_lower_plain(blk: torch.Tensor,
                               b: torch.Tensor) -> torch.Tensor:
    """Solve L w = b with L = tril(blk, -1) + I: blk (B, k, k), b (B, k, m)."""
    w = torch.zeros_like(b)
    for j in range(blk.shape[-1]):
        w[:, j] = b[:, j] - torch.einsum("bk,bkm->bm", blk[:, j, :j],
                                         w[:, :j])
    return w


def trsm_left_upper_plain(blk: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve U w = b with U = triu(blk): blk (B, k, k), b (B, k, m)."""
    k = blk.shape[-1]
    w = torch.zeros_like(b)
    for j in range(k - 1, -1, -1):
        acc = b[:, j] - torch.einsum("bk,bkm->bm", blk[:, j, j + 1:],
                                     w[:, j + 1:])
        w[:, j] = acc / blk[:, j, j][:, None]
    return w
