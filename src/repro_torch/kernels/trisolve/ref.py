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


# The bfloat16 solves with every sum taken in the sweep's order: ascending
# unknowns (descending for U w = b), each product of two bfloat16 values
# (exact in float32) added to a float32 sum as it is solved.  The rounding
# points are the plain versions' above: v = bf16(x - bf16(S)), then
# bf16(v / d).  Each step is elementwise, so the bits do not depend on the
# device: the card's bfloat16 kernels (csrc/trsm.cu) take their sums in
# this order and are held to these versions bit for bit.  The plain
# versions above sum each dot in the order their einsum takes, which on
# the card is cuBLAS's; where x - bf16(S) cancels, one ulp of S is many
# ulps of the result.


def _bf16(t):
    return t.to(torch.bfloat16).float()


def trsm_bf16_ordered(u: torch.Tensor, x: torch.Tensor,
                      unit_diag: bool = False) -> torch.Tensor:
    """:func:`trsm_plain` in bfloat16, summed in the sweep's order."""
    k = u.shape[-1]
    s = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    for j in range(k):
        v = _bf16(x[..., j].float() - _bf16(s[..., j]))
        if not unit_diag:
            v = _bf16(v / u[:, j, j].float()[:, None])
        y[..., j] = v.to(x.dtype)
        s[..., j + 1:] += v[..., None] * u[:, None, j, j + 1:].float()
    return y


def trsm_left_unit_lower_bf16_ordered(blk: torch.Tensor,
                                      b: torch.Tensor) -> torch.Tensor:
    """:func:`trsm_left_unit_lower_plain` in bfloat16, summed in the
    sweep's order."""
    s = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
    w = torch.empty_like(b)
    for j in range(blk.shape[-1]):
        v = _bf16(b[:, j].float() - _bf16(s[:, j]))
        w[:, j] = v.to(b.dtype)
        s[:, j + 1:] += blk[:, j + 1:, j, None].float() * v[:, None]
    return w


def trsm_left_upper_bf16_ordered(blk: torch.Tensor,
                                 b: torch.Tensor) -> torch.Tensor:
    """:func:`trsm_left_upper_plain` in bfloat16, summed in the sweep's
    (descending) order."""
    s = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
    w = torch.empty_like(b)
    for j in range(blk.shape[-1] - 1, -1, -1):
        v = _bf16(b[:, j].float() - _bf16(s[:, j]))
        v = _bf16(v / blk[:, j, j].float()[:, None])
        w[:, j] = v.to(b.dtype)
        s[:, :j] += blk[:, :j, j, None].float() * v[:, None]
    return w
