"""Plain PyTorch version of the panel LU kernels (the counterpart of
``src/repro/kernels/panel/ref.py``): a batch of dense LUs with partial
pivoting restricted to the diagonal block and pivot perturbation.

One loop serves both kernels: the diagonal block starts at column ``c0``
(0 for the column-reordered bucket panels, ``lsize`` for a node panel)
and the elimination runs over the columns ``(c0 + j, wlim)`` (``wu`` for a
bucket, the panel width for a node); every other column is only
row-swapped.  ``eps`` is one threshold per panel."""
from __future__ import annotations

import torch


def panel_lu_plain(panels: torch.Tensor, c0: int, wlim: int,
                   eps: torch.Tensor):
    """panels (B, nr, wt), eps (B,) → (panels, perm (B, nr) int32,
    n_perturb (B,) int32).  Pivot ties go to the lowest row and NaN counts
    as the largest magnitude, as ``jnp.argmax`` does."""
    P = panels.clone()
    B, nr, wt = P.shape
    dev = P.device
    rows = torch.arange(nr, device=dev)
    cols = torch.arange(wt, device=dev)
    bidx = torch.arange(B, device=dev)
    perm = rows.to(torch.int32).expand(B, nr).clone()
    nper = torch.zeros(B, dtype=torch.int32, device=dev)
    eps = eps.to(P.dtype)
    for j in range(nr):
        pc = c0 + j
        cand = torch.where(rows[None, :] >= j, P[:, :, pc].abs(),
                           torch.full((), -1.0, dtype=P.dtype, device=dev))
        p = torch.argmax(cand, dim=1)
        swap = rows.expand(B, nr).clone()
        swap[:, j] = p
        swap[bidx, p] = j                  # p == j leaves the identity
        P = torch.gather(P, 1, swap[:, :, None].expand(B, nr, wt))
        perm = torch.gather(perm, 1, swap)
        piv = P[:, j, pc]
        small = piv.abs() < eps
        piv = torch.where(small, torch.where(piv >= 0, eps, -eps), piv)
        P[:, j, pc] = piv
        nper += small.to(torch.int32)
        # the masks are selects, as XLA runs the Pallas kernels' mask
        # products: a non-finite multiplier or pivot-row entry then spreads
        # NaN exactly as there (0 · inf), nowhere else
        l = torch.where(rows[None, :] > j, P[:, :, pc] / piv[:, None], 0.0)
        urow = torch.where(((cols > pc) & (cols < wlim))[None], P[:, j, :],
                           0.0)
        P = P - l[:, :, None] * urow[:, None, :]
        P[:, :, pc] = torch.where(rows[None, :] > j, l, P[:, :, pc])
    return P, perm, nper
