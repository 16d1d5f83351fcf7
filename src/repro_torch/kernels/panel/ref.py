"""Plain PyTorch version of the panel LU kernels (the counterpart of
``src/repro/kernels/panel/ref.py``): a batch of dense LUs with partial
pivoting restricted to the diagonal block and pivot perturbation.

One loop serves both kernels: the diagonal block starts at column ``c0``
(0 for the column-reordered bucket panels, ``lsize`` for a node panel)
and the elimination runs over the columns ``(c0 + j, wlim)`` (``wu`` for a
bucket, the panel width for a node); every other column is only
row-swapped.  ``eps`` is one threshold per panel.

``panel_lu_bucket_plain`` is the bucketed LU as the engine ran it before
K1 read the value buffer in place: gather the padded panels, factor them,
scatter them back."""
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


def panel_lu_bucket_plain(vals: torch.Tensor, layout, eps: torch.Tensor):
    """One panel bucket of the value buffer ``vals`` (K, slots), in place:
    the padded panels gathered through ``layout.gather``, factored over
    [0, wu) with system k's threshold ``eps[k]``, scattered back through
    ``layout.scatter`` (``src/repro/core/jax_engine.py:215–219``).  Returns
    (perm (K * B, nrp) int32, n_perturb (K * B,) int32)."""
    K = vals.shape[0]
    B = layout.desc.shape[0]
    P = vals[:, layout.gather].view(K * B, layout.nr, layout.wt)
    P, perm, nper = panel_lu_plain(P, 0, layout.wu,
                                   eps.repeat_interleave(B))
    vals[:, layout.scatter] = P.view(K, -1)
    return perm, nper
