"""Plain PyTorch versions of the sup-row kernel (the counterpart of
``src/repro/kernels/suprow/ref.py``), batched over a leading dim, and of
its grouped launch."""
from __future__ import annotations

import torch


def suprow_update_plain(x: torch.Tensor, src: torch.Tensor, k: int):
    """One row x (E, k+m) against the source rows src (E, k, k+m):
    ``y = x[:, :k] · U⁻¹`` (U the upper triangle of ``src[:, :, :k]``) and
    ``xr = x[:, k:] − y · src[:, :, k:]``.  Returns (y (E, k), xr (E, m)).
    Step j divides ``x_j − y[:j] · U[:j, j]`` by U's diagonal, the order of
    ``_trsm_upper_jax`` (``src/repro/core/jax_engine.py:53``); the JAX
    reference's dot runs over all of U's column, where the entries past
    y[:j] meet zeros, so below the diagonal nothing is read here."""
    u = src[:, :, :k]
    y = torch.zeros_like(x[:, :k])
    for j in range(k):
        acc = x[:, j] - torch.einsum("ei,ei->e", y[:, :j], u[:, :j, j])
        y[:, j] = acc / u[:, j, j]
    xr = x[:, k:] - torch.einsum("ei,eim->em", y, src[:, :, k:])
    return y, xr


def suprow_update_grouped_plain(groups):
    """``suprow_update_plain`` on each group (x, src, k) of a list, in
    order: a list of (y, xr)."""
    return [suprow_update_plain(x, src, k) for x, src, k in groups]
