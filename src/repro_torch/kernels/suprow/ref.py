"""Plain PyTorch version of the sup-row kernel (the counterpart of
``src/repro/kernels/suprow/ref.py``), batched over a leading dim."""
from __future__ import annotations

import torch


def suprow_update_plain(x: torch.Tensor, src: torch.Tensor, k: int):
    """One row x (E, k+m) against the source rows src (E, k, k+m):
    ``y = x[:, :k] · U⁻¹`` (U the upper triangle of ``src[:, :, :k]``) and
    ``xr = x[:, k:] − y · src[:, :, k:]``.  Returns (y (E, k), xr (E, m))."""
    u = src[:, :, :k]
    y = torch.zeros_like(x[:, :k])
    for j in range(k):
        acc = x[:, j] - torch.einsum("ei,ei->e", y, u[:, :, j])
        y[:, j] = acc / u[:, j, j]
    xr = x[:, k:] - torch.einsum("ei,eim->em", y, src[:, :, k:])
    return y, xr
