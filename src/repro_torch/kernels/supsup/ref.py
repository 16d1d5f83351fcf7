"""Plain PyTorch versions of the sup-sup kernels (the counterparts of
``src/repro/kernels/supsup/ref.py``), batched over a leading dim."""
from __future__ import annotations

import torch

from ..trisolve.ref import trsm_plain


def gemm_batched_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (E, nr, k) @ b (E, k, m) → (E, nr, m)."""
    return torch.matmul(a, b)


def gemm_update_plain(c: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """c (E, nr, m) − a (E, nr, k) @ b (E, k, m)."""
    return c - torch.matmul(a, b)


def supsup_update_plain(x: torch.Tensor, src: torch.Tensor, k: int):
    """The sup-sup update of a gathered target slice x (E, nr, k+m) by the
    source rows src (E, k, k+m): ``lts = x[..., :k] · U⁻¹`` (U the upper
    triangle of ``src[..., :k]``) and ``xr = x[..., k:] − lts · src[..., k:]``.
    Returns (lts, xr)."""
    lts = trsm_plain(src[..., :k], x[..., :k])
    return lts, gemm_update_plain(x[..., k:], lts, src[..., k:])
