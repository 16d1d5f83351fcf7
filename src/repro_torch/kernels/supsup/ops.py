"""Sup-sup wrappers: K4 ``gemm_batched`` (``csrc/bmm.cu``), the trailing
update of a sup-sup edge bucket, and K5 ``gemm_update``
(``csrc/gemm_update.cu``), C − A·B, under ``supsup_update`` — the per-edge
sup-sup update of the unrolled factor schedule (K3's right solve, then K5).

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version of :mod:`.ref`.  Every launch adds one to
the wrapper's ``launches``; an empty product (m == 0 or k == 0) launches
nothing, as ``src/repro/kernels/supsup/ops.py:35, 57``.  Unlike the JAX
wrappers, nothing is padded: the kernels take the exact shapes.
"""
from __future__ import annotations

import torch

from .. import _build
from ..trisolve import ops as trisolve_ops
from .ref import gemm_batched_plain, gemm_update_plain, supsup_update_plain

__all__ = ["gemm_batched", "gemm_update", "supsup_update",
           "gemm_batched_plain", "gemm_update_plain", "supsup_update_plain"]


def gemm_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (E, nr, k) @ b (E, k, m) → (E, nr, m), accumulated in the input
    dtype.  Replaces ``repro.kernels.supsup.ops.gemm_batched``."""
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"need a (E, nr, k) and b (E, k, m), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    e, nr, k = a.shape
    m = b.shape[2]
    if m == 0 or k == 0:
        return torch.zeros((e, nr, m), dtype=a.dtype, device=a.device)
    if a.device.type == "cpu":
        return gemm_batched_plain(a, b)
    _build.check_cuda("gemm_batched", a, b)
    c = torch.empty((e, nr, m), dtype=a.dtype, device=a.device)
    if e and nr:
        with torch.cuda.device(a.device):
            _build.launch(f"hylu_bmm_{_build.suffix(a)}", _build.ptr(a),
                          _build.ptr(b), _build.ptr(c), e, nr, k, m,
                          _build.stream_of(a))
        gemm_batched.launches += 1
    return c


def gemm_update(c: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """K5 — c (E, nr, m) − a (E, nr, k) @ b (E, k, m), the product summed in
    the input dtype.  Replaces ``repro.kernels.supsup.ops.gemm``."""
    if a.ndim != 3 or b.ndim != 3 or c.ndim != 3 \
            or not a.shape[0] == b.shape[0] == c.shape[0] \
            or a.shape[2] != b.shape[1] or c.shape[1:] != (a.shape[1],
                                                          b.shape[2]):
        raise ValueError(f"need c (E, nr, m), a (E, nr, k) and b (E, k, m), "
                         f"got {tuple(c.shape)}, {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    e, nr, k = a.shape
    m = b.shape[2]
    if m == 0 or k == 0:
        return c.clone()
    if c.device.type == "cpu":
        return gemm_update_plain(c, a, b)
    _build.check_cuda("gemm_update", c, a, b)
    out = torch.empty_like(c)
    if e and nr:
        with torch.cuda.device(c.device):
            _build.launch(f"hylu_gemm_update_{_build.suffix(c)}",
                          _build.ptr(c), _build.ptr(a), _build.ptr(b),
                          _build.ptr(out), e, nr, k, m, _build.stream_of(c))
        gemm_update.launches += 1
    return out


def supsup_update(x: torch.Tensor, src: torch.Tensor, k: int):
    """The sup-sup update of a gathered target slice x (E, nr, k+m) by the
    source rows src (E, k, k+m): K3's right solve ``lts · U = x[..., :k]``,
    then K5 ``xr = x[..., k:] − lts · src[..., k:]``.  Returns (lts, xr).
    Replaces ``repro.kernels.supsup.ops.supsup_update``."""
    if x.device.type == "cpu":
        return supsup_update_plain(x, src, k)
    lts = trisolve_ops.trsm_batched(src[..., :k].contiguous(),
                                    x[..., :k].contiguous())
    xr = gemm_update(x[..., k:].contiguous(), lts,
                     src[..., k:].contiguous())
    return lts, xr


gemm_batched.launches = 0
gemm_update.launches = 0
