"""Sup-row wrapper: K6 (``csrc/suprow.cu``), the fused TRSV + GEMV of one
target row against a source supernode.  No engine path calls it, as in the
JAX package (whose only caller is its own wrapper); the factor programs
update a row against a supernode with plain tensor ops.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version of :mod:`.ref`.  Every launch adds one to
``suprow_update.launches``.  Nothing is padded: the JAX wrapper pads k and
m to multiples of 8 or 128, the kernel takes the exact shapes.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import suprow_update_plain

__all__ = ["suprow_update", "suprow_update_plain"]

MAX_K = 128


def suprow_update(x: torch.Tensor, src: torch.Tensor, k: int):
    """K6 — x (E, k+m) rows, src (E, k, k+m) source rows: returns
    ``y = x[:, :k] · U⁻¹`` (E, k) and ``xr = x[:, k:] − y · src[:, :, k:]``
    (E, m).  Replaces ``repro.kernels.suprow.ops.suprow_update``."""
    if x.ndim != 2 or src.ndim != 3 or src.shape[0] != x.shape[0] \
            or src.shape[1] != k or src.shape[2] != x.shape[1] \
            or not 0 < k <= x.shape[1]:
        raise ValueError(f"need x (E, k+m) and src (E, k, k+m) with k={k}, "
                         f"got {tuple(x.shape)} and {tuple(src.shape)}")
    if x.device.type == "cpu":
        return suprow_update_plain(x, src, k)
    if k > MAX_K:
        raise ValueError(f"the sup-row kernel takes k <= {MAX_K}, got {k}")
    _build.check_cuda("suprow_update", x, src)
    e, w = x.shape
    y = torch.empty((e, k), dtype=x.dtype, device=x.device)
    xr = torch.empty((e, w - k), dtype=x.dtype, device=x.device)
    if e:
        with torch.cuda.device(x.device):
            _build.launch(f"hylu_suprow_{_build.suffix(x)}", _build.ptr(x),
                          _build.ptr(src), _build.ptr(y), _build.ptr(xr), e,
                          k, w - k, _build.stream_of(x))
        suprow_update.launches += 1
    return y, xr


suprow_update.launches = 0
