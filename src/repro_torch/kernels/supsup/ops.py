"""Batched GEMM wrapper: K4 (``csrc/bmm.cu``), the trailing update of a
sup-sup edge bucket.  On a CUDA tensor it launches the kernel (or raises);
on a CPU tensor it runs the plain version of :mod:`.ref`.  Every launch
adds one to ``gemm_batched.launches``; an empty product (m == 0 or k == 0)
returns zeros without a launch, as ``src/repro/kernels/supsup/ops.py:35``.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import gemm_batched_plain

__all__ = ["gemm_batched", "gemm_batched_plain"]


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


gemm_batched.launches = 0
