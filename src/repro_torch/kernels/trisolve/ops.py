"""Triangular-solve wrappers: K3 (``csrc/trsm.cu``), three entry points.

``trsm_batched`` is the right solve Y·U = X of the sup-sup edge buckets;
``trsm_left_unit_lower_batched`` and ``trsm_left_upper_batched`` are the
forward and backward sweeps of the node-block substitution, solved in
place on the dense diagonal block read from the panel buffer (no
transposed or flipped copies, no padding of k).  On a CUDA tensor each
wrapper launches its kernel (or raises); on a CPU tensor it runs the plain
version of :mod:`.ref`.  Every launch adds one to the wrapper's
``launches`` count.  The kernels take k <= 128 (the supernode cap).
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import (trsm_plain, trsm_left_unit_lower_plain,
                  trsm_left_upper_plain)

__all__ = ["trsm_batched", "trsm_left_unit_lower_batched",
           "trsm_left_upper_batched", "trsm_plain",
           "trsm_left_unit_lower_plain", "trsm_left_upper_plain"]

MAX_K = 128


def _check_k(k):
    if k > MAX_K:
        raise ValueError(f"the TRSM kernels take k <= {MAX_K}, got {k}")


def trsm_batched(u: torch.Tensor, x: torch.Tensor,
                 unit_diag: bool = False) -> torch.Tensor:
    """Solve Y[i] @ U[i] = X[i]: u (B, k, k) (upper triangle read), x
    (B, nr, k) contiguous.  u may be a strided view whose rows are
    contiguous, such as the first k columns of the gathered source rows
    (B, k, k + m): the kernel takes its batch and row strides, so no copy
    of U is made.  Replaces ``repro.kernels.trisolve.ops.trsm_batched``."""
    if u.ndim != 3 or x.ndim != 3 or u.shape[0] != x.shape[0] \
            or u.shape[1] != u.shape[2] or x.shape[2] != u.shape[2]:
        raise ValueError(f"need u (B, k, k) and x (B, nr, k), got "
                         f"{tuple(u.shape)} and {tuple(x.shape)}")
    if x.device.type == "cpu":
        return trsm_plain(u, x, unit_diag=unit_diag)
    b, nr, k = x.shape
    _check_k(k)
    _build.check_cuda("trsm_batched", x)
    if u.get_device() != x.get_device():
        raise ValueError(f"trsm_batched: every operand must lie on one CUDA "
                         f"device, got {u.device} and {x.device}")
    if u.dtype != x.dtype:
        raise TypeError(f"trsm_batched: mixed dtypes {u.dtype} and {x.dtype}")
    # the strides of a dimension of size 1 are arbitrary: normalise them
    su_b, su_r, su_c = u.stride()
    su_b = su_b if b > 1 else 0
    su_r = su_r if k > 1 else k
    if (k > 1 and su_c != 1) or su_r < k:
        raise ValueError(f"trsm_batched: u's rows must be contiguous and "
                         f"apart, got strides {tuple(u.stride())}")
    y = torch.empty_like(x)
    if b and nr:
        with _build.on_device(x):
            _build.launch(f"hylu_trsm_right_{_build.suffix(x)}",
                          _build.ptr(u), _build.ptr(x), _build.ptr(y), b, nr,
                          k, int(unit_diag), su_b, su_r, _build.stream_of(x))
        trsm_batched.launches += 1
    return y


def _left(name, plain, wrapper, blk, b):
    if blk.ndim != 3 or b.ndim != 3 or blk.shape[0] != b.shape[0] \
            or blk.shape[1] != blk.shape[2] or b.shape[1] != blk.shape[1]:
        raise ValueError(f"need blk (B, k, k) and b (B, k, m), got "
                         f"{tuple(blk.shape)} and {tuple(b.shape)}")
    if b.device.type == "cpu":
        return plain(blk, b)
    nb, k, m = b.shape
    _check_k(k)
    _build.check_cuda(name, blk, b)
    w = torch.empty_like(b)
    if nb and m:
        with _build.on_device(b):
            _build.launch(f"hylu_{name}_{_build.suffix(b)}", _build.ptr(blk),
                          _build.ptr(b), _build.ptr(w), nb, k, m,
                          _build.stream_of(b))
        wrapper.launches += 1
    return w


def trsm_left_unit_lower_batched(blk: torch.Tensor,
                                 b: torch.Tensor) -> torch.Tensor:
    """Solve L[i] @ w[i] = b[i], L = tril(blk[i], -1) + I; blk (B, k, k)
    dense diagonal blocks (upper part ignored), b (B, k, m)."""
    return _left("trsm_left_unit_lower", trsm_left_unit_lower_plain,
                 trsm_left_unit_lower_batched, blk, b)


def trsm_left_upper_batched(blk: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    """Solve U[i] @ w[i] = b[i], U = triu(blk[i]); blk (B, k, k) dense
    diagonal blocks (strict lower part ignored), b (B, k, m)."""
    return _left("trsm_left_upper", trsm_left_upper_plain,
                 trsm_left_upper_batched, blk, b)


trsm_batched.launches = 0
trsm_left_unit_lower_batched.launches = 0
trsm_left_upper_batched.launches = 0
