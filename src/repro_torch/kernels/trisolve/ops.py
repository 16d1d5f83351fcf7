"""Triangular-solve wrappers: K3 (``csrc/trsm.cu``), three entry points.

``trsm_batched`` is the right solve Y·U = X of the sup-sup edge buckets;
``trsm_left_unit_lower_batched`` and ``trsm_left_upper_batched`` are the
forward and backward sweeps of the node-block substitution, solved in
place on the dense diagonal block read from the panel buffer (no
transposed or flipped copies, no padding of k).  On a CUDA tensor each
wrapper launches its kernel (or raises); on a CPU tensor it runs the plain
version of :mod:`.ref`.  Every launch adds one to the wrapper's
``launches`` count.

The solve kernels above take k <= ``BLOCK_K`` (128, the default supernode
cap).  A supernode may have up to ``max_super`` rows, so a larger k goes
to the wide path (``trsm_right_wide``, ``trsm_left_unit_lower_wide``,
``trsm_left_upper_wide``, each counting its calls): one launch of the wide
kernel (``hylu_trsm_*_wide_*``), which streams the triangle through shared
memory and takes any k.  Every kernel has float64, float32 and bfloat16
instances; the bfloat16 ones keep their sums in float32 and round where
the plain version does (``csrc/trsm.cu``, "bfloat16").
"""
from __future__ import annotations

import functools

import torch

from ...roofline import kernel_cost as kc
from .. import _build
from .ref import (trsm_plain, trsm_left_unit_lower_plain,
                  trsm_left_upper_plain)

__all__ = ["trsm_batched", "trsm_left_unit_lower_batched",
           "trsm_left_upper_batched", "trsm_right_wide",
           "trsm_left_unit_lower_wide", "trsm_left_upper_wide",
           "trsm_plain", "trsm_left_unit_lower_plain",
           "trsm_left_upper_plain"]

BLOCK_K = 128


def _check_right(u, x):
    if u.ndim != 3 or x.ndim != 3 or u.shape[0] != x.shape[0] \
            or u.shape[1] != u.shape[2] or x.shape[2] != u.shape[2]:
        raise ValueError(f"need u (B, k, k) and x (B, nr, k), got "
                         f"{tuple(u.shape)} and {tuple(x.shape)}")


def _check_left(blk, b):
    if blk.ndim != 3 or b.ndim != 3 or blk.shape[0] != b.shape[0] \
            or blk.shape[1] != blk.shape[2] or b.shape[1] != blk.shape[1]:
        raise ValueError(f"need blk (B, k, k) and b (B, k, m), got "
                         f"{tuple(blk.shape)} and {tuple(b.shape)}")


def _right(u, x, unit_diag, wide=False):
    """One launch of the right solve: the k <= 128 kernel, or with
    ``wide`` the wide one (any k); u's rows contiguous, x contiguous.
    Returns y (nothing launched for an empty batch)."""
    b, nr, k = x.shape
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
            if wide:
                scratch = _scratch("hylu_trsm_right_wide_scratch",
                                   (b, nr, k, x.element_size()), x)
                name, extra = "hylu_trsm_right_wide", (
                    None if scratch is None else _build.ptr(scratch),)
            else:
                name, extra = "hylu_trsm_right", ()
            _build.launch(f"{name}_{_build.suffix(x)}",
                          _build.ptr(u), _build.ptr(x), _build.ptr(y), b, nr,
                          k, int(unit_diag), su_b, su_r, *extra,
                          _build.stream_of(x),
                          work=lambda: kc.as_work(x.element_size(),
                                                  kc.trsm_right(
                                                      b, nr, k,
                                                      x.element_size())))
    return y


@functools.lru_cache(maxsize=256)
def _scratch_bytes(entry, shape, device):
    """Bytes of a wide solve's device-memory scratch by its size query
    ``entry`` on ``shape``, read once per shape and device (the kernel's
    shared-memory limit is the current device's)."""
    return getattr(_build.library(), entry)(*shape)


def _scratch(entry, shape, like):
    """A wide solve's scratch on like's device, or None when it needs
    none: the right solve's tiles of Y past k of some 2,400 in float64
    on an H100, a bfloat16 left solve's float32 sums past what fits
    shared memory."""
    n = _scratch_bytes(entry, shape, like.get_device())
    return torch.empty(n, dtype=torch.uint8, device=like.device) if n else None


def trsm_batched(u: torch.Tensor, x: torch.Tensor,
                 unit_diag: bool = False) -> torch.Tensor:
    """Solve Y[i] @ U[i] = X[i]: u (B, k, k) (upper triangle read), x
    (B, nr, k) contiguous.  u may be a strided view whose rows are
    contiguous, such as the first k columns of the gathered source rows
    (B, k, k + m): the kernel takes its batch and row strides, so no copy
    of U is made.  k > 128 goes to :func:`trsm_right_wide`.  Replaces
    ``repro.kernels.trisolve.ops.trsm_batched``."""
    _check_right(u, x)
    if x.device.type == "cpu":
        return trsm_plain(u, x, unit_diag=unit_diag)
    b, nr, k = x.shape
    if k > BLOCK_K:
        return trsm_right_wide(u, x, unit_diag)
    y = _right(u, x, unit_diag)
    if b and nr:
        trsm_batched.launches += 1
    return y


def trsm_right_wide(u: torch.Tensor, x: torch.Tensor,
                    unit_diag: bool = False) -> torch.Tensor:
    """K3's right solve past 128 columns (the wide path of
    :func:`trsm_batched`; same arguments and result, any k): one launch
    of the wide kernel."""
    _check_right(u, x)
    if x.device.type == "cpu":
        return trsm_plain(u, x, unit_diag=unit_diag)
    b, nr, _ = x.shape
    y = _right(u, x, unit_diag, wide=True)
    if b and nr:
        trsm_right_wide.launches += 1
    return y


def _left(name, blk, b, wide=False):
    """One launch of a left solve: the k <= 128 kernel, or with ``wide``
    the wide one (any k; in bfloat16 with a device-memory scratch for its
    float32 sums where they do not fit shared memory); blk and b
    contiguous."""
    nb, k, m = b.shape
    _build.check_cuda(name, blk, b)
    w = torch.empty_like(b)
    if nb and m:
        entry = f"hylu_{name}_wide" if wide else f"hylu_{name}"
        with _build.on_device(b):
            extra = ()
            if wide and b.dtype == torch.bfloat16:
                sums = _scratch("hylu_trsm_left_wide_scratch", (nb, k, m), b)
                extra = (None if sums is None else _build.ptr(sums),)
            _build.launch(f"{entry}_{_build.suffix(b)}", _build.ptr(blk),
                          _build.ptr(b), _build.ptr(w), nb, k, m, *extra,
                          _build.stream_of(b),
                          work=lambda: kc.as_work(b.element_size(),
                                                  kc.trsm_left(
                                                      "lower" in name, nb, k,
                                                      m, b.element_size())))
    return w


def trsm_left_unit_lower_batched(blk: torch.Tensor,
                                 b: torch.Tensor) -> torch.Tensor:
    """Solve L[i] @ w[i] = b[i], L = tril(blk[i], -1) + I; blk (B, k, k)
    dense diagonal blocks (upper part ignored), b (B, k, m).  k > 128 goes
    to :func:`trsm_left_unit_lower_wide`."""
    _check_left(blk, b)
    if b.device.type == "cpu":
        return trsm_left_unit_lower_plain(blk, b)
    if b.shape[1] > BLOCK_K:
        return trsm_left_unit_lower_wide(blk, b)
    w = _left("trsm_left_unit_lower", blk, b)
    if b.shape[0] and b.shape[2]:
        trsm_left_unit_lower_batched.launches += 1
    return w


def trsm_left_unit_lower_wide(blk: torch.Tensor,
                              b: torch.Tensor) -> torch.Tensor:
    """The wide path of :func:`trsm_left_unit_lower_batched` (same
    arguments and result, any k)."""
    _check_left(blk, b)
    if b.device.type == "cpu":
        return trsm_left_unit_lower_plain(blk, b)
    w = _left("trsm_left_unit_lower", blk, b, wide=True)
    if b.shape[0] and b.shape[2]:
        trsm_left_unit_lower_wide.launches += 1
    return w


def trsm_left_upper_batched(blk: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    """Solve U[i] @ w[i] = b[i], U = triu(blk[i]); blk (B, k, k) dense
    diagonal blocks (strict lower part ignored), b (B, k, m).  k > 128
    goes to :func:`trsm_left_upper_wide`."""
    _check_left(blk, b)
    if b.device.type == "cpu":
        return trsm_left_upper_plain(blk, b)
    if b.shape[1] > BLOCK_K:
        return trsm_left_upper_wide(blk, b)
    w = _left("trsm_left_upper", blk, b)
    if b.shape[0] and b.shape[2]:
        trsm_left_upper_batched.launches += 1
    return w


def trsm_left_upper_wide(blk: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """The wide path of :func:`trsm_left_upper_batched` (same arguments
    and result, any k)."""
    _check_left(blk, b)
    if b.device.type == "cpu":
        return trsm_left_upper_plain(blk, b)
    w = _left("trsm_left_upper", blk, b, wide=True)
    if b.shape[0] and b.shape[2]:
        trsm_left_upper_wide.launches += 1
    return w


trsm_batched.launches = 0
trsm_right_wide.launches = 0
trsm_left_unit_lower_batched.launches = 0
trsm_left_unit_lower_wide.launches = 0
trsm_left_upper_batched.launches = 0
trsm_left_upper_wide.launches = 0
