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
``trsm_left_upper_wide``, each counting its calls).  In float64 and
float32 that is one launch of the wide kernel (``hylu_trsm_*_wide_*``),
which streams the triangle through shared memory and takes any k.  In
bfloat16 it is blocked over k: the solve kernel on each diagonal block of
at most 128, and between blocks the trailing update C −= A·B on the
columns (right solve) or rows (left solves) still to be solved, in place
on float32 sums by K5's GEMM update (``csrc/gemm_update.cu``,
``hylu_gemm_update_*``).
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


def _blocks(k):
    return [(s, min(s + BLOCK_K, k)) for s in range(0, k, BLOCK_K)]


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


def _carry(t, s0):
    """A bfloat16 solve's extra argument: the float32 sums its unknowns
    start from (``s0``, X's or B's layout, contiguous; minus the sums, as
    the GEMM update leaves them), or null; nothing for other dtypes."""
    if t.dtype != torch.bfloat16:
        return ()
    return (None if s0 is None else _build.ptr(s0),)


def _as(t, like):
    """t in like's dtype (itself when it is already)."""
    return t if t.dtype == like.dtype else t.to(like.dtype)


def _right(u, x, unit_diag, s0=None, wide=False):
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
                scratch = _wide_scratch(b, nr, k, x)
                name, extra = "hylu_trsm_right_wide", (
                    None if scratch is None else _build.ptr(scratch),)
            else:
                name, extra = "hylu_trsm_right", _carry(x, s0)
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
def _scratch_bytes(b, nr, k, elem, device):
    """Bytes of the wide right solve's scratch, read once per shape and
    device (the kernel's shared-memory limit is the current device's)."""
    return _build.library().hylu_trsm_right_wide_scratch(b, nr, k, elem)


def _wide_scratch(b, nr, k, x):
    """The wide right solve's device-memory scratch for its tiles of Y:
    None when a tile fits shared memory (up to k of some 2,400 in float64
    on an H100)."""
    n = _scratch_bytes(b, nr, k, x.element_size(), x.get_device())
    return torch.empty(n, dtype=torch.uint8, device=x.device) if n else None


def _update(c, a, b):
    """c −= a @ b in place by K5's GEMM update (``hylu_gemm_update_*``,
    its output c itself): c (B, R, N), a (B, R, Kd), b (B, Kd, N), views
    of one dtype on one device whose rows are dense."""
    nb, rows, cols = c.shape
    kd = a.shape[2]
    if not (nb and rows and cols and kd):
        return
    sc, sa, sb = (_build.row_strides("trsm update", t) for t in (c, a, b))
    with _build.on_device(c):
        _build.launch(f"hylu_gemm_update_{_build.suffix(c)}", _build.ptr(c),
                      *sc, _build.ptr(a), *sa, _build.ptr(b), *sb,
                      _build.ptr(c), *sc, nb, rows, kd, cols,
                      _build.stream_of(c),
                      work=lambda: kc.as_work(c.element_size(),
                                              kc.gemm_update(
                                                  nb, rows, kd, cols,
                                                  c.element_size())))


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
    of the wide kernel in float64 and float32, blocked over k in
    bfloat16 (:func:`_right_blocked_bf16`)."""
    _check_right(u, x)
    if x.device.type == "cpu":
        return trsm_plain(u, x, unit_diag=unit_diag)
    b, nr, _ = x.shape
    if x.dtype == torch.bfloat16:
        y = _right_blocked_bf16(u, x, unit_diag)
    else:
        y = _right(u, x, unit_diag, wide=True)
    if b and nr:
        trsm_right_wide.launches += 1
    return y


def _right_blocked_bf16(u, x, unit_diag):
    """The bfloat16 right solve over k > 128: per column block J of at
    most 128, Y_J = X_J U_JJ⁻¹ by the solve kernel, starting from the
    float32 sums acc[:, J] of the blocks before it; then acc[:, later] −=
    Y_J U[J, later] by K5's float32 GEMM update.  Each unknown then rounds
    one dot, as the plain version."""
    b, nr, k = x.shape
    _build.check_cuda("trsm_batched", x)
    y = torch.empty_like(x)
    if not (b and nr):
        return y
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for s, e in _blocks(k):
        yb = _right(u[:, s:e, s:e], x[:, :, s:e].contiguous(), unit_diag,
                    acc[:, :, s:e].contiguous())
        y[:, :, s:e] = yb
        if e < k:
            _update(acc[:, :, e:], _as(yb, acc), _as(u[:, s:e, e:], acc))
    return y


def _left(name, blk, b, s0=None, wide=False):
    """One launch of a left solve: the k <= 128 kernel, or with ``wide``
    the wide one (any k); blk and b contiguous."""
    nb, k, m = b.shape
    _build.check_cuda(name, blk, b)
    w = torch.empty_like(b)
    if nb and m:
        entry = f"hylu_{name}_wide" if wide else f"hylu_{name}"
        with _build.on_device(b):
            _build.launch(f"{entry}_{_build.suffix(b)}", _build.ptr(blk),
                          _build.ptr(b), _build.ptr(w), nb, k, m,
                          *_carry(b, s0), _build.stream_of(b),
                          work=lambda: kc.as_work(b.element_size(),
                                                  kc.trsm_left(
                                                      "lower" in name, nb, k,
                                                      m, b.element_size())))
    return w


def _left_blocked_bf16(name, blk, b):
    """A bfloat16 left solve over k > 128: each diagonal block of at most
    128 by the solve kernel, in sweep order (backward for U), starting
    from the float32 sums of the blocks before it; then the rows still to
    be solved take its product into those sums by K5's float32 GEMM
    update (as :func:`_right_blocked_bf16`)."""
    nb, k, m = b.shape
    _build.check_cuda(name, blk, b)
    w = b.clone()
    if not (nb and m):
        return w
    upper = "upper" in name
    acc = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
    for s, e in (reversed(_blocks(k)) if upper else _blocks(k)):
        wb = _left(name, blk[:, s:e, s:e].contiguous(),
                   w[:, s:e].contiguous(), acc[:, s:e].contiguous())
        w[:, s:e] = wb
        if upper and s > 0:
            _update(acc[:, :s], _as(blk[:, :s, s:e], acc), _as(wb, acc))
        elif not upper and e < k:
            _update(acc[:, e:], _as(blk[:, e:, s:e], acc), _as(wb, acc))
    return w


def _left_wide(name, blk, b):
    """A left solve past 128 rows: one launch of the wide kernel in
    float64 and float32, blocked over k in bfloat16."""
    if b.dtype == torch.bfloat16:
        return _left_blocked_bf16(name, blk, b)
    return _left(name, blk, b, wide=True)


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
    w = _left_wide("trsm_left_unit_lower", blk, b)
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
    w = _left_wide("trsm_left_upper", blk, b)
    if b.shape[0] and b.shape[2]:
        trsm_left_upper_wide.launches += 1
    return w


trsm_batched.launches = 0
trsm_right_wide.launches = 0
trsm_left_unit_lower_batched.launches = 0
trsm_left_unit_lower_wide.launches = 0
trsm_left_upper_batched.launches = 0
trsm_left_upper_wide.launches = 0
