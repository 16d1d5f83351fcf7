"""Sup-row wrappers: K6 (``csrc/suprow.cu``), the fused TRSV + GEMV of a
target row against a source supernode, per (k, m) group
(``suprow_update``) or over many groups in one launch
(``suprow_update_grouped``).  No engine path calls either, as in the JAX
package (whose only caller is its own wrapper); the factor programs
update a row against a supernode with plain tensor ops or inside K5's
node step.

On a CUDA tensor a wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version of :mod:`.ref`.  Every launch adds one to
the wrapper's ``launches``.  Nothing is padded: the JAX wrapper pads k and
m to multiples of 8 or 128, the kernel takes the exact shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...roofline import kernel_cost as kc
from .. import _build
from .ref import suprow_update_grouped_plain, suprow_update_plain

__all__ = ["SuprowGroups", "suprow_groups", "suprow_update",
           "suprow_update_grouped", "suprow_update_plain",
           "suprow_update_grouped_plain"]

MAX_K = 128


def _check(x: torch.Tensor, src: torch.Tensor, k: int) -> None:
    if x.ndim != 2 or src.ndim != 3 or src.shape[0] != x.shape[0] \
            or src.shape[1] != k or src.shape[2] != x.shape[1] \
            or not 0 < k <= x.shape[1]:
        raise ValueError(f"need x (E, k+m) and src (E, k, k+m) with k={k}, "
                         f"got {tuple(x.shape)} and {tuple(src.shape)}")


def _check_k(k: int) -> None:
    if k > MAX_K:
        raise ValueError(f"the sup-row kernel takes k <= {MAX_K}, got {k}")


def _suffix(t) -> str:
    """The entry-point suffix: K6 has float64 and float32 instances only
    (no engine path runs it, in any dtype)."""
    sfx = _build.suffix(t)
    if sfx not in ("f64", "f32"):
        raise TypeError(f"the sup-row kernel takes float64 or float32, got "
                        f"{t.dtype}")
    return sfx


def suprow_update(x: torch.Tensor, src: torch.Tensor, k: int):
    """K6 — x (E, k+m) rows, src (E, k, k+m) source rows: returns
    ``y = x[:, :k] · U⁻¹`` (E, k) and ``xr = x[:, k:] − y · src[:, :, k:]``
    (E, m).  Replaces ``repro.kernels.suprow.ops.suprow_update``."""
    _check(x, src, k)
    if x.device.type == "cpu":
        return suprow_update_plain(x, src, k)
    _check_k(k)
    _build.check_cuda("suprow_update", x, src)
    e, w = x.shape
    y = torch.empty((e, k), dtype=x.dtype, device=x.device)
    xr = torch.empty((e, w - k), dtype=x.dtype, device=x.device)
    if e:
        with _build.on_device(x):
            _build.launch(f"hylu_suprow_{_suffix(x)}", _build.ptr(x),
                          _build.ptr(src), _build.ptr(y), _build.ptr(xr), e,
                          k, w - k, _build.stream_of(x),
                          work=lambda: kc.as_work(x.element_size(), kc.suprow(
                              e, k, w - k, x.element_size())))
        suprow_update.launches += 1
    return y, xr


class SuprowGroups(NamedTuple):
    """The operands of one grouped launch, made once by
    :func:`suprow_groups`: the groups (x, src, k) and, on a card, their
    outputs (y, xr), which every launch overwrites, and the launch's table
    (per group the addresses of x, src, y and xr, k, m, E and its first
    block, then per block its group; int64) with the launch's shape."""
    groups: list
    out: list
    table: torch.Tensor | None
    blocks: int
    k_max: int
    warps: int


def suprow_groups(groups) -> SuprowGroups:
    """A :class:`SuprowGroups` of a list of (x (E, k+m), src (E, k, k+m),
    k), the groups of any (k, m) and E >= 0, all of one dtype on one
    device: outputs allocated and, on a card, the table uploaded in one
    host→device copy.  Raises for what the kernel does not take."""
    groups = list(groups)
    if not groups:
        raise ValueError("suprow_groups: no group")
    for x, src, k in groups:
        _check(x, src, k)
    x0 = groups[0][0]
    k_max = max(k for _, _, k in groups)
    if x0.device.type == "cpu":
        return SuprowGroups(groups, [], None, 0, k_max, 0)
    _check_k(k_max)
    _build.check_cuda("suprow_update_grouped",
                      *[t for x, src, _ in groups for t in (x, src)])
    out = [(torch.empty((x.shape[0], k), dtype=x.dtype, device=x.device),
            torch.empty((x.shape[0], x.shape[1] - k), dtype=x.dtype,
                        device=x.device)) for x, _, k in groups]
    elem = 8 if _suffix(x0) == "f64" else 4
    warps = _build.library().hylu_suprow_warps(k_max, elem)
    rows = np.array([x.shape[0] for x, _, _ in groups], np.int64)
    nblk = -(-rows // warps)
    block0 = np.concatenate([[0], np.cumsum(nblk)[:-1]]).astype(np.int64)
    desc = np.array([(x.data_ptr(), src.data_ptr(), y.data_ptr(),
                      xr.data_ptr(), k, x.shape[1] - k, e, b0)
                     for (x, src, k), (y, xr), e, b0
                     in zip(groups, out, rows.tolist(), block0.tolist())],
                    np.uint64).view(np.int64)
    block_group = np.repeat(np.arange(len(groups), dtype=np.int64), nblk)
    table = torch.from_numpy(np.concatenate([desc.ravel(), block_group])
                             ).to(x0.device)
    return SuprowGroups(groups, out, table, int(nblk.sum()), k_max, warps)


def suprow_update_grouped(groups):
    """K6 over many (k, m) groups in one launch — ``groups`` a list of (x,
    src, k), each as :func:`suprow_update` takes it, or a
    :class:`SuprowGroups` made once from one (its table is then reused
    and its outputs overwritten).  Returns [(y, xr)] per group, as
    ``suprow_update_grouped_plain``.  Nothing is launched when no group
    has a row."""
    if not isinstance(groups, SuprowGroups):
        groups = suprow_groups(groups)
    if groups.table is None:
        return suprow_update_grouped_plain(groups.groups)
    if groups.blocks:
        x0 = groups.groups[0][0]
        with _build.on_device(x0):
            _build.launch(f"hylu_suprow_grouped_{_suffix(x0)}",
                          _build.ptr(groups.table), len(groups.groups),
                          groups.blocks, groups.k_max, groups.warps,
                          _build.stream_of(x0),
                          work=lambda: kc.as_work(x0.element_size(), [
                              sum(w) for w in zip(*(
                                  kc.suprow(x.shape[0], k, x.shape[1] - k,
                                            x0.element_size())
                                  for x, _, k in groups.groups))]))
        suprow_update_grouped.launches += 1
    return groups.out


suprow_update.launches = 0
suprow_update_grouped.launches = 0
