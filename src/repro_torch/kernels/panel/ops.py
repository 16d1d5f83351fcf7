"""Panel LU wrappers: K1 (bucketed) and K2 (one node panel per system).

On a CUDA tensor each wrapper launches its hand-written kernel (all in
``csrc/panel_lu.cu``) or raises; on a CPU tensor it runs the plain PyTorch
version of :mod:`.ref`.  Every launch adds one to the wrapper's
``launches`` count.

Panels of up to ``WINDOW_ROWS`` (256) rows run the window kernel
(``panel_lu_window_kernel``); taller ones, which any ``max_super`` above
256 can produce, run ``panel_lu_kernel``, one block per panel in device
memory, up to ``MAX_ROWS`` rows.  Panels of more than ``WIDE_ROWS`` (128,
the default supernode cap) rows are K1's and K2's wide path: the engine
calls ``panel_lu_bucket_inplace`` and ``panel_lu`` for every panel, and
they hand such panels to ``panel_lu_bucket_wide`` and ``panel_lu_wide``,
which count those launches.

K1 has two wrappers: ``panel_lu_bucket_inplace``, which the engine calls,
factors the members of one panel bucket where they lie in the value buffer
and writes them back in place; ``panel_lu_batched`` takes contiguous
column-reordered panels, as the Pallas wrapper does.

Dtype contract (as ``src/repro/kernels/panel/ops.py``): the LU runs in the
panel dtype; the threshold is cast to it and clamped against underflow
(``_eps_in``).  Unlike the Pallas wrappers, ``eps_p`` may hold one
threshold per panel (per system for the in-place K1), because the batched
engine perturbs each system against its own max|A|.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ...roofline import kernel_cost as kc
from .. import _build
from .ref import panel_lu_bucket_plain, panel_lu_plain

__all__ = ["BucketLayout", "bucket_layout", "bucket_maps", "panel_lu",
           "panel_lu_wide", "panel_lu_batched", "panel_lu_bucket_inplace",
           "panel_lu_bucket_wide", "panel_lu_bucket_plain", "panel_lu_plain"]

WIDE_ROWS = 128        # panels above this count as the wide path
WINDOW_ROWS = 256      # the window kernel: a lane per row, eight warps
MAX_ROWS = 16384       # panel_lu_kernel: per row a multiplier and a perm
#                        entry in shared memory
DESC_FIELDS = ("offset", "nr", "w", "lsize", "usize")


class BucketLayout(NamedTuple):
    """One panel bucket of B members (nodes) as K1 reads it in the value
    buffer.  Member i's padded panel is [block | block pads | U suffix | U
    pads | L prefix | prefix pads] of ``nr`` rows (``wu`` = nrp + usp
    eliminated columns, ``wt`` = wu + lsp in all); pads read the zero slot,
    and a padded row r >= the member's nr the one slot on its own diagonal
    (``src/repro_torch/core/structure.py``, ``_panel_bucket``)."""
    desc: torch.Tensor     # (B, 5) int32: slot offset, nr, w, lsize, usize
    nr: int                # padded rows nrp (a power of two)
    wu: int
    wt: int
    zero_slot: int
    one_slot: int
    gather: torch.Tensor   # (B * nr * wt,) int64: the padded panels' slots
    scatter: torch.Tensor  # (B * nr * wt,) int64: where the plain version
    #                        writes them back (pads to the scratch slot)


def bucket_maps(desc, nrp: int, wu: int, wt: int, zero_slot: int,
                one_slot: int, scratch_slot: int):
    """The gather and scatter maps (B, nrp, wt) of the padded panels that
    the descriptors (B, 5) describe: the maps the analysis builds for a
    panel bucket, from the descriptors alone."""
    desc = np.asarray(desc, np.int64).reshape(-1, len(DESC_FIELDS))
    nb = desc.shape[0]
    gather = np.full((nb, nrp, wt), zero_slot, np.int64)
    gather[:, np.arange(nrp), np.arange(nrp)] = one_slot
    scatter = np.full((nb, nrp, wt), scratch_slot, np.int64)
    for i, (off, nr, w, ls, us) in enumerate(desc):
        cols = np.concatenate([ls + np.arange(nr), np.full(nrp - nr, -1),
                               ls + nr + np.arange(us),
                               np.full(wu - nrp - us, -1), np.arange(ls),
                               np.full(wt - wu - ls, -1)])
        real = cols >= 0
        slots = off + np.arange(nr)[:, None] * w + cols[real][None, :]
        gather[i][:nr, real] = slots
        scatter[i][:nr, real] = slots
    return gather, scatter


def bucket_layout(desc, nrp: int, wu: int, wt: int, zero_slot: int,
                  one_slot: int, gather, scatter, device) -> BucketLayout:
    """A :class:`BucketLayout` on ``device`` from host arrays: the (B, 5)
    descriptors and the (B, nrp, wt) gather / scatter maps of the same
    bucket.  Raises for a member that does not fit the padded sizes."""
    desc = np.ascontiguousarray(desc, np.int64).reshape(-1, len(DESC_FIELDS))
    off, nr, w, ls, us = desc.T
    if not (1 <= nrp <= MAX_ROWS and nrp <= wu <= wt):
        raise ValueError(f"need 1 <= nrp <= {MAX_ROWS} and nrp <= wu <= wt, "
                         f"got nrp={nrp} wu={wu} wt={wt}")
    if ((nr < 1) | (nr > nrp) | (us < 0) | (us > wu - nrp) | (ls < 0)
            | (ls > wt - wu) | (w != ls + nr + us) | (off < 0)).any():
        raise ValueError(f"bucket descriptors {desc.tolist()} do not fit "
                         f"nrp={nrp} wu={wu} wt={wt}")
    if int((off + nr * w).max()) >= 2 ** 31:
        raise ValueError("slot offsets past 2^31 are not supported")
    dev = torch.device(device)
    return BucketLayout(
        desc=torch.from_numpy(desc.astype(np.int32)).to(dev), nr=int(nrp),
        wu=int(wu), wt=int(wt), zero_slot=int(zero_slot),
        one_slot=int(one_slot),
        gather=torch.from_numpy(np.asarray(gather, np.int64).reshape(-1)
                                ).to(dev),
        scatter=torch.from_numpy(np.asarray(scatter, np.int64).reshape(-1)
                                 ).to(dev))


def _eps_in(eps_p, n: int, like: torch.Tensor) -> torch.Tensor:
    """``eps_p`` (a scalar or one value per panel) as an (n,) tensor in the
    panel dtype, a positive threshold that underflows to zero clamped to the
    dtype's smallest normal (``src/repro/kernels/panel/ops.py:20``)."""
    if isinstance(eps_p, torch.Tensor):
        eps0 = eps_p.to(like.device)
    else:                           # a Python float is a float64 value
        eps0 = torch.tensor(float(eps_p), dtype=torch.float64,
                            device=like.device)
    eps = eps0.to(like.dtype)
    if eps0.dtype != like.dtype:        # only a narrower dtype underflows
        tiny = torch.finfo(like.dtype).tiny
        eps = torch.where((eps0 > 0) & (eps <= 0),
                          torch.full((), tiny, dtype=like.dtype,
                                     device=like.device), eps)
    return eps.expand(n).contiguous()


def _check_rows(nr, limit=WINDOW_ROWS):
    if nr > limit:
        raise ValueError(f"the panel LU kernel takes nr <= {limit}, "
                         f"got {nr}")


def _check_node_panels(p3, eps):
    """(B, nr, w) panels on eps's CUDA device and dtype whose rows are
    dense; returns their batch stride."""
    b, nr, w = p3.shape
    _build.check_cuda("panel_lu", eps)
    if not p3.is_cuda or p3.get_device() != eps.get_device():
        raise ValueError(f"panel_lu: every operand must lie on one CUDA "
                         f"device, got {p3.device} and {eps.device}")
    if p3.dtype != eps.dtype:
        raise TypeError(f"panel_lu: mixed dtypes {p3.dtype} and {eps.dtype}")
    # the strides of a dimension of size 1 are arbitrary
    if (w > 1 and p3.stride(2) != 1) or (nr > 1 and p3.stride(1) != w):
        raise ValueError(f"panel_lu: a panel's rows must be dense, got "
                         f"strides {tuple(p3.stride())} for shape "
                         f"{tuple(p3.shape)}")
    return p3.stride(0) if b > 1 else nr * w


def _launch(panels, c0, wlim, eps):
    """One launch of ``panel_lu_kernel`` (``hylu_panel_lu_*``) on (B, nr,
    wt) panels whose rows are dense (a strided view of the value buffer is
    read through its batch stride), eliminated over [c0, wlim): the route
    of panels taller than the window kernel takes, and the parent design
    ``chip_smoke.py`` times beside the window kernel."""
    b, nr, wt = panels.shape
    _check_rows(nr, MAX_ROWS)
    sb = _check_node_panels(panels, eps)
    out = torch.empty((b, nr, wt), dtype=panels.dtype, device=panels.device)
    perm = torch.empty((b, nr), dtype=torch.int32, device=panels.device)
    nper = torch.empty((b,), dtype=torch.int32, device=panels.device)
    with _build.on_device(panels):
        _build.launch(f"hylu_panel_lu_{_build.suffix(panels)}",
                      _build.ptr(panels), sb, _build.ptr(out),
                      _build.ptr(perm), _build.ptr(nper), _build.ptr(eps), b,
                      nr, wt, c0, wlim, _build.stream_of(panels),
                      work=lambda: kc.as_work(panels.element_size(),
                                              kc.panel_work(b, nr, wt, c0,
                                                            wlim,
                                                            panels.element_size())))
    return out, perm, nper


@functools.lru_cache(maxsize=4096)
def _scratch(nr: int, ww: int, np_: int, inplace: bool,
             elem_bytes: int) -> int:
    """Elements of device-memory scratch a launch needs per panel of nr
    rows, a window of ww columns and a prefix of np_: 0 when the window
    fits shared memory."""
    return _build.library().hylu_panel_lu_scratch(nr, ww, np_, int(inplace),
                                                  elem_bytes)


def _node_scratch(nr: int, w: int, c0: int, elem_bytes: int) -> int:
    """K2's scratch per panel (window [c0, w), prefix [0, c0))."""
    return _scratch(nr, w - c0, c0, False, elem_bytes)


def _scratch_for(b, per_panel, like):
    return (torch.empty(b * per_panel, dtype=like.dtype, device=like.device)
            if per_panel else None)


def _launch_node(p3, lsize, eps):
    """One launch of K2's kernel (``hylu_node_panel_lu_*``) on (B, nr, w)
    panels whose rows are dense, read in place through their batch
    stride."""
    b, nr, w = p3.shape
    _check_rows(nr)
    sb = _check_node_panels(p3, eps)
    out = torch.empty((b, nr, w), dtype=p3.dtype, device=p3.device)
    perm = torch.empty((b, nr), dtype=torch.int32, device=p3.device)
    nper = torch.empty((b,), dtype=torch.int32, device=p3.device)
    scratch = _scratch_for(b, _node_scratch(nr, w, lsize, p3.element_size()),
                           p3)
    with _build.on_device(p3):
        _build.launch(f"hylu_node_panel_lu_{_build.suffix(p3)}",
                      _build.ptr(p3), sb, _build.ptr(out), _build.ptr(perm),
                      _build.ptr(nper), _build.ptr(eps),
                      None if scratch is None else _build.ptr(scratch), b,
                      nr, w, lsize, _build.stream_of(p3),
                      work=lambda: kc.as_work(p3.element_size(), kc.panel_work(
                          b, nr, w, lsize, w, p3.element_size())))
    return out, perm, nper


def _launch_batched(panels, wu, eps):
    """One launch of K1's kernel on contiguous (B, nr, wt) panels
    [window (wu) | prefix] (``hylu_panel_lu_batched_*``)."""
    b, nr, wt = panels.shape
    _check_rows(nr)
    _build.check_cuda("panel_lu_batched", panels, eps)
    out = torch.empty_like(panels)
    perm = torch.empty((b, nr), dtype=torch.int32, device=panels.device)
    nper = torch.empty((b,), dtype=torch.int32, device=panels.device)
    scratch = _scratch_for(
        b, _scratch(nr, wu, wt - wu, False, panels.element_size()), panels)
    with _build.on_device(panels):
        _build.launch(f"hylu_panel_lu_batched_{_build.suffix(panels)}",
                      _build.ptr(panels), _build.ptr(out), _build.ptr(perm),
                      _build.ptr(nper), _build.ptr(eps),
                      None if scratch is None else _build.ptr(scratch), b,
                      nr, wt, wu, _build.stream_of(panels),
                      work=lambda: kc.as_work(panels.element_size(),
                                              kc.panel_work(b, nr, wt, 0, wu,
                                                            panels.element_size())))
    return out, perm, nper


def _launch_bucket(vals, lay, eps):
    """One launch of K1's in-place kernel (``hylu_bucket_panel_lu_*``) on
    the K x B members of one bucket in the value buffer ``vals``."""
    k, ldv = vals.shape
    _build.check_cuda("panel_lu_bucket_inplace", vals, eps)
    if lay.desc.device != vals.device or lay.desc.dtype != torch.int32:
        raise ValueError(f"panel_lu_bucket_inplace: descriptors must be "
                         f"int32 on {vals.device}, got {lay.desc.dtype} on "
                         f"{lay.desc.device}")
    if not max(lay.zero_slot, lay.one_slot) < ldv:
        raise ValueError(f"panel_lu_bucket_inplace: sentinel slots "
                         f"{lay.zero_slot}, {lay.one_slot} outside a value "
                         f"buffer of {ldv}")
    b = lay.desc.shape[0]
    perm = torch.empty((k * b, lay.nr), dtype=torch.int32,
                       device=vals.device)
    nper = torch.empty((k * b,), dtype=torch.int32, device=vals.device)
    scratch = _scratch_for(
        k * b, _scratch(lay.nr, lay.wu, lay.wt - lay.wu, True,
                        vals.element_size()), vals)
    with _build.on_device(vals):
        _build.launch(f"hylu_bucket_panel_lu_{_build.suffix(vals)}",
                      _build.ptr(vals), ldv, _build.ptr(lay.desc),
                      _build.ptr(perm), _build.ptr(nper), _build.ptr(eps),
                      None if scratch is None else _build.ptr(scratch), k, b,
                      lay.nr, lay.wu, lay.wt - lay.wu, lay.zero_slot,
                      lay.one_slot, _build.stream_of(vals),
                      work=lambda: kc.as_work(vals.element_size(),
                                              kc.bucket_work(
                                                  lay.desc.cpu().numpy(),
                                                  lay.nr, k,
                                                  vals.element_size())))
    return perm, nper


def _bucket_parent(vals, lay, eps):
    """K1 on a bucket taller than the window kernel takes: the padded
    panels gathered through ``lay.gather``, factored by
    ``panel_lu_kernel`` over [0, wu) with system k's threshold, and the
    positions that read a real slot written back to it (no other slot is
    written, as in place)."""
    k = vals.shape[0]
    b = lay.desc.shape[0]
    P = vals[:, lay.gather].view(k * b, lay.nr, lay.wt)
    out, perm, nper = _launch(P, 0, lay.wu, eps.repeat_interleave(b))
    real = (lay.gather != lay.zero_slot) & (lay.gather != lay.one_slot)
    vals[:, lay.gather[real]] = out.view(k, -1)[:, real]
    return perm, nper


def panel_lu_bucket_inplace(vals: torch.Tensor, layout: BucketLayout,
                            eps_p):
    """K1 — the LU of one panel bucket's members, read from and written
    back to the value buffer ``vals`` (K, slots) in place: the padded
    panels the Pallas kernel factors (:class:`BucketLayout`), eliminated
    over [0, wu), the prefix only permuted; rows at positions below a
    member's nr go back to its real slots, and no other slot is written.
    ``eps_p`` is one threshold per system (or a scalar).  Returns (perms
    (K * B, nrp) int32, n_perturb (K * B,) int32), panel k * B + i for
    member i of system k.  A bucket of more than 128 padded rows goes to
    :func:`panel_lu_bucket_wide`.  Replaces the engine's gather +
    ``repro.kernels.panel.ops.panel_lu_batched`` + scatter
    (``src/repro/core/jax_engine.py:215–219``)."""
    if vals.ndim != 2:
        raise ValueError(f"vals must be (K, slots), got {tuple(vals.shape)}")
    if layout.nr > WIDE_ROWS:
        return panel_lu_bucket_wide(vals, layout, eps_p)
    eps = _eps_in(eps_p, vals.shape[0], vals)
    if vals.device.type == "cpu":
        return panel_lu_bucket_plain(vals, layout, eps)
    out = _launch_bucket(vals, layout, eps)
    panel_lu_bucket_inplace.launches += 1
    return out


def panel_lu_bucket_wide(vals: torch.Tensor, layout: BucketLayout, eps_p):
    """K1's wide path: :func:`panel_lu_bucket_inplace` for a bucket padded
    to more than 128 rows.  Up to 256 rows the window kernel runs in place
    (its window in shared memory where it fits, else in a device-memory
    scratch buffer); taller buckets are gathered, factored by
    ``panel_lu_kernel`` and scattered back.  Same arguments and results."""
    if vals.ndim != 2:
        raise ValueError(f"vals must be (K, slots), got {tuple(vals.shape)}")
    eps = _eps_in(eps_p, vals.shape[0], vals)
    if vals.device.type == "cpu":
        return panel_lu_bucket_plain(vals, layout, eps)
    out = (_launch_bucket(vals, layout, eps) if layout.nr <= WINDOW_ROWS
           else _bucket_parent(vals, layout, eps))
    panel_lu_bucket_wide.launches += 1
    return out


def panel_lu_batched(panels: torch.Tensor, wu: int, eps_p):
    """K1 — bucketed panel LU on column-reordered panels (B, nr, wt)
    [diag block | U suffix | L prefix]: elimination masked to [0, wu).
    Returns (panels, perms (B, nr) int32, n_perturb (B,) int32).
    Replaces ``repro.kernels.panel.ops.panel_lu_batched``."""
    if panels.ndim != 3:
        raise ValueError(f"panels must be (B, nr, wt), got {tuple(panels.shape)}")
    b, nr, wt = panels.shape
    if not nr <= wu <= wt:
        raise ValueError(f"need nr <= wu <= wt, got nr={nr} wu={wu} wt={wt}")
    eps = _eps_in(eps_p, b, panels)
    if panels.device.type == "cpu":
        return panel_lu_plain(panels, 0, wu, eps)
    out = (_launch_batched(panels, wu, eps) if nr <= WINDOW_ROWS
           else _launch(panels, 0, wu, eps))
    panel_lu_batched.launches += 1
    return out


def _node_args(panel, nr, lsize, eps_p):
    single = panel.ndim == 2
    p3 = panel[None] if single else panel
    if p3.ndim != 3 or p3.shape[1] != nr or lsize + nr > p3.shape[2]:
        raise ValueError(f"panel shape {tuple(panel.shape)} does not hold "
                         f"nr={nr} rows with the block at column {lsize}")
    return single, p3, _eps_in(eps_p, p3.shape[0], p3)


def _node_result(single, out):
    return tuple(t[0] for t in out) if single else out


def panel_lu(panel: torch.Tensor, nr: int, lsize: int, eps_p):
    """K2 — LU of node panels [L prefix | diag block | U suffix] with the
    block at column ``lsize``: (nr, w) or a batch (B, nr, w), one system per
    batch member.  The panels may be a strided view whose rows are dense
    (a slice of each system's value buffer): the kernel reads them through
    their batch stride.  Returns a new (panel, perm, n_perturb) with perm
    (nr,) / (B, nr) int32 and n_perturb a () / (B,) int32 tensor.  Panels
    of more than 128 rows go to :func:`panel_lu_wide`.  Replaces
    ``repro.kernels.panel.ops.panel_lu``."""
    if nr > WIDE_ROWS:
        return panel_lu_wide(panel, nr, lsize, eps_p)
    single, p3, eps = _node_args(panel, nr, lsize, eps_p)
    if p3.device.type == "cpu":
        return _node_result(single, panel_lu_plain(p3, lsize, p3.shape[2],
                                                   eps))
    out = _launch_node(p3, lsize, eps)
    panel_lu.launches += 1
    return _node_result(single, out)


def panel_lu_wide(panel: torch.Tensor, nr: int, lsize: int, eps_p):
    """K2's wide path: :func:`panel_lu` for panels of more than 128 rows.
    Up to 256 rows the window kernel runs (its window in shared memory
    where it fits, else in a device-memory scratch buffer); taller panels
    run ``panel_lu_kernel``.  Same arguments and results."""
    single, p3, eps = _node_args(panel, nr, lsize, eps_p)
    if p3.device.type == "cpu":
        return _node_result(single, panel_lu_plain(p3, lsize, p3.shape[2],
                                                   eps))
    out = (_launch_node(p3, lsize, eps) if nr <= WINDOW_ROWS
           else _launch(p3, lsize, p3.shape[2], eps))
    panel_lu_wide.launches += 1
    return _node_result(single, out)


panel_lu_bucket_inplace.launches = 0
panel_lu_bucket_wide.launches = 0
panel_lu_batched.launches = 0
panel_lu.launches = 0
panel_lu_wide.launches = 0
