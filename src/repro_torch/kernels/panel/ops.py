"""Panel LU wrappers: K1 (bucketed) and K2 (one node panel per system).

On a CUDA tensor each wrapper launches its hand-written kernel (both in
``csrc/panel_lu.cu``, each with its own entry points) or raises; on a CPU
tensor it runs the plain PyTorch version of :mod:`.ref`.  Every launch adds
one to the wrapper's ``launches`` count.

Dtype contract (as ``src/repro/kernels/panel/ops.py``): the LU runs in the
panel dtype; the threshold is cast to it and clamped against underflow
(``_eps_in``).  Unlike the Pallas wrappers, ``eps_p`` may hold one
threshold per panel, because the batched engine perturbs each system
against its own max|A|.
"""
from __future__ import annotations

import functools

import torch

from .. import _build
from .ref import panel_lu_plain

__all__ = ["panel_lu", "panel_lu_batched", "panel_lu_plain"]

MAX_ROWS = 128


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


def _check_rows(nr):
    if nr > MAX_ROWS:
        raise ValueError(f"the panel LU kernel takes nr <= {MAX_ROWS}, "
                         f"got {nr}")


def _launch(panels, c0, wlim, eps):
    """One launch of ``csrc/panel_lu.cu`` (K1's kernel; with c0 = lsize and
    wlim = w it is also K2's design before the node kernel)."""
    b, nr, wt = panels.shape
    _check_rows(nr)
    _build.check_cuda("panel_lu", panels, eps)
    out = torch.empty_like(panels)
    perm = torch.empty((b, nr), dtype=torch.int32, device=panels.device)
    nper = torch.empty((b,), dtype=torch.int32, device=panels.device)
    with _build.on_device(panels):
        _build.launch(f"hylu_panel_lu_{_build.suffix(panels)}",
                      _build.ptr(panels), _build.ptr(out), _build.ptr(perm),
                      _build.ptr(nper), _build.ptr(eps), b, nr, wt, c0, wlim,
                      _build.stream_of(panels))
    return out, perm, nper


@functools.lru_cache(maxsize=4096)
def _node_scratch(nr: int, w: int, c0: int, elem_bytes: int) -> int:
    """Elements of device-memory scratch K2 needs per panel: 0 when its
    window [c0, w) fits shared memory."""
    return _build.library().hylu_node_panel_lu_scratch(nr, w, c0, elem_bytes)


def _launch_node(p3, lsize, eps):
    """One launch of K2's kernel (``hylu_node_panel_lu_*``) on (B, nr, w)
    panels whose rows are dense, read in place through their batch
    stride."""
    b, nr, w = p3.shape
    _check_rows(nr)
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
    sb = p3.stride(0) if b > 1 else nr * w
    out = torch.empty((b, nr, w), dtype=p3.dtype, device=p3.device)
    perm = torch.empty((b, nr), dtype=torch.int32, device=p3.device)
    nper = torch.empty((b,), dtype=torch.int32, device=p3.device)
    per_panel = _node_scratch(nr, w, lsize, p3.element_size())
    scratch = (torch.empty(b * per_panel, dtype=p3.dtype, device=p3.device)
               if per_panel else None)
    with _build.on_device(p3):
        _build.launch(f"hylu_node_panel_lu_{_build.suffix(p3)}",
                      _build.ptr(p3), sb, _build.ptr(out), _build.ptr(perm),
                      _build.ptr(nper), _build.ptr(eps),
                      None if scratch is None else _build.ptr(scratch), b,
                      nr, w, lsize, _build.stream_of(p3))
    return out, perm, nper


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
    out = _launch(panels, 0, wu, eps)
    panel_lu_batched.launches += 1
    return out


def panel_lu(panel: torch.Tensor, nr: int, lsize: int, eps_p):
    """K2 — LU of node panels [L prefix | diag block | U suffix] with the
    block at column ``lsize``: (nr, w) or a batch (B, nr, w), one system per
    batch member.  The panels may be a strided view whose rows are dense
    (a slice of each system's value buffer): the kernel reads them through
    their batch stride.  Returns a new (panel, perm, n_perturb) with perm
    (nr,) / (B, nr) int32 and n_perturb a () / (B,) int32 tensor.  Replaces
    ``repro.kernels.panel.ops.panel_lu``."""
    single = panel.ndim == 2
    p3 = panel[None] if single else panel
    if p3.ndim != 3 or p3.shape[1] != nr or lsize + nr > p3.shape[2]:
        raise ValueError(f"panel shape {tuple(panel.shape)} does not hold "
                         f"nr={nr} rows with the block at column {lsize}")
    b, _, w = p3.shape
    eps = _eps_in(eps_p, b, p3)
    if p3.device.type == "cpu":
        out, perm, nper = panel_lu_plain(p3, lsize, w, eps)
    else:
        out, perm, nper = _launch_node(p3, lsize, eps)
        panel_lu.launches += 1
    if single:
        return out[0], perm[0], nper[0]
    return out, perm, nper


panel_lu_batched.launches = 0
panel_lu.launches = 0
