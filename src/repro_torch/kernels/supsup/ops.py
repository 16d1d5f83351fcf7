"""Sup-sup wrappers: K4 ``gemm_batched`` (``csrc/bmm.cu``), the trailing
update of a sup-sup edge bucket, and K5 (``csrc/gemm_update.cu``):
``node_edges_inplace``, the unrolled schedule's node step (a node's whole
edge loop, the sup-sup updates C − A·B among them, in one launch, in
place; a node with an edge source of more than 128 rows goes to
``node_edges_wide``, the kernel's instance that blocks the solve over k),
and the parent design ``gemm_update``, C − A·B per edge, under
``supsup_update`` (K3's right solve, then ``gemm_update``), which no engine
path calls any more.  Its kernel (``hylu_gemm_update_*``) takes strided
views and may write C in place; no path of the system launches it.

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version of :mod:`.ref`.  Every launch adds one to
the wrapper's ``launches``; an empty product (m == 0 or k == 0) launches
nothing, as ``src/repro/kernels/supsup/ops.py:35, 57``.  Unlike the JAX
wrappers, nothing is padded: the kernels take the exact shapes.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ...roofline import kernel_cost as kc
from .. import _build
from ..trisolve import ops as trisolve_ops
from .ref import (gemm_batched_plain, gemm_update_plain, node_edges_plain,
                  supsup_update_plain)

__all__ = ["EdgeTable", "NodeStep", "edge_table", "node_step",
           "node_edges_inplace", "node_edges_wide", "node_edges_plain",
           "gemm_batched",
           "gemm_update", "supsup_update", "gemm_batched_plain",
           "gemm_update_plain", "supsup_update_plain"]

WIDE_K = 128                # sources above this run the wide instance
_NODE_EDGES = {torch.float64: "hylu_node_edges_f64",
               torch.float32: "hylu_node_edges_f32",
               torch.bfloat16: "hylu_node_edges_bf16"}
_NODE_EDGES_WIDE = {torch.float64: "hylu_node_edges_wide_f64",
                    torch.float32: "hylu_node_edges_wide_f32",
                    torch.bfloat16: "hylu_node_edges_wide_bf16"}


class EdgeTable(NamedTuple):
    """Every edge of an unrolled plan, in node order, on one device."""
    desc: torch.Tensor     # (E, 5) int64: soff + slsize, col_map offset,
    #                        k, sw, len(col_map)
    col_map: torch.Tensor  # every edge's col_map, concatenated, int64
    edges: list            # per edge (soff, k, sw, slsize, cm): the plain
    #                        version's, cm a view of col_map


class NodeStep(NamedTuple):
    """One node of the unrolled program: its panel (nr rows of w at slot
    offset ``off``, pivot block at column ``lsize``), its edges [e0, e1) of
    the :class:`EdgeTable` and the rows of its widest edge source
    ``kmax``; ``args`` are the launch's constant ctypes arguments, made
    once."""
    off: int
    nr: int
    w: int
    lsize: int
    e0: int
    e1: int
    kmax: int
    args: tuple


def edge_table(edges, device) -> EdgeTable:
    """An :class:`EdgeTable` on ``device`` from host edges ``(soff, k, sw,
    slsize, col_map)``: one host→device copy for all col_maps and one for
    the descriptors.  Raises for k < 1 or a col_map shorter than k."""
    cms = [np.asarray(e[4], np.int64) for e in edges]
    lens = np.array([len(c) for c in cms], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    desc = np.array([(soff + slsize, o, k, sw, n) for (soff, k, sw, slsize,
                                                       _), o, n
                     in zip(edges, starts, lens)], np.int64).reshape(-1, 5)
    if ((desc[:, 2] < 1) | (desc[:, 4] < desc[:, 2])).any():
        raise ValueError("edge descriptors need k >= 1 and len(col_map) "
                         ">= k")
    dev = torch.device(device)
    flat = torch.from_numpy(np.concatenate(cms) if cms
                            else np.zeros(0, np.int64)).to(dev)
    views = [flat[o:o + n] for o, n in zip(starts.tolist(), lens.tolist())]
    return EdgeTable(desc=torch.from_numpy(desc).to(dev), col_map=flat,
                     edges=[(int(soff), int(k), int(sw), int(slsize), cm)
                            for (soff, k, sw, slsize, _), cm
                            in zip(edges, views)])


def node_step(off: int, nr: int, w: int, lsize: int, e0: int, e1: int,
              kmax: int) -> NodeStep:
    """A :class:`NodeStep`, its launch arguments made once; ``kmax`` is the
    rows of the node's widest edge source (0 without edges)."""
    if not (1 <= nr and 0 <= lsize and lsize + nr <= w and 0 <= e0 <= e1
            and (kmax >= 1 or e0 == e1) and kmax >= 0):
        raise ValueError(f"node (off={off}, nr={nr}, w={w}, lsize={lsize}, "
                         f"edges [{e0}, {e1}), kmax={kmax}) is not a panel")
    return NodeStep(off, nr, w, lsize, e0, e1, kmax,
                    (ctypes.c_longlong(off), ctypes.c_int(nr),
                     ctypes.c_int(w), ctypes.c_int(lsize)))


def node_edges_inplace(vals: torch.Tensor, table: EdgeTable, step: NodeStep,
                       eps: torch.Tensor, nper: torch.Tensor,
                       n_edges=None) -> None:
    """K5 — one node step of the unrolled schedule in place on the value
    buffer ``vals`` (K, slots): the node's edges ``[step.e0, step.e1)`` in
    order (for each, the right solve lts = x[:, :k] U⁻¹ and x[:, k:] −
    lts · src[:, k:] on the panel's columns of the edge's col_map), then,
    for a width-1 node, the pivot perturbation against ``eps`` (K,), the
    vals dtype, counted into ``nper`` (K,) int32 — as :func:`.ref.
    node_edges_plain`.  ``n_edges`` runs only the first ``n_edges`` edges
    and no perturbation.  Nothing is launched when there is nothing to
    do.  A node with an edge source of more than 128 rows goes to
    :func:`node_edges_wide`.  Replaces the engine's per-edge gather,
    ``supsup_update`` (K3 + ``gemm_update``) and write-back, and
    ``repro.kernels.supsup.ops.supsup_update`` under
    ``_node_step_unrolled``."""
    if vals.device.type == "cpu":
        return node_edges_plain(vals, table, step, eps, nper, n_edges)
    if step.kmax > WIDE_K:
        return node_edges_wide(vals, table, step, eps, nper, n_edges)
    if _launch_node_edges(_NODE_EDGES, vals, table, step, eps, nper,
                          n_edges):
        node_edges_inplace.launches += 1
    return None


def node_edges_wide(vals: torch.Tensor, table: EdgeTable, step: NodeStep,
                    eps: torch.Tensor, nper: torch.Tensor,
                    n_edges=None) -> None:
    """K5's node step for a node with an edge source of any rows (the
    kernel's WIDE instance, ``hylu_node_edges_wide_*``): each edge's solve
    runs in blocks of 128 source rows, the lts of the blocks before taken
    from shared memory, sized to ``step.kmax``.  Otherwise as
    :func:`node_edges_inplace`, which hands it the nodes that need it."""
    if vals.device.type == "cpu":
        return node_edges_plain(vals, table, step, eps, nper, n_edges)
    if _launch_node_edges(_NODE_EDGES_WIDE, vals, table, step, eps, nper,
                          n_edges, (step.kmax,)):
        node_edges_wide.launches += 1
    return None


def _node_step_work(step, table, e0, e1, vals):
    """K5's node step's (operations, bytes) over edges [e0, e1) of the
    table (``kernel_cost``), on the rows of ``vals``."""
    edges = [(k, cm.cpu().numpy()) for _, k, _, _, cm in table.edges[e0:e1]]
    return kc.node_step(step.nr, edges, vals.element_size(), vals.shape[0])


def _launch_node_edges(names, vals, table, step, eps, nper, n_edges,
                       extra=()) -> bool:
    """Check the operands and launch one node step on CUDA tensors; False
    when there is nothing to do."""
    e1 = step.e1 if n_edges is None else step.e0 + n_edges
    perturb = n_edges is None and step.nr == 1
    if e1 == step.e0 and not perturb:
        return False
    name = names.get(vals.dtype)
    if name is None:
        raise TypeError(f"the CUDA kernels take bfloat16, float64 or "
                        f"float32, got {vals.dtype}")
    if (vals.ndim != 2 or not vals.is_contiguous() or not eps.is_contiguous()
            or not nper.is_contiguous() or eps.shape != vals.shape[:1]
            or nper.shape != vals.shape[:1]):
        raise ValueError(f"node_edges_inplace: need contiguous vals (K, "
                         f"slots), eps (K,) and nper (K,), got "
                         f"{tuple(vals.shape)}, {tuple(eps.shape)} and "
                         f"{tuple(nper.shape)}")
    if eps.dtype != vals.dtype or nper.dtype != torch.int32:
        raise TypeError(f"node_edges_inplace: eps must be {vals.dtype} and "
                        f"nper int32, got {eps.dtype} and {nper.dtype}")
    dev = vals.device
    if not (vals.is_cuda and eps.device == nper.device == table.desc.device
            == dev and e1 <= table.desc.shape[0]):
        raise ValueError(f"node_edges_inplace: vals, eps, nper and the edge "
                         f"table must lie on one CUDA device and hold edges "
                         f"[{step.e0}, {e1})")
    if step.off + step.nr * step.w > vals.shape[1]:
        raise ValueError(f"node_edges_inplace: panel past the value buffer "
                         f"of {vals.shape[1]} slots")
    with _build.on_device(vals):
        _build.launch(name, vals.data_ptr(), vals.shape[1], *step.args,
                      table.desc.data_ptr(), table.col_map.data_ptr(),
                      step.e0, e1, eps.data_ptr(), nper.data_ptr(),
                      int(perturb), vals.shape[0], *extra,
                      _build.stream_of(vals),
                      work=lambda: kc.as_work(vals.element_size(),
                                              _node_step_work(
                                                  step, table, step.e0, e1,
                                                  vals)))
    return True


# K4's entry points by dtype: the wrapper runs 516 times per bucketed
# refactor of fem2d_10k, where its host cost is that of the launch
_BMM = {torch.float64: "hylu_bmm_f64", torch.float32: "hylu_bmm_f32",
        torch.bfloat16: "hylu_bmm_bf16"}


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
    if a.is_cpu:
        return gemm_batched_plain(a, b)
    _build.check_cuda("gemm_batched", a, b)
    name = _BMM.get(a.dtype)
    if name is None:
        raise TypeError(f"the CUDA kernels take bfloat16, float64 or "
                        f"float32, got {a.dtype}")
    c = a.new_empty((e, nr, m))
    if e and nr:
        with _build.on_device(a):
            _build.launch(name, a.data_ptr(), b.data_ptr(), c.data_ptr(), e,
                          nr, k, m, _build.stream_of(a),
                          work=lambda: kc.as_work(
                              a.element_size(),
                              kc.bmm(e, nr, k, m, a.element_size()),
                              tensor_cores=True))
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
        sc, sa, sb = (_build.row_strides("gemm_update", t) for t in (c, a, b))
        with _build.on_device(c):
            _build.launch(f"hylu_gemm_update_{_build.suffix(c)}",
                          _build.ptr(c), *sc, _build.ptr(a), *sa,
                          _build.ptr(b), *sb, _build.ptr(out), *sc, e, nr, k,
                          m, _build.stream_of(c),
                          work=lambda: kc.as_work(c.element_size(),
                                                  kc.gemm_update(
                                                      e, nr, k, m,
                                                      c.element_size())))
        gemm_update.launches += 1
    return out


def supsup_update(x: torch.Tensor, src: torch.Tensor, k: int):
    """The sup-sup update of a gathered target slice x (E, nr, k+m) by the
    source rows src (E, k, k+m): K3's right solve ``lts · U = x[..., :k]``,
    then K5 ``xr = x[..., k:] − lts · src[..., k:]``.  Returns (lts, xr).
    Replaces ``repro.kernels.supsup.ops.supsup_update``."""
    if x.device.type == "cpu":
        return supsup_update_plain(x, src, k)
    lts = trisolve_ops.trsm_batched(src[..., :k], x[..., :k].contiguous())
    xr = gemm_update(x[..., k:].contiguous(), lts,
                     src[..., k:].contiguous())
    return lts, xr


gemm_batched.launches = 0
gemm_update.launches = 0
node_edges_inplace.launches = 0
node_edges_wide.launches = 0
