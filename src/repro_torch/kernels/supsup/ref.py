"""Plain PyTorch versions of the sup-sup kernels (the counterparts of
``src/repro/kernels/supsup/ref.py``), batched over a leading dim, and of
the unrolled schedule's node step (``node_edges_plain``)."""
from __future__ import annotations

import torch

from ..trisolve.ref import trsm_plain


def gemm_batched_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (E, nr, k) @ b (E, k, m) → (E, nr, m)."""
    return torch.matmul(a, b)


def gemm_update_plain(c: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """c (E, nr, m) − a (E, nr, k) @ b (E, k, m).  Below float32 (bfloat16)
    the product is summed in float32, subtracted from c in float32 and
    rounded once, as the Pallas kernel's float32 accumulator does."""
    if torch.finfo(c.dtype).bits < 32:
        return (c.float() - torch.matmul(a.float(), b.float())).to(c.dtype)
    return c - torch.matmul(a, b)


def supsup_update_plain(x: torch.Tensor, src: torch.Tensor, k: int):
    """The sup-sup update of a gathered target slice x (E, nr, k+m) by the
    source rows src (E, k, k+m): ``lts = x[..., :k] · U⁻¹`` (U the upper
    triangle of ``src[..., :k]``) and ``xr = x[..., k:] − lts · src[..., k:]``.
    Returns (lts, xr)."""
    lts = trsm_plain(src[..., :k], x[..., :k])
    return lts, gemm_update_plain(x[..., k:], lts, src[..., k:])


def node_edges_plain(vals: torch.Tensor, table, step, eps: torch.Tensor,
                     nper: torch.Tensor, n_edges=None,
                     use_kernels: bool = True) -> None:
    """One node step of the unrolled schedule, in place on the value buffer
    ``vals`` (K, slots) (``_node_step_unrolled``,
    ``src/repro/core/jax_engine.py:132–161``): the node's left-looking edge
    loop over the edges ``table.edges[step.e0:step.e1]`` (each ``(soff, k,
    sw, slsize, cm)``: the source panel's offset, rows, width and L-prefix
    size, and the edge's col_map), then, for a width-1 node, its pivot
    perturbation (``jax_engine.py:103–108``): |d| < eps → ±eps by the sign
    of d, NaN left as it is, counted into ``nper`` (K,) int32.  eps is (K,).
    ``n_edges`` runs only the first ``n_edges`` edges and no perturbation.
    Per edge, the target panel's columns are gathered through the col_map
    (no duplicates) and written back:

    * k == 1: a divide and a rank-1 update;
    * k > 1 and nr > 1: ``supsup_update_plain`` (the plain versions of K3
      and K5; in bfloat16 C − A·B rounded once, as the Pallas kernel) when
      ``use_kernels``, else a triangular solve and a product (in bfloat16,
      which ``torch.linalg.solve_triangular`` does not take on either
      device, ``trsm_plain``: the JAX package's ``_trsm_upper_jax``);
    * k > 1 and nr == 1: ``trsm_plain`` and a product, as the JAX package
      does there with or without Pallas (``_trsm_upper_jax``,
      ``jax_engine.py:53``): per column a dot over U[:j, j], then a
      division, so a zero divisor gives the reference's NaN and inf
      positions whatever order a library's triangular solve keeps."""
    k_sys = vals.shape[0]
    nr, w, lsize = step.nr, step.w, step.lsize
    panel = vals[:, step.off:step.off + nr * w].view(k_sys, nr, w)  # a view
    e1 = step.e1 if n_edges is None else step.e0 + n_edges
    for soff, k, sw, slsize, cm in table.edges[step.e0:e1]:
        src = vals[:, soff:soff + k * sw].view(k_sys, k, sw)[:, :, slsize:]
        x = panel[:, :, cm]                            # (K, nr, k+m)
        if k == 1:                                     # row-row/sup-row
            lts = x[:, :, :1] / src[:, :, :1]
            xr = x[:, :, 1:] - lts * src[:, :, 1:]
        elif nr > 1 and use_kernels:                   # sup-sup
            lts, xr = supsup_update_plain(x, src, k)
        else:                                # sup-row; sup-sup, plain
            if nr == 1 or x.dtype == torch.bfloat16:
                lts = trsm_plain(src[:, :, :k], x[:, :, :k])
            else:
                lts = torch.linalg.solve_triangular(
                    src[:, :, :k], x[:, :, :k], upper=True, left=False)
            xr = x[:, :, k:] - torch.matmul(lts, src[:, :, k:])
        panel[:, :, cm] = torch.cat([lts, xr], dim=2)
    if n_edges is None and nr == 1:                    # perturb the pivot
        d = panel[:, 0, lsize]
        small = d.abs() < eps
        panel[:, 0, lsize] = torch.where(
            small, torch.where(d >= 0, eps, -eps), d)
        nper += small.to(torch.int32)
