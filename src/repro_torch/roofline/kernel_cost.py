"""The work of each hand-written kernel: the operations and bytes one
launch needs, from its shapes (and, where the work depends on the data,
from the launch's own descriptors).  One count for two readers: each
wrapper reports its launch's work from these formulas to
``roofline.op_cost`` (through ``kernels._build.launch``), and
``chip_smoke.py``'s bound column computes its bounds from them.

Every function returns ``(operations, bytes)``: the least work of the
function the kernel computes, each input byte read once and each output
byte written once; ``elem`` is the element size in bytes.  A
wrapper hands ``op_cost`` its launch's work as :func:`as_work` gives it.

Kernels: K1 bucketed panel LU, K2 node panel LU, K3 triangular solves,
K4 batched GEMM, K5 GEMM update and node step, K6 sup-row update, K7
flash attention, K8 the WKV recurrence (PERF.md §6).
"""
from __future__ import annotations

import numpy as np

_DTYPE = {8: "float64", 4: "float32", 2: "bfloat16"}


def lu_flops(npan, nr, c0, wlim) -> float:
    """Operations of ``npan`` panel LUs of nr rows eliminated over the
    columns [c0, wlim): a division per multiplier and a multiply-add per
    updated entry."""
    j = np.arange(nr)
    return npan * float(np.sum((nr - j - 1)
                               * (1 + 2 * np.maximum(wlim - c0 - j - 1, 0))))


def bucket_work(desc, nrp: int, k: int, elem: int):
    """One K1 call on ``k`` systems of a bucket whose members the
    descriptors (B, 5) (slot offset, nr, w, lsize, usize) describe, padded
    to ``nrp`` rows: the members' real pivot steps over their real
    windows, their real slots read and written once, the thresholds, the
    descriptors and the perm and counts of every padded row."""
    desc = np.asarray(desc, np.int64).reshape(-1, 5)
    flops = sum(lu_flops(k, int(nr), 0, int(nr + us))
                for _, nr, _, _, us in desc)
    nbytes = (2 * k * int((desc[:, 1] * desc[:, 2]).sum()) * elem + k * elem
              + 4 * k * len(desc) * (nrp + 1) + 4 * desc.size)
    return flops, nbytes


def panel_work(b: int, nr: int, w: int, c0: int, wlim: int, elem: int):
    """One launch of b dense panels (nr, w) eliminated over [c0, wlim): K2
    and the panel kernels of K1's wide and parent routes; panels read and
    written once, the thresholds, perm and counts."""
    return (lu_flops(b, nr, c0, wlim),
            (2 * b * nr * w + b) * elem + b * (nr + 1) * 4)


def node_work(plan, t: int, elem: int, k_sys: int = 1):
    """Node t's K5 step on ``k_sys`` systems: per system and edge nr k^2
    for the right solve and 2 nr k m for the product; per system the
    panel's touched columns read and written once per row, of each edge's
    source rows the part the function reads once (U's upper triangle,
    k (k + 1) / 2, and the k x m rows past it) and, for a width-1 node,
    its pivot and threshold; once, each edge's col_map and descriptor."""
    nodes = plan.nodes
    nd = nodes[t]
    edges = [(nodes[e.src].nr, np.asarray(e.col_map)) for e in nd.edges]
    return node_step(nd.nr, edges, elem, k_sys)


def node_step(nr, edges, elem, k_sys):
    """``node_work`` from the node's rows and its edges' (k, col_map): the
    count the node-step wrapper reports from its edge table."""
    flops = float(sum(nr * (k ** 2 + 2 * k * (len(cm) - k))
                      for k, cm in edges))
    touched = (np.unique(np.concatenate([cm for _, cm in edges])).size
               if edges else int(nr == 1))
    src_elems = sum(k * (k + 1) // 2 + k * (len(cm) - k) for k, cm in edges)
    nbytes = (k_sys * (2 * nr * touched * elem + src_elems * elem
                       + (2 * elem + 4 if nr == 1 else 0))
              + sum(8 * (len(cm) + 5) for _, cm in edges))
    return k_sys * flops, nbytes


def trsm_right(n: int, nr: int, k: int, elem: int):
    """K3's right solve Y U = X on n products: U's upper triangle read
    once, X read and Y written."""
    return (float(n * nr * k * k),
            (n * k * (k + 1) // 2 + 2 * n * nr * k) * elem)


def trsm_left(unit_lower: bool, n: int, k: int, m: int, elem: int):
    """K3's left solves on n blocks (k, k) and right-hand sides (k, m):
    the unit-lower one reads the strict lower triangle, the upper one the
    upper triangle with its diagonal; b read, w written."""
    if unit_lower:
        return (float(n * k * (k - 1) * m),
                (n * k * (k - 1) // 2 + 2 * n * k * m) * elem)
    return (float(n * k * k * m), (n * k * (k + 1) // 2 + 2 * n * k * m)
            * elem)


def bmm(e: int, n: int, k: int, m: int, elem: int):
    """K4: (E, n, k) @ (E, k, m)."""
    return 2.0 * e * n * k * m, elem * e * (n * k + k * m + n * m)


def gemm_update(e: int, n: int, k: int, m: int, elem: int):
    """K5's GEMM update C − A·B: A and B read, C read and written."""
    return 2.0 * e * n * k * m, elem * e * (n * k + k * m + 2 * n * m)


def suprow(rows: int, k: int, m: int, elem: int):
    """K6 on ``rows`` rows of one (k, m) group: k^2 + 2 k m operations a
    row; x (k + m), U's upper triangle k (k + 1) / 2 and the k x m rows
    past it read once, y (k) and xr (m) written once."""
    return (rows * float(k * k + 2 * k * m),
            rows * elem * float(2 * (k + m) + k * (k + 1) // 2 + k * m))


def suprow_work(groups, elem: int):
    """K6 over every row of ``groups`` {(k, m): (x, ...)}."""
    flops = nbytes = 0.0
    for (k, m), (x, *_) in groups.items():
        f, b = suprow(x.shape[0], k, m, elem)
        flops, nbytes = flops + f, nbytes + b
    return flops, nbytes


def flash(b: int, hq: int, hkv: int, t: int, s: int, d: int, elem: int,
          causal: bool = True):
    """K7: per query head and (row, column) pair the causal mask keeps (all
    T·S without it), q·k and p·v, 4 D operations; q, k, v read and o
    written once."""
    pairs = t * (t + 1) / 2 if causal else float(t * s)
    return (4.0 * d * pairs * b * hq,
            (2 * b * hq * t * d + 2 * b * hkv * s * d) * elem)


def wkv(b: int, nh: int, t: int, hs: int, u_elems: int):
    """K8 in float32: per step and head, k v^T, the state update and y's
    sum over rows (5 hs^2), the bonus sum_k r u k and its product with v
    (5 hs); r, k, v, w read and y written once, u (``u_elems``) read and
    the final state written."""
    steps = t * b * nh
    return ((5.0 * hs * hs + 5.0 * hs) * steps,
            4 * (5 * b * nh * t * hs + u_elems + b * nh * hs * hs))


def as_work(elem: int, flops_bytes, tensor_cores: bool = False):
    """({dtype name: operations}, bytes) of an (operations, bytes) pair
    for ``op_cost``, the operations under the peak they run at: a
    bfloat16 kernel's arithmetic is float32 on the SIMT cores unless it
    runs on the tensor cores (K4, K7)."""
    flops, nbytes = flops_bytes
    dt = _DTYPE[elem]
    if dt == "bfloat16" and not tensor_cores:
        dt = "float32"
    return {dt: float(flops)}, float(nbytes)
