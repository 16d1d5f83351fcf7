"""The port's CUDA kernels on the card (marker ``cuda``; skips without one).

Each kernel against its plain PyTorch version on the same device tensors
(K1 and K2 also on panels with a zero pivot under a zero threshold or a
non-finite entry; K4 over ragged shapes at one product and 2,048; K5's
node step on synthetic nodes, a NaN source and zero pivots, every node of
one unrolled refactor of fem2d(12, 12) and fem2d_10k's largest node; K7 and
K8 on the strided layouts the models hand them, K7 at every head width,
ragged, with GQA and with S != T, K8 at every head width, ragged, at
rwkv6's full shape and at extreme decays),
the engine on the card against the engine on the CPU, the unrolled
one-system lifecycle against the bucketed one, and the serving path of two
reduced models on the card (K7 / K8 in prefill) against the CPU.  This file
imports neither JAX nor the JAX package, so on a machine that has a card
but no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: 1e-10 in float64, 1e-4 in float32 and 1e-3 for the float32
left solves (``tests/test_kernels.py``); the kernels sum in another order
than the plain versions, nothing else.  Pivot permutations and
perturbation counts must match exactly.  Between the card and the CPU the
duplicate-index scatter-adds (``index_add_``) sum in an order that changes
from run to run on the card, so the engine is held to 1e-10 there too,
not to bit-identity.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.core import (HyluOptions, analyze, factor,  # noqa: E402
                              factor_batched, refactor, solve, solve_batched,
                              torch_repeated_engine)
from repro_torch.kernels.flashattn import ops as flash  # noqa: E402
from repro_torch.kernels.panel import ops as panel  # noqa: E402
from repro_torch.kernels.suprow import ops as suprow  # noqa: E402
from repro_torch.kernels.supsup import ops as supsup  # noqa: E402
from repro_torch.kernels.trisolve import ops as tri  # noqa: E402
from repro_torch.kernels.trisolve import ref as tri_ref  # noqa: E402
from repro_torch.kernels.wkv import ops as wkvops  # noqa: E402
from repro_torch.matrices import circuit_like, fem2d, to_csr  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import serve_step as S  # noqa: E402

# the wrappers the batched path launches (K5 runs in the unrolled schedule,
# K6 on no engine path)
BATCHED_PATH = ("panel_lu_bucket_inplace", "panel_lu", "trsm_batched",
                "trsm_left_unit_lower_batched", "trsm_left_upper_batched",
                "gemm_batched")
TOLS = {"float64": (torch.float64, 1e-10, 1e-10),
        "float32": (torch.float32, 1e-4, 1e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _tri(rng, b, k):
    return np.triu(rng.normal(size=(b, k, k))) + 3 * np.eye(k)


def _wide_block(rng, b, k):
    """(b, k, k) dense diagonal blocks whose unit-lower and upper triangles
    both stay well conditioned at k > 128 (strict upper part scaled by
    1/sqrt(k), strict lower part by 1/k, diagonal 3 plus noise), so that
    float32 holds its tolerance through the wide solves."""
    return (np.triu(rng.normal(size=(b, k, k)), 1) / np.sqrt(k)
            + np.tril(rng.normal(size=(b, k, k)), -1) / k
            + (3 + 0.1 * rng.random((b, k, 1))) * np.eye(k))


def _node_buffer(rng, K, nr, w, lsize, sources, tdt, dev):
    """A value buffer (K, slots) of finished source panels and one target
    node of nr rows of w (pivot block at column ``lsize``), three random
    slots between panels; ``sources`` lists (k, m) per edge, in order: a
    source of k rows, an L prefix of 2, a dominant U block (strict upper
    part scaled by 1/sqrt(k); random below it, which nothing may read) and
    an m-column suffix, mapped into k + m distinct random target columns.
    Returns (vals, edge table, node step)."""
    parts, edges, pos = [], [], 3
    for k, m in sources:
        p = rng.normal(size=(K, k, 2 + k + m))
        p[:, :, 2:2 + k] = (np.triu(rng.normal(size=(K, k, k)), 1)
                            / np.sqrt(k) + 3 * np.eye(k)
                            + np.tril(rng.normal(size=(K, k, k)), -1))
        parts.append((pos, p))
        edges.append((pos, k, 2 + k + m, 2,
                      np.sort(rng.choice(w, size=k + m, replace=False))))
        pos += p[0].size + 3
    p = rng.normal(size=(K, nr, w))
    p[:, :, lsize:lsize + nr] += 3 * np.eye(nr)
    parts.append((pos, p))
    off = pos
    vals = rng.normal(size=(K, pos + p[0].size + 3))
    for o, p in parts:
        vals[:, o:o + p[0].size] = p.reshape(K, -1)
    table = supsup.edge_table(edges, dev)
    step = supsup.node_step(off, nr, w, lsize, 0, len(edges),
                            max((k for k, _ in sources), default=0))
    return torch.tensor(vals, dtype=tdt, device=dev), table, step


def _cases(rng, tdt, dev):
    def t(a):
        return torch.tensor(a, dtype=tdt, device=dev)

    pb = t(rng.normal(size=(6, 32, 80)))        # bucket: block + U + L
    p2 = t(rng.normal(size=(4, 24, 60)))        # node panel, block at 10
    # too big for shared memory; a dominant block keeps 128 float32 pivot
    # steps inside the 1e-4 tolerance (a random 128-row block missed it on
    # the card); the random block is held in float64 below
    p3 = rng.normal(size=(2, 128, 300))
    p3[:, :, 100:228] += 16 * np.eye(128)
    p3 = t(p3)
    u = t(_tri(rng, 5, 40) + np.tril(rng.normal(size=(5, 40, 40)), -1))
    x = t(rng.normal(size=(5, 70, 40)))
    blk = t(_tri(rng, 4, 33) + np.tril(rng.normal(size=(4, 33, 33)), -1))
    b = t(rng.normal(size=(4, 33, 20)))         # two column tiles
    a, bb = t(rng.normal(size=(5, 40, 24))), t(rng.normal(size=(5, 24, 50)))
    # K5 at the largest sup-sup edge of fem2d_10k's unrolled schedule and at
    # ragged tile edges; K6 at two column tiles.  Source blocks have their
    # strict upper part scaled by 1/sqrt(k), so that float32 stays in 1e-4
    c5, a5, b5 = (t(rng.normal(size=s_)) for s_ in
                  ((3, 128, 100), (3, 128, 128), (3, 128, 100)))
    c5r, a5r, b5r = (t(rng.normal(size=s_)) for s_ in
                     ((2, 70, 65), (2, 70, 17), (2, 17, 65)))
    x5 = t(rng.normal(size=(3, 128, 228)))
    s5 = rng.normal(size=(3, 128, 228))
    s5[:, :, :128] = (np.triu(rng.normal(size=(3, 128, 128)), 1)
                      / np.sqrt(128) + 3 * np.eye(128))
    s5 = t(s5)
    x6 = t(rng.normal(size=(4, 96 + 300)))
    s6 = rng.normal(size=(4, 96, 96 + 300))
    s6[:, :, :96] = (np.triu(rng.normal(size=(4, 96, 96)), 1) / np.sqrt(96)
                     + 3 * np.eye(96))
    s6 = t(s6)

    def eps(n):
        return torch.full((n,), 1e-8, dtype=tdt, device=dev)

    # K1 in place: one padded bucket of three members, 4 systems
    desc, parts, n = _place(rng, 4, [(5, 20, 28), (8, 24, 32), (6, 1, 3)],
                            3, 1)
    vb, lay = _bucket_vals(4, n, parts, tdt, dev), _layout(desc, 8, 24, 32,
                                                           n, dev)

    def in_place(fn):           # the buffer but the plain version's scratch
        v = vb.clone()
        return (v[:, :-1],) + tuple(fn(v, lay, eps(4)))

    # K5's node step in place: 3 systems, a node of 17 rows fed by sup-sup
    # and row-row edges
    vn, tab, stp = _node_buffer(rng, 3, 17, 60, 20,
                                [(1, 9), (5, 20), (1, 3), (40, 19)], tdt,
                                dev)

    def node_step(fn):
        v = vn.clone()
        nper = torch.zeros(3, dtype=torch.int32, device=dev)
        fn(v, tab, stp, eps(3), nper)
        return v, nper

    # K6 grouped: groups of fem2d_10k's sup-row shapes (k <= 8, registers),
    # and groups up to k = 128 with k = 1, m = 0 and E = 0 among them
    # (shared memory)
    g6 = [_suprow_group(rng, e, k, m, tdt, dev) for k, m, e in
          ((2, 18, 53), (2, 19, 35), (6, 25, 30), (3, 28, 10), (4, 27, 2))]
    g6l = [_suprow_group(rng, e, k, m, tdt, dev) for k, m, e in
           ((1, 0, 3), (128, 40, 5), (2, 5, 0), (33, 300, 4), (6, 25, 9))]

    def grouped(fn, groups):
        return tuple(t for pair in fn(groups) for t in pair)

    # the wide paths: K2 at 150 rows (window kernel), K1 padded to 256 rows
    # (window in device memory), K3 at k = 150 (the wide kernel)
    pw = rng.normal(size=(2, 150, 200))
    pw[:, :, 40:190] += 16 * np.eye(150)
    pw = t(pw)
    dw, partsw, nw = _place(rng, 2, [(140, 20, 30), (150, 24, 0)], 3, 1)
    vw, layw = _bucket_vals(2, nw, partsw, tdt, dev), _layout(dw, 256, 24,
                                                              32, nw, dev)

    def in_place_wide(fn):
        v = vw.clone()
        return (v[:, :-1],) + tuple(fn(v, layw, eps(2)))

    uw = t(_wide_block(rng, 3, 150))
    xw = t(rng.normal(size=(3, 40, 150)))
    bw = t(rng.normal(size=(2, 150, 3)))
    # K5's wide node step: a node of 9 rows fed by a 150-row source among
    # narrow ones
    vnw, tabw, stpw = _node_buffer(rng, 3, 9, 260, 30,
                                   [(1, 5), (150, 90), (7, 20)], tdt, dev)

    def node_step_wide(fn):
        v = vnw.clone()
        nper = torch.zeros(3, dtype=torch.int32, device=dev)
        fn(v, tabw, stpw, eps(3), nper)
        return v, nper

    return {
        "panel_lu_bucket_inplace": (
            lambda: in_place(panel.panel_lu_bucket_inplace),
            lambda: in_place(panel.panel_lu_bucket_plain)),
        "panel_lu_batched": (lambda: panel.panel_lu_batched(pb, 50, eps(6)),
                             lambda: panel.panel_lu_plain(pb, 0, 50, eps(6))),
        "panel_lu": (lambda: panel.panel_lu(p2, 24, 10, eps(4)),
                     lambda: panel.panel_lu_plain(p2, 10, 60, eps(4))),
        "panel_lu_global": (lambda: panel.panel_lu(p3, 128, 100, eps(2)),
                            lambda: panel.panel_lu_plain(p3, 100, 300,
                                                         eps(2))),
        "panel_lu_wide": (lambda: panel.panel_lu(pw, 150, 40, eps(2)),
                          lambda: panel.panel_lu_plain(pw, 40, 200, eps(2))),
        "panel_lu_bucket_wide": (
            lambda: in_place_wide(panel.panel_lu_bucket_inplace),
            lambda: in_place_wide(panel.panel_lu_bucket_plain)),
        "trsm_batched": (lambda: tri.trsm_batched(u, x),
                         lambda: tri.trsm_plain(u, x)),
        "trsm_right_wide": (lambda: tri.trsm_batched(uw, xw),
                            lambda: tri.trsm_plain(uw, xw)),
        "trsm_left_unit_lower_wide": (
            lambda: tri.trsm_left_unit_lower_batched(uw[:2], bw),
            lambda: tri.trsm_left_unit_lower_plain(uw[:2], bw)),
        "trsm_left_upper_wide": (
            lambda: tri.trsm_left_upper_batched(uw[:2], bw),
            lambda: tri.trsm_left_upper_plain(uw[:2], bw)),
        "trsm_left_unit_lower_batched": (
            lambda: tri.trsm_left_unit_lower_batched(blk, b),
            lambda: tri.trsm_left_unit_lower_plain(blk, b)),
        "trsm_left_upper_batched": (
            lambda: tri.trsm_left_upper_batched(blk, b),
            lambda: tri.trsm_left_upper_plain(blk, b)),
        "gemm_batched": (lambda: supsup.gemm_batched(a, bb),
                         lambda: supsup.gemm_batched_plain(a, bb)),
        "gemm_update": (lambda: supsup.gemm_update(c5, a5, b5),
                        lambda: supsup.gemm_update_plain(c5, a5, b5)),
        "gemm_update_ragged": (
            lambda: supsup.gemm_update(c5r, a5r, b5r),
            lambda: supsup.gemm_update_plain(c5r, a5r, b5r)),
        "supsup_update": (lambda: supsup.supsup_update(x5, s5, 128),
                          lambda: supsup.supsup_update_plain(x5, s5, 128)),
        "suprow_update": (lambda: suprow.suprow_update(x6, s6, 96),
                          lambda: suprow.suprow_update_plain(x6, s6, 96)),
        "node_edges_inplace": (lambda: node_step(supsup.node_edges_inplace),
                               lambda: node_step(supsup.node_edges_plain)),
        "node_edges_wide": (lambda: node_step_wide(supsup.node_edges_wide),
                            lambda: node_step_wide(supsup.node_edges_plain)),
        "suprow_update_grouped": (
            lambda: grouped(suprow.suprow_update_grouped, g6),
            lambda: grouped(suprow.suprow_update_grouped_plain, g6)),
        "suprow_update_grouped_large_k": (
            lambda: grouped(suprow.suprow_update_grouped, g6l),
            lambda: grouped(suprow.suprow_update_grouped_plain, g6l)),
    }


# the wrapper whose count a case adds one to (supsup_update: K3 then K5)
COUNTED = {"panel_lu_global": ("panel_lu",),
           "gemm_update_ragged": ("gemm_update",),
           "supsup_update": ("trsm_batched", "gemm_update"),
           "suprow_update_grouped_large_k": ("suprow_update_grouped",)}
# the solver's wrappers; K7 and K8 have their own tests below
MODEL_WRAPPERS = ("flash_attention", "wkv")
CASES = sorted(set(kernels.WRAPPERS) - set(MODEL_WRAPPERS)) + sorted(COUNTED)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain(name, dt, cuda):
    tdt, tol, ltol = TOLS[dt]
    tol = ltol if "left" in name else tol
    kern, plain = _cases(np.random.default_rng(1), tdt, cuda)[name]
    wrappers = COUNTED.get(name, (name,))
    before = kernels.launch_counts()
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert all(after[w] == before[w] + 1 for w in wrappers), (before, after)
    if name.startswith("panel_lu"):
        assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
        got, ref = got[0], ref[0]
    for g, r in zip(*((got, ref) if isinstance(got, tuple)
                      else ((got,), (ref,)))):
        torch.testing.assert_close(g, r, rtol=tol, atol=tol)


# fem2d_10k's sup-row edges (target nr = 1, source k > 1) of its unrolled
# plan, fem2d(100, 100, seed=930): 340 edges in these 31 (k, m) groups
SUPROW_FEM2D = [(2, 11), (2, 12), (2, 13), (2, 14), (2, 15), (2, 16),
                (2, 17), (2, 18), (2, 19), (2, 20), (2, 21), (2, 22),
                (2, 23), (2, 24), (2, 25), (2, 26), (2, 27), (2, 28),
                (2, 32), (2, 35), (3, 14), (3, 17), (3, 19), (3, 21),
                (3, 23), (3, 28), (4, 27), (6, 16), (6, 17), (6, 25),
                (6, 26)]
SUPROW_SHAPES = SUPROW_FEM2D + [(k, m) for k in (32, 33, 96, 128)
                                for m in (0, 1, 31, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("k,m", SUPROW_SHAPES)
def test_suprow_update_shapes(k, m, K, dt, cuda):
    """K6 at each (k, m) of fem2d_10k's sup-row edges and at large k, K
    rows: the per-group launch and the grouped launch of this group beside
    a k = 1 group, each one launch, held to the plain version."""
    tdt, tol, _ = TOLS[dt]
    rng = np.random.default_rng(1000 * k + m + K)
    g = _suprow_group(rng, K, k, m, tdt, cuda)
    g1 = _suprow_group(rng, 2, 1, 3, tdt, cuda)
    ref = suprow.suprow_update_plain(*g)
    before = kernels.launch_counts()
    got = suprow.suprow_update(*g)
    both = suprow.suprow_update_grouped([g, g1])
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["suprow_update"] == before["suprow_update"] + 1
    assert (after["suprow_update_grouped"]
            == before["suprow_update_grouped"] + 1)
    for out in (got, both[0]):
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=tol, atol=tol)
    for a, b in zip(both[1], suprow.suprow_update_plain(*g1)):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("k", [2, 6, 33, 128])
@pytest.mark.parametrize("case", ["zero_diagonal", "zero_over_zero",
                                  "nan_in_u", "nan_in_b"])
def test_suprow_update_nonfinite_matches_plain(case, k, dt, cuda):
    """K6 on rows with an exact zero on U's diagonal (its infinite quotient
    also meeting a zero of U), 0 / 0, or a NaN in U's upper triangle or in
    the rows past it, through both entry points: the plain version's NaN
    and inf positions, its infinities and its finite values."""
    tdt, tol, _ = TOLS[dt]
    rng = np.random.default_rng(k + len(case))
    x, src, _ = _suprow_group(rng, 3, k, 9, tdt, cuda)
    j = k // 2
    if case == "zero_diagonal":
        src[0, j, j] = src[0, j, j + 1] = 0.0
    elif case == "zero_over_zero":
        x[1, 0] = src[1, 0, 0] = 0.0
    elif case == "nan_in_u":
        src[0, 0, j] = float("nan")
    else:
        src[2, j, k + 4] = float("nan")
    ref = suprow.suprow_update_plain(x, src, k)
    for got in (suprow.suprow_update(x, src, k),
                suprow.suprow_update_grouped([(x, src, k)])[0]):
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert torch.equal(g.isnan(), r.isnan())
            assert torch.equal(g.isinf(), r.isinf())
            assert torch.equal(g[g.isinf()], r[r.isinf()])
            fin = r.isfinite()
            torch.testing.assert_close(g[fin], r[fin], rtol=tol, atol=tol)
    assert not all(bool(r.isfinite().all()) for r in ref)


def _suprow_group(rng, e, k, m, tdt, dev):
    """One K6 group (x (e, k+m), src (e, k, k+m), k): U dominant, its strict
    upper part scaled by 1/sqrt(k), random below it (nothing may read
    it)."""
    src = rng.normal(size=(e, k, k + m))
    src[:, :, :k] = (np.triu(rng.normal(size=(e, k, k)), 1) / np.sqrt(k)
                     + 3 * np.eye(k) + np.tril(rng.normal(size=(e, k, k)),
                                               -1))
    return (torch.tensor(rng.normal(size=(e, k + m)), dtype=tdt, device=dev),
            torch.tensor(src, dtype=tdt, device=dev), k)


def _src_rows(rng, b, k, m, tdt, dev):
    """(b, k, k + m) source rows: a dominant upper triangle in the first k
    columns (strict part scaled by 1/sqrt(k)) and NaN below its diagonal,
    which no right solve may read."""
    s = rng.normal(size=(b, k, k + m))
    s[:, :, :k] = (np.triu(rng.normal(size=(b, k, k)), 1) / np.sqrt(k)
                   + 3 * np.eye(k))
    il = np.tril_indices(k, -1)
    s[:, il[0], il[1]] = np.nan
    return torch.tensor(s, dtype=tdt, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("m", [3, 8])
@pytest.mark.parametrize("nr", [1, 31, 33, 128, 300])
@pytest.mark.parametrize("k", [1, 2, 15, 16, 17, 33, 50, 64, 100, 128])
def test_trsm_right_on_a_strided_view(k, nr, m, dt, cuda):
    """K3's right solve on U = S[..., :k], the strided view of (B, k, k + m)
    source rows the engine hands it (m odd: rows not 16-byte aligned), with
    NaN in U's strict lower triangle: one launch per call, the plain
    version's result, and the same bits as on a contiguous U whose lower
    triangle is zero."""
    tdt, tol, _ = TOLS[dt]
    rng = np.random.default_rng(1000 * k + nr + m)
    S = _src_rows(rng, 3, k, m, tdt, cuda)
    u = S[..., :k]
    clean = torch.nan_to_num(u, nan=0.0)
    x = torch.tensor(rng.normal(size=(3, nr, k)), dtype=tdt, device=cuda)
    for unit in (False, True):
        before = tri.trsm_batched.launches
        got = tri.trsm_batched(u, x, unit_diag=unit)
        torch.cuda.synchronize()
        assert tri.trsm_batched.launches == before + 1
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, tri.trsm_plain(u, x, unit_diag=unit),
                                   rtol=tol, atol=tol)
        assert torch.equal(got, tri.trsm_batched(clean, x, unit_diag=unit))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("m", [1, 3, 17])
@pytest.mark.parametrize("k", [2, 31, 32, 33, 100, 128])
def test_trsm_left_ignores_the_other_triangle(k, m, upper, dt, cuda):
    """K3's left solves with NaN in the triangle each ignores (the upper
    one and the diagonal for unit-lower, the strict lower one for upper):
    one launch per call, the plain version's result, and the same bits as
    on the block with that triangle zero."""
    tdt, _, tol = TOLS[dt]
    rng = np.random.default_rng(100 * k + m)
    a = ((np.triu(rng.normal(size=(3, k, k)), 1)
          + np.tril(rng.normal(size=(3, k, k)), -1)) / np.sqrt(k)
         + 3 * np.eye(k))
    ign = np.tril_indices(k, -1) if upper else np.triu_indices(k)
    a0 = a.copy()
    a0[:, ign[0], ign[1]] = 0.0
    a[:, ign[0], ign[1]] = np.nan
    blk, clean = (torch.tensor(v, dtype=tdt, device=cuda) for v in (a, a0))
    b = torch.tensor(rng.normal(size=(3, k, m)), dtype=tdt, device=cuda)
    fn, plain = ((tri.trsm_left_upper_batched, tri.trsm_left_upper_plain)
                 if upper else (tri.trsm_left_unit_lower_batched,
                                tri.trsm_left_unit_lower_plain))
    before = fn.launches
    got = fn(blk, b)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, plain(blk, b), rtol=tol, atol=tol)
    assert torch.equal(got, fn(clean, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("k", [64, 100])
def test_trsm_left_misaligned_block(k, dt, cuda):
    """A block that starts 8 bytes past a 16-byte boundary takes the
    element-wise copies: the same bits as the aligned block."""
    tdt, _, tol = TOLS[dt]
    rng = np.random.default_rng(k)
    a = rng.normal(size=(2, k, k)) / np.sqrt(k) + 3 * np.eye(k)
    blk = torch.tensor(a, dtype=tdt, device=cuda)
    flat = torch.empty(blk.numel() + 2, dtype=tdt, device=cuda)
    flat[1:-1] = blk.reshape(-1)
    off = flat[1:-1].view(blk.shape)
    b = torch.tensor(rng.normal(size=(2, k, 3)), dtype=tdt, device=cuda)
    for fn in (tri.trsm_left_unit_lower_batched, tri.trsm_left_upper_batched):
        assert torch.equal(fn(off, b), fn(blk, b))


@pytest.mark.cuda
def test_trsm_right_refuses_strided_rows(cuda):
    """U's rows must be contiguous and not overlap: the kernel reads them
    through a batch and a row stride only."""
    s = torch.zeros(2, 8, 8, device=cuda, dtype=torch.float64)
    x = torch.zeros(2, 5, 4, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        tri.trsm_batched(s[:, :4, ::2], x)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        tri.trsm_batched(s.as_strided((2, 4, 4), (64, 2, 1)), x)
    with pytest.raises(TypeError, match="mixed dtypes"):
        tri.trsm_batched(s[:, :4, :4].float(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
def test_trsm_quotients_are_true_divisions(dt, cuda):
    """At k = 1 each solve is one division per entry.  The kernels divide
    by a product with the diagonal's reciprocal corrected to the correctly
    rounded quotient; it must give the bits of a true division, with zero
    and subnormal dividends and operands outside the fast path's range."""
    tdt = TOLS[dt][0]
    rng = np.random.default_rng(9)
    lo, hi, ul = (-1070, 1000, 20) if dt == "float64" else (-140, 60, 60)
    x = (rng.normal(size=(64, 2000, 1))
         * 2.0 ** rng.integers(lo, hi, size=(64, 2000, 1)))
    x[:, ::7] = 0.0
    u = rng.normal(size=(64, 1, 1)) * 2.0 ** rng.integers(-ul, ul,
                                                          size=(64, 1, 1))
    X, U = (torch.tensor(v, dtype=tdt, device=cuda) for v in (x, u))
    assert torch.equal(tri.trsm_batched(U, X), X / U)
    b = X[:, :1].contiguous()
    assert torch.equal(tri.trsm_left_upper_batched(U, b), b / U)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
def test_trsm_infinite_operand(dt, cuda):
    """An infinite entry of X (right solve) or of b (left upper solve): the
    quotients are true divisions, so the kernel's NaN and inf positions,
    its infinities and its finite values are the plain version's (float32
    once turned inf / d into NaN)."""
    tdt, tol, ltol = TOLS[dt]
    rng = np.random.default_rng(17)
    u = torch.tensor(_tri(rng, 2, 40), dtype=tdt, device=cuda)
    x = torch.tensor(rng.normal(size=(2, 33, 40)), dtype=tdt, device=cuda)
    x[0, 3, 5], x[1, 7, 0] = float("inf"), -float("inf")
    blk = torch.tensor(_tri(rng, 2, 40), dtype=tdt, device=cuda)
    b = torch.tensor(rng.normal(size=(2, 40, 3)), dtype=tdt, device=cuda)
    b[0, 30, 1], b[1, 39, 0] = float("inf"), -float("inf")
    for (got, ref), t_ in (((tri.trsm_batched(u, x), tri.trsm_plain(u, x)),
                            tol),
                           ((tri.trsm_left_upper_batched(blk, b),
                             tri.trsm_left_upper_plain(blk, b)), ltol)):
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        assert torch.equal(torch.isinf(got), torch.isinf(ref))
        assert torch.isinf(ref).any()
        assert torch.equal(got[torch.isinf(got)], ref[torch.isinf(ref)])
        fin = torch.isfinite(ref)
        torch.testing.assert_close(got[fin], ref[fin], rtol=t_, atol=t_)


@pytest.mark.cuda
def test_panel_lu_global_pivots_float64(cuda):
    # the device-memory path (128 x 300 does not fit in shared memory) on a
    # random block with no dominant diagonal, so partial pivoting moves
    # rows; float64 holds 1e-10 through 128 pivot steps
    p = torch.tensor(np.random.default_rng(2).normal(size=(2, 128, 300)),
                     dtype=torch.float64, device=cuda)
    eps = torch.full((2,), 1e-8, dtype=torch.float64, device=cuda)
    got = panel.panel_lu(p, 128, 100, eps)
    ref = panel.panel_lu_plain(p, 100, 300, eps)
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    assert (got[1] != torch.arange(128, device=cuda)).any()
    torch.testing.assert_close(got[0], ref[0], rtol=1e-10, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("case", ["zero_pivot", "nan_in_u", "inf_in_l",
                                  "nan_in_block", "zero_pivot_global"])
def test_panel_lu_nonfinite_steps(case, bucketed, cuda):
    """K1 and K2 on degenerate panels — an exact zero pivot under eps = 0,
    a non-finite entry — give the plain version's NaN and inf positions
    and its finite values (the plain version is held to the interpreted
    Pallas kernels by tests/test_torch_kernels.py).  "zero_pivot_global"
    is a 128 x 300 panel in device memory, pivoted by rows and shuffled."""
    rng = np.random.default_rng(4)
    if case == "zero_pivot_global":
        p = rng.normal(size=(2, 128, 300))
        p[:, :, 100] = 0.0                       # the first pivot column
        nr, c0, eps = 128, 100, 0.0
    else:
        p = rng.normal(size=(2, 5, 12))
        nr, c0, eps = 5, 3, 1e-8
        if case == "zero_pivot":
            p[:, :, 3] = 0.0
            eps = 0.0
        else:
            row, col, v = {"nan_in_u": (1, 9, np.nan),
                           "inf_in_l": (4, 1, np.inf),
                           "nan_in_block": (2, 5, np.nan)}[case]
            p[:, row, col] = v
    w = p.shape[2]
    if bucketed:                  # column-reordered [block | U | L], wu = w - c0
        p = np.concatenate([p[:, :, c0:], p[:, :, :c0]], axis=2)
    P = torch.tensor(p, dtype=torch.float64, device=cuda)
    e = torch.full((2,), eps, dtype=torch.float64, device=cuda)
    if bucketed:
        got = panel.panel_lu_batched(P, w - c0, e)
        ref = panel.panel_lu_plain(P, 0, w - c0, e)
    else:
        got = panel.panel_lu(P, nr, c0, e)
        ref = panel.panel_lu_plain(P, c0, w, e)
    torch.cuda.synchronize()
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    g, r = got[0], ref[0]
    assert not torch.isfinite(r).all() and torch.isfinite(r).any()
    assert torch.equal(torch.isnan(g), torch.isnan(r))
    assert torch.equal(torch.isinf(g), torch.isinf(r))
    fin = torch.isfinite(r)
    torch.testing.assert_close(g[fin], r[fin], rtol=1e-10, atol=1e-10)


def _node_panels(rng, b, nr, lsize, us, dominant):
    """(b, nr, lsize + nr + us) node panels with their rows shuffled, so
    that partial pivoting has to move rows; a dominant block (16 I before
    the shuffle) keeps float32 inside 1e-4 through 128 pivot steps."""
    p = rng.normal(size=(b, nr, lsize + nr + us))
    if dominant:
        p[:, :, lsize:lsize + nr] += 16 * np.eye(nr)
    rows = np.argsort(rng.random((b, nr)), axis=1)
    return np.take_along_axis(p, rows[:, :, None], axis=1)


def _node_held(P, nr, lsize, eps, tol):
    """K2 on P against its plain version: one launch, equal pivots and
    perturbation counts, values within tol."""
    before = panel.panel_lu.launches
    got = panel.panel_lu(P, nr, lsize, eps)
    ref = panel.panel_lu_plain(P, lsize, P.shape[2], eps)
    torch.cuda.synchronize()
    assert panel.panel_lu.launches == before + 1
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    torch.testing.assert_close(got[0], ref[0], rtol=tol, atol=tol)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("us", [0, 22, 100])
@pytest.mark.parametrize("lsize", [0, 3, 2197])
@pytest.mark.parametrize("nr", [2, 3, 17, 31, 32, 33, 64, 128])
def test_node_panel_lu_shapes(nr, lsize, us, dt, cuda):
    """K2 at one panel (the unrolled schedule) and at 32 (a narrow level
    at K = 32): every block size (a lone pivot warp with three copying
    warps up to nr = 8, then 4 and 8 warps), prefixes longer than one
    round of the prefix copy, and U suffixes of 0 to 100 columns; rows
    shuffled, random blocks in float64."""
    tdt, tol, _ = TOLS[dt]
    rng = np.random.default_rng(nr * 10007 + lsize * 31 + us)
    for b in (1, 32):
        p = _node_panels(rng, b, nr, lsize, us, dominant=dt == "float32")
        P = torch.tensor(p, dtype=tdt, device=cuda)
        eps = torch.full((b,), 1e-8, dtype=tdt, device=cuda)
        got = _node_held(P, nr, lsize, eps, tol)
        if b > 1:
            assert (got[1] != torch.arange(nr, device=cuda)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
def test_node_panel_lu_window_in_device_memory(dt, cuda):
    """A window [lsize, w) above the 227 KB a block may stage (128 rows by
    350 columns in float64, 550 in float32): K2 works on it in a scratch
    buffer in device memory, with the same pivots and values."""
    tdt, tol, _ = TOLS[dt]
    nr, lsize = 128, 50
    us = (350 if dt == "float64" else 550) - nr
    w = lsize + nr + us
    elem = torch.finfo(tdt).bits // 8
    assert nr * (w - lsize) * elem > 227 * 1024
    assert panel._node_scratch(nr, w, lsize, elem) > 0
    rng = np.random.default_rng(12)
    for b in (1, 3):
        p = _node_panels(rng, b, nr, lsize, us, dominant=dt == "float32")
        P = torch.tensor(p, dtype=tdt, device=cuda)
        eps = torch.full((b,), 1e-8, dtype=tdt, device=cuda)
        _node_held(P, nr, lsize, eps, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("nr,lsize", [(8, 2197), (40, 2197), (128, 300)])
def test_node_panel_lu_nonfinite_multiplier_poisons_prefix(nr, lsize, dt,
                                                           cuda):
    """Two infinities in the first block column: the first is the pivot,
    the other's multiplier is inf / inf = NaN, which (0 * NaN in the Pallas
    arithmetic) turns that row's whole prefix NaN; the NaN row is the next
    pivot, so every later row follows.  NaN and inf positions and the
    finite values match the plain version."""
    tdt, tol, _ = TOLS[dt]
    rng = np.random.default_rng(nr + lsize)
    p = _node_panels(rng, 2, nr, lsize, 7, dominant=True)
    p[:, 2, lsize] = np.inf
    p[:, nr - 1, lsize] = np.inf
    P = torch.tensor(p, dtype=tdt, device=cuda)
    eps = torch.full((2,), 1e-8, dtype=tdt, device=cuda)
    got = panel.panel_lu(P, nr, lsize, eps)
    ref = panel.panel_lu_plain(P, lsize, P.shape[2], eps)
    torch.cuda.synchronize()
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    g, r = got[0], ref[0]
    assert torch.isnan(r[:, 1:, :lsize]).all()
    assert torch.isfinite(r[:, 0, :lsize]).all()
    assert torch.equal(torch.isnan(g), torch.isnan(r))
    assert torch.equal(torch.isinf(g), torch.isinf(r))
    fin = torch.isfinite(r)
    torch.testing.assert_close(g[fin], r[fin], rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("nr,lsize,us", [(2, 8, 13), (9, 0, 0), (24, 262, 58),
                                         (32, 2197, 22)])
@pytest.mark.parametrize("b", [133, 300, 1001])
def test_node_panel_lu_more_panels_than_sms(b, nr, lsize, us, dt, cuda):
    """More panels than SMs (a narrow level at K = 133 to 1,001 systems),
    at a lone pivot warp's size (nr = 2) and at four warps' (nr = 9 to 32),
    prefixes from none to one that does not fit beside the window (lsize
    2,197 at nr = 32): every panel has its own pivots."""
    tdt, tol, _ = TOLS[dt]
    rng = np.random.default_rng(b + nr)
    p = _node_panels(rng, b, nr, lsize, us, dominant=True)
    P = torch.tensor(p, dtype=tdt, device=cuda)
    eps = torch.full((b,), 1e-8, dtype=tdt, device=cuda)
    got = _node_held(P, nr, lsize, eps, tol)
    assert (got[1] != torch.arange(nr, device=cuda)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("b", [1, 2, 300])
@pytest.mark.parametrize("nr,lsize", [(24, 262), (32, 2197)])
def test_node_panel_lu_nonfinite_with_nan_in_u(nr, lsize, b, dt, cuda):
    """The non-finite rules with both kinds at once, also with the prefix
    split over several blocks (b = 1, lsize 2,197) and with more panels
    than SMs: an infinite first-column entry below the pivot poisons its
    row's prefix and, as the next pivot, every later row; a NaN in the U
    suffix turns its column NaN in the rows above the step that reads
    it."""
    tdt, tol, _ = TOLS[dt]
    rng = np.random.default_rng(nr * b)
    p = _node_panels(rng, b, nr, lsize, 9, dominant=True)
    p[:, 2, lsize] = np.inf
    p[:, nr - 1, lsize] = np.inf
    p[:, 5, lsize + nr + 3] = np.nan
    P = torch.tensor(p, dtype=tdt, device=cuda)
    eps = torch.full((b,), 1e-8, dtype=tdt, device=cuda)
    got = panel.panel_lu(P, nr, lsize, eps)
    ref = panel.panel_lu_plain(P, lsize, P.shape[2], eps)
    torch.cuda.synchronize()
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    g, r = got[0], ref[0]
    assert torch.isnan(r[:, 1:, :lsize]).all()
    assert torch.equal(torch.isnan(g), torch.isnan(r))
    assert torch.equal(torch.isinf(g), torch.isinf(r))
    fin = torch.isfinite(r)
    torch.testing.assert_close(g[fin], r[fin], rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("off", [0, 3])
def test_node_panel_lu_reads_a_strided_view(off, dt, cuda):
    """K2 on the (K, nr, w) view of a slice of each system's value buffer
    that the engine hands it (batch stride = the buffer's row length; off
    odd: rows not 16-byte aligned) gives exactly what it gives on the
    contiguous copy, in one launch each."""
    tdt, tol, _ = TOLS[dt]
    nr, lsize, w, k = 24, 40, 80, 32
    rng = np.random.default_rng(off)
    buf = rng.normal(size=(k, off + nr * w + 17))
    seg = buf[:, off:off + nr * w].reshape(k, nr, w)
    seg[:, :, lsize:lsize + nr] += 16 * np.eye(nr)
    buf[:, off:off + nr * w] = seg.reshape(k, -1)
    B = torch.tensor(buf, dtype=tdt, device=cuda)
    view = B[:, off:off + nr * w].view(k, nr, w)
    assert not view.is_contiguous()
    eps = torch.full((k,), 1e-8, dtype=tdt, device=cuda)
    got = _node_held(view, nr, lsize, eps, tol)
    again = _node_held(view.contiguous(), nr, lsize, eps, tol)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def _place(rng, k, members, start, gap):
    """Node panels (nr, us, ls) -> (k, nr, ls + nr + us) with a dominant
    block and their rows shuffled, laid out from slot ``start`` on with
    ``gap`` slots before each (an odd gap: rows not 16-byte aligned).
    Returns (descriptors, [(offset, values (k, nr * w))], end)."""
    desc, parts, off = [], [], start
    for nr, us, ls in members:
        off += gap
        w = ls + nr + us
        p = rng.normal(size=(k, nr, w))
        p[:, :, ls:ls + nr] += 16 * np.eye(nr)
        rows = np.argsort(rng.random((k, nr)), axis=1)
        p = np.take_along_axis(p, rows[:, :, None], axis=1)
        desc.append((off, nr, w, ls, us))
        parts.append((off, p.reshape(k, -1)))
        off += nr * w
    return desc, parts, off


def _bucket_vals(k, n, parts, tdt, dev):
    """A (k, n + 3) value buffer: the panels' values, pi in every other
    slot, then the zero, one (1e30) and scratch slots."""
    vals = np.full((k, n + 3), np.pi)
    for off, v in parts:
        vals[:, off:off + v.shape[1]] = v
    vals[:, n:] = (0.0, 1e30, 0.0)
    return torch.tensor(vals, dtype=tdt, device=dev)


def _layout(desc, nrp, usp, lsp, n, dev):
    """The bucket's layout in a buffer whose sentinel slots are n, n + 1,
    n + 2."""
    wu, wt = nrp + usp, nrp + usp + lsp
    g, s = panel.bucket_maps(desc, nrp, wu, wt, n, n + 1, n + 2)
    return panel.bucket_layout(desc, nrp, wu, wt, n, n + 1, g, s, dev)


def _bits(t):
    return t.contiguous().view(torch.int64 if t.element_size() == 8
                               else torch.int32)


def _bucket_held(vals, lay, eps, tol, counter=None):
    """K1 in place on a copy of vals against its plain version on another:
    one launch (counted by ``counter``, the in-place wrapper unless given),
    equal pivots and perturbation counts, the real slots' NaN and inf
    positions equal and finite values within tol, and every slot outside
    the bucket's real slots bit-identical to before (the plain version's
    scratch slot aside).  Returns the kernel's (perm, nper, vals)."""
    counter = counter or panel.panel_lu_bucket_inplace
    before = counter.launches
    got, ref = vals.clone(), vals.clone()
    gp, gn = panel.panel_lu_bucket_inplace(got, lay, eps)
    rp, rn = panel.panel_lu_bucket_plain(ref, lay, eps)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert torch.equal(gp, rp) and torch.equal(gn, rn)
    real = torch.zeros(vals.shape[1], dtype=torch.bool, device=vals.device)
    for off, nr, w, _, _ in lay.desc.tolist():
        real[off:off + nr * w] = True
    assert torch.equal(_bits(got[:, ~real]), _bits(vals[:, ~real]))
    g, r = got[:, real], ref[:, real]
    assert torch.equal(torch.isnan(g), torch.isnan(r))
    assert torch.equal(torch.isinf(g), torch.isinf(r))
    fin = torch.isfinite(r)
    torch.testing.assert_close(g[fin], r[fin], rtol=tol, atol=tol)
    return gp, gn, got


def _eps_per_system(k, tdt, dev):
    """1e-8 for most systems, 1e3 (above every pivot of a block whose
    diagonal is 16 plus noise: all perturbed) for every third from the
    second on."""
    eps = torch.full((k,), 1e-8, dtype=tdt, device=dev)
    eps[1::3] = 1e3
    return eps


# K1 in place: (nrp, usp, lsp, members (nr, usize, lsize)) from a lone
# pivot warp (nrp <= 8, windows up to 208 columns, more than one 128-column
# round of its update) to eight warps; members below every padded size;
# at nrp = 128 a prefix of 2,197 columns passes through shared memory in
# chunks, beside a window staged in shared memory (float32) or, at 129 x
# 226 float64 values, in device memory
BUCKETS = [(2, 8, 16, [(2, 8, 16), (2, 3, 0), (2, 0, 9)]),
           (4, 16, 24, [(3, 15, 19), (4, 16, 24), (3, 0, 0)]),
           (8, 24, 32, [(5, 20, 28), (8, 24, 32), (6, 1, 3)]),
           (8, 120, 16, [(7, 120, 16), (8, 119, 0)]),
           (8, 200, 10, [(5, 190, 10), (8, 200, 0)]),
           (16, 40, 64, [(9, 33, 64), (16, 40, 5)]),
           (32, 64, 304, [(17, 64, 300), (32, 0, 299), (31, 50, 1)]),
           (64, 104, 448, [(33, 100, 448), (64, 104, 0)]),
           (128, 96, 2200, [(100, 96, 2197), (128, 7, 1000)])]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("gap", [0, 1])
@pytest.mark.parametrize("k", [1, 32])
@pytest.mark.parametrize("bucket", range(len(BUCKETS)))
def test_bucket_panel_lu_inplace(bucket, k, gap, dt, cuda):
    """K1 in place on padded buckets, one system and 32, rows aligned and
    not, with a threshold per system (every third system perturbs every
    pivot): the plain version's pivots, counts and values; no other slot
    written; rows moved by pivoting."""
    tdt, tol, _ = TOLS[dt]
    nrp, usp, lsp, members = BUCKETS[bucket]
    rng = np.random.default_rng(bucket * 100 + k + gap)
    desc, parts, n = _place(rng, k, members, 5, gap)
    vals = _bucket_vals(k, n, parts, tdt, cuda)
    perm, nper, _ = _bucket_held(vals, _layout(desc, nrp, usp, lsp, n, cuda),
                                 _eps_per_system(k, tdt, cuda), tol)
    b = len(members)
    assert (perm != torch.arange(nrp, device=cuda)).any()
    assert int(nper.view(k, b)[0].sum()) == 0
    if k > 1:
        assert (nper.view(k, b)[1] == torch.tensor(
            [m[0] for m in members], device=cuda)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("k,members,nrp,usp,lsp",
                         [(300, [(3, 5, 7)], 4, 8, 8),
                          (32, [(5, 20, 28), (8, 24, 32), (6, 1, 3)] * 2, 8,
                           24, 32),
                          (40, [(24, 58, 262), (20, 30, 100)], 32, 64, 264)])
def test_bucket_panel_lu_more_panels_than_sms(k, members, nrp, usp, lsp, dt,
                                             cuda):
    """More panels than SMs (K x B = 300, 192, 80 at four warps' size with
    a wide prefix): every panel has its own pivots and threshold."""
    tdt, tol, _ = TOLS[dt]
    rng = np.random.default_rng(k + nrp)
    desc, parts, n = _place(rng, k, members, 3, 1)
    vals = _bucket_vals(k, n, parts, tdt, cuda)
    _bucket_held(vals, _layout(desc, nrp, usp, lsp, n, cuda),
                 _eps_per_system(k, tdt, cuda), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
def test_bucket_panel_lu_window_in_device_memory(dt, cuda):
    """nrp = 128 with a wide U suffix (window 128 + 250 columns in float64,
    128 + 450 in float32, above the 227 KB a block may stage): the window
    lives in a scratch buffer in device memory, the prefix still passes
    through shared memory."""
    tdt, tol, _ = TOLS[dt]
    elem = torch.finfo(tdt).bits // 8
    usp = 250 if dt == "float64" else 450
    members = [(128, usp, 40), (90, usp - 3, 0), (127, 1, 33)]
    assert panel._scratch(128, 128 + usp, 40, True, elem) > 0
    rng = np.random.default_rng(usp)
    for k in (1, 3):
        desc, parts, n = _place(rng, k, members, 0, 1)
        vals = _bucket_vals(k, n, parts, tdt, cuda)
        _bucket_held(vals, _layout(desc, 128, usp, 40, n, cuda),
                     _eps_per_system(k, tdt, cuda), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("nrp,usp,lsp,members",
                         [(8, 24, 32, [(5, 20, 28), (8, 24, 32)]),
                          (8, 200, 10, [(5, 190, 10), (8, 200, 0)]),
                          (32, 64, 304, [(20, 60, 300), (32, 0, 5)])])
@pytest.mark.parametrize("case", ["zero_pivot", "nan_pivot_row",
                                  "padded_row_wins"])
def test_bucket_panel_lu_nonfinite(case, nrp, usp, lsp, members, dt, cuda):
    """Member 0 (nr < nrp; a lone pivot warp on a narrow and a wide window,
    and four warps) degenerate in every system: an exactly zero
    first block column under a zero threshold; a NaN that wins the first
    pivot; a dominant first pivot row infinite in the second block column
    above nonzero multipliers, so that every real candidate of step 1 is
    infinite, every padded row NaN there, and a padded row wins the pivot.
    NaN and inf positions, pivots and finite values as the plain version,
    whose arithmetic tests/test_torch_kernels.py holds to the JAX
    engine's."""
    tdt, tol, _ = TOLS[dt]
    k = 2
    rng = np.random.default_rng(nrp)
    desc, parts, n = _place(rng, k, members, 0, 1)
    off, nr, w, ls, _ = desc[0]
    p = parts[0][1].reshape(k, nr, w)
    eps = torch.full((k,), 1e-8, dtype=tdt, device=cuda)
    if case == "zero_pivot":
        p[:, :, ls] = 0.0
        eps.zero_()
    elif case == "nan_pivot_row":
        p[:, 2, ls] = np.nan
    else:
        p[:, :, ls] = 1.0
        p[:, 0, ls] = 1e3
        p[:, 0, ls + 1] = np.inf
    vals = _bucket_vals(k, n, parts, tdt, cuda)
    perm, _, got = _bucket_held(vals, _layout(desc, nrp, usp, lsp, n, cuda),
                                eps, tol)
    assert not torch.isfinite(got[:, off:off + nr * w]).all()
    if case == "padded_row_wins":
        assert (perm[::len(members), 1] == nr).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
def test_bucket_panel_lu_buckets_of_one_level(dt, cuda):
    """Two buckets of one level whose members interleave in the value
    buffer, run back to back: each leaves the other's slots (and the
    sentinels) bit-identical, and each matches its plain version."""
    tdt, tol, _ = TOLS[dt]
    k = 8
    rng = np.random.default_rng(77)
    da, pa, end = _place(rng, k, [(3, 10, 14)], 1, 1)
    db, pb, end = _place(rng, k, [(16, 30, 60)], end, 3)
    da2, pa2, end = _place(rng, k, [(4, 12, 0)], end, 1)
    db2, pb2, n = _place(rng, k, [(9, 1, 64)], end, 0)
    vals = _bucket_vals(k, n, pa + pb + pa2 + pb2, tdt, cuda)
    eps = _eps_per_system(k, tdt, cuda)
    _, _, after_a = _bucket_held(vals, _layout(da + da2, 4, 16, 16, n, cuda),
                                 eps, tol)
    _bucket_held(after_a, _layout(db + db2, 16, 32, 64, n, cuda), eps, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("b,nr,wu,wt", [(6, 32, 50, 80), (300, 4, 20, 44),
                                        (2, 128, 378, 400),
                                        (3, 128, 150, 2400), (5, 1, 3, 5)])
def test_panel_lu_batched_runs_the_window_kernel(b, nr, wu, wt, dt, cuda):
    """The contiguous K1 wrapper launches the same kernel template
    (``hylu_panel_lu_batched_*``): one launch, the plain version's pivots,
    counts and values, also with the window in device memory (128 x 378)
    and a prefix split over several blocks (128 x 150 + 2,250)."""
    tdt, tol, _ = TOLS[dt]
    rng = np.random.default_rng(b + nr + wt)
    p = rng.normal(size=(b, nr, wt))
    p[:, :, :nr] += 16 * np.eye(nr)
    p = np.take_along_axis(p, np.argsort(rng.random((b, nr)), axis=1)[
        :, :, None], axis=1)
    P = torch.tensor(p, dtype=tdt, device=cuda)
    eps = _eps_per_system(b, tdt, cuda)
    before = panel.panel_lu_batched.launches
    got = panel.panel_lu_batched(P, wu, eps)
    ref = panel.panel_lu_plain(P, 0, wu, eps)
    torch.cuda.synchronize()
    assert panel.panel_lu_batched.launches == before + 1
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    torch.testing.assert_close(got[0], ref[0], rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_route_on_card_matches_cpu(dtype, cuda):
    """use_kernels=False on the card — the plain factor program and the
    level-scheduled substitution, whose per-level ``index_add_`` is atomic
    there — against the same route on the CPU, and no kernel launched."""
    A = to_csr(fem2d(12, 12, seed=1))
    rng = np.random.default_rng(0)
    vb = A.data[None] * rng.uniform(0.8, 1.2, (4, A.nnz))
    bb = rng.normal(size=(4, A.n))
    kw = dict(force_mode="supernodal", bulk_min_width=2, use_kernels=False,
              factor_dtype=dtype)
    out = {}
    kernels.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        bst = factor_batched(analyze(A, HyluOptions(device=dev, **kw)), A,
                             vb)
        out[dev] = (bst,) + solve_batched(bst, bb)
    assert not any(kernels.launch_counts().values())
    (bg, xg, ig), (bc, xc, ic) = out["cuda"], out["cpu"]
    assert np.array_equal(bg.n_perturb, bc.n_perturb)
    if dtype == "float64":
        assert torch.equal(bg.inode_perm.cpu(), bc.inode_perm)
        torch.testing.assert_close(bg.vals.cpu(), bc.vals, rtol=1e-10,
                                   atol=1e-10)
    assert max(ig["residual"].max(), ic["residual"].max()) < 1e-10
    assert np.abs(xg - xc).max() / np.abs(xc).max() < 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_unrolled_lifecycle_matches_bucketed(dtype, cuda):
    """factor → refactor → solve of one system on the card under the
    unrolled schedule (K5's node step once per node with edges or width 1,
    K2 per node with nr > 1; neither the per-edge K5 nor K3) against the
    bucketed one: equal pivots and perturbation counts, factors within
    1e-10 in float64, residuals within 1e-10 after refinement."""
    a = fem2d(12, 12, seed=1)
    A = to_csr(a)
    vals2 = A.data * np.random.default_rng(3).uniform(0.8, 1.2, A.nnz)
    A2 = type(A)(A.n, A.indptr, A.indices, vals2)
    b = np.random.default_rng(4).normal(size=A.n)
    kw = dict(force_mode="supernodal", max_super=4, bulk_min_width=2,
              factor_dtype=dtype)
    base = analyze(A, HyluOptions(**kw))
    out = {}
    for sched in ("bucketed", "unrolled"):
        an = analyze(A, HyluOptions(factor_schedule=sched, **kw),
                     reuse=base)
        st = factor(an, A)
        kernels.reset_launch_counts()
        st = refactor(st, A2)
        counts = kernels.launch_counts()
        out[sched] = (st.torch_factors,) + solve(st, b)
    nodes = base.plan.nodes
    n_supsup = sum(1 for nd in nodes for e in nd.edges
                   if nd.nr > 1 and nodes[e.src].nr > 1)
    assert n_supsup > 0
    assert counts["node_edges_inplace"] == sum(
        1 for nd in nodes if nd.edges or nd.nr == 1)
    assert counts["gemm_update"] == counts["trsm_batched"] == 0
    assert counts["panel_lu"] == sum(nd.nr > 1 for nd in nodes)
    (fb, xb, ib), (fu, xu, iu) = out["bucketed"], out["unrolled"]
    assert torch.equal(fb.inode_perm, fu.inode_perm)
    assert int(fb.n_perturb) == int(fu.n_perturb)
    if dtype == "float64":
        torch.testing.assert_close(fu.vals, fb.vals, rtol=1e-10, atol=1e-10)
    assert max(ib["residual"], iu["residual"]) < 1e-10
    assert np.abs(xu - xb).max() / np.abs(xb).max() < 1e-10


# K5's node step (``node_edges_inplace``) against ``node_edges_plain``: on
# synthetic nodes (row-row and sup-row edges into a width-1 node, sup-sup
# edges with k up to 128, col_maps longer than 128, a row too wide for
# shared memory, 301 edges, no edge), on every node of one unrolled refactor
# of fem2d(12, 12) and at fem2d_10k's node with the most edge work.
NODES = {
    "row_row": (1, 30, 4, [(1, int(m)) for m in
                           np.random.default_rng(0).integers(0, 20, 40)]),
    "sup_row": (1, 150, 10, [(5, 30), (1, 8), (50, 60), (1, 0), (128, 21)]),
    "sup_sup": (17, 200, 40, [(1, 30), (2, 7), (5, 90), (64, 36), (128, 20),
                              (1, 1)]),
    "long_col_map": (33, 400, 100, [(100, 100), (3, 150), (2, 300)]),
    "wide_row": (5, 9000, 8000, [(1, 40), (7, 300), (128, 100)]),
    "many_edges": (128, 600, 300, [(1 + i % 3, 7 + i % 11)
                                   for i in range(301)]),
    "no_edges": (1, 12, 5, []),
}


def _node_step_held(v0, table, step, eps, tol, nonfinite=False):
    """Kernel and plain version on copies of v0: launches (of the wide
    instance for a source over 128 rows), nper, the node's panel (NaN and
    inf positions too) and every other slot's bits."""
    K = v0.shape[0]
    g, r = v0.clone(), v0.clone()
    ng = torch.zeros(K, dtype=torch.int32, device=v0.device)
    nr_ = torch.zeros_like(ng)
    counter = (supsup.node_edges_wide if step.kmax > supsup.WIDE_K
               else supsup.node_edges_inplace)
    before = counter.launches
    supsup.node_edges_inplace(g, table, step, eps, ng)
    supsup.node_edges_plain(r, table, step, eps, nr_)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert torch.equal(ng, nr_)
    lo, hi = step.off, step.off + step.nr * step.w
    for a, b in ((g[:, :lo], v0[:, :lo]), (g[:, hi:], v0[:, hi:])):
        assert torch.equal(_bits(a), _bits(b))
    gp, rp = g[:, lo:hi], r[:, lo:hi]
    if nonfinite:
        assert torch.equal(torch.isnan(gp), torch.isnan(rp))
        assert torch.equal(torch.isinf(gp), torch.isinf(rp))
        assert torch.equal(gp[torch.isinf(gp)], rp[torch.isinf(rp)])
        fin = torch.isfinite(rp)
        gp, rp = gp[fin], rp[fin]
    else:
        assert torch.isfinite(gp).all()
    torch.testing.assert_close(gp, rp, rtol=tol, atol=tol)
    return g, ng


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("case", sorted(NODES))
def test_node_edges_shapes(case, K, dt, cuda):
    tdt, tol, _ = TOLS[dt]
    nr, w, lsize, sources = NODES[case]
    rng = np.random.default_rng(len(case) * 31 + K)
    v0, table, step = _node_buffer(rng, K, nr, w, lsize, sources, tdt, cuda)
    # a width-1 node perturbs its pivot in the last system only
    eps = torch.full((K,), 1e-8, dtype=tdt, device=cuda)
    eps[-1] = 1e6 if nr == 1 else 1e-8
    g, ng = _node_step_held(v0, table, step, eps, tol)
    if nr == 1:
        assert ng.tolist() == [0] * (K - 1) + [1]
    # stopped after half the edges: no perturbation
    half = len(sources) // 2
    if half:
        before = supsup.node_edges_inplace.launches
        g, r = v0.clone(), v0.clone()
        for fn, v in ((supsup.node_edges_inplace, g),
                      (supsup.node_edges_plain, r)):
            fn(v, table, step, eps, torch.zeros(K, dtype=torch.int32,
                                                device=cuda), half)
        torch.cuda.synchronize()
        assert supsup.node_edges_inplace.launches == before + 1
        torch.testing.assert_close(g, r, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("nr", [1, 17])
@pytest.mark.parametrize("case", ["nan_in_source", "zero_pivot",
                                  "zero_source_diagonal"])
def test_node_edges_nonfinite(case, nr, dt, cuda):
    """A NaN in a source's U block or suffix, or an exact zero as a k = 1
    divisor (and, for nr > 1, on a source's U diagonal) with the target's
    pivot zero under eps = 0, or exact zeros on the U diagonals of the
    k > 1 sources (for nr = 1 sup-row edges: a quotient by zero meeting a
    zero of U, and a zero diagonal under a zeroed x_0): the kernel gives
    the plain version's NaN and inf positions, its infinities and its
    finite values.  The plain version's
    sup-sup solve is K3's column sweep and its sup-row solve
    ``trsm_plain`` (``_trsm_upper_jax``'s order): the same terms as the
    kernel's column sweep, in another order."""
    tdt, tol, _ = TOLS[dt]
    rng = np.random.default_rng(nr + len(case))
    sources = [(6, 12), (1, 4), (30, 9), (1, 10)]
    v0, table, step = _node_buffer(rng, 2, nr, 70, 25, sources, tdt, cuda)
    e6, e1, e30 = table.edges[0], table.edges[-1], table.edges[2]
    if case == "nan_in_source":
        v0[0, e6[0] + 2 * e6[2] + e6[3] + 4] = float("nan")     # U, row 2
        v0[1, e1[0] + e1[3] + 5] = float("nan")                 # suffix
    elif case == "zero_pivot":
        v0[:, e1[0] + e1[3]] = 0.0                       # k = 1 divisor
        if nr > 1:
            v0[1, e6[0] + 3 * e6[2] + e6[3] + 3] = 0.0   # U[3, 3]
        v0[:, step.off + step.lsize] = 0.0               # target pivot
    else:
        u33 = e6[0] + 3 * e6[2] + e6[3] + 3
        v0[1, u33] = v0[1, u33 + 1] = 0.0                # U[3, 3], U[3, 4]
        v0[0, e30[0] + e30[3]] = 0.0                     # U[0, 0] ...
        v0[0, step.off + int(e30[4][0])] = 0.0           # ... of x_0 = 0
    eps = torch.zeros(2, dtype=tdt, device=cuda)
    g, ng = _node_step_held(v0, table, step, eps, tol, nonfinite=True)
    assert not torch.isfinite(g[:, step.off:step.off + step.nr * step.w]
                              ).all()
    assert ng.tolist() == [0, 0]


def _spy_node_steps(monkeypatch, tol):
    """Hold every node step the engine launches to the plain version on a
    copy of its input; returns the list of checked (nr, edges)."""
    seen, orig = [], supsup.node_edges_inplace

    def spy(vals, table, step, eps, nper, n_edges=None):
        v0, n0 = vals.clone(), nper.clone()
        orig(vals, table, step, eps, nper, n_edges)
        supsup.node_edges_plain(v0, table, step, eps, n0, n_edges)
        torch.cuda.synchronize()
        assert torch.equal(nper, n0)
        torch.testing.assert_close(vals, v0, rtol=tol, atol=tol)
        seen.append((step.nr, step.e1 - step.e0))

    spy.launches = 0        # the wrapper counts through the module's name
    monkeypatch.setattr(supsup, "node_edges_inplace", spy)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("K", [1, 3])
def test_node_edges_every_node_of_fem2d_12(K, dt, cuda, monkeypatch):
    """Every node step of one unrolled refactor of fem2d(12, 12)'s
    supernodal plan (K systems), each held to the plain version on the
    same input."""
    tdt, tol, _ = TOLS[dt]
    A = to_csr(fem2d(12, 12, seed=1))
    an = analyze(A, HyluOptions(force_mode="supernodal", max_super=4,
                                bulk_min_width=2, factor_dtype=dt,
                                factor_schedule="unrolled"))
    eng = torch_repeated_engine(an)
    vals = A.data[None] * np.random.default_rng(K).uniform(0.8, 1.2,
                                                            (K, A.nnz))
    seen = _spy_node_steps(monkeypatch, tol)
    f = eng.refactor_batched(torch.from_numpy(vals).to(cuda))
    nodes = an.plan.nodes
    assert len(seen) == sum(1 for nd in nodes if nd.edges or nd.nr == 1)
    assert any(nr > 1 and n > 0 for nr, n in seen)
    assert torch.isfinite(f.vals).all()


@functools.lru_cache(maxsize=1)
def _fem2d_10k():
    """fem2d_10k's unrolled engine on the card (analysed once)."""
    A = to_csr(fem2d(100, 100, seed=930))
    an = analyze(A, HyluOptions(factor_schedule="unrolled"))
    return A, torch_repeated_engine(an)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("K", [1, 3])
def test_node_edges_at_fem2d_10k_largest_node(K, dt, cuda):
    """fem2d_10k's node with the most edge work (nr = 128, 1,085 edges) on
    the buffer the unrolled program hands it, in float64 and float32."""
    tdt, tol, _ = TOLS[dt]
    A, eng = _fem2d_10k()
    plan = eng.plan
    work = [sum(nd.nr * plan.nodes[e.src].nr * len(e.col_map)
                for e in nd.edges) for nd in plan.nodes]
    t = int(np.argmax(work))
    vals = A.data[None] * np.random.default_rng(K).uniform(0.8, 1.2,
                                                            (K, A.nnz))
    v0, eps = eng.refactor_batched(torch.from_numpy(vals).to(cuda),
                                   stop=(t, 0))
    _node_step_held(v0.to(tdt), eng._edges, eng._nodes[t][1], eps.to(tdt),
                    tol)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    # K2 takes any nr since the wide path; its kernels read rows densely
    for nr in (129, 300):
        with pytest.raises(ValueError, match="rows must be dense"):
            panel.panel_lu(torch.zeros(1, nr, 2 * nr + 4, device=cuda,
                                       dtype=torch.float64)[:, :, ::2],
                           nr, 0, 1e-8)
    with pytest.raises(TypeError, match="float64 or float32"):
        supsup.gemm_batched(torch.zeros(2, 3, 4, device=cuda,
                                        dtype=torch.float16),
                            torch.zeros(2, 4, 5, device=cuda,
                                        dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        tri.trsm_batched(torch.zeros(2, 4, 4, device=cuda,
                                     dtype=torch.float64),
                         torch.zeros(2, 4, 5, device=cuda,
                                     dtype=torch.float64)[:, :, :4])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fem2d_12", "circuit_300"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_engine_on_card_matches_cpu(name, dtype, cuda):
    if name == "fem2d_12":
        a, kw = fem2d(12, 12, seed=1), dict(force_mode="supernodal",
                                            bulk_min_width=2)
    else:
        a, kw = circuit_like(300, seed=3), {}
    A = to_csr(a)
    rng = np.random.default_rng(0)
    vb = A.data[None] * rng.uniform(0.8, 1.2, (4, A.nnz))
    bb = rng.normal(size=(4, A.n))
    out = {}
    kernels.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        an = analyze(A, HyluOptions(device=dev, factor_dtype=dtype, **kw))
        bst = factor_batched(an, A, vb)
        out[dev] = (bst,) + solve_batched(bst, bb)
    counts = kernels.launch_counts()
    if name == "fem2d_12":
        assert all(counts[w] > 0 for w in BATCHED_PATH), counts
    (bg, xg, ig), (bc, xc, ic) = out["cuda"], out["cpu"]
    assert np.array_equal(bg.n_perturb, bc.n_perturb)
    if dtype == "float64":
        assert torch.equal(bg.inode_perm.cpu(), bc.inode_perm)
        torch.testing.assert_close(bg.vals.cpu(), bc.vals, rtol=1e-10,
                                   atol=1e-10)
    assert max(ig["residual"].max(), ic["residual"].max()) < 1e-10
    assert np.abs(xg - xc).max() / np.abs(xc).max() < 1e-10


# K7 and K8 at the cases of tests/test_kernels.py (test_flash_attention,
# test_wkv_kernel) and at the widths of the serving configs (D = 128 of
# phi3-medium, hs = 64 of rwkv6): K7 against its plain version on the same
# operands at the JAX 2e-5 in float32, and in bfloat16 (the plain version
# rounding p as the kernel does) at rtol 1e-2, atol 2e-3, inside the JAX
# 3e-2; 2e-4 for K8's y and final state
# (the bfloat16 route runs on the tensor cores in 128-row query tiles and
# 128-row KV tiles, 64 at D = 256: every D below has a T that is a multiple
# of neither, and GQA groups of 1, 4 and 5 appear)
FLASH_CASES = [(2, 4, 2, 64, 32, True), (1, 8, 8, 96, 64, True),
               (2, 4, 1, 40, 16, True), (1, 2, 2, 50, 32, False),
               (1, 4, 4, 130, 64, True), (2, 8, 2, 200, 128, True),
               (1, 4, 1, 77, 128, False), (2, 8, 2, 200, 256, True),
               (1, 10, 2, 333, 256, False), (1, 4, 4, 1000, 256, True),
               (1, 10, 2, 150, 128, True), (2, 5, 1, 257, 64, True),
               (1, 5, 1, 300, 16, True), (2, 4, 1, 190, 32, True)]
# non-causal with S != T (longer and shorter KV), at every head width
FLASH_OTHER_S = [(d, t, s) for d in (16, 32, 64, 128, 256)
                 for t, s in ((100, 333), (260, 70))]
# K4 at ragged shapes, one product and 2,048 (K = 32 systems times 64
# edges), each against the plain version at the solver's limits
BMM_SWEEP = [(1, 1, 1), (7, 3, 129), (33, 13, 5), (128, 128, 100),
             (128, 50, 100)]
WKV_CASES = [(4, 64, 16), (2, 100, 32), (6, 33, 8), (1, 256, 64),
             (8, 300, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,t,d,causal", FLASH_CASES)
def test_flash_attention_matches_plain(b, hq, hkv, t, d, causal, dt, cuda):
    tdt, rtol, atol = {"float32": (torch.float32, 2e-5, 2e-5),
                       "bfloat16": (torch.bfloat16, 1e-2, 2e-3)}[dt]
    rng = np.random.default_rng(t + d)
    q = torch.tensor(rng.normal(size=(b, t, hq, d)), dtype=tdt,
                     device=cuda).transpose(1, 2)   # the model's layout
    k, v = (torch.tensor(rng.normal(size=(b, t, hkv, d)), dtype=tdt,
                         device=cuda).transpose(1, 2) for _ in range(2))
    before = kernels.launch_counts()["flash_attention"]
    got = flash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == tdt and got.shape == (b, hq, t, d)
    ref = flash.attention_plain(q, k, v, causal)
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,t,s", FLASH_OTHER_S)
def test_flash_attention_noncausal_other_s(d, t, s, dt, cuda):
    tdt, rtol, atol = {"float32": (torch.float32, 2e-5, 2e-5),
                       "bfloat16": (torch.bfloat16, 1e-2, 2e-3)}[dt]
    rng = np.random.default_rng(d + t + s)
    q = torch.tensor(rng.normal(size=(2, t, 8, d)), dtype=tdt,
                     device=cuda).transpose(1, 2)
    k, v = (torch.tensor(rng.normal(size=(2, s, 2, d)), dtype=tdt,
                         device=cuda).transpose(1, 2) for _ in range(2))
    got = flash.flash_attention(q, k, v, causal=False)
    ref = flash.attention_plain(q, k, v, False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 256])
def test_flash_attention_contiguous_heads_layout(d, cuda):
    """bfloat16 operands stored (B, H, T, D) rather than the model's
    (B, T, H, D): the tensor maps take either stride order."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.tensor(rng.normal(size=(2, 4, 150, d)),
                            dtype=torch.bfloat16, device=cuda)
               for _ in range(3))
    got = flash.flash_attention(q, k, v, causal=True)
    ref = flash.attention_plain(q, k, v, True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), rtol=1e-2,
                               atol=2e-3)


@pytest.mark.cuda
def test_flash_attention_refuses_unaligned_bfloat16(cuda):
    """TMA reads 16-byte aligned bases and strides: a bfloat16 operand
    that starts 2 bytes into its buffer is refused, not rerouted."""
    buf = torch.zeros(1 * 2 * 40 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    q = buf[1:].view(1, 2, 40, 64)
    k = torch.zeros(1, 2, 40, 64, dtype=torch.bfloat16, device=cuda)
    before = kernels.launch_counts()["flash_attention"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash.flash_attention(q, k, k)
    assert kernels.launch_counts()["flash_attention"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("e", [1, 2048])
@pytest.mark.parametrize("nr,k,m", BMM_SWEEP)
def test_gemm_batched_ragged_sweep(nr, k, m, e, dt, cuda):
    tdt, tol, _ = TOLS[dt]
    rng = np.random.default_rng(nr * 7 + k * 3 + m + e)
    a = torch.tensor(rng.normal(size=(e, nr, k)), dtype=tdt, device=cuda)
    b = torch.tensor(rng.normal(size=(e, k, m)), dtype=tdt, device=cuda)
    before = kernels.launch_counts()["gemm_batched"]
    got = supsup.gemm_batched(a, b)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gemm_batched"] == before + 1
    torch.testing.assert_close(got, supsup.gemm_batched_plain(a, b),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,hs", WKV_CASES)
def test_wkv_matches_plain(bh, t, hs, cuda):
    rng = np.random.default_rng(bh + t + hs)

    def f(a):
        return torch.tensor(a, dtype=torch.float32, device=cuda)

    r, v = (f(rng.normal(size=(bh, t, hs))) for _ in range(2))
    k = f(rng.normal(size=(bh, t, hs)) * 0.3)
    w = f(rng.uniform(0.7, 0.999, size=(bh, t, hs)))
    u = f(rng.normal(size=(bh, hs)) * 0.3)
    before = kernels.launch_counts()["wkv"]
    y, s = wkvops.wkv(r[None], k[None], v[None], w[None], u)  # B = 1
    torch.cuda.synchronize()
    assert kernels.launch_counts()["wkv"] == before + 1
    yr, sr = wkvops.wkv_plain(r[None], k[None], v[None], w[None], u)
    torch.testing.assert_close(y, yr, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s, sr, rtol=2e-4, atol=2e-4)
    if bh % 2 == 0:            # the model's layout: (B, H, T, hs) views
        h = bh // 2
        ops4 = [a.reshape(2, h, t, hs).transpose(1, 2).contiguous()
                .transpose(1, 2) for a in (r, k, v, w)]
        y4, s4 = wkvops.wkv(*ops4, u[:h])
        yr4, sr4 = wkvops.wkv_plain(*ops4, u[:h])
        torch.testing.assert_close(y4, yr4, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(s4, sr4, rtol=2e-4, atol=2e-4)


# K8's design cases (y and the final state against the plain version at
# 2e-4): rwkv6-1.6b's full shape in the model's (B, T, H, hs) storage; T of
# one step, of one more than a tile of 32 or 64 steps, and ragged at 2,000;
# decays from the model's range, from [1e-6, 0.05] and exactly 1.0; every
# head size; u shared over the batch (stride 0) or one per request; more
# blocks than SMs; a NaN in one head's v; r starting 4 bytes off a 16-byte
# boundary (the kernel stages in 4-byte copies then).  Each call's outputs
# are allocated where a NaN-filled buffer was just freed, so a column that
# no block writes shows as NaN.  Fields: B, H, T, hs, decays, one u per
# request, what else.
WKV_DESIGN = {
    "rwkv6_full": (4, 32, 2048, 64, "model", False, None),
    "rwkv6_full_tiny_decay": (4, 32, 2048, 64, "tiny", False, None),
    "rwkv6_full_unit_decay": (4, 32, 2048, 64, "one", False, None),
    "t1": (2, 3, 1, 64, "model", False, None),
    "t33": (2, 3, 33, 64, "model", False, None),
    "t65": (2, 3, 65, 64, "model", False, None),
    "t2000": (1, 4, 2000, 64, "model", False, None),
    **{f"hs{hs}_{d}": (2, 5, 77, hs, d, False, None)
       for hs in wkvops.HEAD_SIZES for d in ("model", "tiny", "one")},
    **{f"hs{hs}_u_per_request": (3, 2, 40, hs, "model", True, None)
       for hs in wkvops.HEAD_SIZES},
    "more_blocks_than_sms": (10, 30, 70, 64, "model", False, None),
    "nan_in_one_head": (2, 4, 90, 64, "model", False, "nan"),
    **{f"hs{hs}_misaligned": (2, 3, 70, hs, "model", False, "misaligned")
       for hs in (16, 64)},
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WKV_DESIGN))
def test_wkv_design_cases(case, cuda):
    b, h, t, hs, decay, u_per_request, other = WKV_DESIGN[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    shape = (b, t, h, hs)

    def f(a):                  # (B, T, H, hs) storage, (B, H, T, hs) view
        return torch.tensor(a, dtype=torch.float32,
                            device=cuda).transpose(1, 2)

    r, v = (f(rng.normal(size=shape)) for _ in range(2))
    k = f(rng.normal(size=shape) * 0.3)
    w = {"model": lambda: f(np.exp(-np.exp(rng.normal(-2.0, 0.5, shape)))),
         "tiny": lambda: f(rng.uniform(1e-6, 0.05, shape)),
         "one": lambda: torch.ones_like(r)}[decay]()
    u = torch.tensor(rng.normal(size=(b, h, hs) if u_per_request else (h, hs))
                     * 0.3, dtype=torch.float32, device=cuda)
    if other == "nan":
        v[1, 2, 40, 7] = float("nan")
    if other == "misaligned":  # the same values and strides, one float on
        buf = torch.empty(r.numel() + 1, device=cuda)
        r = buf[1:].view(shape).copy_(r.transpose(1, 2)).transpose(1, 2)
        assert r.data_ptr() % 16 == 4 and r.stride() == k.stride()
    junk = torch.full((2 * b * h * t * hs + b * h * hs * hs,), float("nan"),
                      device=cuda)
    del junk
    before = kernels.launch_counts()["wkv"]
    y, s = wkvops.wkv(r, k, v, w, u)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["wkv"] == before + 1
    assert y.shape == (b, h, t, hs) and s.shape == (b, h, hs, hs)
    yr, sr = wkvops.wkv_plain(r, k, v, w, u)
    nan = other == "nan"
    torch.testing.assert_close(y, yr, rtol=2e-4, atol=2e-4, equal_nan=nan)
    torch.testing.assert_close(s, sr, rtol=2e-4, atol=2e-4, equal_nan=nan)
    if nan:                     # only column 7 of head (1, 2), from step 40
        mask = torch.zeros_like(y, dtype=torch.bool)
        mask[1, 2, 40:, 7] = True
        assert torch.equal(torch.isnan(y), mask)
        assert torch.equal(torch.isnan(yr), mask)
        smask = torch.zeros_like(s, dtype=torch.bool)
        smask[1, 2, :, 7] = True
        assert torch.equal(torch.isnan(s), smask)
    else:
        assert torch.isfinite(y).all() and torch.isfinite(s).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name,wrapper", [
    ("phi3-medium-14b", "flash_attention"), ("rwkv6-1.6b", "wkv"),
    ("qwen3-moe-30b-a3b", "flash_attention"),
    ("grok-1-314b", "flash_attention"),
    ("jamba-1.5-large-398b", "flash_attention")])
def test_serving_on_card_matches_cpu(name, wrapper, cuda):
    """Prefill and greedy decode of a reduced model in float32 on the card
    (K7 or K8 once per attention or RWKV6 layer of the prefill, nothing in
    decode; the MoE and Mamba layers are plain PyTorch) against the same
    weights on the CPU (the plain routes): logits within 1e-4, the same
    tokens."""
    cfg = registry.get(name).reduced()
    n_kernel = cfg.n_periods * sum(k != "mamba" for k in cfg.layer_kinds())
    p_cpu = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_card(v) for v in tree]
        return tree.to(cuda)

    p_gpu = to_card(p_cpu)
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)))
    out = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        kernels.reset_launch_counts()
        logits, _ = S.make_prefill_step(cfg, s_max=44)(params,
                                                       tokens=toks.to(dev))
        per_prefill = kernels.launch_counts()[wrapper]
        kernels.reset_launch_counts()
        gen = S.greedy_generate(cfg, params, toks.to(dev), 4)
        out[dev] = (logits.cpu(), gen.cpu(), per_prefill,
                    kernels.launch_counts()[wrapper])
    assert out["cuda"][2:] == (n_kernel, n_kernel)
    assert out["cpu"][2:] == (0, 0)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(out["cuda"][1], out["cpu"][1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["phi3-medium-14b", "qwen3-moe-30b-a3b",
                                  "jamba-1.5-large-398b", "rwkv6-1.6b"])
def test_train_step_on_card_matches_cpu(name, cuda):
    """One training step of a reduced model in float32 on the card against
    the same params, optimizer state and batch on the CPU (the training
    step takes the plain route on both: K7 and K8 launch nothing): loss
    and metrics within 1e-5 relative; m and v (the gradient, scaled)
    within 1e-4 of each leaf's largest entry; params: at least 99.9% of
    the entries within 1e-3 of lr and every entry within 0.2 lr (an entry
    whose gradient is noise near Adam's eps moves by a sizeable part of
    lr when the summation order changes that noise: measured up to
    0.063 lr at these sizes)."""
    from repro_torch import tree as tr
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    cfg = registry.get(name).reduced()
    p_cpu = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(1)
    batch = dict(tokens=torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40))
                                         .astype(np.int32)),
                 labels=torch.from_numpy(rng.integers(-1, cfg.vocab, (2, 40))
                                         .astype(np.int32)))
    ocfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, ocfg, seq_chunk=16)
    out = {}
    for dev in ("cuda", "cpu"):
        params = tr.map_leaves(lambda p: p.to(dev).clone(), p_cpu)
        st = adamw.init_state(params)
        kernels.reset_launch_counts()
        params, st, _, m = step(params, st, None,
                                {k: v.to(dev) for k, v in batch.items()})
        assert not any(kernels.launch_counts().values())
        out[dev] = (tr.map_leaves(lambda x: x.cpu(), params),
                    tr.map_leaves(lambda x: x.cpu(), st),
                    {k: float(v) for k, v in m.items()})
    (pg, sg, mg), (pc, sc, mc) = out["cuda"], out["cpu"]
    for k in mc:
        assert abs(mg[k] - mc[k]) <= 1e-5 * max(abs(mc[k]), 1.0), k
    lr = mc["lr"]
    far = n = 0
    for a, b in zip(tr.leaves(pg), tr.leaves(pc)):
        d = (a - b).abs() / lr
        assert float(d.max()) <= 0.2
        far, n = far + int((d > 1e-3).sum()), n + d.numel()
    assert far <= 1e-3 * n, (far, n)
    for a, b in zip(tr.leaves((sg.m, sg.v)), tr.leaves((sc.m, sc.v))):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name,wrapper", [("phi3-medium-14b",
                                           "flash_attention"),
                                          ("rwkv6-1.6b", "wkv")])
def test_kernel_route_refuses_grad(name, wrapper, cuda):
    """K7 and K8 have no backward: ``forward(use_kernels=True)`` under grad
    with params that require grad raises (and launches nothing) instead
    of returning hidden states whose projections get no gradient; under
    ``no_grad`` the kernel route runs and launches; ``use_kernels=False``
    under grad gives every projection a gradient."""
    cfg = registry.get(name).reduced()
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)), device=cuda)
    leaf = params["blocks"][0]["attn" if wrapper == "flash_attention"
                               else "rwkv"]["wq" if wrapper ==
                                            "flash_attention" else "wr"]
    leaf.requires_grad_(True)
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        T.forward(cfg, params, tokens=toks, remat=False)
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        T.forward(cfg, params, tokens=toks, remat=True)
    assert kernels.launch_counts()[wrapper] == 0
    with torch.no_grad():
        T.forward(cfg, params, tokens=toks)
    assert kernels.launch_counts()[wrapper] == cfg.n_layers
    h, _, _ = T.forward(cfg, params, tokens=toks, use_kernels=False)
    (g,) = torch.autograd.grad(h.square().sum(), leaf)
    assert torch.count_nonzero(g) > 0


@pytest.mark.cuda
def test_async_fault_storm_on_card(cuda):
    """A mixed-pattern stream laced with every fault kind through the async
    server on the card: one terminal result each, every status inside its
    kind's expectation, healthy requests within 1e-10 of the dense fp64
    oracle, and the kernels its plans reach launched (at n = 32 with
    supernodes of at most 4 columns: K2 on narrow nodes, K3 and K4 on
    sup-sup edges, both left solves; no level is wide enough for K1's
    buckets, which the round trip below reaches)."""
    import asyncio

    from repro_torch.serve.async_server import AsyncSolverServer
    from repro_torch.serve.faultinject import (check_report, make_stream,
                                               run_stream)
    from repro_torch.serve.solver_service import SolverService

    service = SolverService(opts=HyluOptions(force_mode="supernodal",
                                             bulk_min_width=2, max_super=4),
                            cache_dir=None, batch_size=4)
    assert service.device.type == "cuda"
    stream = make_stream(40, fault_rate=0.35, seed=5, n=32)

    async def main():
        async with AsyncSolverServer(service, max_linger_ms=20.0) as server:
            return await run_stream(server, stream)

    kernels.reset_launch_counts()
    report = asyncio.run(main())
    counts = kernels.launch_counts()
    violations = check_report(report)
    assert not violations, "\n".join(violations)
    assert report["lost"] == 0 and report["n_healthy_checked"] > 0
    assert report["by_status"]["solved"] > 0
    assert report["by_status"]["rejected"] > 0
    assert report["by_status"]["quarantined"] > 0
    for w in ("panel_lu", "trsm_batched", "gemm_batched",
              "trsm_left_unit_lower_batched", "trsm_left_upper_batched"):
        assert counts[w] > 0, (w, counts)


@pytest.mark.cuda
def test_plan_cache_round_trip_on_card(cuda, tmp_path):
    """A plan saved from the card's service and loaded by a fresh cache
    solves on the card as the original did.  ``index_add_`` is atomic on
    CUDA, so its sums change order from run to run: the reloaded plan is
    held to 1e-10 with equal pivots and perturbation counts, not to
    bit-identity as on the CPU."""
    from repro_torch.core import PlanCache

    A = to_csr(fem2d(12, 12, seed=1))
    opts = HyluOptions(force_mode="supernodal", bulk_min_width=2)
    rng = np.random.default_rng(4)
    vb = A.data[None] * rng.uniform(0.8, 1.2, (4, A.nnz))
    bb = rng.normal(size=(4, A.n))
    cache = PlanCache(directory=str(tmp_path))
    an = cache.get_or_analyze(A, opts)
    kernels.reset_launch_counts()
    bst0 = factor_batched(an, A, vb)
    x0, info0 = solve_batched(bst0, bb)
    assert all(kernels.launch_counts()[w] > 0 for w in BATCHED_PATH)
    fresh = PlanCache(directory=str(tmp_path))
    an2 = fresh.get_or_analyze(A, opts)
    assert fresh.stats["disk_hits"] == 1 and fresh.stats["analyze_calls"] == 0
    bst1 = factor_batched(an2, A, vb)
    x1, info1 = solve_batched(bst1, bb)
    assert torch.equal(bst0.inode_perm, bst1.inode_perm)
    assert np.array_equal(bst0.n_perturb, bst1.n_perturb)
    assert max(info0["residual"].max(), info1["residual"].max()) < 1e-10
    assert np.abs(x1 - x0).max() / np.abs(x0).max() < 1e-10


# ------------------------------------------ supernodes over 128 rows
# K2 and K1 at nr > 128: the window kernel up to 256 rows (its window in
# shared memory where it fits, else in device memory), panel_lu_kernel
# beyond; K3 past 128 columns by one launch of its wide kernel; K4 on
# 256-row edge buckets.
WIDE_NODE = [(129, 0, 0), (150, 2370, 0), (150, 40, 30), (256, 10, 4),
             (300, 20, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("nr,lsize,us", WIDE_NODE)
def test_wide_node_panel_lu(nr, lsize, us, dt, cuda):
    """K2's wide path at one panel and at 32 (a narrow level at K = 32),
    rows shuffled: one ``panel_lu_wide`` launch and none of ``panel_lu``,
    the plain version's pivots, perturbation counts and values; the
    150-row panel with a 2,370-column prefix is fem2d_10k's root under
    ``pardiso_like``."""
    tdt, tol, _ = TOLS[dt]
    rng = np.random.default_rng(nr * 31 + lsize + us)
    for b in (1, 32) if nr <= 150 else (2,):
        p = _node_panels(rng, b, nr, lsize, us, dominant=True)
        P = torch.tensor(p, dtype=tdt, device=cuda)
        eps = _eps_per_system(b, tdt, cuda)
        before = kernels.launch_counts()
        got = panel.panel_lu(P, nr, lsize, eps)
        ref = panel.panel_lu_plain(P, lsize, P.shape[2], eps)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        assert after["panel_lu_wide"] == before["panel_lu_wide"] + 1
        assert after["panel_lu"] == before["panel_lu"]
        assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
        assert (got[1] != torch.arange(nr, device=cuda)).any()
        torch.testing.assert_close(got[0], ref[0], rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("nr", [150, 300])
@pytest.mark.parametrize("case", ["zero_pivot", "nan_in_u", "inf_in_l"])
def test_wide_node_panel_lu_nonfinite(case, nr, cuda):
    """K2's wide path on degenerate panels (an exact zero pivot column
    under eps = 0, a NaN in the U suffix, an infinity in the L prefix):
    the plain version's NaN and inf positions, pivots and finite values,
    through the window kernel (150 rows) and panel_lu_kernel (300)."""
    rng = np.random.default_rng(nr)
    lsize, us = 12, 20
    p = _node_panels(rng, 2, nr, lsize, us, dominant=True)
    eps = 1e-8
    if case == "zero_pivot":
        p[:, :, lsize] = 0.0
        eps = 0.0
    elif case == "nan_in_u":
        p[:, 3, lsize + nr + 5] = np.nan
    else:
        p[:, 7, 2] = np.inf
    P = torch.tensor(p, dtype=torch.float64, device=cuda)
    e = torch.full((2,), eps, dtype=torch.float64, device=cuda)
    got = panel.panel_lu(P, nr, lsize, e)
    ref = panel.panel_lu_plain(P, lsize, P.shape[2], e)
    torch.cuda.synchronize()
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    g, r = got[0], ref[0]
    assert not torch.isfinite(r).all() and torch.isfinite(r).any()
    assert torch.equal(torch.isnan(g), torch.isnan(r))
    assert torch.equal(torch.isinf(g), torch.isinf(r))
    fin = torch.isfinite(r)
    torch.testing.assert_close(g[fin], r[fin], rtol=1e-10, atol=1e-10)


# K1 wide: (nrp, usp, lsp, members (nr, usize, lsize)): the window kernel
# in place at 256 padded rows, panel_lu_kernel on the gathered panels at
# 512
WIDE_BUCKETS = [(256, 24, 32, [(129, 20, 30), (150, 24, 0), (256, 3, 32)]),
                (512, 16, 40, [(300, 16, 40), (257, 0, 7)])]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("bucket", range(len(WIDE_BUCKETS)))
def test_wide_bucket_panel_lu(bucket, k, dt, cuda):
    """K1's wide path on buckets padded to 256 and 512 rows, rows not
    16-byte aligned, a threshold per system: one ``panel_lu_bucket_wide``
    launch, the plain version's pivots, counts and values, and no slot
    outside the members' written."""
    tdt, tol, _ = TOLS[dt]
    nrp, usp, lsp, members = WIDE_BUCKETS[bucket]
    rng = np.random.default_rng(nrp + k)
    desc, parts, n = _place(rng, k, members, 5, 1)
    vals = _bucket_vals(k, n, parts, tdt, cuda)
    before = panel.panel_lu_bucket_inplace.launches
    perm, _, _ = _bucket_held(vals, _layout(desc, nrp, usp, lsp, n, cuda),
                              _eps_per_system(k, tdt, cuda), tol,
                              counter=panel.panel_lu_bucket_wide)
    assert panel.panel_lu_bucket_inplace.launches == before
    assert (perm != torch.arange(nrp, device=cuda)).any()


def _launch_spy(monkeypatch):
    """The entry points ``_build.launch`` is asked for, in order."""
    from repro_torch.kernels import _build

    names, launch = [], _build.launch

    def spy(name, *args, **kwargs):
        names.append(name)
        return launch(name, *args, **kwargs)

    monkeypatch.setattr(_build, "launch", spy)
    return names


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS) + ["bfloat16"])
@pytest.mark.parametrize("k", [129, 150, 256, 600, 1100, 3000])
def test_trsm_wide(k, dt, cuda, monkeypatch):
    """K3's three entries at k > 128, one launch of the wide kernel each:
    the right solve on a strided view of source rows with NaN below U's
    diagonal (nr 40 and 300, unit diagonal too), the left solves on blocks
    with NaN in the triangle they do not read, m = 1 and 3; each one count
    of its ``*_wide`` wrapper and none of the k <= 128 one, exactly one
    ``hylu_trsm_*_wide_*`` launch and no GEMM update; values within the
    plain versions' tolerance.  bfloat16: bit-equal to the plain versions
    summed in the kernels' order (``ref.*_bf16_ordered``); against the
    plain versions themselves, whose dots sum in cuBLAS's order, an entry
    where x - bf16(S) cancels differs by many of its own ulps (k >= 256
    here).  At k = 3000 in float64 the right solve's tiles live in its
    device-memory scratch and the left solves' w (m = 3) in W itself."""
    bf = dt == "bfloat16"
    tdt, tol, ltol = (torch.bfloat16, None, None) if bf else TOLS[dt]
    sfx = {torch.float64: "f64", torch.float32: "f32",
           torch.bfloat16: "bf16"}[tdt]
    ordered = {tri.trsm_plain: tri_ref.trsm_bf16_ordered,
               tri.trsm_left_unit_lower_plain:
                   tri_ref.trsm_left_unit_lower_bf16_ordered,
               tri.trsm_left_upper_plain:
                   tri_ref.trsm_left_upper_bf16_ordered}

    def plain_of(plain):
        return ordered[plain] if bf else plain

    def held(got, ref, t):
        if bf:
            assert torch.equal(got, ref)
        else:
            torch.testing.assert_close(got, ref, rtol=t, atol=t)

    names = _launch_spy(monkeypatch)
    rng = np.random.default_rng(k)
    for nr in (40, 300):
        src = _src_rows(rng, 3, k, 7, tdt, cuda)
        x = torch.tensor(rng.normal(size=(3, nr, k)), dtype=tdt,
                         device=cuda)
        for unit in (False, True):
            ref = plain_of(tri.trsm_plain)(src[..., :k], x, unit_diag=unit)
            before = kernels.launch_counts()
            del names[:]
            got = tri.trsm_batched(src[..., :k], x, unit_diag=unit)
            after = kernels.launch_counts()
            assert names == [f"hylu_trsm_right_wide_{sfx}"], names
            assert after["trsm_right_wide"] == before["trsm_right_wide"] + 1
            assert after["trsm_batched"] == before["trsm_batched"]
            held(got, ref, tol)
    blk = _wide_block(rng, 2, k)
    for m in (1, 3):
        b = torch.tensor(rng.normal(size=(2, k, m)), dtype=tdt, device=cuda)
        for name, fn, plain, other in (
                ("trsm_left_unit_lower", tri.trsm_left_unit_lower_batched,
                 tri.trsm_left_unit_lower_plain,
                 np.triu_indices(k, 0)),       # the unit diagonal too
                ("trsm_left_upper", tri.trsm_left_upper_batched,
                 tri.trsm_left_upper_plain, np.tril_indices(k, -1))):
            ref = plain_of(plain)(torch.tensor(blk, dtype=tdt, device=cuda),
                                  b)
            poisoned = blk.copy()
            poisoned[:, other[0], other[1]] = np.nan
            before = kernels.launch_counts()
            del names[:]
            got = fn(torch.tensor(poisoned, dtype=tdt, device=cuda), b)
            after = kernels.launch_counts()
            assert names == [f"hylu_{name}_wide_{sfx}"], names
            assert after[name + "_wide"] == before[name + "_wide"] + 1
            assert after[name + "_batched"] == before[name + "_batched"]
            held(got, ref, ltol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("k,m", [(1, 8), (64, 104), (256, 40)])
def test_bmm_on_256_row_buckets(k, m, dt, cuda):
    """K4 on edge buckets of target nr = 256, as ``pardiso_like`` makes
    them at fem2d_10k (k up to 64, m up to 104), and at k = 256 (a source
    of more than 128 rows): one launch, the plain version's values."""
    tdt, tol, _ = TOLS[dt]
    rng = np.random.default_rng(k + m)
    a = torch.tensor(rng.normal(size=(5, 256, k)), dtype=tdt, device=cuda)
    b = torch.tensor(rng.normal(size=(5, k, m)), dtype=tdt, device=cuda)
    before = supsup.gemm_batched.launches
    got = supsup.gemm_batched(a, b)
    torch.cuda.synchronize()
    assert supsup.gemm_batched.launches == before + 1
    torch.testing.assert_close(got, supsup.gemm_batched_plain(a, b),
                               rtol=tol, atol=tol)


def _card_wide_source(n=200, blk=140, cpl=20, seed=6):
    """tests/test_torch_baselines.py's ``_wide_source_system``: under
    natural ordering a 140-row supernode that is a panel bucket of its own
    (padded to 256 rows) and the source of sup-sup edges (k 140)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    r = n - blk
    a = sp.lil_matrix((n, n))
    a[blk:, blk:] = sp.random(r, r, density=0.05,
                              random_state=np.random.RandomState(seed))
    a[:blk, :blk] = rng.normal(size=(blk, blk))
    a[blk:blk + cpl, :blk] = rng.normal(size=(cpl, blk))
    a[:blk, blk:blk + cpl] = rng.normal(size=(blk, cpl))
    diag = rng.uniform(1.0, 2.0, n) * rng.choice([-1, 1], n) * 30
    return (a.tocsr() + sp.diags(diag)).tocsr()


def _card_wide_root(n=200, blk=160, seed=5):
    """tests/test_torch_baselines.py's ``_wide_root_system``: a 160-row
    root supernode, factored per node at a narrow level."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=0.02,
                  random_state=np.random.RandomState(seed), format="lil")
    a[20:20 + blk, 20:20 + blk] = rng.normal(size=(blk, blk))
    diag = rng.uniform(1.0, 2.0, n) * rng.choice([-1, 1], n) * 4
    return (a.tocsr() + sp.diags(diag)).tocsr()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["wide_source", "wide_root"])
def test_pardiso_like_on_card_matches_cpu(name, cuda):
    """A whole ``pardiso_like`` batched factor and solve of a plan with a
    node of more than 128 rows on the card (the wide paths) against the
    CPU's plain versions: equal pivots and perturbation counts, factors
    and solutions within 1e-10 (``index_add_`` sums in another order on
    the card), the wide paths launched; for the 140-row edge source also
    the unrolled schedule's kernel route (K5's wide node step) against the
    CPU's unrolled run and the bucketed one."""
    from repro_torch.core import baselines

    if name == "wide_source":
        a, kw = _card_wide_source(), dict(orderings=("natural",),
                                          bulk_min_width=2)
        wide = ("panel_lu_bucket_wide", "trsm_right_wide",
                "trsm_left_unit_lower_wide", "trsm_left_upper_wide")
    else:
        a, kw = _card_wide_root(), {}
        wide = ("panel_lu_wide", "trsm_left_unit_lower_wide",
                "trsm_left_upper_wide")
    A = to_csr(a)
    rng = np.random.default_rng(3)
    vb = A.data[None] * rng.uniform(0.8, 1.2, (4, A.nnz))
    bb = rng.normal(size=(4, A.n))
    out = {}
    for dev in ("cpu", "cuda"):
        an = analyze(A, baselines.pardiso_like_options(device=dev, **kw))
        kernels.reset_launch_counts()
        bst = factor_batched(an, A, vb)
        out[dev] = (bst,) + solve_batched(bst, bb) + (
            kernels.launch_counts(),)
    (bc, xc, ic, _), (bg, xg, ig, counts) = out["cpu"], out["cuda"]
    assert all(counts[w] > 0 for w in wide), counts
    assert torch.equal(bg.inode_perm.cpu(), bc.inode_perm)
    assert np.array_equal(bg.n_perturb, bc.n_perturb)
    torch.testing.assert_close(bg.vals.cpu(), bc.vals, rtol=1e-10,
                               atol=1e-10)
    assert max(ig["residual"].max(), ic["residual"].max()) < 1e-10
    assert np.abs(xg - xc).max() / np.abs(xc).max() < 1e-10
    if name == "wide_source":             # the unrolled kernel route
        out_u = {}
        for dev in ("cpu", "cuda"):
            an_u = analyze(A, baselines.pardiso_like_options(
                device=dev, factor_schedule="unrolled", **kw))
            kernels.reset_launch_counts()
            bst = factor_batched(an_u, A, vb)
            out_u[dev] = (bst,) + solve_batched(bst, bb) + (
                kernels.launch_counts(),)
        (uc, xuc, _, _), (ug, xug, iug, cu) = out_u["cpu"], out_u["cuda"]
        assert cu["node_edges_wide"] > 0 and cu["node_edges_inplace"] > 0
        assert torch.equal(ug.inode_perm.cpu(), uc.inode_perm)
        assert torch.equal(ug.inode_perm.cpu(), bc.inode_perm)
        assert np.array_equal(ug.n_perturb, uc.n_perturb)
        torch.testing.assert_close(ug.vals.cpu(), uc.vals, rtol=1e-10,
                                   atol=1e-10)
        torch.testing.assert_close(ug.vals.cpu(), bc.vals, rtol=1e-10,
                                   atol=1e-10)
        assert iug["residual"].max() < 1e-10
        assert np.abs(xug - xuc).max() / np.abs(xuc).max() < 1e-10


@pytest.mark.cuda
def test_unrolled_plain_node_step_on_card_takes_wide_sources(cuda):
    """The unrolled schedule with ``use_kernels=False`` on the card runs
    the plain node step, which takes any edge source: ``pardiso_like``'s
    plan of the 140-row source factors and solves there and matches the
    CPU's plain route (equal pivots and perturbation counts, factors and
    solutions within 1e-10), launching no kernel."""
    from repro_torch.core import baselines

    A = to_csr(_card_wide_source())
    kw = dict(orderings=("natural",), bulk_min_width=2,
              factor_schedule="unrolled", use_kernels=False)
    rng = np.random.default_rng(4)
    vb = A.data[None] * rng.uniform(0.8, 1.2, (3, A.nnz))
    bb = rng.normal(size=(3, A.n))
    out = {}
    for dev in ("cpu", "cuda"):
        an = analyze(A, baselines.pardiso_like_options(device=dev, **kw))
        kernels.reset_launch_counts()
        bst = factor_batched(an, A, vb)
        out[dev] = (bst,) + solve_batched(bst, bb) + (
            kernels.launch_counts(),)
        eng = torch_repeated_engine(an)
        assert eng.schedule == "unrolled" and not eng.use_kernels
        assert max(e[1] for e in eng._edges.edges) == 140
    (bc, xc, ic, _), (bg, xg, ig, counts) = out["cpu"], out["cuda"]
    assert not any(counts.values()), counts
    assert torch.equal(bg.inode_perm.cpu(), bc.inode_perm)
    assert np.array_equal(bg.n_perturb, bc.n_perturb)
    torch.testing.assert_close(bg.vals.cpu(), bc.vals, rtol=1e-10,
                               atol=1e-10)
    assert max(ig["residual"].max(), ic["residual"].max()) < 1e-10
    assert np.abs(xg - xc).max() / np.abs(xc).max() < 1e-10


# K5's wide node step (``node_edges_wide``, a source over 128 rows): k of
# 129, 140, 256 and 300 with col_maps shorter than, as long as and longer
# than k + 128, mixed with narrow sources, into a width-1 node and a node
# of 5 rows
@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("nr", [1, 5])
@pytest.mark.parametrize("m", [60, 128, 200])
@pytest.mark.parametrize("k", [129, 140, 256, 300])
def test_node_edges_wide_sources(k, m, nr, dt, cuda):
    tdt, tol, _ = TOLS[dt]
    rng = np.random.default_rng(k + m + nr)
    sources = [(2, 9), (k, m), (1, 4), (64, 30), (k, m // 2)]
    v0, table, step = _node_buffer(rng, 3, nr, k + m + 30, 7, sources, tdt,
                                   cuda)
    assert step.kmax == k > supsup.WIDE_K
    eps = torch.full((3,), 1e-8, dtype=tdt, device=cuda)
    before = supsup.node_edges_inplace.launches
    _node_step_held(v0, table, step, eps, tol)
    assert supsup.node_edges_inplace.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("nr", [1, 17])
@pytest.mark.parametrize("case", ["nan_in_source", "zero_pivot",
                                  "zero_source_diagonal"])
def test_node_edges_wide_nonfinite(case, nr, dt, cuda):
    """``test_node_edges_nonfinite``'s cases on a 140-row source, placed
    in its second block of the solve (row and column 133): the wide
    instance gives the plain version's NaN and inf positions, infinities
    and finite values."""
    tdt, tol, _ = TOLS[dt]
    rng = np.random.default_rng(nr + len(case))
    sources = [(140, 12), (1, 4), (30, 9), (1, 10)]
    v0, table, step = _node_buffer(rng, 2, nr, 240, 25, sources, tdt, cuda)
    e140, e1, e30 = table.edges[0], table.edges[-1], table.edges[2]
    u133 = e140[0] + 133 * e140[2] + e140[3] + 133          # U[133, 133]
    if case == "nan_in_source":
        v0[0, u133 - 133 * e140[2] + 1] = float("nan")       # U[0, 134]
        v0[1, e1[0] + e1[3] + 5] = float("nan")              # suffix
    elif case == "zero_pivot":
        v0[:, e1[0] + e1[3]] = 0.0                           # k = 1 divisor
        if nr > 1:
            v0[1, u133] = 0.0
        v0[:, step.off + step.lsize] = 0.0                   # target pivot
    else:
        v0[1, u133] = v0[1, u133 + 1] = 0.0
        v0[0, e30[0] + e30[3]] = 0.0                         # U[0, 0] ...
        v0[0, step.off + int(e30[4][0])] = 0.0               # ... of x_0 = 0
    eps = torch.zeros(2, dtype=tdt, device=cuda)
    g, ng = _node_step_held(v0, table, step, eps, tol, nonfinite=True)
    assert not torch.isfinite(g[:, step.off:step.off + step.nr * step.w]
                              ).all()
    assert ng.tolist() == [0, 0]


@pytest.mark.cuda
def test_node_edges_fem2d_10k_keeps_the_narrow_instance(cuda):
    """fem2d_10k's sources have at most 64 rows: one unrolled refactor
    launches the k <= 128 instance once per node step and the wide one
    never."""
    A, eng = _fem2d_10k()
    assert max(st.kmax for _, st in eng._nodes) <= supsup.WIDE_K
    kernels.reset_launch_counts()
    eng.refactor(torch.from_numpy(A.data).to(cuda))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["node_edges_wide"] == 0
    assert counts["node_edges_inplace"] == sum(
        1 for nd in eng.plan.nodes if nd.edges or nd.nr == 1)


@pytest.mark.cuda
@pytest.mark.parametrize("donate", [False, True])
def test_sequence_pipeline_on_card_matches_sequential(donate, cuda,
                                                     monkeypatch):
    """The T-step pipeline on the card (pinned staging, a copy stream,
    with and without donation) against T sequential ``factor_batched`` +
    ``solve_batched`` calls on the card: x within 1e-10, equal counts and
    masks; a caller's device RHS shared by the steps comes out
    unchanged.  Host values go through the pinned buffers; device values
    and right-hand sides never do: without donation the step reads the
    caller's tensor in place, with it a device-to-device copy."""
    from repro_torch.core import batched as batched_mod
    from repro_torch.core import solve_sequence

    A = to_csr(fem2d(12, 12, seed=1))
    rng = np.random.default_rng(12)
    steps = [A.data[None] * rng.uniform(0.8, 1.2, (4, A.nnz))
             for _ in range(3)]
    b = rng.normal(size=(4, A.n))
    b_dev = torch.from_numpy(b).to(cuda)
    opts = HyluOptions(force_mode="supernodal", bulk_min_width=2,
                       donate=donate)
    fills, pinned = [], []
    fill, slot = batched_mod._Staging.fill, batched_mod._Staging._slot

    def spy_fill(self, i, src):
        out = fill(self, i, src)
        fills.append((src, out))
        return out

    def spy_slot(self, bufs, i, shape, pin=False):
        pinned.append(pin)
        return slot(self, bufs, i, shape, pin)

    monkeypatch.setattr(batched_mod._Staging, "fill", spy_fill)
    monkeypatch.setattr(batched_mod._Staging, "_slot", spy_slot)
    xs, info = solve_sequence(A, steps, b_dev, opts)
    assert any(pinned)                       # the host values' staging
    steps_dev = [torch.from_numpy(v).to(cuda) for v in steps]
    fills.clear()
    pinned.clear()
    xs_dev, info_dev = solve_sequence(A, steps_dev, b_dev, opts)
    assert len(fills) == 6 and not any(pinned)
    for src, out in fills:
        assert out.is_cuda
        assert (out.data_ptr() == src.data_ptr()) is (not donate)
    # index_add_ is atomic on CUDA: two runs agree to rounding, not bits
    assert np.abs(xs_dev - xs).max() / np.abs(xs).max() < 1e-10
    assert info_dev["n_refine"] == info["n_refine"]
    an = analyze(A, HyluOptions(force_mode="supernodal", bulk_min_width=2))
    for t in range(3):
        x, it = solve_batched(factor_batched(an, A, steps[t]), b)
        assert np.abs(xs[t] - x).max() / np.abs(x).max() < 1e-10
        assert info["n_refine"][t] == it["n_refine"]
        for key in ("n_refine_per_system", "refine_failed",
                    "refine_stalled", "n_perturb"):
            assert np.array_equal(info[key][t], it[key]), key
    assert torch.equal(b_dev.cpu(), torch.from_numpy(b))
    assert info["donate"] is donate and info["residual"].max() < 1e-10


@pytest.mark.cuda
def test_on_device_resolves_the_current_index(cuda):
    """A tensor made on ``cuda`` reports ``cuda:<current>``: ``on_device``
    holds it on the engine's ``cuda`` and on that index, not on the CPU."""
    from repro_torch.core.torch_engine import on_device

    t = torch.zeros(3, device="cuda")
    idx = torch.cuda.current_device()
    assert t.device.index == idx
    assert on_device(t, torch.device("cuda"))
    assert on_device(t, torch.device("cuda", idx))
    assert not on_device(t, torch.device("cpu"))
    assert not on_device(t.cpu(), torch.device("cuda"))


@pytest.mark.cuda
def test_make_sparse_solve_on_card_matches_cpu(cuda):
    """x, ā and b̄ of the differentiable solve on the card (K1-K4 in its
    forward) against the port on the CPU, 1e-10."""
    from repro_torch.core import make_sparse_solve

    A = to_csr(fem2d(12, 12, seed=1))
    rng = np.random.default_rng(13)
    b, w = rng.normal(size=A.n), rng.normal(size=A.n)
    out = {}
    for dev in ("cpu", "cuda"):
        an = analyze(A, HyluOptions(force_mode="supernodal",
                                    bulk_min_width=2, device=dev))
        a_t = torch.tensor(A.data, requires_grad=True)
        b_t = torch.tensor(b, requires_grad=True)
        kernels.reset_launch_counts()
        x = make_sparse_solve(an)(a_t, b_t)
        (torch.from_numpy(w).to(x.device) * x).sum().backward()
        out[dev] = (x.detach().cpu().numpy(), a_t.grad.numpy(),
                    b_t.grad.numpy(), kernels.launch_counts())
    for got, want in zip(out["cuda"][:3], out["cpu"][:3]):
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-10
    assert out["cuda"][3]["panel_lu_bucket_inplace"] > 0
    assert not any(out["cpu"][3].values())


# ------------------------------------------------------------- bfloat16
# The bfloat16 instances of K1-K5 against their plain versions run in
# bfloat16 on the card, entry by entry.  Pivots and perturbation counts must
# be equal.  The panel LUs round where the plain version does, in its order:
# their finite values must be bit-equal.  The solves, products and node
# steps sum their dots in float32 in another order than the plain version:
# each finite entry within two bf16 ulps of its own magnitude (BF16_ULPS)
# plus bf16's smallest normal, and for a product also the float32 summation
# bound 2 k 2^-24 (|A| |B|) of the two orders.  Operands are diagonally
# dominant, so that one rounding step's difference is not amplified by a
# solve.
BF16_ULPS = 2
BF16_TINY = 2.0 ** -126


def _bf16_ulps_of(r):
    """One bf16 ulp at each entry's magnitude (2^-7 of its binade; the
    subnormal spacing below the smallest normal)."""
    a = r.float().abs().clamp(min=BF16_TINY)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _sum_bound(a, b):
    """The float32 summation bound of a (.., nr, k) @ (.., k, m) product
    summed in two orders: 2 k 2^-24 (|a| |b|)."""
    return (2.0 * a.shape[-1] * 2.0 ** -24
            * torch.matmul(a.float().abs(), b.float().abs()))


def _held_bf16(got, ref, exact=False, bound=None):
    """got and ref (bfloat16, one pair or tuples of pairs): equal NaN and
    inf positions and infinities; finite values bit-equal when ``exact``,
    else each within BF16_ULPS of its own ulp plus BF16_TINY (plus
    ``bound``, broadcast against the first pair, where given); returns the
    largest error in ulps of its entry."""
    pairs = (list(zip(got, ref)) if isinstance(got, tuple)
             else [(got, ref)])
    worst = 0.0
    for i, (g, r) in enumerate(pairs):
        assert g.dtype == r.dtype == torch.bfloat16
        g, r = g.float(), r.float()
        assert torch.equal(torch.isnan(g), torch.isnan(r))
        assert torch.equal(torch.isinf(g), torch.isinf(r))
        assert torch.equal(g[torch.isinf(g)], r[torch.isinf(r)])
        fin = torch.isfinite(r)
        if not fin.any():
            continue
        err = (g - r).abs()
        ulp = _bf16_ulps_of(r)
        if exact:
            assert torch.equal(g[fin], r[fin]), float(err[fin].max())
            continue
        lim = BF16_ULPS * ulp + BF16_TINY
        if bound is not None and i == 0:
            lim = lim + bound
        over = fin & (err > lim)
        assert not over.any(), (int(over.sum()), float(err[over].max()),
                                float(r[over][0]), float(g[over][0]))
        worst = max(worst, float((err[fin] / ulp[fin]).max()))
    return worst


def _bf16_lu_held(got, ref):
    torch.cuda.synchronize()
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    return _held_bf16(got[0], ref[0], exact=True)


def _bf16_bucket_held(vals, lay, eps, counter):
    """K1 in place in bfloat16 against its plain version: one launch,
    equal pivots and counts, no slot outside the members written, the real
    slots held by :func:`_held_bf16`."""
    before = counter.launches
    got, ref = vals.clone(), vals.clone()
    gp, gn = panel.panel_lu_bucket_inplace(got, lay, eps)
    rp, rn = panel.panel_lu_bucket_plain(ref, lay, eps)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert torch.equal(gp, rp) and torch.equal(gn, rn)
    real = torch.zeros(vals.shape[1], dtype=torch.bool, device=vals.device)
    for off, nr, w, _, _ in lay.desc.tolist():
        real[off:off + nr * w] = True
    assert torch.equal(got[:, ~real].view(torch.int16),
                       vals[:, ~real].view(torch.int16))
    _held_bf16(got[:, real], ref[:, real], exact=True)
    return gp


@functools.lru_cache(maxsize=1)
def _fem2d_10k_bf16():
    """fem2d_10k's bucketed and unrolled bfloat16 engines on the card and
    K = 3 value sets (analysed once)."""
    A = to_csr(fem2d(100, 100, seed=930))
    an = analyze(A, HyluOptions(factor_dtype="bfloat16"))
    an_u = analyze(A, HyluOptions(factor_dtype="bfloat16",
                                  factor_schedule="unrolled"), reuse=an)
    vals = A.data[None] * np.random.default_rng(3).uniform(0.8, 1.2,
                                                            (3, A.nnz))
    return (A, torch_repeated_engine(an), torch_repeated_engine(an_u),
            torch.from_numpy(vals).to("cuda"))


@pytest.mark.cuda
def test_bf16_k1_at_fem2d_10k_largest_bucket(cuda):
    """K1 in place on fem2d_10k's largest panel bucket, on the value buffer
    and thresholds the bfloat16 factor program hands it."""
    _, eng, _, a_dev = _fem2d_10k_bf16()
    st, (lay, _) = max(((i, p) for i, s in enumerate(eng._steps)
                        for p in s[1]), key=lambda ip: ip[1][0].gather.numel())
    vals, eps = eng.refactor_batched(a_dev, stop=(st, "panels"))
    assert vals.dtype == eps.dtype == torch.bfloat16
    _bf16_bucket_held(vals, lay, eps, panel.panel_lu_bucket_inplace)


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", range(len(WIDE_BUCKETS)))
def test_bf16_k1_wide_buckets(bucket, cuda):
    """K1's wide path in bfloat16: padded to 256 (window kernel) and 512
    rows (panel_lu_kernel on the gathered panels)."""
    nrp, usp, lsp, members = WIDE_BUCKETS[bucket]
    rng = np.random.default_rng(nrp)
    desc, parts, n = _place(rng, 3, members, 5, 1)
    vals = _bucket_vals(3, n, parts, torch.bfloat16, cuda)
    perm = _bf16_bucket_held(vals, _layout(desc, nrp, usp, lsp, n, cuda),
                             _eps_per_system(3, torch.bfloat16, cuda),
                             panel.panel_lu_bucket_wide)
    assert (perm != torch.arange(nrp, device=cuda)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", range(len(BUCKETS)))
def test_bf16_k1_buckets(bucket, cuda):
    """K1 in place in bfloat16 on every bucket shape of the float tests,
    rows not 4-byte aligned (a gap of one slot)."""
    nrp, usp, lsp, members = BUCKETS[bucket]
    rng = np.random.default_rng(bucket)
    desc, parts, n = _place(rng, 4, members, 3, 1)
    vals = _bucket_vals(4, n, parts, torch.bfloat16, cuda)
    _bf16_bucket_held(vals, _layout(desc, nrp, usp, lsp, n, cuda),
                      _eps_per_system(4, torch.bfloat16, cuda),
                      panel.panel_lu_bucket_inplace)


@pytest.mark.cuda
@pytest.mark.parametrize("nr,lsize,us,counter",
                         [(128, 2197, 22, "panel_lu"), (8, 2197, 0,
                                                        "panel_lu"),
                          (40, 3, 17, "panel_lu"), (150, 40, 10,
                                                    "panel_lu_wide"),
                          (300, 12, 20, "panel_lu_wide")])
def test_bf16_k2(nr, lsize, us, counter, cuda):
    """K2 in bfloat16: fem2d_10k's largest narrow node shape (128 x 2,347),
    a lone pivot warp, the wide path at 150 (window kernel) and 300 rows
    (panel_lu_kernel), rows shuffled so that pivoting moves them, and a
    strided view of every other panel."""
    rng = np.random.default_rng(nr + lsize)
    P = torch.tensor(_node_panels(rng, 6, nr, lsize, us, dominant=True),
                     dtype=torch.bfloat16, device=cuda)[::2]
    eps = torch.full((3,), 1e-8, dtype=torch.bfloat16, device=cuda)
    fn = getattr(panel, counter)
    before = fn.launches
    got = panel.panel_lu(P, nr, lsize, eps)
    ref = panel.panel_lu_plain(P, lsize, P.shape[2], eps)
    _bf16_lu_held(got, ref)
    assert fn.launches == before + 1
    assert (got[1] != torch.arange(nr, device=cuda)).any()


@pytest.mark.cuda
def test_bf16_k2_at_fem2d_10k_largest_narrow_node(cuda):
    """K2 on fem2d_10k's largest narrow-level node, on the value buffer the
    bucketed bfloat16 program hands it (a strided view)."""
    _, eng, _, a_dev = _fem2d_10k_bf16()
    st, (nr, w, lsize, off, _) = max(
        ((i, q) for i, s in enumerate(eng._steps) for q in s[2]),
        key=lambda iq: iq[1][0] * iq[1][1])
    vals, eps = eng.refactor_batched(a_dev, stop=(st, "seq"))
    P = vals[:, off:off + nr * w].view(-1, nr, w)
    _bf16_lu_held(panel.panel_lu(P, nr, lsize, eps),
                  panel.panel_lu_plain(P, lsize, w, eps))


def _bf16_tensor(a, dev):
    return torch.tensor(a, dtype=torch.bfloat16, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 33, 100, 128, 150, 256])
def test_bf16_k3(k, cuda, monkeypatch):
    """K3's three entries in bfloat16: the right solve on a strided view of
    source rows (nr 70 and 1), both left solves at one and 17 right-hand
    sides; each call one launch of its bfloat16 kernel (k = 150 and 256:
    the wide one, ``hylu_trsm_*_wide_bf16``), within BF16_ULPS of each
    entry of the plain version and bit-equal to it summed in the kernels'
    order (``ref.*_bf16_ordered``)."""
    names = _launch_spy(monkeypatch)
    wide = "_wide" if k > tri.BLOCK_K else ""
    rng = np.random.default_rng(k)
    blk = _wide_block(rng, 3, k)
    S = np.concatenate([blk, rng.normal(size=(3, k, 9))], axis=2)
    S = _bf16_tensor(S, cuda)
    U = S[..., :k]                                 # rows k + 9 apart

    def one_launch(name, call):
        del names[:]
        got = call()
        assert names == [f"hylu_{name}{wide}_bf16"], names
        return got

    def held(got, plain, ordered):
        _held_bf16(got, plain)
        assert torch.equal(got, ordered)

    for nr in (70, 1):
        x = _bf16_tensor(rng.normal(size=(3, nr, k)), cuda)
        held(one_launch("trsm_right", lambda: tri.trsm_batched(U, x)),
             tri.trsm_plain(U, x), tri_ref.trsm_bf16_ordered(U, x))
    B = _bf16_tensor(blk, cuda)
    for m in (1, 17):
        b = _bf16_tensor(rng.normal(size=(3, k, m)), cuda)
        held(one_launch("trsm_left_unit_lower",
                        lambda: tri.trsm_left_unit_lower_batched(B, b)),
             tri.trsm_left_unit_lower_plain(B, b),
             tri_ref.trsm_left_unit_lower_bf16_ordered(B, b))
        held(one_launch("trsm_left_upper",
                        lambda: tri.trsm_left_upper_batched(B, b)),
             tri.trsm_left_upper_plain(B, b),
             tri_ref.trsm_left_upper_bf16_ordered(B, b))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_bf16_k3_quotients_and_infinities(cuda):
    """At k = 1 the bfloat16 solves are one rounded float32 division per
    entry, bit for bit torch's; an infinite entry of X or b gives the plain
    version's NaN and inf positions."""
    rng = np.random.default_rng(9)
    X = _bf16_tensor(rng.normal(size=(64, 500, 1))
                     * 2.0 ** rng.integers(-60, 60, size=(64, 500, 1)), cuda)
    U = _bf16_tensor(rng.normal(size=(64, 1, 1)), cuda)
    assert torch.equal(tri.trsm_batched(U, X), X / U)
    b = X[:, :1].contiguous()
    assert torch.equal(tri.trsm_left_upper_batched(U, b), b / U)
    u = _bf16_tensor(_wide_block(rng, 2, 40), cuda)
    x = _bf16_tensor(rng.normal(size=(2, 33, 40)), cuda)
    x[0, 3, 5], x[1, 7, 0] = float("inf"), -float("inf")
    bb = _bf16_tensor(rng.normal(size=(2, 40, 3)), cuda)
    bb[0, 30, 1], bb[1, 39, 0] = float("inf"), -float("inf")
    for got, ref in ((tri.trsm_batched(u, x), tri.trsm_plain(u, x)),
                     (tri.trsm_left_upper_batched(u, bb),
                      tri.trsm_left_upper_plain(u, bb))):
        torch.cuda.synchronize()
        assert torch.isinf(ref).any()
        _held_bf16(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("e,nr,k,m", [(64, 128, 64, 104), (5, 40, 24, 50),
                                      (7, 33, 13, 5), (3, 1, 1, 1),
                                      (2048, 32, 16, 40)])
def test_bf16_k4(e, nr, k, m, cuda):
    """K4 in bfloat16 (tensor cores, float32 sums): fem2d_10k's 64-product
    bucket shape, rows that are not 16-byte aligned (plain loads), ragged
    tiles and many products."""
    rng = np.random.default_rng(e + nr)
    a = _bf16_tensor(rng.normal(size=(e, nr, k)), cuda)
    b = _bf16_tensor(rng.normal(size=(e, k, m)), cuda)
    before = supsup.gemm_batched.launches
    _held_bf16(supsup.gemm_batched(a, b), supsup.gemm_batched_plain(a, b),
               bound=_sum_bound(a, b))
    assert supsup.gemm_batched.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 128, 128, 100), (2, 70, 17, 65),
                                   (1, 1, 200, 3)])
def test_bf16_k5_gemm_update(shape, cuda):
    """K5's GEMM update in bfloat16 (C - A.B summed in float32 and rounded
    once), out of place through its wrapper, and through its entry point
    in place on a strided view (OUT = C, rows m + 3 apart: the kernel's
    interface for views, which no path of the system uses any more)."""
    from repro_torch.kernels import _build

    e, nr, k, m = shape
    rng = np.random.default_rng(nr + k)
    wide = _bf16_tensor(rng.normal(size=(e, nr, m + 3)), cuda)
    c = wide[..., :m].contiguous()
    a = _bf16_tensor(rng.normal(size=(e, nr, k)) / np.sqrt(k), cuda)
    b = _bf16_tensor(rng.normal(size=(e, k, m)), cuda)
    ref = supsup.gemm_update_plain(c, a, b)
    bound = _sum_bound(a, b)
    _held_bf16(supsup.gemm_update(c, a, b), ref, bound=bound)
    cv = wide[..., :m]
    sc, sa, sb = (_build.row_strides("gemm_update", t) for t in (cv, a, b))
    _build.launch("hylu_gemm_update_bf16", _build.ptr(cv), *sc,
                  _build.ptr(a), *sa, _build.ptr(b), *sb, _build.ptr(cv),
                  *sc, e, nr, k, m, _build.stream_of(cv))
    torch.cuda.synchronize()
    _held_bf16(cv, ref, bound=bound)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(NODES))
def test_bf16_node_edges_shapes(case, cuda):
    """K5's node step in bfloat16 on the float tests' synthetic nodes (a
    width-1 node perturbs its pivot in the last system)."""
    nr, w, lsize, sources = NODES[case]
    rng = np.random.default_rng(len(case) * 7)
    v0, table, step = _node_buffer(rng, 3, nr, w, lsize, sources,
                                   torch.bfloat16, cuda)
    eps = torch.full((3,), 1e-8, dtype=torch.bfloat16, device=cuda)
    eps[-1] = 1e6 if nr == 1 else 1e-8
    _bf16_node_held(v0, table, step, eps)


def _bf16_node_held(v0, table, step, eps):
    """The bfloat16 node step against its plain version on copies of v0:
    one launch of the right instance, equal counts, no slot outside the
    node written, the panel held by :func:`_held_bf16`."""
    K = v0.shape[0]
    g, r = v0.clone(), v0.clone()
    ng = torch.zeros(K, dtype=torch.int32, device=v0.device)
    nr_ = torch.zeros_like(ng)
    counter = (supsup.node_edges_wide if step.kmax > supsup.WIDE_K
               else supsup.node_edges_inplace)
    before = counter.launches
    supsup.node_edges_inplace(g, table, step, eps, ng)
    supsup.node_edges_plain(r, table, step, eps, nr_)
    torch.cuda.synchronize()
    assert counter.launches == before + (step.e1 > step.e0 or step.nr == 1)
    assert torch.equal(ng, nr_)
    lo, hi = step.off, step.off + step.nr * step.w
    for a, b in ((g[:, :lo], v0[:, :lo]), (g[:, hi:], v0[:, hi:])):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    return _held_bf16(g[:, lo:hi], r[:, lo:hi])


@pytest.mark.cuda
def test_bf16_node_edges_at_fem2d_10k_largest_node(cuda):
    """fem2d_10k's node with the most edge work (node 7,665: 128 rows,
    1,085 edges) on the buffer the unrolled bfloat16 program hands it."""
    _, _, eng, a_dev = _fem2d_10k_bf16()
    plan = eng.plan
    work = [sum(nd.nr * plan.nodes[e.src].nr * len(e.col_map)
                for e in nd.edges) for nd in plan.nodes]
    t = int(np.argmax(work))
    v0, eps = eng.refactor_batched(a_dev, stop=(t, 0))
    _bf16_node_held(v0, eng._edges, eng._nodes[t][1], eps)


@pytest.mark.cuda
def test_bf16_node_edges_wide_node_of_the_140_row_plan(cuda):
    """The wide instance in bfloat16 at the node of pardiso_like's 140-row
    plan whose edge source has 140 rows, on the buffer its unrolled
    program hands it, and on a synthetic node fed by a 150-row source."""
    from repro_torch.core import baselines

    A = to_csr(_card_wide_source())
    an = analyze(A, baselines.pardiso_like_options(
        orderings=("natural",), bulk_min_width=2, factor_dtype="bfloat16",
        factor_schedule="unrolled"))
    eng = torch_repeated_engine(an)
    t = next(i for i, (_, s) in enumerate(eng._nodes)
             if s.kmax > supsup.WIDE_K)
    vals = A.data[None] * np.random.default_rng(2).uniform(0.8, 1.2,
                                                            (2, A.nnz))
    v0, eps = eng.refactor_batched(torch.from_numpy(vals).to(cuda),
                                   stop=(t, 0))
    _bf16_node_held(v0, eng._edges, eng._nodes[t][1], eps)
    rng = np.random.default_rng(11)
    v1, tab, stp = _node_buffer(rng, 3, 9, 260, 30,
                                [(1, 5), (150, 90), (7, 20)],
                                torch.bfloat16, cuda)
    _bf16_node_held(v1, tab, stp, torch.full((3,), 1e-8,
                                             dtype=torch.bfloat16,
                                             device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("case", ["zero_pivot", "nan_in_u", "inf_in_l",
                                  "nan_in_block", "zero_pivot_global"])
def test_bf16_panel_lu_nonfinite_steps(case, bucketed, cuda):
    """test_panel_lu_nonfinite_steps in bfloat16: the plain version's
    pivots, counts, NaN and inf positions and finite values."""
    rng = np.random.default_rng(4)
    if case == "zero_pivot_global":
        p = rng.normal(size=(2, 128, 300))
        p[:, :, 100] = 0.0
        nr, c0, eps = 128, 100, 0.0
    else:
        p = rng.normal(size=(2, 5, 12))
        nr, c0, eps = 5, 3, 1e-8
        if case == "zero_pivot":
            p[:, :, 3] = 0.0
            eps = 0.0
        else:
            row, col, v = {"nan_in_u": (1, 9, np.nan),
                           "inf_in_l": (4, 1, np.inf),
                           "nan_in_block": (2, 5, np.nan)}[case]
            p[:, row, col] = v
    w = p.shape[2]
    if bucketed:
        p = np.concatenate([p[:, :, c0:], p[:, :, :c0]], axis=2)
    P = _bf16_tensor(p, cuda)
    e = torch.full((2,), eps, dtype=torch.bfloat16, device=cuda)
    if bucketed:
        got = panel.panel_lu_batched(P, w - c0, e)
        ref = panel.panel_lu_plain(P, 0, w - c0, e)
    else:
        got = panel.panel_lu(P, nr, c0, e)
        ref = panel.panel_lu_plain(P, c0, w, e)
    assert not torch.isfinite(ref[0]).all()
    _bf16_lu_held(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zero_pivot", "nan_pivot_row"])
def test_bf16_bucket_panel_lu_nonfinite(case, cuda):
    """K1 in place in bfloat16 with a zero pivot column under eps = 0 or a
    NaN in a pivot row: the plain version's positions and values."""
    rng = np.random.default_rng(8)
    desc, parts, n = _place(rng, 2, [(5, 20, 28), (8, 24, 32)], 3, 1)
    vals = _bucket_vals(2, n, parts, torch.bfloat16, cuda)
    off, nr, w, ls, _ = desc[1]
    if case == "zero_pivot":
        vals[:, off + ls:off + nr * w:w] = 0.0
        eps = torch.zeros(2, dtype=torch.bfloat16, device=cuda)
    else:
        vals[0, off + 2 * w + ls + 5] = float("nan")
        eps = torch.full((2,), 1e-8, dtype=torch.bfloat16, device=cuda)
    _bf16_bucket_held(vals, _layout(desc, 8, 24, 32, n, cuda), eps,
                      panel.panel_lu_bucket_inplace)


@pytest.mark.cuda
@pytest.mark.parametrize("nr", [1, 17])
@pytest.mark.parametrize("case", ["nan_in_source", "zero_pivot",
                                  "zero_source_diagonal"])
def test_bf16_node_edges_nonfinite(case, nr, cuda):
    """test_node_edges_nonfinite in bfloat16."""
    rng = np.random.default_rng(nr + len(case))
    sources = [(6, 12), (1, 4), (30, 9), (1, 10)]
    v0, table, step = _node_buffer(rng, 2, nr, 70, 25, sources,
                                   torch.bfloat16, cuda)
    e6, e1, e30 = table.edges[0], table.edges[-1], table.edges[2]
    if case == "nan_in_source":
        v0[0, e6[0] + 2 * e6[2] + e6[3] + 4] = float("nan")
        v0[1, e1[0] + e1[3] + 5] = float("nan")
    elif case == "zero_pivot":
        v0[:, e1[0] + e1[3]] = 0.0
        if nr > 1:
            v0[1, e6[0] + 3 * e6[2] + e6[3] + 3] = 0.0
        v0[:, step.off + step.lsize] = 0.0
    else:
        u33 = e6[0] + 3 * e6[2] + e6[3] + 3
        v0[1, u33] = v0[1, u33 + 1] = 0.0
        v0[0, e30[0] + e30[3]] = 0.0
        v0[0, step.off + int(e30[4][0])] = 0.0
    eps = torch.zeros(2, dtype=torch.bfloat16, device=cuda)
    _bf16_node_held(v0, table, step, eps)
    g = v0.clone()
    supsup.node_edges_inplace(g, table, step, eps,
                              torch.zeros(2, dtype=torch.int32, device=cuda))
    assert not torch.isfinite(g[:, step.off:step.off + step.nr * step.w]
                              ).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 300])
@pytest.mark.parametrize("nr,lsize,nan_in_u", [(8, 2197, False),
                                               (128, 300, False),
                                               (24, 262, True),
                                               (32, 2197, True)])
def test_bf16_node_panel_lu_nonfinite_prefix(nr, lsize, nan_in_u, b, cuda):
    """test_node_panel_lu_nonfinite_multiplier_poisons_prefix and
    test_node_panel_lu_nonfinite_with_nan_in_u in bfloat16: two
    infinities in the first block column poison the prefix of every row
    after the pivot, a NaN in the U suffix its column above; the plain
    version's positions and values, more panels than SMs too."""
    rng = np.random.default_rng(nr * b + lsize)
    p = _node_panels(rng, b, nr, lsize, 9, dominant=True)
    p[:, 2, lsize] = np.inf
    p[:, nr - 1, lsize] = np.inf
    if nan_in_u:
        p[:, 5, lsize + nr + 3] = np.nan
    P = _bf16_tensor(p, cuda)
    eps = torch.full((b,), 1e-8, dtype=torch.bfloat16, device=cuda)
    got = panel.panel_lu(P, nr, lsize, eps)
    ref = panel.panel_lu_plain(P, lsize, P.shape[2], eps)
    assert torch.isnan(ref[0][:, 1:, :lsize]).all()
    _bf16_lu_held(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("nr", [1, 17])
@pytest.mark.parametrize("case", ["nan_in_source", "zero_pivot",
                                  "zero_source_diagonal"])
def test_bf16_node_edges_wide_nonfinite(case, nr, cuda):
    """test_node_edges_wide_nonfinite in bfloat16: the wide instance on a
    140-row source with the fault in its second block."""
    rng = np.random.default_rng(nr + len(case))
    sources = [(140, 12), (1, 4), (30, 9), (1, 10)]
    v0, table, step = _node_buffer(rng, 2, nr, 240, 25, sources,
                                   torch.bfloat16, cuda)
    e140, e1, e30 = table.edges[0], table.edges[-1], table.edges[2]
    u133 = e140[0] + 133 * e140[2] + e140[3] + 133
    if case == "nan_in_source":
        v0[0, u133 - 133 * e140[2] + 1] = float("nan")
        v0[1, e1[0] + e1[3] + 5] = float("nan")
    elif case == "zero_pivot":
        v0[:, e1[0] + e1[3]] = 0.0
        if nr > 1:
            v0[1, u133] = 0.0
        v0[:, step.off + step.lsize] = 0.0
    else:
        v0[1, u133] = v0[1, u133 + 1] = 0.0
        v0[0, e30[0] + e30[3]] = 0.0
        v0[0, step.off + int(e30[4][0])] = 0.0
    _bf16_node_held(v0, table, step,
                    torch.zeros(2, dtype=torch.bfloat16, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["bucketed", "unrolled"])
def test_bf16_engine_on_card_matches_cpu(schedule, cuda):
    """factor_batched + solve_batched with bfloat16 factors on fem2d(12, 12)
    on the card against the CPU: equal pivots and counts, the factors held
    entry by entry (:func:`_held_bf16`), every system takes the float64
    fallback in both, and x agrees to 1e-10; the bfloat16 kernels were
    launched."""
    A = to_csr(fem2d(12, 12, seed=1))
    rng = np.random.default_rng(5)
    vb = A.data[None] * rng.uniform(0.8, 1.2, (4, A.nnz))
    bb = rng.normal(size=(4, A.n))
    out = {}
    for dev in ("cpu", "cuda"):
        an = analyze(A, HyluOptions(force_mode="supernodal",
                                    bulk_min_width=2, device=dev,
                                    factor_dtype="bfloat16",
                                    factor_schedule=schedule))
        kernels.reset_launch_counts()
        bst = factor_batched(an, A, vb)
        x, info = solve_batched(bst, bb)
        out[dev] = (bst, x, info, kernels.launch_counts())
    (bc, xc, ic, _), (bg, xg, ig, counts) = out["cpu"], out["cuda"]
    assert bg.vals.dtype == torch.bfloat16
    assert np.array_equal(bg.n_perturb, bc.n_perturb)
    assert torch.equal(bg.inode_perm.cpu(), bc.inode_perm)
    _held_bf16(bg.vals.cpu(), bc.vals)
    assert np.array_equal(ig["fallback_mask"], ic["fallback_mask"])
    assert not ig["refine_failed"].any()
    assert np.abs(xg - xc).max() / np.abs(xc).max() < 1e-10
    path = (("node_edges_inplace",) if schedule == "unrolled"
            else BATCHED_PATH)
    assert all(counts[w] > 0 for w in path), counts


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["bucketed", "unrolled"])
def test_bf16_plain_route_on_card_matches_cpu(schedule, cuda):
    """bfloat16 factors with ``use_kernels=False`` on the card, where
    ``torch.linalg.solve_triangular`` takes no bfloat16 (the sup-sup edges
    take ``trsm_plain``): factor_batched + solve_batched on fem2d(12, 12)
    against the same route on the CPU: equal pivots and counts, each
    factor entry within two bf16 ulps of its own (:func:`_held_bf16`),
    equal fallback masks, x within 1e-10, no kernel launched."""
    A = to_csr(fem2d(12, 12, seed=1))
    rng = np.random.default_rng(5)
    vb = A.data[None] * rng.uniform(0.8, 1.2, (4, A.nnz))
    bb = rng.normal(size=(4, A.n))
    out = {}
    kernels.reset_launch_counts()
    for dev in ("cpu", "cuda"):
        an = analyze(A, HyluOptions(force_mode="supernodal",
                                    bulk_min_width=2, device=dev,
                                    factor_dtype="bfloat16",
                                    factor_schedule=schedule,
                                    use_kernels=False))
        bst = factor_batched(an, A, vb)
        out[dev] = (bst,) + solve_batched(bst, bb)
    assert not any(kernels.launch_counts().values())
    (bc, xc, ic), (bg, xg, ig) = out["cpu"], out["cuda"]
    assert bg.vals.dtype == torch.bfloat16
    assert np.array_equal(bg.n_perturb, bc.n_perturb)
    assert torch.equal(bg.inode_perm.cpu(), bc.inode_perm)
    _held_bf16(bg.vals.cpu(), bc.vals)
    assert np.array_equal(ig["fallback_mask"], ic["fallback_mask"])
    assert not ig["refine_failed"].any()
    assert np.abs(xg - xc).max() / np.abs(xc).max() < 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("kernels_on", [True, False])
def test_bf16_one_system_apply_is_deterministic_on_card(kernels_on, cuda):
    """The one-system bfloat16 ``apply`` (level-scheduled; its row
    scatters in ordered passes of unique rows) on one factor of the card:
    two runs bit-identical, and bit-equal to the CPU's apply on the same
    factor; the batched level-scheduled apply (``use_kernels=False``) too."""
    A = to_csr(fem2d(12, 12, seed=1))
    opts = HyluOptions(force_mode="supernodal", bulk_min_width=2,
                       factor_dtype="bfloat16", use_kernels=kernels_on)
    an = analyze(A, opts)
    eng = torch_repeated_engine(an)
    eng_c = torch_repeated_engine(an, device="cpu")
    rng = np.random.default_rng(3)
    f = eng.refactor(torch.from_numpy(A.data).to(cuda))
    b = torch.from_numpy(rng.normal(size=(3, A.n)))
    xs = [eng.apply(f.vals, f.inode_perm, b[0].to(cuda)).cpu()
          for _ in range(2)]
    x_c = eng_c.apply(f.vals.cpu(), f.inode_perm.cpu(), b[0])
    bits = [x.view(torch.int16) for x in xs + [x_c]]
    assert torch.equal(bits[0], bits[1]) and torch.equal(bits[0], bits[2])
    if not kernels_on:
        vals = f.vals[None].expand(3, -1)
        inode = f.inode_perm[None].expand(3, -1)
        xb = eng.apply_batched(vals, inode, b.to(cuda)).cpu()
        xb_c = eng_c.apply_batched(vals.cpu(), inode.cpu(), b)
        assert torch.equal(xb.view(torch.int16), xb_c.view(torch.int16))


# ------------------------------------------------------------------ mesh
@pytest.mark.cuda
def test_mesh_on_card_matches_unsplit(cuda):
    """The split of K on one card: mesh=["cuda:0", "cuda:0"] and mesh=1
    against the unsplit run at K = 5 (the second shard padded): x and the
    residuals within 1e-10, equal pivots, perturbation counts and
    refinement counts; one engine serves both shards; the donating
    pipeline under the split against the unsplit pipeline."""
    from repro_torch.core import solve_sequence

    A = to_csr(fem2d(12, 12, seed=1))
    rng = np.random.default_rng(21)
    vb = A.data[None] * rng.uniform(0.8, 1.2, (5, A.nnz))
    bb = rng.normal(size=(5, A.n))
    kw = dict(force_mode="supernodal", bulk_min_width=2)
    an0 = analyze(A, HyluOptions(**kw))
    bst0 = factor_batched(an0, A, vb)
    x0, i0 = solve_batched(bst0, bb)
    for mesh in (["cuda:0", "cuda:0"], 1):
        an = analyze(A, HyluOptions(mesh=mesh, **kw), reuse=an0)
        kernels.reset_launch_counts()
        bst = factor_batched(an, A, vb)
        x, info = solve_batched(bst, bb)
        assert len(bst.shards) == (2 if isinstance(mesh, list) else 1)
        assert all(p.vals.is_cuda for p in bst.shards)
        assert kernels.launch_counts()["panel_lu_bucket_inplace"] > 0
        assert torch.equal(bst.inode_perm, bst0.inode_perm)
        assert np.array_equal(bst.n_perturb, bst0.n_perturb)
        assert np.abs(x - x0).max() / np.abs(x0).max() < 1e-10
        np.testing.assert_allclose(info["residual"], i0["residual"],
                                   rtol=0, atol=1e-10)
        assert np.array_equal(info["n_refine_per_system"],
                              i0["n_refine_per_system"])
        assert len(an.engine_cache) == 1
    steps = [A.data[None] * rng.uniform(0.8, 1.2, (5, A.nnz))
             for _ in range(3)]
    xs, _ = solve_sequence(A, steps, bb, HyluOptions(
        mesh=["cuda:0", "cuda:0"], donate=True, **kw))
    xs0, _ = solve_sequence(A, steps, bb, HyluOptions(**kw))
    assert np.abs(xs - xs0).max() / np.abs(xs0).max() < 1e-10
