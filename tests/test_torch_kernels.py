"""Each kernel wrapper of the port against the JAX package's wrapper.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode, as ``tests/test_kernels.py``
does.  Inputs come from numpy seeds and go to both.  Tolerances are those
of ``tests/test_kernels.py``: 1e-10 in float64 (the two sides sum in
another order), 1e-4 in float32 and 1e-3 for the float32 left solves
(their error grows with k through the substitution).  Pivot permutations
and perturbation counts must match exactly.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.panel import ops as jpanel  # noqa: E402
from repro.kernels.suprow import ops as jsuprow  # noqa: E402
from repro.kernels.supsup import ops as jsupsup  # noqa: E402
from repro.kernels.trisolve import ops as jtri  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.panel import ops as panel  # noqa: E402
from repro_torch.kernels.suprow import ops as suprow  # noqa: E402
from repro_torch.kernels.supsup import ops as supsup  # noqa: E402
from repro_torch.kernels.trisolve import ops as tri  # noqa: E402

DTYPES = {"float64": (jnp.float64, torch.float64, 1e-10, 1e-10),
          "float32": (jnp.float32, torch.float32, 1e-4, 1e-3)}
TRISOLVE_SHAPES = [(1, 3), (5, 8), (17, 13), (40, 32), (3, 1)]
LEFT_SHAPES = [(1, 5, 1), (4, 13, 3), (3, 8, 6), (2, 2, 1)]
SUPSUP_SHAPES = [(5, 3, 7), (16, 8, 40), (33, 13, 5), (2, 1, 3), (8, 8, 128)]
# nr, k, m: not multiples of 8 (the JAX wrapper pads them), m >= 128 (it
# pads m to a multiple of 128), and k = nr = 128, m = 100 (the largest
# sup-sup edge of fem2d_10k's unrolled schedule)
UPDATE_SHAPES = [(5, 3, 7), (13, 9, 130), (1, 17, 5), (40, 33, 200),
                 (128, 128, 100)]
SUPROW_SHAPES = [(3, 7), (9, 130), (17, 1), (33, 0), (128, 300)]
PANEL_SHAPES = [(4, 2, 3), (16, 5, 9), (1, 0, 4), (8, 0, 0), (32, 7, 40)]
BUCKET_SHAPES = [(3, 4, 12, 9), (2, 16, 40, 30), (4, 8, 8, 8), (2, 1, 5, 3)]


def _close(got, ref, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol,
                               rtol=tol)


def _tri(rng, b, k):
    return np.triu(rng.normal(size=(b, k, k))) + 3 * np.eye(k)


def _src_block(rng, b, k):
    """A source supernode's diagonal block: U's strict upper part scaled by
    1/sqrt(k) (a random 128-wide triangle with O(1) entries amplifies
    float32 rounding far past 1e-4 in any summation order), garbage below
    the diagonal that no solve may read."""
    u = np.triu(rng.normal(size=(b, k, k)), 1) / np.sqrt(k) + 3 * np.eye(k)
    return u + np.tril(rng.normal(size=(b, k, k)), -1)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("b,nr,wt,wu", BUCKET_SHAPES)
def test_panel_lu_batched(b, nr, wt, wu, dt):
    jdt, tdt, tol, _ = DTYPES[dt]
    p = np.random.default_rng(nr * 100 + wt).normal(size=(b, nr, wt))
    out, perm, nper = panel.panel_lu_batched(torch.tensor(p, dtype=tdt), wu,
                                             1e-10)
    jo, jp, jn = jpanel.panel_lu_batched(jnp.asarray(p, jdt), wu, 1e-10)
    _close(out, jo, tol)
    assert np.array_equal(perm.numpy(), np.asarray(jp))
    assert np.array_equal(nper.numpy(), np.asarray(jn))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("nr,ls,us", PANEL_SHAPES)
def test_panel_lu(nr, ls, us, dt):
    jdt, tdt, tol, _ = DTYPES[dt]
    p = np.random.default_rng(nr * 10 + ls).normal(size=(nr, ls + nr + us))
    out, perm, nper = panel.panel_lu(torch.tensor(p, dtype=tdt), nr, ls,
                                     1e-10)
    jo, jp, jn = jpanel.panel_lu(jnp.asarray(p, jdt), nr, ls, 1e-10)
    _close(out, jo, tol)
    assert np.array_equal(perm.numpy(), np.asarray(jp))
    assert int(nper) == int(jn)


def test_panel_lu_per_panel_eps():
    """One threshold per panel (the batched engine's per-system eps): each
    batch member equals the JAX kernel run alone with its own eps."""
    rng = np.random.default_rng(3)
    p = rng.normal(size=(3, 6, 14))
    p[:, :, :6] *= 0.05                  # block entries near the threshold
    eps = np.array([1e-10, 0.08, 1e-10])
    out, perm, nper = panel.panel_lu(torch.tensor(p), 6, 0,
                                     torch.tensor(eps))
    for i in range(3):
        jo, jp, jn = jpanel.panel_lu(jnp.asarray(p[i]), 6, 0, eps[i])
        _close(out[i], jo, 1e-10)
        assert np.array_equal(perm[i].numpy(), np.asarray(jp))
        assert int(nper[i]) == int(jn)
    assert int(nper[1]) > 0 and int(nper[0]) == 0


def test_panel_lu_zero_pivot_counts():
    """tests/test_kernels.py's tiny-pivot panel: three pivots perturbed, in
    both wrappers, counts and permutations exact."""
    p = np.zeros((4, 6))
    p[:, 1:5] = np.eye(4) * 1e-30
    p[0, 1] = 2.0
    out, perm, nper = panel.panel_lu(torch.tensor(p), 4, 1, 1e-8)
    jo, jp, jn = jpanel.panel_lu(jnp.asarray(p), 4, 1, 1e-8)
    assert int(nper) == int(jn) == 3
    assert np.array_equal(perm.numpy(), np.asarray(jp))
    _close(out, jo, 1e-10)
    # the same panel column-reordered as a bucket member [block | U | L]
    pb = np.concatenate([p[:, 1:5], p[:, 5:], p[:, :1]], axis=1)[None]
    out, perm, nper = panel.panel_lu_batched(torch.tensor(pb), 5, 1e-8)
    jo, jp, jn = jpanel.panel_lu_batched(jnp.asarray(pb), 5, 1e-8)
    assert int(nper[0]) == int(jn[0]) == 3
    assert np.array_equal(perm.numpy(), np.asarray(jp))
    _close(out, jo, 1e-10)


def test_panel_lu_pivot_ties():
    """Equal-magnitude pivot candidates: the first (lowest) row wins, as
    jnp.argmax picks it; the permutations must match exactly."""
    p = np.array([[0.5, 1.0, 2.0, 0.0, 1.0],
                  [-2.0, 1.0, 0.0, 3.0, 1.0],
                  [1.0, 2.0, 1.0, 1.0, 1.0],
                  [2.0, 1.0, 4.0, 3.0, 1.0]])
    out, perm, nper = panel.panel_lu_batched(torch.tensor(p[None]), 4, 0.0)
    jo, jp, jn = jpanel.panel_lu_batched(jnp.asarray(p[None]), 4, 0.0)
    assert perm[0, 0] == 1                       # rows 1 and 3 tie at |2|
    assert np.array_equal(perm.numpy(), np.asarray(jp))
    assert np.array_equal(nper.numpy(), np.asarray(jn))
    _close(out, jo, 1e-12)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("nr,k", TRISOLVE_SHAPES)
def test_trsm_batched(nr, k, dt):
    jdt, tdt, tol, _ = DTYPES[dt]
    rng = np.random.default_rng(nr * 7 + k)
    # the lower triangle holds garbage: only U's upper triangle is read
    u = _tri(rng, 3, k) + np.tril(rng.normal(size=(3, k, k)), -1)
    x = rng.normal(size=(3, nr, k))
    for unit in (False, True):
        y = tri.trsm_batched(torch.tensor(u, dtype=tdt),
                             torch.tensor(x, dtype=tdt), unit_diag=unit)
        jy = jtri.trsm_batched(jnp.asarray(u, jdt), jnp.asarray(x, jdt),
                               unit_diag=unit)
        _close(y, jy, tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("kb,k,m", LEFT_SHAPES)
def test_trsm_left_solves(kb, k, m, dt):
    jdt, tdt, _, tol = DTYPES[dt]
    rng = np.random.default_rng(kb * 31 + k)
    blk = _tri(rng, kb, k) + np.tril(rng.normal(size=(kb, k, k)), -1)
    b = rng.normal(size=(kb, k, m))
    tb, tr = torch.tensor(blk, dtype=tdt), torch.tensor(b, dtype=tdt)
    jb, jr = jnp.asarray(blk, jdt), jnp.asarray(b, jdt)
    _close(tri.trsm_left_unit_lower_batched(tb, tr),
           jtri.trsm_left_unit_lower_batched(jb, jr), tol)
    _close(tri.trsm_left_upper_batched(tb, tr),
           jtri.trsm_left_upper_batched(jb, jr), tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("nr,k,m", SUPSUP_SHAPES)
def test_gemm_batched(nr, k, m, dt):
    jdt, tdt, tol, _ = DTYPES[dt]
    rng = np.random.default_rng(nr + 3 * k + 5 * m)
    a, b = rng.normal(size=(3, nr, k)), rng.normal(size=(3, k, m))
    _close(supsup.gemm_batched(torch.tensor(a, dtype=tdt),
                               torch.tensor(b, dtype=tdt)),
           jsupsup.gemm_batched(jnp.asarray(a, jdt), jnp.asarray(b, jdt)),
           tol)


def test_gemm_batched_empty_product_launches_nothing():
    kernels.reset_launch_counts()
    out = supsup.gemm_batched(torch.zeros(2, 3, 4), torch.zeros(2, 4, 0))
    assert out.shape == (2, 3, 0)
    assert kernels.launch_counts()["gemm_batched"] == 0


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        panel.panel_lu_batched(torch.zeros(2, 4, 6), 3, 1e-8)   # wu < nr
    with pytest.raises(ValueError):
        tri.trsm_batched(torch.zeros(2, 3, 3), torch.zeros(2, 5, 4))
    with pytest.raises(ValueError):
        supsup.gemm_batched(torch.zeros(2, 3, 4), torch.zeros(2, 5, 4))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("nr,k,m", UPDATE_SHAPES)
def test_gemm_update(nr, k, m, dt):
    """K5's plain version against ``repro.kernels.supsup.ops.gemm`` (one
    product at a time on the JAX side, a batch of two here)."""
    jdt, tdt, tol, _ = DTYPES[dt]
    rng = np.random.default_rng(nr + 7 * k + 11 * m)
    c, a, b = (rng.normal(size=(2, nr, m)), rng.normal(size=(2, nr, k)),
               rng.normal(size=(2, k, m)))
    got = supsup.gemm_update(*(torch.tensor(v, dtype=tdt) for v in (c, a, b)))
    assert got.shape == (2, nr, m)
    for e in range(2):
        _close(got[e], jsupsup.gemm(jnp.asarray(c[e], jdt),
                                    jnp.asarray(a[e], jdt),
                                    jnp.asarray(b[e], jdt)), tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("nr,k,m", UPDATE_SHAPES)
def test_supsup_update(nr, k, m, dt):
    """The sup-sup update (K3's right solve, then K5) against
    ``repro.kernels.supsup.ops.supsup_update``; src's lower triangle holds
    garbage that neither side may read."""
    jdt, tdt, tol, _ = DTYPES[dt]
    rng = np.random.default_rng(3 * nr + k + m)
    x = rng.normal(size=(2, nr, k + m))
    src = rng.normal(size=(2, k, k + m))
    src[:, :, :k] = _src_block(rng, 2, k)
    lts, xr = supsup.supsup_update(torch.tensor(x, dtype=tdt),
                                   torch.tensor(src, dtype=tdt), k)
    for e in range(2):
        jl, jx = jsupsup.supsup_update(jnp.asarray(x[e], jdt),
                                       jnp.asarray(src[e], jdt), k)
        _close(lts[e], jl, tol)
        _close(xr[e], jx, tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("k,m", SUPROW_SHAPES)
def test_suprow_update(k, m, dt):
    """K6's plain version against ``repro.kernels.suprow.ops.suprow_update``
    (which pads k and m and fills the padded diagonal with ones)."""
    jdt, tdt, tol, _ = DTYPES[dt]
    rng = np.random.default_rng(k * 13 + m)
    x = rng.normal(size=(3, k + m))
    src = rng.normal(size=(3, k, k + m))
    src[:, :, :k] = _src_block(rng, 3, k)
    y, xr = suprow.suprow_update(torch.tensor(x, dtype=tdt),
                                 torch.tensor(src, dtype=tdt), k)
    assert y.shape == (3, k) and xr.shape == (3, m)
    for e in range(3):
        jy, jx = jsuprow.suprow_update(jnp.asarray(x[e], jdt),
                                       jnp.asarray(src[e], jdt), k)
        _close(y[e], jy, tol)
        _close(xr[e], jx, tol)


def _degenerate_panel(case):
    """A (5, 12) node panel, block at column 3, and its threshold: an exact
    zero pivot under eps = 0, or a non-finite entry in the U suffix, the L
    prefix or the block."""
    p = np.random.default_rng(4).normal(size=(5, 12))
    eps = 1e-8
    if case == "zero_pivot":
        p[:, 3] = 0.0
        eps = 0.0
    else:
        row, col, v = {"nan_in_u": (1, 9, np.nan), "inf_in_l": (4, 1, np.inf),
                       "nan_in_block": (2, 5, np.nan)}[case]
        p[row, col] = v
    return p, eps


@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("case", ["zero_pivot", "nan_in_u", "inf_in_l",
                                  "nan_in_block"])
def test_panel_lu_nonfinite_steps(case, bucketed):
    """Degenerate panels: the Pallas kernels (interpreted, as the JAX
    package runs them) spread NaN through their masked rank-1 update.  The
    plain version (which the CUDA kernel is held to on the card) gives the
    same NaN and inf positions and the same finite values."""
    p, eps = _degenerate_panel(case)
    if bucketed:
        pb = np.concatenate([p[:, 3:8], p[:, 8:], p[:, :3]], axis=1)[None]
        out, perm, nper = panel.panel_lu_batched(torch.tensor(pb), 9, eps)
        jo, jp, jn = jpanel.panel_lu_batched(jnp.asarray(pb), 9, eps)
    else:
        out, perm, nper = panel.panel_lu(torch.tensor(p), 5, 3, eps)
        jo, jp, jn = jpanel.panel_lu(jnp.asarray(p), 5, 3, eps)
    got, ref = out.numpy(), np.asarray(jo)
    assert not np.isfinite(ref).all() and np.isfinite(ref).any()
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-12, atol=1e-12)
    assert np.array_equal(perm.numpy(), np.asarray(jp))
    assert np.array_equal(np.asarray(nper).ravel(), np.asarray(jn).ravel())


def test_update_wrappers_empty_and_bad_shapes():
    kernels.reset_launch_counts()
    c = torch.ones(2, 3, 4)
    out = supsup.gemm_update(c, torch.zeros(2, 3, 0), torch.zeros(2, 0, 4))
    assert torch.equal(out, c) and out is not c
    assert kernels.launch_counts()["gemm_update"] == 0
    with pytest.raises(ValueError):
        supsup.gemm_update(c, torch.zeros(2, 3, 5), torch.zeros(2, 4, 4))
    with pytest.raises(ValueError):
        suprow.suprow_update(torch.zeros(2, 6), torch.zeros(2, 3, 7), 3)
