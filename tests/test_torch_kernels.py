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
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.kernels.flashattn.kernel import flash_attention as jflash  # noqa: E402
from repro.kernels.panel import ops as jpanel  # noqa: E402
from repro.kernels.suprow import ops as jsuprow  # noqa: E402
from repro.kernels.supsup import ops as jsupsup  # noqa: E402
from repro.kernels.trisolve import ops as jtri  # noqa: E402
from repro.kernels.wkv.ops import wkv_padded  # noqa: E402
from repro.kernels.wkv.ref import wkv_ref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.kernels.flashattn import ops as flash  # noqa: E402
from repro_torch.kernels.panel import ops as panel  # noqa: E402
from repro_torch.kernels.suprow import ops as suprow  # noqa: E402
from repro_torch.kernels.supsup import ops as supsup  # noqa: E402
from repro_torch.kernels.trisolve import ops as tri  # noqa: E402
from repro_torch.kernels.trisolve import ref as trisolve_ref  # noqa: E402
from repro_torch.kernels.wkv import ops as wkvops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

DTYPES = {"float64": (jnp.float64, torch.float64, 1e-10, 1e-10),
          "float32": (jnp.float32, torch.float32, 1e-4, 1e-3)}
# past k = 128 the CUDA wrappers take their wide path (one launch of the
# wide kernel)
TRISOLVE_SHAPES = [(1, 3), (5, 8), (17, 13), (40, 32), (3, 1), (40, 150),
                   (7, 256), (3, 129)]
LEFT_SHAPES = [(1, 5, 1), (4, 13, 3), (3, 8, 6), (2, 2, 1), (2, 150, 1),
               (2, 150, 3), (1, 256, 3), (3, 129, 1)]
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


def _solve_block(rng, b, k):
    """A block for the triangular solves: ``_tri``'s upper triangle and
    O(1) garbage below it (the right solve must not read it; the unit-lower
    solve reads it as L).  Past 128 columns both triangles are scaled by
    1/sqrt(k), as ``_src_block``'s: with O(1) entries the solutions of a
    150- or 256-wide random triangle reach 1e18 to 1e32 and float32
    rounding in any summation order differs by more than 1e-3."""
    if k <= tri.BLOCK_K:
        return _tri(rng, b, k) + np.tril(rng.normal(size=(b, k, k)), -1)
    return (np.triu(rng.normal(size=(b, k, k)))
            + np.tril(rng.normal(size=(b, k, k)), -1)) / np.sqrt(k) \
        + 3 * np.eye(k)


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


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_panel_lu_wide_prefix(dt):
    """A node panel whose L prefix holds most of its columns (6 x 300, the
    block at column 280), as fem2d_10k's largest node does (its prefix is
    2,197 of 2,347 columns): only [280, 300) is eliminated, and the prefix
    comes out as the input's rows in pivot order."""
    jdt, tdt, tol, _ = DTYPES[dt]
    p = np.random.default_rng(280).normal(size=(6, 300))
    out, perm, nper = panel.panel_lu(torch.tensor(p, dtype=tdt), 6, 280,
                                     1e-10)
    jo, jp, jn = jpanel.panel_lu(jnp.asarray(p, jdt), 6, 280, 1e-10)
    _close(out, jo, tol)
    assert np.array_equal(perm.numpy(), np.asarray(jp))
    assert int(nper) == int(jn)
    assert (perm.numpy() != np.arange(6)).any()
    assert np.array_equal(out[:, :280].numpy(),
                          p[perm.numpy(), :280].astype(out.numpy().dtype))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_panel_lu_strided_view(dt):
    """K2 on the (K, nr, w) view of a slice of each system's value buffer,
    as the engine hands it (rows dense, batch stride the buffer's row
    length): the same result as on the contiguous copy, and the JAX
    wrapper's on each system."""
    jdt, tdt, tol, _ = DTYPES[dt]
    nr, ls, w = 6, 10, 30
    buf = torch.tensor(np.random.default_rng(31).normal(
        size=(3, 5 + nr * w + 7)), dtype=tdt)
    view = buf[:, 5:5 + nr * w].view(3, nr, w)
    assert not view.is_contiguous()
    got = panel.panel_lu(view, nr, ls, 1e-10)
    ref = panel.panel_lu(view.contiguous(), nr, ls, 1e-10)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    for k in range(3):
        jo, jp, jn = jpanel.panel_lu(jnp.asarray(view[k].numpy(), jdt), nr,
                                     ls, 1e-10)
        _close(got[0][k], jo, tol)
        assert np.array_equal(got[1][k].numpy(), np.asarray(jp))
        assert int(got[2][k]) == int(jn)


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
    u = _solve_block(rng, 3, k)
    x = rng.normal(size=(3, nr, k))
    for unit in (False, True):
        y = tri.trsm_batched(torch.tensor(u, dtype=tdt),
                             torch.tensor(x, dtype=tdt), unit_diag=unit)
        jy = jtri.trsm_batched(jnp.asarray(u, jdt), jnp.asarray(x, jdt),
                               unit_diag=unit)
        _close(y, jy, tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("nr,k", TRISOLVE_SHAPES)
def test_trsm_batched_strided_u(nr, k, dt):
    """U as the strided view S[..., :k] of (B, k, k + m) source rows (m odd),
    as the engine passes it: the same result as on its contiguous copy and
    with NaN below the diagonal, and the JAX trsm_batched's."""
    jdt, tdt, tol, _ = DTYPES[dt]
    rng = np.random.default_rng(nr * 11 + k)
    s = rng.normal(size=(3, k, k + 5))
    s[:, :, :k] = _src_block(rng, 3, k)
    S = torch.tensor(s, dtype=tdt)
    Sn = S.clone()
    il = np.tril_indices(k, -1)
    Sn[:, il[0], il[1]] = float("nan")
    x = rng.normal(size=(3, nr, k))
    tx = torch.tensor(x, dtype=tdt)
    for unit in (False, True):
        y = tri.trsm_batched(S[..., :k], tx, unit_diag=unit)
        assert torch.equal(y, tri.trsm_batched(S[..., :k].contiguous(), tx,
                                               unit_diag=unit))
        assert torch.equal(y, tri.trsm_batched(Sn[..., :k], tx,
                                               unit_diag=unit))
        _close(y, jtri.trsm_batched(jnp.asarray(s[:, :, :k], jdt),
                                    jnp.asarray(x, jdt), unit_diag=unit), tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("kb,k,m", LEFT_SHAPES)
def test_trsm_left_solves(kb, k, m, dt):
    jdt, tdt, _, tol = DTYPES[dt]
    rng = np.random.default_rng(kb * 31 + k)
    blk = _solve_block(rng, kb, k)
    b = rng.normal(size=(kb, k, m))
    tb, tr = torch.tensor(blk, dtype=tdt), torch.tensor(b, dtype=tdt)
    jb, jr = jnp.asarray(blk, jdt), jnp.asarray(b, jdt)
    _close(tri.trsm_left_unit_lower_batched(tb, tr),
           jtri.trsm_left_unit_lower_batched(jb, jr), tol)
    _close(tri.trsm_left_upper_batched(tb, tr),
           jtri.trsm_left_upper_batched(jb, jr), tol)


# (nr, k) of the bfloat16 K3 parity cases: k = 1, ragged, at and past the
# k <= 128 kernels' limit (the card's wide kernels take k > 128)
TRSM_BF16_SHAPES = [(17, 1), (17, 13), (5, 64), (17, 128), (3, 129),
                    (17, 150), (7, 256)]


@pytest.mark.parametrize("nr,k", TRSM_BF16_SHAPES)
def test_trsm_bf16_matches_jax(nr, k):
    """K3 in bfloat16 bit for bit against the JAX package's
    ``trsm_batched``, ``trsm_left_unit_lower_batched`` and
    ``trsm_left_upper_batched`` (the Pallas kernel in interpret mode): the
    right solve with and without a unit diagonal, U also as a strided view
    of source rows with NaN below its diagonal, and the left solves at m =
    1 and 3, on dominant blocks (16 on the diagonal, off-diagonal parts
    scaled by 1/sqrt(k)).  The port's wrappers run their plain versions
    here; equal bits pin the rounding points the card's bfloat16 kernels
    copy (float32 sums, x - bf16(S) rounded, then the quotient rounded).
    The versions summed in the sweep's order (``ref.*_bf16_ordered``, the
    card kernels' exact reference) give the same bits here.  Inputs are
    rounded to bfloat16 once, by torch, and handed to JAX as those
    values."""
    rng = np.random.default_rng(nr * 13 + k)
    s = rng.normal(size=(3, k, k + 5))
    s[:, :, :k] = ((np.triu(s[:, :, :k], 1) + np.tril(s[:, :, :k], -1))
                   / np.sqrt(k) + 16 * np.eye(k))
    S = torch.tensor(s, dtype=torch.bfloat16)
    Sn = S.clone()
    il = np.tril_indices(k, -1)
    Sn[:, il[0], il[1]] = float("nan")
    blk = S[..., :k].contiguous()
    x = torch.tensor(rng.normal(size=(3, nr, k)), dtype=torch.bfloat16)

    def jax_of(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    def torch_of(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()

    for unit in (False, True):
        want = torch_of(jtri.trsm_batched(jax_of(blk), jax_of(x),
                                          unit_diag=unit))
        assert bool(torch.isfinite(want.float()).all())
        for u in (blk, S[..., :k], Sn[..., :k]):
            assert torch.equal(tri.trsm_batched(u, x, unit_diag=unit), want)
            assert torch.equal(trisolve_ref.trsm_bf16_ordered(
                u, x, unit_diag=unit), want)
    for m in (1, 3):
        b = torch.tensor(rng.normal(size=(3, k, m)), dtype=torch.bfloat16)
        for fn, ordered, jfn in (
                (tri.trsm_left_unit_lower_batched,
                 trisolve_ref.trsm_left_unit_lower_bf16_ordered,
                 jtri.trsm_left_unit_lower_batched),
                (tri.trsm_left_upper_batched,
                 trisolve_ref.trsm_left_upper_bf16_ordered,
                 jtri.trsm_left_upper_batched)):
            want = torch_of(jfn(jax_of(blk), jax_of(b)))
            assert bool(torch.isfinite(want.float()).all())
            assert torch.equal(fn(blk, b), want)
            assert torch.equal(ordered(blk, b), want)


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


# (k, m, E) per group of one grouped call: k = 1, m = 0, E = 0, both of
# K6's register and shared-memory paths (k <= 8 and k > 8), m past 128
SUPROW_GROUPS = [(1, 0, 2), (3, 7, 3), (9, 130, 2), (2, 5, 0), (17, 1, 1),
                 (8, 13, 2), (6, 25, 4)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_suprow_update_grouped(dt):
    """``suprow_update_grouped`` on groups of mixed (k, m), E = 0 among
    them: the per-group plain version's output, which row by row is
    ``repro.kernels.suprow.ops.suprow_update``'s.  On the CPU nothing is
    launched."""
    jdt, tdt, tol, _ = DTYPES[dt]
    rng = np.random.default_rng(21)
    groups = []
    for k, m, e in SUPROW_GROUPS:
        src = rng.normal(size=(e, k, k + m))
        src[:, :, :k] = _src_block(rng, e, k)
        groups.append((rng.normal(size=(e, k + m)), src, k))
    tgroups = [(torch.tensor(x, dtype=tdt), torch.tensor(s, dtype=tdt), k)
               for x, s, k in groups]
    kernels.reset_launch_counts()
    out = suprow.suprow_update_grouped(tgroups)
    assert kernels.launch_counts()["suprow_update_grouped"] == 0
    tab = suprow.suprow_groups(tgroups)
    assert tab.table is None and tab.k_max == 17
    again = suprow.suprow_update_grouped(tab)
    assert len(out) == len(again) == len(groups)
    for (x, src, k), (y, xr), (y2, xr2), (ty, txr) in zip(
            groups, out, again,
            suprow.suprow_update_grouped_plain(tgroups)):
        assert y.shape == (x.shape[0], k) and xr.shape == (x.shape[0],
                                                         x.shape[1] - k)
        for a, b in ((y, ty), (xr, txr), (y2, ty), (xr2, txr)):
            assert torch.equal(a, b)
        for e in range(x.shape[0]):
            jy, jx = jsuprow.suprow_update(jnp.asarray(x[e], jdt),
                                           jnp.asarray(src[e], jdt), k)
            _close(y[e], jy, tol)
            _close(xr[e], jx, tol)


@pytest.mark.parametrize("case", ["zero_diagonal", "zero_over_zero",
                                  "nan_in_u", "nan_in_b"])
@pytest.mark.parametrize("k", [8, 16])
def test_suprow_update_nonfinite(case, k):
    """K6's plain version on a row with an exact zero on U's diagonal (its
    infinite quotient also meeting a zero of U), 0 / 0, or a NaN in U's
    upper triangle or in the rows past it, against the JAX wrapper in
    float64: the same NaN and inf positions, infinities and finite values.
    k is a multiple of 8, since the JAX wrapper pads k with unit diagonal
    entries and zeros above them, where an infinite y meets 0 and turns the
    padded y, and with it every xr, to NaN; m = 13 is padded to 16, and
    only the unpadded columns are compared."""
    m = 13
    rng = np.random.default_rng(k + len(case))
    x = rng.normal(size=(2, k + m))
    src = rng.normal(size=(2, k, k + m))
    src[:, :, :k] = _src_block(rng, 2, k)
    j = k // 2
    if case == "zero_diagonal":
        src[0, j, j] = src[0, j, j + 1] = 0.0
    elif case == "zero_over_zero":
        x[0, 0] = src[0, 0, 0] = 0.0
    elif case == "nan_in_u":
        src[0, 1, j] = np.nan
    else:
        src[0, j, k + 4] = np.nan
    y, xr = suprow.suprow_update(torch.tensor(x), torch.tensor(src), k)
    assert not (torch.isfinite(y[0]).all() and torch.isfinite(xr[0]).all())
    for e in range(2):
        jy, jx = jsuprow.suprow_update(jnp.asarray(x[e]),
                                       jnp.asarray(src[e]), k)
        for got, ref in ((y[e].numpy(), np.asarray(jy)),
                         (xr[e].numpy(), np.asarray(jx))):
            assert np.array_equal(np.isnan(got), np.isnan(ref))
            assert np.array_equal(np.isinf(got), np.isinf(ref))
            assert np.array_equal(got[np.isinf(got)], ref[np.isinf(ref)])
            fin = np.isfinite(ref)
            np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-10,
                                       atol=1e-10)


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


@functools.lru_cache(maxsize=1)
def _bucket_program():
    """The panel buckets of fem2d(16, 16) under max_super=5 (nine buckets;
    members with nr < nrp, usize < usp and lsize < lsp, nrp 2 to 8) and,
    for each, the value buffer (K = 3 systems, sentinel slots included)
    and thresholds the port's factor program hands it: (engine, [(the
    analysis's bucket, the engine's layout, vals, eps)])."""
    from repro_torch.core import HyluOptions, analyze, torch_repeated_engine
    from repro_torch.matrices import fem2d, to_csr

    A = to_csr(fem2d(16, 16, seed=1))
    eng = torch_repeated_engine(analyze(A, HyluOptions(
        device="cpu", force_mode="supernodal", max_super=5,
        bulk_min_width=2)))
    a = torch.tensor(A.data[None] * np.random.default_rng(18).uniform(
        0.8, 1.2, (3, A.nnz)))
    out = []
    for i, step in enumerate(eng.sched.steps):
        if step.panels:
            vals, eps = eng.refactor_batched(a, stop=(i, "panels"))
            for pb, (lay, _) in zip(step.panels, eng._steps[i][1]):
                out.append((pb, lay, vals.numpy(), eps.numpy()))
    return eng, out


def _bucket_held(pb, lay, vals, eps, dt, total):
    """K1 in place (its plain route on the CPU) on every system of vals
    against the JAX engine's gather, interpreted Pallas kernel and scatter
    on that system (``jax_engine.py:215–219``): equal pivots and
    perturbation counts, the same NaN and inf positions, finite values of
    vals[:, :total] within the dtype's tolerance.  Returns (perm, nper)."""
    jdt, tdt, tol, _ = DTYPES[dt]
    v = torch.tensor(vals, dtype=tdt)
    perm, nper = panel.panel_lu_bucket_inplace(v, lay, torch.tensor(eps))
    b = len(pb.nids)
    assert perm.shape == (vals.shape[0] * b, pb.nr)
    for k in range(vals.shape[0]):
        jv = jnp.asarray(vals[k], jdt)
        P, jp, jn = jpanel.panel_lu_batched(jv[jnp.asarray(pb.gather)],
                                            pb.wu, eps[k], interpret=True)
        jv = np.asarray(jv.at[jnp.asarray(pb.scatter)].set(P))[:total]
        assert np.array_equal(perm[k * b:(k + 1) * b].numpy(),
                              np.asarray(jp))
        assert np.array_equal(nper[k * b:(k + 1) * b].numpy(),
                              np.asarray(jn))
        got = v[k, :total].numpy()
        assert np.array_equal(np.isnan(got), np.isnan(jv))
        assert np.array_equal(np.isinf(got), np.isinf(jv))
        fin = np.isfinite(jv)
        np.testing.assert_allclose(got[fin], jv[fin], rtol=tol, atol=tol)
    return perm, nper


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_panel_lu_bucket_inplace_matches_jax(dt):
    """Every bucket of the program at its own operands, with a threshold
    per system: the engine's for system 0, one that perturbs many pivots
    for system 1, none for system 2."""
    eng, buckets = _bucket_program()
    assert any((lay.desc[:, 1] < lay.nr).any()
               and (lay.desc[:, 4] < lay.wu - lay.nr).any()
               and (lay.desc[:, 3] < lay.wt - lay.wu).any()
               for _, lay, _, _ in buckets)
    counts = np.zeros(3, np.int64)
    for pb, lay, vals, eps in buckets:
        eps = np.array([eps[0], 3.5, 0.0])
        _, nper = _bucket_held(pb, lay, vals, eps, dt,
                               eng.sched.total_slots)
        counts += nper.view(3, -1).sum(dim=1).numpy()
    assert counts[0] == counts[2] == 0 < counts[1]


@pytest.mark.parametrize("case", ["zero_pivot", "nan_pivot_row",
                                  "padded_row_wins"])
def test_panel_lu_bucket_inplace_nonfinite(case):
    """Degenerate values in member 0 of a bucket whose members have nr = 5
    < nrp = 8, in every system: an exactly zero first block column under a
    zero threshold; a NaN that wins the first pivot; and a dominant first
    pivot row that is infinite in the second block column, with nonzero
    multipliers below it, so that every real candidate of step 1 is
    infinite while each padded row turns NaN there (0 * inf) and a padded
    row wins the pivot (tests/test_kernels.py's arithmetic)."""
    eng, buckets = _bucket_program()
    pb, lay, vals, eps = next(c for c in buckets if c[1].nr == 8)
    off, nr, w, ls, _ = (int(x) for x in lay.desc[0])
    assert nr < lay.nr
    vals = vals.copy()
    rows = off + np.arange(nr) * w
    if case == "zero_pivot":
        vals[:, rows + ls] = 0.0
        eps = np.zeros_like(eps)
    elif case == "nan_pivot_row":
        vals[:, rows[2] + ls] = np.nan
    else:
        vals[:, rows + ls] = 1.0
        vals[:, rows[0] + ls] = 1e3
        vals[:, rows[0] + ls + 1] = np.inf
    perm, _ = _bucket_held(pb, lay, vals, eps, "float64",
                           eng.sched.total_slots)
    b = lay.desc.shape[0]
    if case == "padded_row_wins":
        assert (perm[::b, 1] == nr).all()


def test_bucket_descriptors_give_the_analysis_maps():
    """The descriptors the engine uploads describe each bucket's members
    exactly: the gather and scatter maps built from them alone are the
    analysis's."""
    eng, buckets = _bucket_program()
    sched = eng.sched
    for pb, lay, _, _ in buckets:
        g, s = panel.bucket_maps(lay.desc.numpy(), pb.nr, pb.wu, pb.wt,
                                 sched.zero_slot, sched.one_slot,
                                 sched.scratch_slot)
        assert np.array_equal(g, pb.gather) and np.array_equal(s, pb.scatter)
        assert torch.equal(lay.gather, torch.from_numpy(
            pb.gather.reshape(-1).astype(np.int64)))


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


# K7 and K8: the cases of tests/test_kernels.py (test_flash_attention,
# test_wkv_kernel), with their tolerances
FLASH_CASES = [(2, 4, 2, 64, 32, True), (1, 8, 8, 96, 64, True),
               (2, 4, 1, 40, 16, True), (1, 2, 2, 50, 32, False),
               (1, 4, 4, 130, 64, True)]
FLASH_DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
                "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
WKV_CASES = [(4, 64, 16, 16), (2, 100, 32, 32), (6, 33, 8, 16),
             (1, 256, 64, 64)]
# the decays: the JAX test's range, then those where a float32 redesign of K8
# is most likely to part from the plain version: near zero and exactly one
WKV_DECAYS = {"model": (0.7, 0.999), "tiny": (1e-6, 0.05), "one": None}
WKV_PARAMS = [pytest.param(*c, d, id="-".join(map(str, c))
                           + ("" if d == "model" else f"-{d}"))
              for d in WKV_DECAYS for c in WKV_CASES]


@pytest.mark.parametrize("dt", sorted(FLASH_DTYPES))
@pytest.mark.parametrize("b,hq,hkv,t,d,causal", FLASH_CASES)
def test_flash_attention(b, hq, hkv, t, d, causal, dt):
    """K7's plain version (the CPU route of ``flash_attention``) against the
    interpreted Pallas ``flash_attention`` (32 x 32 tiles: ragged T, GQA,
    one non-causal case), float32 at 2e-5 and bfloat16 at 3e-2."""
    jdt, tdt, tol = FLASH_DTYPES[dt]
    rng = np.random.default_rng(t * 7 + d + hq)
    q = rng.normal(size=(b, hq, t, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, hkv, t, d)).astype(np.float32)
            for _ in range(2))
    kernels.reset_launch_counts()
    got = flash.flash_attention(*(torch.tensor(a).to(tdt) for a in (q, k, v)),
                                causal=causal)
    assert kernels.launch_counts()["flash_attention"] == 0   # plain on CPU
    assert got.dtype == tdt and got.shape == (b, hq, t, d)
    ref = jflash(*(jnp.asarray(a, jdt) for a in (q, k, v)), bq=32, bk=32,
                 causal=causal)
    _close(got.float(), np.asarray(ref, np.float32), tol)


@pytest.mark.parametrize("dt", sorted(FLASH_DTYPES))
@pytest.mark.parametrize("t,s,causal", [(70, 70, True), (70, 45, False)])
def test_flash_attention_head_dim_256(t, s, causal, dt):
    """K7's plain version against the interpreted Pallas ``flash_attention``
    at D = 256 (gemma-7b's head width) with GQA groups of 4, causal and
    non-causal with T != S: the oracle the card holds K7 to at that D."""
    jdt, tdt, tol = FLASH_DTYPES[dt]
    rng = np.random.default_rng(t + s + 256)
    q = rng.normal(size=(1, 8, t, 256)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2, s, 256)).astype(np.float32)
            for _ in range(2))
    got = flash.flash_attention(*(torch.tensor(a).to(tdt) for a in (q, k, v)),
                                causal=causal)
    assert got.dtype == tdt and got.shape == (1, 8, t, 256)
    ref = jflash(*(jnp.asarray(a, jdt) for a in (q, k, v)), bq=32, bk=32,
                 causal=causal)
    _close(got.float(), np.asarray(ref, np.float32), tol)


def test_flash_attention_refuses_what_it_does_not_take():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="T == S"):
        flash.flash_attention(q, torch.zeros(1, 2, 6, 16),
                              torch.zeros(1, 2, 6, 16))
    with pytest.raises(ValueError, match="Hq % Hkv"):
        flash.flash_attention(q, torch.zeros(1, 3, 8, 16),
                              torch.zeros(1, 3, 8, 16))


@pytest.mark.parametrize("bh,t,hs,bt,decay", WKV_PARAMS)
def test_wkv(bh, t, hs, bt, decay):
    """K8's plain version (y and the final state) against the interpreted
    Pallas ``wkv_padded`` (y) and the oracle ``wkv_ref`` (y, state), at
    2e-4, with decays from the JAX test's range, from [1e-6, 0.05] and
    exactly 1.0; also in the (B, H, T, hs) layout the model hands it, read
    through strides, with one u per head shared over the batch."""
    rng = np.random.default_rng(bh * 100 + t + hs)
    r = rng.normal(size=(bh, t, hs)).astype(np.float32)
    k = (rng.normal(size=(bh, t, hs)) * 0.3).astype(np.float32)
    v = rng.normal(size=(bh, t, hs)).astype(np.float32)
    lo_hi = WKV_DECAYS[decay]
    w = (rng.uniform(*lo_hi, size=(bh, t, hs)).astype(np.float32) if lo_hi
         else np.ones((bh, t, hs), np.float32))
    u = (rng.normal(size=(bh, hs)) * 0.3).astype(np.float32)
    y, s = wkvops.wkv(*(torch.tensor(a)[None] for a in (r, k, v, w)),
                      torch.tensor(u))              # B = 1, H = bh
    jargs = [jnp.asarray(a) for a in (r, k, v, w, u)]
    yr, sr = wkv_ref(*jargs)
    _close(y[0], wkv_padded(*jargs, bt=bt), 2e-4)
    _close(y[0], yr, 2e-4)
    _close(s[0], sr, 2e-4)
    if bh % 2 == 0:              # (B=2, T, H, hs) storage, (B, H, T, hs) view
        h = bh // 2
        ops4 = [torch.tensor(a).reshape(2, h, t, hs).transpose(1, 2)
                .contiguous().transpose(1, 2) for a in (r, k, v, w)]
        u4 = torch.tensor(u[:h])
        y4, s4 = wkvops.wkv(*ops4, u4)
        yr4, sr4 = wkv_ref(*jargs[:4], jnp.asarray(np.tile(u[:h], (2, 1))))
        _close(y4.reshape(bh, t, hs), yr4, 2e-4)
        _close(s4.reshape(bh, hs, hs), sr4, 2e-4)


def test_attention_seq_cpu_route_matches_the_flash_layer():
    """The port's ``attention_seq`` on the CPU (the chunked attention)
    against the JAX ``attention_seq(use_flash_kernel=True)`` (the
    interpreted Pallas kernel), phi3-medium's reduced layer, float32."""
    name = "phi3-medium-14b"
    jc = jreg.get(name).reduced()
    jp = JT.init_params(jc, jax.random.PRNGKey(5), dtype=jnp.float32)
    blk = jax.tree.map(lambda a: a[0], jp["blocks"][0]["attn"])
    tb = params_from_numpy(jax.tree.map(np.asarray, blk), device="cpu")
    x = np.random.default_rng(6).normal(size=(2, 40, jc.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32)[None], (2, 40)).copy()
    jo, _ = JL.attention_seq(jc, blk, jnp.asarray(x), jnp.asarray(pos),
                             use_flash_kernel=True)
    o, _ = L.attention_seq(treg.get(name).reduced(), tb, torch.tensor(x),
                           torch.tensor(pos).long())
    _close(o, jo, 2e-5)
