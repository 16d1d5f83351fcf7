"""The port's CUDA kernels on the card (marker ``cuda``; skips without one).

Each kernel against its plain PyTorch version on the same device tensors
(K1 and K2 also on panels with a zero pivot under a zero threshold or a
non-finite entry), the engine on the card against the engine on the CPU,
and the unrolled one-system lifecycle against the bucketed one.  This file
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
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.core import (HyluOptions, analyze, factor,  # noqa: E402
                              factor_batched, refactor, solve, solve_batched)
from repro_torch.kernels.panel import ops as panel  # noqa: E402
from repro_torch.kernels.suprow import ops as suprow  # noqa: E402
from repro_torch.kernels.supsup import ops as supsup  # noqa: E402
from repro_torch.kernels.trisolve import ops as tri  # noqa: E402
from repro_torch.matrices import circuit_like, fem2d, to_csr  # noqa: E402

# the wrappers the batched path launches (K5 runs in the unrolled schedule,
# K6 on no engine path)
BATCHED_PATH = ("panel_lu_batched", "panel_lu", "trsm_batched",
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

    return {
        "panel_lu_batched": (lambda: panel.panel_lu_batched(pb, 50, eps(6)),
                             lambda: panel.panel_lu_plain(pb, 0, 50, eps(6))),
        "panel_lu": (lambda: panel.panel_lu(p2, 24, 10, eps(4)),
                     lambda: panel.panel_lu_plain(p2, 10, 60, eps(4))),
        "panel_lu_global": (lambda: panel.panel_lu(p3, 128, 100, eps(2)),
                            lambda: panel.panel_lu_plain(p3, 100, 300,
                                                         eps(2))),
        "trsm_batched": (lambda: tri.trsm_batched(u, x),
                         lambda: tri.trsm_plain(u, x)),
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
    }


# the wrapper whose count a case adds one to (supsup_update: K3 then K5)
COUNTED = {"panel_lu_global": ("panel_lu",),
           "gemm_update_ragged": ("gemm_update",),
           "supsup_update": ("trsm_batched", "gemm_update")}
CASES = sorted(kernels.WRAPPERS) + sorted(COUNTED)


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
    unrolled schedule (K2 per node, K3 + K5 per sup-sup edge) against the
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
    assert counts["gemm_update"] == counts["trsm_batched"] == n_supsup > 0
    assert counts["panel_lu"] == sum(nd.nr > 1 for nd in nodes)
    (fb, xb, ib), (fu, xu, iu) = out["bucketed"], out["unrolled"]
    assert torch.equal(fb.inode_perm, fu.inode_perm)
    assert int(fb.n_perturb) == int(fu.n_perturb)
    if dtype == "float64":
        torch.testing.assert_close(fu.vals, fb.vals, rtol=1e-10, atol=1e-10)
    assert max(ib["residual"], iu["residual"]) < 1e-10
    assert np.abs(xu - xb).max() / np.abs(xb).max() < 1e-10


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(ValueError, match="nr <= 128"):
        panel.panel_lu(torch.zeros(1, 129, 140, device=cuda,
                                   dtype=torch.float64), 129, 0, 1e-8)
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
