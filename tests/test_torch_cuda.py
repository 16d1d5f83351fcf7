"""The port's CUDA kernels on the card (marker ``cuda``; skips without one).

Each kernel against its plain PyTorch version on the same device tensors,
and the engine on the card against the engine on the CPU.  This file
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
from repro_torch.core import (HyluOptions, analyze, factor_batched,  # noqa: E402
                              solve_batched)
from repro_torch.kernels.panel import ops as panel  # noqa: E402
from repro_torch.kernels.supsup import ops as supsup  # noqa: E402
from repro_torch.kernels.trisolve import ops as tri  # noqa: E402
from repro_torch.matrices import circuit_like, fem2d, to_csr  # noqa: E402

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
    }


CASES = sorted(kernels.WRAPPERS) + ["panel_lu_global"]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain(name, dt, cuda):
    tdt, tol, ltol = TOLS[dt]
    tol = ltol if "left" in name else tol
    kern, plain = _cases(np.random.default_rng(1), tdt, cuda)[name]
    wrapper = "panel_lu" if name == "panel_lu_global" else name
    before = kernels.launch_counts()[wrapper]
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    assert kernels.launch_counts()[wrapper] == before + 1
    if isinstance(got, tuple):
        assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
        got, ref = got[0], ref[0]
    torch.testing.assert_close(got, ref, rtol=tol, atol=tol)


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
        assert all(c > 0 for c in counts.values()), counts
    (bg, xg, ig), (bc, xc, ic) = out["cuda"], out["cpu"]
    assert np.array_equal(bg.n_perturb, bc.n_perturb)
    if dtype == "float64":
        assert torch.equal(bg.inode_perm.cpu(), bc.inode_perm)
        torch.testing.assert_close(bg.vals.cpu(), bc.vals, rtol=1e-10,
                                   atol=1e-10)
    assert max(ig["residual"].max(), ic["residual"].max()) < 1e-10
    assert np.abs(xg - xc).max() / np.abs(xc).max() < 1e-10
