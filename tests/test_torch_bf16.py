"""bfloat16 factors: the port against the JAX package on the CPU.

The same analysis (the JAX package's ``save_analysis`` artifact carried
across with ``analysis_from_arrays``) and the same numpy-seeded value sets
and right-hand sides go through ``factor_batched`` / ``solve_batched``
with ``factor_dtype="bfloat16"`` in both packages: the JAX package with
``use_pallas`` on (Pallas in interpret mode) and off, the port with
``device="cpu"`` (the kernels' plain versions, which run in bfloat16) and
``use_kernels`` on and off, under both factor schedules, on the
``circuit`` and ``banded`` scenarios.

Tolerances.  Pivot permutations and perturbation counts must be equal.
Factor values within 1.6e-2 of the largest magnitude (two bf16 ulps):
the two frameworks round bfloat16 at other places (the JAX side fuses
some steps; measured at most 7.1e-3, one ulp).  Both packages refine in
float64 and send every refinement-failed system through the float64
fallback, so the fallback masks must be equal and x agree to 1e-10.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import HyluOptions as JaxOptions  # noqa: E402
from repro.core import analyze as jax_analyze  # noqa: E402
from repro.core.api import (factor_batched as jax_factor_batched,  # noqa: E402
                            solve_batched as jax_solve_batched)
from repro.core.plan_cache import save_analysis  # noqa: E402
from repro.kernels.panel.ops import _eps_in as jax_eps_in  # noqa: E402
from repro_torch.core import (CSR, HyluOptions,  # noqa: E402
                              analysis_from_arrays, factor_batched,
                              solve_batched, torch_repeated_engine)
from repro_torch.kernels.panel.ops import _eps_in  # noqa: E402

from tests.helpers import scenario_system  # noqa: E402

K, N = 4, 60
FACTOR_TOL = 1.6e-2          # of the largest magnitude: two bf16 ulps
X_TOL = 1e-10
SCENARIOS = ["circuit", "banded"]
SCHEDULES = ["bucketed", "unrolled"]
ROUTES = [True, False]       # use_pallas / use_kernels


class Case:
    """One scenario and route, analysed once by the JAX package."""

    def __init__(self, scenario, schedule, kernels, tmp):
        aj, _, _, _ = scenario_system(scenario, n=N, seed=3)
        self.aj = aj
        self.at = CSR(aj.n, aj.indptr, aj.indices, aj.data)
        kw = dict(factor_dtype="bfloat16", factor_schedule=schedule)
        self.an_j = jax_analyze(aj, JaxOptions(engine="jax",
                                               use_pallas=kernels, **kw))
        path = save_analysis(self.an_j, str(
            tmp / f"{scenario}_{schedule}_{kernels}.npz"))
        with np.load(path) as z:
            self.an_t = analysis_from_arrays(
                z, z["meta"], HyluOptions(device="cpu", use_kernels=kernels,
                                          **kw))
        rng = np.random.default_rng(11)
        self.vb = aj.data[None] * rng.uniform(0.8, 1.2, (K, aj.nnz))
        self.b = rng.normal(size=(K, aj.n))
        bst_j = jax_factor_batched(self.an_j, aj, self.vb)
        self.jax = (bst_j,) + jax_solve_batched(bst_j, self.b)
        bst_t = factor_batched(self.an_t, self.at, self.vb)
        self.port = (bst_t,) + solve_batched(bst_t, self.b)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bf16_plans")
    return {(s, sch, k): Case(s, sch, k, tmp) for s in SCENARIOS
            for sch in SCHEDULES for k in ROUTES}


def _f32(a):
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("kernels", ROUTES)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_bf16_factors_match_jax(scenario, schedule, kernels, cases):
    c = cases[scenario, schedule, kernels]
    bst_j, bst_t = c.jax[0], c.port[0]
    eng = torch_repeated_engine(c.an_t)
    assert eng.factor_dtype == torch.bfloat16 and eng.use_kernels == kernels
    assert bst_t.vals.dtype == torch.bfloat16
    assert np.array_equal(bst_t.inode_perm.numpy(),
                          np.asarray(bst_j.inode_perm))
    assert np.array_equal(bst_t.n_perturb, np.asarray(bst_j.n_perturb))
    vj, vt = _f32(bst_j.vals), bst_t.vals.float().numpy()
    assert np.isfinite(vt).all()
    assert np.abs(vt - vj).max() <= FACTOR_TOL * np.abs(vj).max()


@pytest.mark.parametrize("kernels", ROUTES)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_bf16_solve_matches_jax(scenario, schedule, kernels, cases):
    """The float64 refinement and the float64 fallback: equal masks, x
    within 1e-10 of the JAX x, an all-clear failure mask."""
    c = cases[scenario, schedule, kernels]
    _, x_j, info_j = c.jax
    _, x_t, info_t = c.port
    assert info_t["factor_dtype"] == "bfloat16"
    for key in ("fallback_mask", "refine_failed"):
        assert np.array_equal(info_t[key], np.asarray(info_j[key])), key
    assert info_t["n_fp64_fallback"] == info_j["n_fp64_fallback"]
    assert not info_t["refine_failed"].any()
    assert info_t["residual"].max() < X_TOL
    assert (np.abs(x_t - np.asarray(x_j)).max()
            / np.abs(np.asarray(x_j)).max()) < X_TOL


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_bf16_multi_rhs_hostloop_and_lifecycle(schedule, cases):
    """Two right-hand sides per system through the bfloat16 factors (x
    within 1e-10 of the JAX x, equal fallback masks); the host-loop solve
    on them; and the one-system lifecycle (factor, refactor, solve) in
    bfloat16 against the JAX package's, whose host refinement runs in
    float64 from the same bfloat16 factors."""
    from repro.core import factor as jax_factor, refactor as jax_refactor
    from repro.core import solve as jax_solve
    from repro.core.api import _solve_batched_hostloop as jax_hostloop
    from repro_torch.core import factor, refactor, solve
    from repro_torch.core.api import _solve_batched_hostloop

    c = cases["banded", schedule, True]
    bm = np.random.default_rng(4).normal(size=(K, c.aj.n, 2))
    x_j, info_j = jax_solve_batched(c.jax[0], bm)
    bst = factor_batched(c.an_t, c.at, c.vb)
    x_t, info_t = solve_batched(bst, bm)
    assert x_t.shape == (K, c.aj.n, 2)
    assert np.array_equal(info_t["fallback_mask"],
                          np.asarray(info_j["fallback_mask"]))
    assert np.abs(x_t - np.asarray(x_j)).max() < X_TOL * np.abs(x_t).max()
    xh_j, ih_j = jax_hostloop(c.jax[0], c.b)
    xh_t, ih_t = _solve_batched_hostloop(bst, c.b)
    assert np.array_equal(ih_t["refine_failed"],
                          np.asarray(ih_j["refine_failed"]))
    assert ih_t["n_refine"] == ih_j["n_refine"]
    assert np.abs(xh_t - np.asarray(xh_j)).max() <= (
        FACTOR_TOL * np.abs(np.asarray(xh_j)).max())
    a2_t = dataclasses.replace(c.at, data=c.vb[1])
    a2_j = dataclasses.replace(c.aj, data=c.vb[1])
    x1, i1 = solve(refactor(factor(c.an_t, c.at), a2_t), c.b[1])
    xj1, ij1 = jax_solve(jax_refactor(jax_factor(c.an_j, c.aj), a2_j),
                         c.b[1])
    assert i1["n_perturb"] == ij1["n_perturb"]
    assert i1["refine_failed"] == ij1["refine_failed"]
    assert np.abs(x1 - np.asarray(xj1)).max() <= (
        FACTOR_TOL * np.abs(np.asarray(xj1)).max())


@pytest.mark.parametrize("dtype,eps,positive", [
    (torch.bfloat16, 1e-30, True), (torch.float32, 1e-42, True),
    (torch.bfloat16, 0.0, False), (torch.float32, 1e-4, True)])
def test_eps_in_clamps_underflow_as_jax(dtype, eps, positive):
    """A positive threshold stays positive in the panel dtype (one that
    underflows to zero is clamped to the smallest normal), an exact zero
    stays zero (tests/test_mixed_precision.py:251–260).  Where the value is
    normal in the dtype it is the JAX package's ``_eps_in`` bit for bit;
    float32's 1e-42 is subnormal, which PyTorch keeps and XLA's CPU flushes
    to zero and clamps, so there it is only positive and below the
    smallest normal."""
    like = torch.zeros(1, dtype=dtype)
    got = _eps_in(eps, 3, like)
    assert got.dtype == dtype and got.shape == (3,)
    assert bool((got > 0).all()) == positive
    if not positive:
        assert not got.any()
    tiny = torch.finfo(dtype).tiny
    if 0 < float(got[0].float()) < tiny:
        return
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = float(np.asarray(jax_eps_in(jdt, eps)).astype(np.float32))
    assert float(got[0].float()) == want


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_bf16_plain_route_sup_sup_edges_match_jax(schedule, tmp_path,
                                                  monkeypatch):
    """``use_kernels=False`` on a supernodal plan whose sup-sup edges take
    the plain triangular solve: torch has no bfloat16
    ``solve_triangular``, so the port solves them by ``trsm_plain`` in
    bfloat16, the column loop of the JAX package's ``_trsm_upper_jax``.
    Against the JAX package with ``use_pallas=False``: equal pivots and
    counts; the unrolled factors bit-equal (the same loop), the bucketed
    ones (XLA's ``triangular_solve`` there, which rounds elsewhere) within
    the file's 1.6e-2 of the largest magnitude (measured: 2.0e-4); x
    within 1e-10 after the float64 fallback."""
    aj, _, _, _ = scenario_system("denseish", n=30, seed=3)
    at = CSR(aj.n, aj.indptr, aj.indices, aj.data)
    kw = dict(factor_dtype="bfloat16", factor_schedule=schedule,
              force_mode="supernodal", max_super=8, bulk_min_width=2)
    an_j = jax_analyze(aj, JaxOptions(engine="jax", use_pallas=False, **kw))
    with np.load(save_analysis(an_j, str(tmp_path / "plan.npz"))) as z:
        an_t = analysis_from_arrays(z, z["meta"], HyluOptions(
            device="cpu", use_kernels=False, **kw))
    plan = torch_repeated_engine(an_t).plan
    assert any(plan.nodes[e.src].nr > 1 and nd.nr > 1
               for nd in plan.nodes for e in nd.edges)   # sup-sup edges
    calls = []
    solve_tri = torch.linalg.solve_triangular

    def spy(*a, **k):
        calls.append(a[0].dtype)
        return solve_tri(*a, **k)

    rng = np.random.default_rng(11)
    vb = aj.data[None] * rng.uniform(0.8, 1.2, (K, aj.nnz))
    b = rng.normal(size=(K, aj.n))
    bst_j = jax_factor_batched(an_j, aj, vb)
    x_j, info_j = jax_solve_batched(bst_j, b)
    monkeypatch.setattr(torch.linalg, "solve_triangular", spy)
    bst_t = factor_batched(an_t, at, vb)
    monkeypatch.undo()
    assert torch.bfloat16 not in calls
    x_t, info_t = solve_batched(bst_t, b)
    assert np.array_equal(bst_t.inode_perm.numpy(),
                          np.asarray(bst_j.inode_perm))
    assert np.array_equal(bst_t.n_perturb, np.asarray(bst_j.n_perturb))
    vj, vt = _f32(bst_j.vals), bst_t.vals.float().numpy()
    if schedule == "unrolled":
        assert np.array_equal(vt, vj)
    else:
        assert np.abs(vt - vj).max() <= FACTOR_TOL * np.abs(vj).max()
    assert np.array_equal(info_t["fallback_mask"],
                          np.asarray(info_j["fallback_mask"]))
    assert (np.abs(x_t - np.asarray(x_j)).max()
            / np.abs(np.asarray(x_j)).max()) < X_TOL


def test_bf16_substitution_passes_give_index_add_bits():
    """The level substitution's ordered passes (``row_passes`` /
    ``add_rows``) against the CPU's ``index_add_`` on bfloat16, which
    adds in source order and rounds each add: bit-equal, on random
    duplicate-heavy rows; and a whole bfloat16 one-system ``apply`` with
    the passes against the same apply with ``index_add_`` scatters."""
    from repro_torch.core import analyze as t_analyze
    from repro_torch.core.torch_engine import _index, add_rows, row_passes
    from repro_torch.matrices import fem2d, to_csr

    rng = np.random.default_rng(7)
    for _ in range(20):
        rows = rng.integers(0, 9, 60)
        upd = torch.from_numpy(rng.normal(size=(3, 60, 2))).bfloat16()
        w = torch.from_numpy(rng.normal(size=(3, 10, 2))).bfloat16()
        ref = w.clone().index_add_(1, _index(rows, "cpu"), upd)
        got = w.clone()
        add_rows(got, [_index(a, "cpu") for a in row_passes(rows)], upd)
        assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
    a = to_csr(fem2d(10, 10))
    an = t_analyze(a, HyluOptions(device="cpu", factor_dtype="bfloat16"))
    eng = torch_repeated_engine(an)
    f = eng.refactor(torch.from_numpy(a.data))
    b = torch.from_numpy(rng.normal(size=a.n))
    x = eng.apply(f.vals, f.inode_perm, b)
    eng._tris.clear()
    eng.dtype = torch.float32           # build index_add_ schedules ...
    for name in ("l_fwd", "u_bwd"):
        eng._tri(name)
    eng.dtype = torch.bfloat16          # ... and run them in bfloat16
    assert isinstance(eng._tris["l_fwd"].head[0][1], torch.Tensor)
    x_ref = eng.apply(f.vals, f.inode_perm, b)
    assert x.dtype == torch.bfloat16
    assert torch.equal(x.view(torch.int16), x_ref.view(torch.int16))
