"""The port's batched repeated-solve path against the JAX package's.

Both packages run the very same analysis: the JAX package analyzes and
writes its ``save_analysis`` artifact, and the port carries it across
with ``analysis_from_arrays`` (so no step of the host analysis can
differ).  Then the
same numpy-seeded value sets and right-hand sides go through
``factor_batched`` / ``solve_batched`` / ``solve_sequence`` of both — on
the JAX side with ``use_pallas=True`` (Pallas in interpret mode) and with
``use_pallas=False``, on the port's side with ``device="cpu"`` (the plain
PyTorch versions of the kernels).

Tolerance: 1e-10 on factors, solutions and residuals in float64 — the two
sides sum in different orders (batched GEMMs and scatter-adds), nothing
else.  Pivot permutations, perturbation counts, refinement counts and the
failure masks must be equal.  The float32-factor path refines in float64
and must land within 1e-10 of the float64 oracle, as
``tests/test_mixed_precision.py`` requires of the JAX package.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from repro.core import CSR as JaxCSR, HyluOptions as JaxOptions  # noqa: E402
from repro.core import analyze as jax_analyze  # noqa: E402
from repro.core.api import (factor_batched as jax_factor_batched,  # noqa: E402
                            solve_batched as jax_solve_batched,
                            solve_sequence as jax_solve_sequence)
from repro.core.plan_cache import save_analysis  # noqa: E402
from repro_torch.core import (CSR, HyluOptions,  # noqa: E402
                              analysis_from_arrays, factor_batched,
                              solve_batched, solve_sequence,
                              torch_repeated_engine)
from repro_torch.matrices import fem2d  # noqa: E402

from tests.helpers import circuit_system  # noqa: E402

K = 4
TOL = 1e-10


def _matrix(case):
    if case == "fem2d_12":
        return fem2d(12, 12, seed=1), dict(force_mode="supernodal",
                                           bulk_min_width=2)
    if case == "circuit_30":
        return circuit_system(30, seed=0), {}
    # an indefinite shift of the stencil: with perturb_eps=1e-2 a pivot of
    # one of the four systems falls under the threshold
    a = fem2d(8, 8, seed=1) - 3.0 * sp.eye(64)
    return a, dict(force_mode="supernodal", bulk_min_width=2,
                   perturb_eps=1e-2)


CASES = ["fem2d_12", "circuit_30", "fem2d_8_perturbed"]
PATHS = ["pallas-interpret", "jit"]


class Case:
    """One matrix analyzed once by the JAX package and carried across."""

    def __init__(self, name, tmp):
        a, kw = _matrix(name)
        a = a.tocsr()
        a.sort_indices()
        self.aj = JaxCSR.from_scipy(a)
        self.at = CSR(self.aj.n, self.aj.indptr, self.aj.indices,
                      self.aj.data)
        self.kw = kw
        self.an_j = jax_analyze(self.aj, JaxOptions(engine="jax",
                                                    use_pallas=True, **kw))
        path = save_analysis(self.an_j, str(tmp / f"{name}.npz"))
        with np.load(path) as z:
            self.an_t = analysis_from_arrays(
                z, z["meta"], HyluOptions(device="cpu", **kw))
        rng = np.random.default_rng(7)
        self.vb = self.aj.data[None] * rng.uniform(0.8, 1.2,
                                                   (K, self.aj.nnz))
        self.b = np.random.default_rng(17).normal(size=(K, self.aj.n))
        self._jax = {}

    def jax_analysis(self, path):
        if path == "pallas-interpret":
            return self.an_j
        opts = dataclasses.replace(self.an_j.opts, use_pallas=False)
        return dataclasses.replace(self.an_j, opts=opts, jit_cache={})

    def jax(self, path):
        """(analysis, factor state, x, info) of the JAX package."""
        if path not in self._jax:
            an = self.jax_analysis(path)
            bst = jax_factor_batched(an, self.aj, self.vb)
            x, info = jax_solve_batched(bst, self.b)
            self._jax[path] = (an, bst, x, info)
        return self._jax[path]

    def port(self, dtype="float64"):
        an = self.an_t
        if dtype != "float64":
            an = dataclasses.replace(
                an, opts=dataclasses.replace(an.opts, factor_dtype=dtype),
                engine_cache={})
        bst = factor_batched(an, self.at, self.vb)
        x, info = solve_batched(bst, self.b)
        return an, bst, x, info


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("plans")
    return {name: Case(name, tmp) for name in CASES}


@pytest.fixture(scope="module")
def port64(cases):
    return {name: c.port() for name, c in cases.items()}


def _rel(x, ref):
    return np.abs(np.asarray(x) - np.asarray(ref)).max() / (
        np.abs(np.asarray(ref)).max() + 1e-300)


def test_cases_reach_every_path(cases, port64):
    """fem2d_12 reaches a panel bucket, narrow-level supernodes, sup-sup
    edges and node blocks with nr > 1; circuit_30 scan chunks and row-row
    edges; the shifted case perturbs pivots."""
    s = torch_repeated_engine(cases["fem2d_12"].an_t).sched
    assert sum(len(t.panels) for t in s.steps) > 0
    assert sum(len(t.seq) for t in s.steps) > 0
    assert any(e.k > 1 for t in s.steps for e in t.edges)
    assert any(nd.nr > 1 for nd in cases["fem2d_12"].an_t.plan.nodes)
    s = torch_repeated_engine(cases["circuit_30"].an_t).sched
    assert len(s.scan_chunks) > 0
    assert any(e.k == 1 for t in s.steps for e in t.edges)
    assert port64["fem2d_8_perturbed"][1].n_perturb.sum() > 0


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", CASES)
def test_factors_match_jax(case, path, cases, port64):
    _, bst_j, _, _ = cases[case].jax(path)
    _, bst_t, _, _ = port64[case]
    np.testing.assert_allclose(bst_t.vals.numpy(), np.asarray(bst_j.vals),
                               rtol=TOL, atol=TOL)
    assert np.array_equal(bst_t.inode_perm.numpy(),
                          np.asarray(bst_j.inode_perm))
    assert np.array_equal(bst_t.n_perturb, np.asarray(bst_j.n_perturb))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", CASES)
def test_solve_matches_jax(case, path, cases, port64):
    _, _, x_j, info_j = cases[case].jax(path)
    _, _, x_t, info_t = port64[case]
    assert _rel(x_t, x_j) < TOL
    np.testing.assert_allclose(info_t["residual"], info_j["residual"],
                               rtol=0, atol=TOL)
    assert info_t["residual"].max() < TOL
    for key in ("n_refine_per_system", "refine_failed", "refine_stalled"):
        assert np.array_equal(info_t[key], np.asarray(info_j[key])), key
    assert info_t["n_refine"] == info_j["n_refine"]


@pytest.mark.parametrize("case", CASES)
def test_mixed_precision_matches_fp64_oracle(case, cases):
    """float32 factors refined in float64 land within 1e-10 of the JAX
    float64 solution (test_mixed_precision.py:75), with no fp64 fallback."""
    _, _, x64, info64 = cases[case].jax("pallas-interpret")
    _, bst, x32, info = cases[case].port("float32")
    assert bst.vals.dtype == torch.float32
    assert info["factor_dtype"] == "float32"
    assert info["residual"].max() < TOL
    assert not info["refine_failed"].any() and not info64["refine_failed"].any()
    assert info["n_fp64_fallback"] == 0
    assert _rel(x32, x64) < TOL


@pytest.mark.parametrize("case", ["fem2d_12", "circuit_30"])
def test_multi_rhs_matches_jax(case, cases):
    c = cases[case]
    an_j, bst_j, _, _ = c.jax("pallas-interpret")
    bm = np.random.default_rng(3).normal(size=(K, c.aj.n, 3))
    x_j, info_j = jax_solve_batched(bst_j, bm)
    bst_t = factor_batched(c.an_t, c.at, c.vb)
    x_t, info_t = solve_batched(bst_t, bm)
    assert x_t.shape == (K, c.aj.n, 3) and info_t["residual"].shape == (K, 3)
    assert _rel(x_t, x_j) < TOL
    np.testing.assert_allclose(info_t["residual"], info_j["residual"],
                               rtol=0, atol=TOL)
    assert np.array_equal(info_t["n_refine_per_system"],
                          np.asarray(info_j["n_refine_per_system"]))


@pytest.mark.parametrize("case", ["fem2d_8_perturbed", "circuit_30"])
def test_refine_false_matches_jax(case, cases):
    """The base solve alone: with perturbed pivots it stays above tol, and
    both report no refinement and no failure mask."""
    c = cases[case]
    _, bst_j, _, _ = c.jax("pallas-interpret")
    x_j, info_j = jax_solve_batched(bst_j, c.b, refine=False)
    bst_t = factor_batched(c.an_t, c.at, c.vb)
    x_t, info_t = solve_batched(bst_t, c.b, refine=False)
    assert _rel(x_t, x_j) < TOL
    np.testing.assert_allclose(info_t["residual"], info_j["residual"],
                               rtol=TOL, atol=TOL)
    assert info_t["n_refine"] == info_j["n_refine"] == 0
    assert not info_t["refine_failed"].any()
    assert np.array_equal(info_t["refine_failed"],
                          np.asarray(info_j["refine_failed"]))


def test_nonfinite_system_flagged_failed(cases):
    """A NaN value set poisons its own system only, which both packages
    report failed; the healthy systems still match."""
    c = cases["circuit_30"]
    vb = c.vb.copy()
    vb[2, 0] = np.nan
    an_j, _, _, _ = c.jax("pallas-interpret")
    x_j, info_j = jax_solve_batched(jax_factor_batched(an_j, c.aj, vb), c.b)
    x_t, info_t = solve_batched(factor_batched(c.an_t, c.at, vb), c.b)
    assert np.array_equal(info_t["refine_failed"], [False, False, True,
                                                    False])
    assert np.array_equal(info_t["refine_failed"],
                          np.asarray(info_j["refine_failed"]))
    ok = [0, 1, 3]
    assert _rel(x_t[ok], x_j[ok]) < TOL
    assert info_t["residual"][ok].max() < TOL


def test_solve_sequence_matches_jax(cases):
    """T = 2 steps through solve_sequence of both packages (each runs its
    own analysis, identical by tests/test_torch_analysis.py)."""
    c = cases["circuit_30"]
    rng = np.random.default_rng(23)
    steps = c.aj.data[None, None] * rng.uniform(0.8, 1.2, (2, K, c.aj.nnz))
    pattern = (c.aj.indptr, c.aj.indices)
    x_j, info_j = jax_solve_sequence(
        pattern, steps, c.b, JaxOptions(engine="jax", use_pallas=True))
    x_t, info_t = solve_sequence(pattern, steps, c.b,
                                 HyluOptions(device="cpu"))
    assert x_t.shape == (2, K, c.aj.n)
    assert _rel(x_t, x_j) < TOL
    np.testing.assert_allclose(info_t["residual"], info_j["residual"],
                               rtol=0, atol=TOL)
    assert info_t["n_refine"] == list(info_j["n_refine"])
    assert np.array_equal(info_t["n_perturb"], np.asarray(info_j["n_perturb"]))
    # the single-step form of the same entry point
    x1, info1 = solve_sequence(pattern, steps[0], c.b,
                               HyluOptions(device="cpu"))
    assert _rel(x1, x_t[0]) < TOL and info1["k"] == K


@pytest.mark.parametrize("case", CASES)
def test_factors_match_host_reference_engine(case, cases, port64):
    """The port's own copy of the numpy reference engine is a third oracle:
    every system's factors equal its left-looking host factorization."""
    from repro_torch.core import ref_engine

    c = cases[case]
    an = c.an_t
    _, bst, _, _ = port64[case]
    for k in range(K):
        m = CSR(c.aj.n, an.m_pattern[0], an.m_pattern[1],
                c.vb[k][an.src_map] * an.scale_map)
        f = ref_engine.factor(an.plan, m, perturb_eps=an.opts.perturb_eps)
        np.testing.assert_allclose(bst.vals[k].numpy(), f.vals, rtol=TOL,
                                   atol=TOL)
        assert np.array_equal(bst.inode_perm[k].numpy(), f.inode_perm)
        assert int(bst.n_perturb[k]) == f.n_perturb
