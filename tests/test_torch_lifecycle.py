"""The port's one-system lifecycle against the JAX package's.

``analyze → factor → refactor (new values) → solve`` and ``solve_system``
run through both packages on the same numpy-seeded matrices, value sets
and right-hand sides: on the JAX side with ``engine="jax"``, on the port's
side with ``device="cpu"`` (the plain PyTorch versions of the kernels).
The routes are paired as the port names them: ``use_pallas=True`` (Pallas
in interpret mode) against ``use_kernels=True``, ``use_pallas=False``
against ``use_kernels=False``, under both factor schedules.

The matrices: ``circuit`` (rowrow: row-row edges and the scanned width-1
tail of the bucketed schedule), ``denseish`` forced supernodal with
``max_super=8`` (sup-sup edges and narrow-level supernodes) and a 2-D grid
``fem2d_8`` with ``max_super=4`` (a panel bucket and a sup-row edge).

Tolerances: in float64, 1e-10 on factors, solutions and residuals (the two
sides sum in other orders, nothing else) with identical pivot
permutations, perturbation counts, refinement counts and failure flags.
float32 factors are held to 1e-4 (``tests/test_kernels.py``); refined in
float64 they must land within 1e-10 of the JAX float64 solution, as
``tests/test_mixed_precision.py`` requires of the JAX package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import CSR as JaxCSR, HyluOptions as JaxOptions  # noqa: E402
from repro.core import (analyze as jax_analyze, factor as jax_factor,  # noqa: E402
                        refactor as jax_refactor, solve as jax_solve,
                        solve_system as jax_solve_system)
from repro.core.api import (factor_batched as jax_factor_batched,  # noqa: E402
                            jax_repeated_engine,
                            solve_batched as jax_solve_batched)
import repro_torch  # noqa: E402
from repro_torch.core import (CSR, HyluOptions, factor_batched,  # noqa: E402
                              solve_batched, torch_repeated_engine)
from repro_torch.matrices import fem2d  # noqa: E402

from tests.helpers import circuit_system, denseish_system  # noqa: E402

TOL = 1e-10
TOL32 = 1e-4
CASES = ["circuit", "denseish", "fem2d_8"]
SCHEDULES = ["bucketed", "unrolled"]
ROUTES = {"kernels": dict(use_pallas=True), "plain": dict(use_pallas=False)}


def _matrix(case):
    if case == "circuit":
        return circuit_system(30, seed=3), {}
    if case == "denseish":
        return denseish_system(40, seed=3), dict(
            force_mode="supernodal", max_super=8, bulk_min_width=2)
    return fem2d(8, 8, seed=1), dict(force_mode="supernodal", max_super=4,
                                     bulk_min_width=2)


class Case:
    """One matrix, a second value set of its pattern and a right-hand
    side, in both packages' CSR types."""

    def __init__(self, name):
        a, self.kw = _matrix(name)
        a = a.tocsr()
        a.sort_indices()
        self.aj = JaxCSR.from_scipy(a)
        self.at = CSR(self.aj.n, self.aj.indptr, self.aj.indices,
                      self.aj.data)
        rng = np.random.default_rng(11)
        self.vals2 = self.aj.data * rng.uniform(0.8, 1.2, self.aj.nnz)
        self.aj2 = self.with_values(self.vals2, JaxCSR)
        self.at2 = self.with_values(self.vals2, CSR)
        self.b = np.random.default_rng(13).normal(size=self.aj.n)

    def with_values(self, vals, kind):
        return kind(self.aj.n, self.aj.indptr, self.aj.indices, vals)

    def opts(self, route, schedule, dtype="float64"):
        jo = JaxOptions(engine="jax", factor_schedule=schedule,
                        factor_dtype=dtype, **ROUTES[route], **self.kw)
        to = HyluOptions(device="cpu", factor_schedule=schedule,
                         factor_dtype=dtype, use_kernels=route == "kernels",
                         **self.kw)
        return jo, to


def _lifecycle(pkg, c, opts):
    analyze, factor, refactor, solve, a, a2 = pkg(c)
    an = analyze(a, opts)
    st = refactor(factor(an, a), a2)
    x, info = solve(st, c.b)
    return an, st, x, info


def _jax_pkg(c):
    return jax_analyze, jax_factor, jax_refactor, jax_solve, c.aj, c.aj2


def _port_pkg(c):
    return (repro_torch.analyze, repro_torch.factor, repro_torch.refactor,
            repro_torch.solve, c.at, c.at2)


@pytest.fixture(scope="module")
def cases():
    return {name: Case(name) for name in CASES}


@pytest.fixture(scope="module")
def runs(cases):
    """(case, route, schedule, dtype) → (JAX run, port run), computed once."""
    cache = {}

    def get(case, route, schedule, dtype="float64"):
        key = (case, route, schedule, dtype)
        if key not in cache:
            c = cases[case]
            jo, to = c.opts(route, schedule, dtype)
            cache[key] = (_lifecycle(_jax_pkg, c, jo),
                          _lifecycle(_port_pkg, c, to))
        return cache[key]

    return get


def _rel(x, ref):
    return np.abs(np.asarray(x) - np.asarray(ref)).max() / (
        np.abs(np.asarray(ref)).max() + 1e-300)


def test_cases_reach_every_path(cases):
    """Between them the matrices reach a panel bucket and narrow-level
    nodes (bucketed), scan chunks, and sup-sup, sup-row and row-row edges
    (unrolled)."""
    seen = set()
    for c in cases.values():
        an = repro_torch.analyze(c.at, c.opts("kernels", "bucketed")[1])
        eng = torch_repeated_engine(an)
        nodes = an.plan.nodes
        seen |= {"panels"} if any(s.panels for s in eng.sched.steps) else set()
        seen |= {"seq"} if any(len(s.seq) for s in eng.sched.steps) else set()
        seen |= {"chunks"} if eng.sched.scan_chunks else set()
        for nd in nodes:
            for e in nd.edges:
                k = nodes[e.src].nr
                seen.add("row" if k == 1 else
                         "supsup" if nd.nr > 1 else "suprow")
    assert seen == {"panels", "seq", "chunks", "row", "supsup", "suprow"}


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("case", CASES)
def test_lifecycle_matches_jax(case, route, schedule, runs):
    (an_j, st_j, x_j, info_j), (an_t, st_t, x_t, info_t) = runs(
        case, route, schedule)
    jf, tf = st_j.jax_factors, st_t.torch_factors
    assert st_t.engine == "torch" and st_t.a.data is not None
    np.testing.assert_allclose(tf.vals.numpy(), np.asarray(jf.vals),
                               rtol=TOL, atol=TOL)
    assert np.array_equal(tf.inode_perm.numpy(), np.asarray(jf.inode_perm))
    assert int(tf.n_perturb) == int(jf.n_perturb)
    assert _rel(x_t, x_j) < TOL
    assert abs(info_t["residual"] - info_j["residual"]) < TOL
    assert info_t["residual"] < TOL
    for key in ("n_refine", "n_perturb", "refine_failed"):
        assert info_t[key] == info_j[key], key


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("case", CASES)
def test_lifecycle_float32_factors(case, schedule, runs):
    """float32 factors refined in float64 on the host: the factors within
    1e-4 of the JAX package's float32 factors, the solution within 1e-10
    of its float64 one."""
    _, (_, _, x64, _) = runs(case, "kernels", schedule)
    (_, st_j, _, info_j), (_, st_t, x_t, info_t) = runs(
        case, "kernels", schedule, "float32")
    jf, tf = st_j.jax_factors, st_t.torch_factors
    assert tf.vals.dtype == torch.float32
    np.testing.assert_allclose(tf.vals.numpy(), np.asarray(jf.vals),
                               rtol=TOL32, atol=TOL32)
    assert np.array_equal(tf.inode_perm.numpy(), np.asarray(jf.inode_perm))
    assert int(tf.n_perturb) == int(jf.n_perturb)
    assert x_t.dtype == np.float64
    assert _rel(x_t, x64) < TOL
    assert info_t["residual"] < TOL
    assert info_t["refine_failed"] is info_j["refine_failed"] is False


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_refactor_equals_a_fresh_factor(schedule, cases, runs):
    """refactor(st, a2) reuses the engine and gives what factor(an, a2)
    gives."""
    c = cases["fem2d_8"]
    _, (an_t, st_t, _, _) = runs("fem2d_8", "kernels", schedule)
    fresh = repro_torch.factor(an_t, c.at2).torch_factors
    assert torch.equal(fresh.vals, st_t.torch_factors.vals)
    assert torch.equal(fresh.inode_perm, st_t.torch_factors.inode_perm)
    assert len(an_t.engine_cache) == 1


@pytest.mark.parametrize("case", CASES)
def test_solve_system_matches_jax(case, cases):
    c = cases[case]
    x_j, info_j = jax_solve_system(c.aj, c.b, JaxOptions(
        engine="jax", use_pallas=True, **c.kw))
    x_t, info_t = repro_torch.solve_system(c.at, c.b, HyluOptions(
        device="cpu", **c.kw))
    assert _rel(x_t, x_j) < TOL
    assert info_t["residual"] < TOL
    for key in ("mode", "ordering", "n_refine", "n_perturb",
                "refine_failed"):
        assert info_t[key] == info_j[key], key
    assert info_t["engine"] == "torch"
    assert set(info_t["timings"]) == {"preprocess", "factor"}


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("case", CASES)
def test_lut_solve_matches_jax(case, schedule, runs):
    """L⁻ᵀ U⁻ᵀ c on the same factors, against
    ``RepeatedSolveEngine.lut_solve``; checked as an adjoint too:
    ⟨L⁻ᵀU⁻ᵀ c, d⟩ = ⟨c, U⁻¹L⁻¹ d⟩."""
    (an_j, st_j, _, _), (an_t, st_t, _, _) = runs(case, "kernels", schedule)
    rng = np.random.default_rng(5)
    cvec, dvec = rng.normal(size=(2, an_t.n))
    jf, tf = st_j.jax_factors, st_t.torch_factors
    ref = np.asarray(jax_repeated_engine(an_j).lut_solve(jf.vals, cvec))
    eng = torch_repeated_engine(an_t)
    got = eng.lut_solve(tf.vals, torch.from_numpy(cvec)).numpy()
    assert _rel(got, ref) < TOL
    lu = eng._level_solve(tf.vals[None],
                          torch.from_numpy(dvec)[None, :, None])[0, :, 0]
    assert abs(got @ dvec - cvec @ lu.numpy()) < TOL * np.abs(got).sum()


@pytest.mark.parametrize("case", CASES)
def test_batched_plain_route_matches_jax(case, cases):
    """The batched ``use_kernels=False`` route (plain factor program and
    level-scheduled substitution) against the JAX package's
    ``use_pallas=False`` ``factor_batched`` / ``solve_batched``."""
    c = cases[case]
    rng = np.random.default_rng(17)
    vb = c.aj.data[None] * rng.uniform(0.8, 1.2, (3, c.aj.nnz))
    bb = rng.normal(size=(3, c.aj.n))
    jo, to = c.opts("plain", "bucketed")
    bst_j = jax_factor_batched(jax_analyze(c.aj, jo), c.aj, vb)
    x_j, info_j = jax_solve_batched(bst_j, bb)
    from repro_torch import kernels

    kernels.reset_launch_counts()
    bst_t = factor_batched(repro_torch.analyze(c.at, to), c.at, vb)
    x_t, info_t = solve_batched(bst_t, bb)
    np.testing.assert_allclose(bst_t.vals.numpy(), np.asarray(bst_j.vals),
                               rtol=TOL, atol=TOL)
    assert np.array_equal(bst_t.inode_perm.numpy(),
                          np.asarray(bst_j.inode_perm))
    assert _rel(x_t, x_j) < TOL
    np.testing.assert_allclose(info_t["residual"], info_j["residual"],
                               rtol=0, atol=TOL)
    for key in ("n_perturb", "n_refine_per_system", "refine_failed"):
        assert np.array_equal(info_t[key], np.asarray(info_j[key])), key
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize("case", CASES)
def test_ref_engine_matches_jax(case, cases):
    """engine="ref": the copied numpy reference engine on the host, asked
    for by name, against the JAX package's."""
    c = cases[case]
    an_j = jax_analyze(c.aj, JaxOptions(engine="ref", **c.kw))
    an_t = repro_torch.analyze(c.at, HyluOptions(engine="ref", device="cpu",
                                                 **c.kw))
    st_j = jax_refactor(jax_factor(an_j, c.aj), c.aj2)
    st_t = repro_torch.refactor(repro_torch.factor(an_t, c.at), c.at2)
    assert st_t.engine == "ref" and st_t.torch_factors is None
    np.testing.assert_array_equal(st_t.factors.vals, st_j.factors.vals)
    x_j, info_j = jax_solve(st_j, c.b)
    x_t, info_t = repro_torch.solve(st_t, c.b)
    np.testing.assert_array_equal(x_t, x_j)
    assert info_t["residual"] == info_j["residual"]
    assert info_t["n_refine"] == info_j["n_refine"]


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_nan_value_set_reports_like_the_reference(schedule, route, cases,
                                                  runs):
    """A NaN in the values poisons the factors and the solution.  The JAX
    package's scalar ``solve`` compares ``resid > rtol``, which is False
    for NaN, so it reports ``refine_failed=False`` (ROADMAP.md, Queue C);
    the port reports exactly what the reference reports."""
    c = cases["fem2d_8"]
    vals = c.vals2.copy()
    vals[5] = np.nan
    (an_j, _, _, _), (an_t, _, _, _) = runs("fem2d_8", route, schedule)
    st_j = jax_factor(an_j, c.with_values(vals, JaxCSR))
    st_t = repro_torch.factor(an_t, c.with_values(vals, CSR))
    x_j, info_j = jax_solve(st_j, c.b)
    x_t, info_t = repro_torch.solve(st_t, c.b)
    assert not np.isfinite(x_j).all() and not np.isfinite(x_t).all()
    assert np.isnan(info_j["residual"]) and np.isnan(info_t["residual"])
    for key in ("n_refine", "n_perturb", "refine_failed"):
        assert info_t[key] == info_j[key], key


def test_engine_cache_keys_route_and_schedule(cases):
    """Two engines of one analysis never share a cache slot: the kernel
    route and the factor schedule are part of the key, as in the JAX
    package's ``jax_repeated_engine``."""
    c = cases["fem2d_8"]
    an = repro_torch.analyze(c.at, c.opts("kernels", "bucketed")[1])
    e0 = torch_repeated_engine(an)
    e1 = torch_repeated_engine(an, use_kernels=False)
    e2 = torch_repeated_engine(an, schedule="unrolled")
    assert len({id(e0), id(e1), id(e2)}) == 3 and len(an.engine_cache) == 3
    assert (e0.use_kernels, e0.schedule) == (True, "bucketed")
    assert (e1.use_kernels, e1.schedule) == (False, "bucketed")
    assert (e2.use_kernels, e2.schedule) == (True, "unrolled")
    assert torch_repeated_engine(an, schedule="unrolled") is e2
    with pytest.raises(ValueError, match="schedule"):
        torch_repeated_engine(an, schedule="levels")
