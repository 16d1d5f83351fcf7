"""The paper's §4 comparison in the port, against the JAX package.

The baseline presets (``repro_torch.core.baselines``), the host-side
oracles ``_batched_matvec`` and ``_solve_batched_hostloop``, and plans
with supernodes of more than 128 rows (what ``pardiso_like``'s
``max_super = 256`` produces), on the CPU: the port with ``device="cpu"``
(its kernel wrappers run their plain versions), the JAX package with
``engine="jax"``, Pallas in interpret mode where the pair is the kernel
route.  Inputs are made with numpy from fixed seeds.

Tolerances: 1e-10 in float64 on factors, solutions and residuals (the two
packages sum in other orders), with equal pivot permutations,
perturbation counts, refinement counts and failure masks; float32
solutions refined in float32 to 1e-4.  ``_batched_matvec`` is the same
numpy code in both packages, so it is held to bit-identity.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

torch = pytest.importorskip("torch")

from repro.core import CSR as JaxCSR, HyluOptions as JaxOptions  # noqa: E402
from repro.core import baselines as jax_baselines  # noqa: E402
from repro.core import (analyze as jax_analyze, factor as jax_factor,  # noqa: E402
                        solve as jax_solve, plan_fingerprint as jax_fingerprint)
from repro.core.api import (factor_batched as jax_factor_batched,  # noqa: E402
                            solve_batched as jax_solve_batched,
                            _batched_matvec as jax_batched_matvec,
                            _solve_batched_hostloop as jax_hostloop)
from repro_torch import kernels  # noqa: E402
from repro_torch.core import (CSR, HyluOptions, analyze, baselines,  # noqa: E402
                              factor, factor_batched, plan_fingerprint,
                              solve, solve_batched, torch_repeated_engine)
from repro_torch.core.api import (_batched_matvec,  # noqa: E402
                                  _solve_batched_hostloop)
from repro_torch.core.options import PLAN_OPTION_FIELDS  # noqa: E402
from repro_torch.kernels.supsup import ops as supsup  # noqa: E402

from tests.helpers import (empty_row_pattern, random_system,  # noqa: E402
                           scenario_system)

TOL = 1e-10
TOL32 = 1e-4
K = 3
PRESETS = sorted(baselines.BASELINES)


def _rel(x, ref):
    return np.abs(np.asarray(x) - np.asarray(ref)).max() / (
        np.abs(np.asarray(ref)).max() + 1e-300)


def _both(a):
    """One scipy matrix as (JAX CSR, port CSR)."""
    a = a.tocsr()
    a.sort_indices()
    aj = JaxCSR.from_scipy(a)
    return aj, CSR(aj.n, aj.indptr, aj.indices, aj.data)


# ---------------------------------------------------------------- presets
@pytest.mark.parametrize("name", PRESETS)
def test_preset_equals_the_jax_preset(name):
    """Every field the two option types share has the JAX preset's value,
    and the plan fingerprints agree, ``use_kernels`` standing for
    ``use_pallas``; keyword arguments pass through."""
    port, ref = baselines.BASELINES[name](), jax_baselines.BASELINES[name]()
    shared = ({f.name for f in dataclasses.fields(port)}
              & {f.name for f in dataclasses.fields(ref)}) - {"engine"}
    assert set(PLAN_OPTION_FIELDS) - {"use_kernels"} <= shared
    for field in sorted(shared):
        assert getattr(port, field) == getattr(ref, field), field
    aj, at = _both(random_system(40, 0.1, 3)[1])
    assert plan_fingerprint(at, port) == jax_fingerprint(
        aj, jax_baselines.BASELINES[name](use_pallas=True))
    assert plan_fingerprint(
        at, baselines.BASELINES[name](use_kernels=False)) \
        == jax_fingerprint(aj, ref)
    opts = baselines.BASELINES[name](device="cpu", factor_dtype="float32")
    assert (opts.device, opts.factor_dtype) == ("cpu", "float32")
    assert opts.force_mode == ref.force_mode


def test_pardiso_like_keeps_an_explicit_relax():
    opts = baselines.pardiso_like_options(relax=4, max_super=64)
    assert (opts.relax, opts.max_super, opts.force_mode) == (4, 64,
                                                             "supernodal")


@pytest.fixture(scope="module")
def preset_system():
    _, a_sp, b = random_system(90, 0.06, 17)
    return _both(a_sp) + (a_sp, b)


@pytest.mark.parametrize("name", PRESETS)
def test_preset_solve_matches_jax(name, preset_system):
    """analyze → factor → solve under each preset through both packages
    (the port's kernel route against Pallas in interpret mode), as
    ``tests/test_solver.py::test_baseline_presets`` runs the JAX presets:
    factors, pivots, perturbation and refinement counts, the solution and
    ``spsolve``."""
    aj, at, a_sp, b = preset_system
    an_j = jax_analyze(aj, jax_baselines.BASELINES[name](
        engine="jax", use_pallas=True))
    an_t = analyze(at, baselines.BASELINES[name](device="cpu"))
    assert an_t.choice.mode == an_j.choice.mode
    st_j, st_t = jax_factor(an_j, aj), factor(an_t, at)
    jf, tf = st_j.jax_factors, st_t.torch_factors
    assert np.array_equal(tf.inode_perm.numpy(), np.asarray(jf.inode_perm))
    assert int(tf.n_perturb) == int(jf.n_perturb)
    np.testing.assert_allclose(tf.vals.numpy(), np.asarray(jf.vals),
                               rtol=TOL, atol=TOL)
    (x_j, info_j), (x_t, info_t) = jax_solve(st_j, b), solve(st_t, b)
    assert _rel(x_t, x_j) < TOL
    assert info_t["residual"] < 1e-9
    for key in ("n_refine", "n_perturb", "refine_failed"):
        assert info_t[key] == info_j[key], key
    assert _rel(x_t, spla.spsolve(a_sp.tocsc(), b)) < TOL


# ---------------------------------------------------------- host matvec
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batched_matvec_matches_jax(dtype):
    """The host matvec of both packages on a pattern with empty rows
    (the scatter-add branch) and on one without (``reduceat``), one and
    several right-hand sides: bit-identical, dtype kept, empty rows 0."""
    rng = np.random.default_rng(9)
    indptr, indices = empty_row_pattern(n=9, seed=2)[:2]
    full = random_system(12, 0.3, 4)[0]
    for pat, n in (((indptr, indices), 9), ((full.indptr, full.indices),
                                             12)):
        vals = rng.normal(size=(K, len(pat[1]))).astype(dtype)
        for shape in ((K, n), (K, n, 4)):
            x = rng.normal(size=shape).astype(dtype)
            got = _batched_matvec(pat, vals, x)
            ref = jax_batched_matvec(pat, vals, x)
            assert got.dtype == dtype and got.shape == shape
            assert np.array_equal(got, ref)
    empty = np.where(np.diff(indptr) == 0)[0]
    assert len(empty)
    out = _batched_matvec((indptr, indices),
                          rng.normal(size=(2, len(indices))),
                          rng.normal(size=(2, 9)))
    assert np.all(out[:, empty] == 0.0)


# --------------------------------------------------------- host-loop solve
def _value_sets(a, k, seed):
    return a.data[None, :] * np.random.default_rng(seed).uniform(
        0.8, 1.2, (k, a.nnz))


HOSTLOOP_CASES = {
    # name: (scenario, kernel mode, factor dtype, refine dtype, rhs columns)
    "banded_f64": ("banded", "hybrid", "float64", "auto", None),
    "banded_multi_rhs": ("banded", "hybrid", "float64", "auto", 3),
    "circuit_rowrow": ("circuit", "rowrow", "float64", "auto", None),
    "banded_f32_refined_f64": ("banded", "hybrid", "float32", "auto", None),
    "circuit_f32_refined_f32": ("circuit", "hybrid", "float32", "float32",
                                None),
}


@pytest.fixture(scope="module")
def hostloop_runs():
    cache = {}

    def get(name):
        if name not in cache:
            scen, mode, fdt, rdt, m = HOSTLOOP_CASES[name]
            aj_, a_sp, _, _ = scenario_system(scen, n=30, seed=3)
            aj, at = _both(a_sp)
            vb = _value_sets(aj, K, 7)
            rng = np.random.default_rng(17)
            bb = rng.normal(size=(K, aj.n) if m is None else (K, aj.n, m))
            kw = dict(force_mode=mode, factor_dtype=fdt, refine_dtype=rdt)
            bst_j = jax_factor_batched(jax_analyze(aj, JaxOptions(
                engine="jax", use_pallas=True, **kw)), aj, vb)
            bst_t = factor_batched(analyze(at, HyluOptions(device="cpu",
                                                            **kw)), at, vb)
            cache[name] = (bst_t, bb, jax_hostloop(bst_j, bb),
                           _solve_batched_hostloop(bst_t, bb),
                           solve_batched(bst_t, bb))
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(HOSTLOOP_CASES))
def test_hostloop_matches_jax_and_the_fused_solve(name, hostloop_runs):
    """The port's host loop against the JAX package's host loop and the
    port's fused solve (``tests/test_fused_solve.py``,
    ``tests/test_mixed_precision.py::test_hostloop_oracle_mixed_parity``):
    x within 1e-10 (1e-4 refined in float32), equal refinement counts,
    failure and stall masks, residuals and dtypes; float32 factors
    refined in float64 engage refinement."""
    bst, bb, (x_j, info_j), (x_h, info_h), (x_f, info_f) = hostloop_runs(
        name)
    fdt, rdt = HOSTLOOP_CASES[name][2:4]
    tol = TOL32 if rdt == "float32" else TOL
    assert x_h.shape == bb.shape == x_f.shape
    assert x_h.dtype == (np.float32 if rdt == "float32" else np.float64)
    assert set(info_h) == {"residual", "n_refine", "n_perturb",
                           "refine_failed", "refine_stalled", "solve_time"}
    for x_other in (x_j, x_f):
        assert _rel(x_h, x_other) < tol
    assert info_h["n_refine"] == info_j["n_refine"] == info_f["n_refine"]
    if fdt == "float32" and rdt == "auto":
        assert info_h["n_refine"] >= 1
    for key in ("refine_failed", "refine_stalled"):
        assert np.array_equal(info_h[key], info_j[key]), key
        assert np.array_equal(info_h[key], info_f[key]), key
    assert not info_h["refine_failed"].any()
    assert info_h["residual"].shape == info_f["residual"].shape
    assert np.abs(info_h["residual"] - info_j["residual"]).max() < tol
    assert np.array_equal(info_h["n_perturb"], bst.n_perturb)


def test_hostloop_refine_false_and_broadcast_rhs(hostloop_runs):
    bst, bb = hostloop_runs("banded_f64")[:2]
    x0, info0 = _solve_batched_hostloop(bst, bb, refine=False)
    assert info0["n_refine"] == 0 and not info0["refine_failed"].any()
    xb, infob = _solve_batched_hostloop(bst, bb[0])
    xf, _ = solve_batched(bst, bb[0])
    assert xb.shape == (K, bst.analysis.n)
    assert _rel(xb, xf) < TOL and infob["residual"].max() < TOL


def test_hostloop_refinement_engaged_at_zero_tolerance(hostloop_runs):
    """refine_tol = 0 makes both loops iterate until they stall; their
    accept / reject decisions sit at the round-off floor, so, as
    ``tests/test_fused_solve.py::test_refinement_engaged_parity`` holds
    the JAX pair, both must iterate and land on the same solution."""
    bst, bb = hostloop_runs("circuit_rowrow")[:2]
    opts = bst.analysis.opts
    saved, opts.refine_tol = opts.refine_tol, 0.0
    try:
        xf, inff = solve_batched(bst, bb, refine=True)
        xh, infh = _solve_batched_hostloop(bst, bb, refine=True)
    finally:
        opts.refine_tol = saved
    assert inff["n_refine"] >= 1 and infh["n_refine"] >= 1
    assert _rel(xf, xh) < 1e-12
    assert max(inff["residual"].max(), infh["residual"].max()) < 1e-12


# ------------------------------------------- supernodes over 128 rows
def _wide_source_system(n=200, blk=140, cpl=20, seed=6):
    """A dense 140-row block coupled to the next 20 rows and a sparse
    remainder: under natural ordering a 140-row supernode that is a panel
    bucket of its own (padded to 256 rows) and the source of sup-sup
    edges (k = 140, padded to 256)."""
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


def _wide_root_system(n=200, blk=160, seed=5):
    """A dense 160-row block in a sparse matrix: under the default
    orderings the root supernode (160 rows, factored per node at a narrow
    level) and a 160-row block of the node-block substitution."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=0.02,
                  random_state=np.random.RandomState(seed), format="lil")
    a[20:20 + blk, 20:20 + blk] = rng.normal(size=(blk, blk))
    diag = rng.uniform(1.0, 2.0, n) * rng.choice([-1, 1], n) * 4
    return (a.tocsr() + sp.diags(diag)).tocsr()


WIDE = {"wide_source": (_wide_source_system,
                        dict(orderings=("natural",), bulk_min_width=2)),
        "wide_root": (_wide_root_system, {})}


@pytest.fixture(scope="module")
def wide_cases():
    out = {}
    for name, (make, kw) in WIDE.items():
        a = make()
        aj, at = _both(a)
        vb = _value_sets(aj, K, 11)
        bb = np.random.default_rng(13).normal(size=(K, aj.n))
        out[name] = (a, aj, at, vb, bb, kw)
    return out


def test_wide_plans_reach_every_wide_path(wide_cases):
    """Between them: a panel bucket and a narrow-level node of more than
    128 rows, a sup-sup edge whose source has more than 128 rows, and a
    node-block of more than 128 rows."""
    seen = set()
    for a, aj, at, vb, bb, kw in wide_cases.values():
        an = analyze(at, baselines.pardiso_like_options(device="cpu", **kw))
        eng = torch_repeated_engine(an)
        nodes = an.plan.nodes
        for step in eng.sched.steps:
            seen |= {"bucket"} if any(p.nr > 128 for p in step.panels) \
                else set()
            seen |= {"seq"} if any(nodes[int(t)].nr > 128
                                   for t in step.seq) else set()
            seen |= {"edge"} if any(e.k > 128 for e in step.edges) else set()
        seen |= {"block"} if any(b.nr > 128 for b in eng.ss.blocks) \
            else set()
    assert seen == {"bucket", "seq", "edge", "block"}


@pytest.mark.parametrize("schedule", ["bucketed", "unrolled"])
@pytest.mark.parametrize("name", sorted(WIDE))
def test_wide_plan_lifecycle_matches_jax(name, schedule, wide_cases):
    """analyze → factor → solve of one system under ``pardiso_like``
    through both packages (the port's kernel route, its plain versions on
    the CPU): equal pivots and perturbation counts, factors, solution and
    residual within 1e-10, and no launch.  The JAX side runs Pallas in
    interpret mode under the same schedule, except for the unrolled
    schedule on the 140-row edge source: there the reference's Pallas GEMM
    (``src/repro/kernels/supsup/kernel.py``, ``gemm_update``) reads a
    second 128-deep k tile past the padded k = 144 and returns NaN
    (ROADMAP.md, Queue C, reference faults), and its plain route's
    unrolled trace compiles for about 110 s on the CPU.  The plan, and so
    the factors, are the same under both schedules, so there the port's
    unrolled run is held to the JAX bucketed run."""
    jax_schedule = ("bucketed" if (schedule, name) == ("unrolled",
                                                       "wide_source")
                    else schedule)
    a, aj, at, vb, bb, kw = wide_cases[name]
    b = bb[0]
    an_j = jax_analyze(aj, jax_baselines.pardiso_like_options(
        engine="jax", use_pallas=True, factor_schedule=jax_schedule, **kw))
    an_t = analyze(at, baselines.pardiso_like_options(
        device="cpu", factor_schedule=schedule, **kw))
    assert max(nd.nr for nd in an_t.plan.nodes) > 128
    kernels.reset_launch_counts()
    st_j, st_t = jax_factor(an_j, aj), factor(an_t, at)
    jf, tf = st_j.jax_factors, st_t.torch_factors
    assert np.array_equal(tf.inode_perm.numpy(), np.asarray(jf.inode_perm))
    assert int(tf.n_perturb) == int(jf.n_perturb)
    np.testing.assert_allclose(tf.vals.numpy(), np.asarray(jf.vals),
                               rtol=TOL, atol=TOL)
    (x_j, info_j), (x_t, info_t) = jax_solve(st_j, b), solve(st_t, b)
    assert not any(kernels.launch_counts().values())
    assert _rel(x_t, x_j) < TOL
    assert abs(info_t["residual"] - info_j["residual"]) < TOL
    assert info_t["residual"] < TOL
    assert _rel(x_t, spla.spsolve(a.tocsc(), b)) < TOL


@pytest.mark.parametrize("name", sorted(WIDE))
def test_wide_plan_batched_matches_jax(name, wide_cases):
    """factor_batched → solve_batched (the node-block substitution, with
    its blocked left solves above 128 rows) and the host loop under
    ``pardiso_like``, against the JAX package's batched path."""
    a, aj, at, vb, bb, kw = wide_cases[name]
    bst_j = jax_factor_batched(jax_analyze(aj, jax_baselines.
                                           pardiso_like_options(
                                               engine="jax", use_pallas=True,
                                               **kw)), aj, vb)
    bst_t = factor_batched(analyze(at, baselines.pardiso_like_options(
        device="cpu", **kw)), at, vb)
    assert torch.equal(bst_t.inode_perm,
                       torch.from_numpy(np.array(bst_j.inode_perm)[:K]))
    assert np.array_equal(bst_t.n_perturb, np.asarray(bst_j.n_perturb))
    (x_j, info_j), (x_t, info_t) = (jax_solve_batched(bst_j, bb),
                                    solve_batched(bst_t, bb))
    x_h, info_h = _solve_batched_hostloop(bst_t, bb)
    for x in (x_t, x_h):
        assert _rel(x, x_j) < TOL
    assert info_t["n_refine"] == info_h["n_refine"] == info_j["n_refine"]
    assert max(info_t["residual"].max(), info_h["residual"].max()) < TOL


# ----------------------------------- the unrolled schedule, wide sources
def test_unrolled_on_cuda_refuses_wide_edge_sources(wide_cases):
    """The refusal this test once held is gone: K5's node step takes edge
    sources of any rows (over 128, its wide instance, chosen per node by
    the rows of the node's widest source).  The edge table takes sources
    of 140 and 300 rows; the unrolled engine marks exactly the nodes with
    a source over 128 rows for the wide instance; and its batched factor
    of ``pardiso_like``'s 140-row plan (the plain node step on the CPU)
    matches the JAX bucketed run of the same plan to 1e-10 with equal
    pivots and perturbation counts (the JAX unrolled Pallas route returns
    NaN there: ROADMAP.md, Queue C, reference faults)."""
    rng = np.random.default_rng(2)
    for k in (140, 300):
        cm = np.sort(rng.choice(k + 40, size=k + 9, replace=False))
        table = supsup.edge_table([(0, k, k + 9, 0, cm)], "cpu")
        assert table.desc[0, 2] == k and table.edges[0][1] == k
        assert supsup.node_step(0, 2, k + 40, 0, 0, 1, k).kmax == k
    a, aj, at, vb, bb, kw = wide_cases["wide_source"]
    an = analyze(at, baselines.pardiso_like_options(
        device="cpu", factor_schedule="unrolled", **kw))
    eng = torch_repeated_engine(an)
    nodes = an.plan.nodes
    wide = [nd.nid for nd in nodes
            if any(nodes[e.src].nr > 128 for e in nd.edges)]
    assert wide and [t for t, (_, st) in enumerate(eng._nodes)
                     if st.kmax > supsup.WIDE_K] == wide
    an_j = jax_analyze(aj, jax_baselines.pardiso_like_options(
        engine="jax", use_pallas=True, **kw))
    bst_j = jax_factor_batched(an_j, aj, vb)
    kernels.reset_launch_counts()
    bst_t = factor_batched(an, at, vb)
    assert not any(kernels.launch_counts().values())
    assert torch.equal(bst_t.inode_perm,
                       torch.from_numpy(np.array(bst_j.inode_perm)[:K]))
    assert np.array_equal(bst_t.n_perturb, np.asarray(bst_j.n_perturb))
    np.testing.assert_allclose(bst_t.vals.numpy(),
                               np.asarray(bst_j.vals)[:K], rtol=TOL, atol=TOL)
