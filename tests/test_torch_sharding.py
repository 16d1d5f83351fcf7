"""The split of the system batch K over devices (``HyluOptions.mesh``), the
port's counterpart of the JAX package's shard over a 1-D mesh, on the CPU.

Mirrors ``tests/test_sharding.py`` case by case.  The CPU stands for as
many devices as a mesh names (``["cpu"] * 4``), as the JAX tests force
virtual CPU devices.  Every system's arithmetic is its own and the CPU's
scatter-adds are deterministic, so a split run must be bit-identical to
the port's unsplit run; against the JAX package's unsharded run x and the
residuals agree to 1e-10, with equal pivots, perturbation counts and
refinement counts.  K = 5 divides no shard count above one: the last
shards are padded with system 0 and zero right-hand sides.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import HyluOptions as JaxOptions  # noqa: E402
from repro.core import analyze as jax_analyze  # noqa: E402
from repro.core.api import (factor_batched as jax_factor_batched,  # noqa: E402
                            solve_batched as jax_solve_batched)
from repro_torch.core import (CSR, HyluOptions, analyze,  # noqa: E402
                              factor_batched, solve_batched, solve_sequence,
                              torch_repeated_engine)
from repro_torch.core.api import _solve_batched_hostloop  # noqa: E402
from repro_torch.launch.mesh import BATCH_AXIS, make_solver_mesh  # noqa: E402

from tests.helpers import scenario_system  # noqa: E402

K = 5            # deliberately not divisible by any multi-device count
N = 36
SCENARIOS_RUN = ["circuit", "banded"]
TOL = 1e-10
MESHES = {"1": 1, "cpu_x2": ["cpu"] * 2, "cpu_x4": ["cpu"] * 4, "int_2": 2}


def _case(scenario, k=K, seed=3):
    aj, _, _, _ = scenario_system(scenario, n=N, seed=seed)
    at = CSR(aj.n, aj.indptr, aj.indices, aj.data)
    rng = np.random.default_rng(seed + 10)
    vb = aj.data[None, :] * rng.uniform(0.9, 1.1, (k, aj.nnz))
    bb = rng.normal(size=(k, aj.n))
    return aj, at, vb, bb


def _opts(mesh=None, **kw):
    return HyluOptions(device="cpu", mesh=mesh, **kw)


def _solve(at, vb, bb, opts):
    an = analyze(at, opts)
    bst = factor_batched(an, at, vb)
    x, info = solve_batched(bst, bb)
    return x, info, bst


def _seeded(at, steps):
    """The pattern with system 0 of step 0's values: the matrix the
    sequence pipeline analyses."""
    return CSR(at.n, at.indptr, at.indices, np.asarray(steps[0][0]))


def _inode(bst):
    return bst.inode_perm.numpy()


def _same(x, info, x0, info0):
    """Bit-identical solutions and per-system reports."""
    assert np.array_equal(x, x0)
    for key in ("residual", "n_refine_per_system", "refine_failed",
                "refine_stalled", "n_perturb", "fallback_mask"):
        assert np.array_equal(info[key], info0[key]), key
    assert info["n_refine"] == info0["n_refine"]


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's unsharded run of each scenario."""
    out = {}
    for scenario in SCENARIOS_RUN:
        aj, _, vb, bb = _case(scenario)
        an = jax_analyze(aj, JaxOptions(engine="jax"))
        bst = jax_factor_batched(an, aj, vb)
        out[scenario] = (bst,) + jax_solve_batched(bst, bb)
    return out


@pytest.mark.parametrize("scenario", SCENARIOS_RUN)
def test_one_device_mesh_equals_unsharded(scenario, jax_runs):
    """mesh=1 routes through the split and its padding but equals the
    unsplit run bit for bit, and the JAX package's to 1e-10."""
    _, at, vb, bb = _case(scenario)
    x0, info0, _ = _solve(at, vb, bb, _opts())
    x1, info1, bst1 = _solve(at, vb, bb, _opts(1))
    assert bst1.k == K and bst1.k_pad == K and len(bst1.shards) == 1
    _same(x1, info1, x0, info0)
    bst_j, x_j, info_j = jax_runs[scenario]
    assert np.abs(x1 - np.asarray(x_j)).max() < TOL
    np.testing.assert_allclose(info1["residual"], info_j["residual"],
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("mesh", ["cpu_x2", "cpu_x4", "int_2"])
@pytest.mark.parametrize("scenario", SCENARIOS_RUN)
def test_split_matches_unsplit_and_jax(scenario, mesh, jax_runs):
    """K = 5 on two and four shards: padded to a multiple of the shard
    count, bit-identical to the unsplit port run, within 1e-10 of the JAX
    package's unsharded run with equal pivots and counts."""
    _, at, vb, bb = _case(scenario)
    x0, info0, bst0 = _solve(at, vb, bb, _opts())
    x, info, bst = _solve(at, vb, bb, _opts(MESHES[mesh]))
    nd = len(bst.shards)
    assert nd == (4 if mesh == "cpu_x4" else 2)
    assert bst.k == K and bst.k_pad % nd == 0 and bst.k_pad >= K
    assert x.shape == x0.shape
    _same(x, info, x0, info0)
    assert np.array_equal(_inode(bst), _inode(bst0))
    bst_j, x_j, info_j = jax_runs[scenario]
    assert np.array_equal(_inode(bst), np.asarray(bst_j.inode_perm))
    assert np.array_equal(bst.n_perturb, np.asarray(bst_j.n_perturb))
    assert np.abs(x - np.asarray(x_j)).max() < TOL
    np.testing.assert_allclose(info["residual"], info_j["residual"],
                               rtol=0, atol=TOL)
    assert np.array_equal(info["n_refine_per_system"],
                          np.asarray(info_j["n_refine_per_system"]))
    # the shards on one device share its engine
    an = bst.analysis
    assert len(an.engine_cache) == 1
    assert torch_repeated_engine(an) is torch_repeated_engine(
        an, device=bst.shards[1].device)


@pytest.mark.parametrize("mesh", ["1", "cpu_x2"])
def test_multirhs_and_hostloop_oracle(mesh):
    _, at, vb, _ = _case("circuit")
    bm = np.random.default_rng(0).normal(size=(K, at.n, 3))
    x0, _, _ = _solve(at, vb, bm, _opts())
    x1, info1, bst1 = _solve(at, vb, bm, _opts(MESHES[mesh]))
    assert x1.shape == (K, at.n, 3) and info1["residual"].shape == (K, 3)
    assert np.array_equal(x1, x0)
    # the host-loop oracle cuts the padding off and agrees too
    xh, ih = _solve_batched_hostloop(bst1, bm)
    assert xh.shape == (K, at.n, 3)
    np.testing.assert_allclose(xh, x1, rtol=0, atol=TOL)
    xh0, ih0 = _solve_batched_hostloop(factor_batched(
        analyze(at, _opts()), at, vb), bm)
    assert np.array_equal(xh, xh0)
    assert ih["n_refine"] == ih0["n_refine"]


def test_device_buffer_input_no_reupload():
    """A tensor already on the shards' device is read in place: every
    full shard's staged values are a view of the caller's buffer (only the
    padded last shard is a copy), and the host oracle round-trips."""
    _, at, vb, bb = _case("circuit", k=6)
    an = analyze(at, _opts(["cpu"] * 2))
    vdev = torch.from_numpy(vb)
    bst = factor_batched(an, at, vdev)
    base = vdev.untyped_storage().data_ptr()
    for i, p in enumerate(bst.shards):
        assert p.values_dev.untyped_storage().data_ptr() == base
        assert p.values_dev.data_ptr() == vdev[3 * i:].data_ptr()
        assert p.values_host is None
    assert bst._values_host is None
    x, _ = solve_batched(bst, torch.from_numpy(bb))
    x0, _ = solve_batched(factor_batched(analyze(at, _opts()), at, vb), bb)
    assert np.array_equal(x, x0)
    np.testing.assert_array_equal(bst.values_batch, vb)
    _, at, vb5, _ = _case("circuit")             # K = 5: the last shard
    v5 = torch.from_numpy(vb5)                   # is padded, a copy
    bst5 = factor_batched(an, at, v5)
    assert bst5.shards[0].values_dev.data_ptr() == v5.data_ptr()
    assert bst5.shards[1].values_dev.untyped_storage().data_ptr() != \
        v5.untyped_storage().data_ptr()
    assert [p.k for p in bst5.shards] == [3, 3] and bst5.k_pad == 6


def test_donating_solve_consumes_state():
    _, at, vb, bb = _case("circuit")
    an = analyze(at, _opts(["cpu"] * 2))
    x0, _ = solve_batched(factor_batched(an, at, vb), bb)
    bst = factor_batched(an, at, vb)
    xd, _ = solve_batched(bst, bb, donate=True)
    assert np.array_equal(xd, x0)
    assert bst.consumed and all(p.values_dev is None for p in bst.shards)
    with pytest.raises(RuntimeError, match="consumed"):
        solve_batched(bst, bb)
    np.testing.assert_array_equal(bst.values_batch, vb)


@pytest.mark.parametrize("donate", [False, True])
def test_sequence_pipeline_matches_per_step_solves(donate):
    """The double-buffered T-step pipeline split over two shards, with and
    without donation, against T unsplit factor_batched + solve_batched
    calls, bit for bit."""
    _, at, vb, bb = _case("circuit")
    rng = np.random.default_rng(5)
    steps = [at.data[None, :] * rng.uniform(0.9, 1.1, (K, at.nnz))
             for _ in range(4)]
    xs, info = solve_sequence(at, steps, bb, _opts(["cpu"] * 2,
                                                   donate=donate))
    assert xs.shape == (4, K, at.n)
    assert info["steps"] == 4 and info["k"] == K
    assert info["n_perturb"].shape == (4, K)
    an = analyze(_seeded(at, steps), _opts())    # the pipeline's analysis
    for t, vt in enumerate(steps):
        xt, it = solve_batched(factor_batched(an, at, vt), bb)
        assert np.array_equal(xs[t], xt)
        assert np.array_equal(info["residual"][t], it["residual"])
        assert info["n_refine"][t] == it["n_refine"]


def test_sequence_per_step_rhs_and_stacked_values():
    _, at, vb, bb = _case("circuit")
    rng = np.random.default_rng(6)
    steps = np.stack([at.data[None, :] * rng.uniform(0.9, 1.1, (K, at.nnz))
                      for _ in range(3)])            # (T, K, nnz) stacked
    bs = [rng.normal(size=(K, at.n)) for _ in range(3)]
    xs, info = solve_sequence(at, steps, bs, _opts(4))
    an = analyze(_seeded(at, steps), _opts())
    for t in range(3):
        xt, _ = solve_batched(factor_batched(an, at, steps[t]), bs[t])
        assert np.array_equal(xs[t], xt)
    with pytest.raises(ValueError, match="per-step right-hand sides"):
        solve_sequence(at, steps, bs[:2], _opts(4))


def test_sequence_donate_shared_device_rhs():
    """A right-hand-side tensor shared by every step survives donation
    under the split: each step stages copies of its shards."""
    _, at, vb, bb = _case("circuit")
    rng = np.random.default_rng(8)
    steps = [at.data[None, :] * rng.uniform(0.9, 1.1, (K, at.nnz))
             for _ in range(3)]
    b_dev = torch.from_numpy(bb.copy())
    xs, _ = solve_sequence(at, steps, b_dev, _opts(2, donate=True))
    xs0, _ = solve_sequence(at, steps, bb, _opts())
    assert np.array_equal(xs, xs0)
    np.testing.assert_array_equal(b_dev.numpy(), bb)  # caller's b intact


def test_wrong_batch_size_rhs_raises():
    """A mis-sized RHS batch raises under the split, not zero-padded."""
    _, at, vb, bb = _case("circuit")
    bst = factor_batched(analyze(at, _opts(2)), at, vb)
    with pytest.raises(ValueError, match="batch size"):
        solve_batched(bst, bb[: K - 2])
    with pytest.raises(ValueError, match="batch size"):
        _solve_batched_hostloop(bst, bb[: K - 2])


def test_list_of_1d_value_sets_is_one_batched_step():
    _, at, vb, bb = _case("circuit")
    x_list, _ = solve_sequence(at, [vb[i] for i in range(K)], bb, _opts(2))
    assert x_list.shape == (K, at.n)
    x_arr, _ = solve_sequence(at, vb, bb, _opts())
    assert np.array_equal(x_list, x_arr)


def test_mesh_option_validation():
    """mirrors test_mesh_option_validation: a mesh that is no device count
    or device list raises TypeError; more CUDA devices than are visible
    raise ValueError; the mesh is runtime-only."""
    from repro_torch.core.options import plan_fingerprint, resolve_mesh

    _, at, vb, bb = _case("circuit")
    with pytest.raises(TypeError, match="mesh must be"):
        _solve(at, vb, bb, _opts("four"))
    with pytest.raises(TypeError, match="mesh must be"):
        resolve_mesh(_opts(2.5))
    with pytest.raises(ValueError, match="empty"):
        resolve_mesh(_opts([]))
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_mesh(_opts(["cpu", "meta"]))
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="one device type"):
            resolve_mesh(_opts(["cpu", "cuda:0"]))
    with pytest.raises(ValueError, match="at least one"):
        resolve_mesh(_opts(0))
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="visible"):
        resolve_mesh(HyluOptions(mesh=visible + 1))
    with pytest.raises(ValueError, match="visible"):
        make_solver_mesh(visible + 1)
    assert BATCH_AXIS == "systems"
    assert resolve_mesh(_opts(3)) == (torch.device("cpu"),) * 3
    assert resolve_mesh(_opts()) is None
    assert plan_fingerprint(at, _opts(["cpu"] * 2)) == plan_fingerprint(
        at, _opts())


def test_serve_cli_with_devices_matches_unsplit(capsys):
    """The serve CLI with ``--device cpu --devices 2`` on a small
    fault-laced stream: the same statuses and counts as without the
    split, and the contract holds."""
    from repro_torch.launch import serve

    reports = {}
    for devices in (None, 2):
        argv = ["--requests", "24", "--device", "cpu", "--n", "24",
                "--seed", "3"]
        if devices:
            argv += ["--devices", str(devices)]
        args = serve.build_parser().parse_args(argv)
        import asyncio

        reports[devices] = asyncio.run(serve._serve_and_drive(args))
        assert serve.main(argv) == 0
    r0, r2 = reports[None], reports[2]
    assert r2["mesh"] == ["cpu", "cpu"] and r0["mesh"] is None
    assert r2["by_status"] == r0["by_status"]
    assert r2["lost"] == r0["lost"] == 0
    assert "K split over" in capsys.readouterr().out


def _spy_launches_and_reads(monkeypatch) -> list:
    """Record, in order, each shard's refactor and each substitution of a
    refinement iteration (keyed by the factor tensor it reads and the
    refactors seen so far), and every host read of a tensor."""
    from repro_torch.core.torch_engine import RepeatedSolveEngine

    ev = []
    refactor = RepeatedSolveEngine.refactor_batched
    apply_b = RepeatedSolveEngine.apply_batched

    def spy_refactor(self, *a, **kw):
        ev.append(("factor", None))
        return refactor(self, *a, **kw)

    def spy_apply(self, vals, *a, **kw):
        n_fact = sum(e[0] == "factor" for e in ev)
        ev.append(("apply", (vals.data_ptr(), n_fact)))
        return apply_b(self, vals, *a, **kw)

    monkeypatch.setattr(RepeatedSolveEngine, "refactor_batched", spy_refactor)
    monkeypatch.setattr(RepeatedSolveEngine, "apply_batched", spy_apply)
    for name in ("cpu", "numpy", "item", "tolist", "__bool__"):
        def read(self, *a, _orig=getattr(torch.Tensor, name), **kw):
            ev.append(("read", None))
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, read)
    return ev


def _no_read_between_shards(ev, n_shards):
    """Every group of n_shards refactors, and every round of the shards'
    substitutions (the i-th of each shard's loop), falls between two host
    reads; returns the number of rounds in which more than one shard
    substituted."""
    reads = [i for i, e in enumerate(ev) if e[0] == "read"]

    def clear(a, b):
        return not any(a < r < b for r in reads)

    facts = [i for i, e in enumerate(ev) if e[0] == "factor"]
    assert facts and len(facts) % n_shards == 0
    for j in range(0, len(facts), n_shards):
        assert clear(facts[j], facts[j + n_shards - 1]), ev
    seen, rounds = {}, {}
    for i, (kind, key) in enumerate(ev):
        if kind == "apply":
            seen[key] = seen.get(key, -1) + 1
            rounds.setdefault((key[1], seen[key]), []).append(i)
    for pos in rounds.values():
        assert clear(min(pos), max(pos)), ev
    return sum(len(pos) > 1 for pos in rounds.values())


@pytest.mark.parametrize("path", ["solve", "hostloop", "pipeline"])
def test_split_shards_queue_before_any_host_read(path, monkeypatch):
    """No host read falls between two shards' launches: every shard's
    refactor is queued before a perturbation count is read, and each
    refinement iteration (each host-loop substitution) of every live
    shard is queued before any loop flag (any x) is read.  float32
    factors refined in float64, so the loops run several iterations; the
    results stay bit-identical to the unsplit run."""
    _, at, vb, bb = _case("banded")
    kw = dict(factor_dtype="float32", fp64_fallback=False)
    an0 = analyze(at, _opts(**kw))
    if path == "pipeline":
        steps = [vb, vb * 1.01]
        x0, i0 = solve_sequence(at, steps, bb, _opts(**kw))
    else:
        solve = solve_batched if path == "solve" else _solve_batched_hostloop
        x0, i0 = solve(factor_batched(an0, at, vb), bb)
    assert np.max(i0["n_refine"]) >= 1
    mesh = ["cpu"] * 2
    ev = _spy_launches_and_reads(monkeypatch)
    if path == "pipeline":
        x, info = solve_sequence(at, steps, bb, _opts(mesh=mesh, **kw))
    else:
        an = analyze(at, _opts(mesh=mesh, **kw), reuse=an0)
        x, info = solve(factor_batched(an, at, vb), bb)
    monkeypatch.undo()
    assert _no_read_between_shards(ev, 2) >= 2
    assert np.array_equal(x, x0)
    assert np.array_equal(info["residual"], i0["residual"])
