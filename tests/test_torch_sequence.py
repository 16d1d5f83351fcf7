"""Buffer donation and the T-step ``solve_sequence`` pipeline of the port.

``solve_batched(donate=True)``, ``BatchedFactorState.consumed``,
``refactor_batched(out=)`` and the double-buffered, optionally donating
pipeline behind ``solve_sequence`` on the CPU (``device="cpu"``, the
kernels' plain versions): against the port's own per-step
``factor_batched`` + ``solve_batched`` (bit for bit: the same operations
on the same staged values) and against the JAX package's
``solve_sequence(..., HyluOptions(donate=...))`` at 1e-10 with equal
refinement counts, perturbation counts and failure masks.  Inputs are
made with numpy from fixed seeds.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from repro.core import CSR as JaxCSR, HyluOptions as JaxOptions  # noqa: E402
from repro.core.api import solve_sequence as jax_solve_sequence  # noqa: E402
from repro_torch.core import (CSR, HyluOptions, analyze,  # noqa: E402
                              factor_batched, plan_fingerprint,
                              solve_batched, solve_sequence,
                              torch_repeated_engine)
from repro_torch.matrices import fem2d  # noqa: E402

from tests.helpers import circuit_system  # noqa: E402

K, T_STEPS, TOL = 4, 3, 1e-10
# fem2d(8, 8) shifted indefinite: under perturb_eps 1e-2 pivots are
# perturbed and refinement runs (tests/test_torch_engine.py's case)
PERTURBED = dict(force_mode="supernodal", bulk_min_width=2, perturb_eps=1e-2)


def _perturbed_pattern():
    a = (fem2d(8, 8, seed=1) - 3.0 * sp.eye(64)).tocsr()
    a.sort_indices()
    return a


@pytest.fixture(scope="module")
def stream():
    """The pattern, T steps of K value sets and per-step right-hand
    sides."""
    a = _perturbed_pattern()
    rng = np.random.default_rng(31)
    steps = [a.data[None] * rng.uniform(0.8, 1.2, (K, a.nnz))
             for _ in range(T_STEPS)]
    bs = [rng.normal(size=(K, a.shape[0])) for _ in range(T_STEPS)]
    return (a.indptr, a.indices), steps, bs


def _opts(donate, **kw):
    return HyluOptions(device="cpu", donate=donate, **PERTURBED, **kw)


@pytest.mark.parametrize("donate", [False, True])
def test_pipeline_matches_per_step_port(donate, stream):
    """Every step of the pipeline equals ``factor_batched`` +
    ``solve_batched`` of that step, bit for bit, and so do the counts and
    masks (also for a single RHS reused every step)."""
    pattern, steps, bs = stream
    n = len(pattern[0]) - 1
    an = analyze(CSR(n, *pattern, steps[0][0]), _opts(False))
    for b_steps in (bs, bs[0]):
        x, info = solve_sequence(pattern, steps, b_steps, _opts(donate))
        assert x.shape == (T_STEPS, K, n)
        assert info["donate"] is donate and info["steps"] == T_STEPS
        for t in range(T_STEPS):
            bst = factor_batched(an, pattern, steps[t])
            xt, it = solve_batched(bst, bs[t] if isinstance(b_steps, list)
                                   else b_steps)
            assert np.array_equal(x[t], xt)
            assert np.array_equal(info["residual"][t], it["residual"])
            assert info["n_refine"][t] == it["n_refine"]
            assert np.array_equal(info["n_perturb"][t], it["n_perturb"])
            for key in ("n_refine_per_system", "refine_failed",
                        "refine_stalled"):
                assert np.array_equal(info[key][t], it[key]), key
    assert info["n_perturb"].sum() > 0 and max(info["n_refine"]) > 0


@pytest.mark.parametrize("donate", [False, True])
def test_pipeline_matches_jax(donate, stream):
    """The port's pipeline against the JAX package's, with and without
    donation: x and residuals within 1e-10, equal counts and masks."""
    pattern, steps, bs = stream
    x_j, info_j = jax_solve_sequence(
        pattern, steps, bs, JaxOptions(engine="jax", use_pallas=False,
                                       donate=donate, **PERTURBED))
    x_t, info_t = solve_sequence(pattern, steps, bs, _opts(donate))
    assert np.abs(x_t - np.asarray(x_j)).max() \
        / np.abs(np.asarray(x_j)).max() < TOL
    np.testing.assert_allclose(info_t["residual"], info_j["residual"],
                               rtol=0, atol=TOL)
    assert info_t["n_refine"] == list(info_j["n_refine"])
    for key in ("n_refine_per_system", "n_perturb", "refine_failed",
                "refine_stalled"):
        assert np.array_equal(info_t[key], np.asarray(info_j[key])), key
    assert info_t["donate"] == info_j["donate"] == donate
    assert set(info_j) <= set(info_t)


def test_donating_solve_consumes_the_state(stream):
    """``solve_batched(donate=True)`` gives the same answer, keeps the host
    copy of the values, drops the staged buffer and marks the state
    consumed: a second solve raises."""
    pattern, steps, bs = stream
    n = len(pattern[0]) - 1
    an = analyze(CSR(n, *pattern, steps[0][0]), _opts(False))
    x0, info0 = solve_batched(factor_batched(an, pattern, steps[0]), bs[0])
    bst = factor_batched(an, pattern, torch.from_numpy(steps[0]))
    assert not bst.consumed
    x1, info1 = solve_batched(bst, bs[0], donate=True)
    assert np.array_equal(x0, x1)
    assert np.array_equal(info0["residual"], info1["residual"])
    assert bst.consumed and bst.values_dev is None
    assert np.array_equal(bst.values_batch, steps[0])
    with pytest.raises(RuntimeError, match="consumed"):
        solve_batched(bst, bs[0])


def test_caller_tensor_shared_across_steps_is_unchanged(stream):
    """A caller's tensors (one RHS for every step, the values of each
    step) come out of a donating stream unchanged, and the answers are
    those of the stream without donation."""
    pattern, steps, bs = stream
    b_t = torch.from_numpy(bs[0].copy())
    v_t = [torch.from_numpy(v.copy()) for v in steps]
    x_d, _ = solve_sequence(pattern, v_t, b_t, _opts(True))
    x_0, _ = solve_sequence(pattern, steps, bs[0], _opts(False))
    assert np.array_equal(x_d, x_0)
    assert torch.equal(b_t, torch.from_numpy(bs[0]))
    for v, ref in zip(v_t, steps):
        assert torch.equal(v, torch.from_numpy(ref))


def test_per_step_rhs_and_mismatches_raise(stream):
    """Per-step right-hand sides as a list (multi-RHS too); a list of the
    wrong length, or a step of another batch size, raises."""
    pattern, steps, bs = stream
    n = len(pattern[0]) - 1
    bm = [np.stack([b, 2 * b], axis=2) for b in bs]
    x, info = solve_sequence(pattern, steps, bm, _opts(True))
    assert x.shape == (T_STEPS, K, n, 2)
    assert info["residual"].shape == (T_STEPS, K, 2)
    np.testing.assert_allclose(x[..., 1], 2 * x[..., 0], rtol=1e-9,
                               atol=1e-12)
    with pytest.raises(ValueError, match="per-step right-hand sides"):
        solve_sequence(pattern, steps, bs[:2], _opts(False))
    with pytest.raises(ValueError, match="batch size"):
        solve_sequence(pattern, [steps[0], steps[1][:2]], bs[0],
                       _opts(True))


def _illconditioned_batch(n=24, seed=0):
    """tests/test_mixed_precision.py's [well, ill, well, ill] dense batch:
    under float32 factors the ill systems stall in refinement."""
    rng = np.random.default_rng(seed)
    q1, _ = np.linalg.qr(rng.normal(size=(n, n)))
    q2, _ = np.linalg.qr(rng.normal(size=(n, n)))
    ill = q1 @ np.diag(np.logspace(0, -5, n)) @ q2
    well = ill + np.diag(3.0 * np.ones(n))
    indptr = np.arange(0, n * n + 1, n, dtype=np.int64)
    indices = np.tile(np.arange(n, dtype=np.int64), n)
    vb = np.stack([well.reshape(-1), ill.reshape(-1),
                   well.reshape(-1), ill.reshape(-1)])
    return (indptr, indices), vb, rng.normal(size=(4, n))


@pytest.mark.parametrize("donate", [False, True])
def test_float32_stream_reports_stall_masks(donate):
    """The float32-factor stream reports each step's failure masks and runs
    no fp64 redo (``test_stall_masks_in_sequence_pipeline``), as the JAX
    package's does."""
    pattern, vb, bb = _illconditioned_batch()
    x, info = solve_sequence(pattern, [vb, vb], bb, HyluOptions(
        device="cpu", factor_dtype="float32", donate=donate))
    assert info["refine_failed"].shape == (2, 4)
    assert info["refine_failed"].tolist() == [[False, True, False, True]] * 2
    assert info["refine_stalled"].shape == (2, 4)
    assert not (info["refine_stalled"] & ~info["refine_failed"]).any()
    _, info_j = jax_solve_sequence(pattern, [vb, vb], bb, JaxOptions(
        engine="jax", factor_dtype="float32", donate=donate))
    for key in ("refine_failed", "refine_stalled", "n_refine_per_system"):
        assert np.array_equal(info[key], np.asarray(info_j[key])), key


def test_donated_solve_keeps_the_fp64_escape_hatch():
    """A donating solve on float32 factors still redoes the failed systems
    in float64, from the host copy of the values and the snapshot of the
    right-hand sides, as the solve without donation does."""
    pattern, vb, bb = _illconditioned_batch()
    n = len(pattern[0]) - 1
    an = analyze(CSR(n, *pattern, vb[0]),
                 HyluOptions(device="cpu", factor_dtype="float32"))
    x0, info0 = solve_batched(factor_batched(an, pattern, vb), bb)
    bst = factor_batched(an, pattern, vb)
    x1, info1 = solve_batched(bst, torch.from_numpy(bb), donate=True)
    assert info0["n_fp64_fallback"] == info1["n_fp64_fallback"] == 2
    assert np.array_equal(x0, x1)
    assert info1["residual"].max() < TOL and bst.consumed


@pytest.mark.parametrize("schedule", ["bucketed", "unrolled"])
def test_refactor_batched_out_reuses_the_buffers(schedule, stream):
    """``refactor_batched(out=)`` writes the factors of new values into an
    earlier call's buffers: the same factors as a fresh buffer, in the
    same storage; a buffer of another batch size raises."""
    pattern, steps, _ = stream
    n = len(pattern[0]) - 1
    an = analyze(CSR(n, *pattern, steps[0][0]),
                 _opts(False, factor_schedule=schedule))
    eng = torch_repeated_engine(an)
    a0, a1 = (torch.from_numpy(v) for v in steps[:2])
    prev = eng.refactor_batched(a0)
    fresh = eng.refactor_batched(a1)
    ptrs = (prev.vals.data_ptr(), prev.inode_perm.data_ptr())
    got = eng.refactor_batched(a1, out=prev)
    assert (got.vals.data_ptr(), got.inode_perm.data_ptr()) == ptrs
    assert torch.equal(got.vals, fresh.vals)
    assert torch.equal(got.inode_perm, fresh.inode_perm)
    assert torch.equal(got.n_perturb, fresh.n_perturb)
    with pytest.raises(ValueError, match="out="):
        eng.refactor_batched(a1[:2], out=got)
    with pytest.raises(ValueError, match="out="):    # one system: no
        eng.refactor_batched(a1[:1], out=eng.refactor(a1[0]))  # buffers


def test_donate_is_runtime_only():
    """``donate`` builds an engine on the CPU and never enters a plan
    fingerprint."""
    a = JaxCSR.from_scipy(circuit_system(30, seed=0).tocsr())
    at = CSR(a.n, a.indptr, a.indices, a.data)
    on, off = _opts(True), _opts(False)
    assert plan_fingerprint(at, on) == plan_fingerprint(at, off)
    eng = torch_repeated_engine(analyze(at, dataclasses.replace(on)))
    assert eng.device.type == "cpu"


def test_on_device_compares_types_and_indices():
    """``on_device`` holds a CPU tensor on the CPU and never on a CUDA
    device, whatever its index (the card's own case is in
    ``tests/test_torch_cuda.py``)."""
    from repro_torch.core.torch_engine import on_device

    t = torch.zeros(2)
    assert on_device(t, torch.device("cpu"))
    assert not on_device(t, torch.device("cuda"))
    assert not on_device(t, torch.device("cuda", 0))


@pytest.mark.parametrize("copy", [False, True])
def test_staging_uses_a_device_tensor_in_place_unless_copying(copy):
    """A tensor already on the staging device is read in place (no host
    round trip), or copied into the slot's own buffer under donation;
    host arrays always land in the slot, and each slot keeps its
    buffer."""
    from repro_torch.core.batched import _Staging

    st = _Staging(torch.device("cpu"), torch.float64, copy)
    src = torch.arange(6, dtype=torch.float64).view(2, 3)
    out = st.fill(0, src)
    assert torch.equal(out, src)
    assert (out.data_ptr() == src.data_ptr()) is (not copy)
    host = st.fill(1, src.numpy() + 1)
    assert host.data_ptr() not in (src.data_ptr(), out.data_ptr())
    assert st.fill(1, src.numpy()).data_ptr() == host.data_ptr()
    assert st.pinned == [None, None]
