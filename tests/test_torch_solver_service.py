"""The port's SolverService: the contracts of ``tests/test_solver_service.py``
on ``repro_torch.serve.solver_service`` (``device="cpu"``, the plain
PyTorch path), and one mixed, fault-laced stream sent through both
packages' services.

Within the port, results through the service are bit-identical to the
batched path fed the same group (the CPU sums in a fixed order).  Across
the packages statuses, error codes and the retry, perturbation and
refinement counts must be equal, and solutions within 1e-10.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import HyluOptions as JaxOptions  # noqa: E402
from repro.serve.solver_service import \
    SolverService as JaxService  # noqa: E402
from repro_torch.core import CSR, HyluOptions, PlanCache  # noqa: E402
from repro_torch.core.api import (analyze, factor, factor_batched,  # noqa: E402
                                  plan_fingerprint, solve, solve_batched)
from repro_torch.serve import faultinject  # noqa: E402
from repro_torch.serve.solver_service import (  # noqa: E402
    ERR_BAD_MATRIX, ERR_NONFINITE_VALUES, ERR_SHAPE_MISMATCH,
    STATUS_REJECTED, STATUS_SOLVED, InvalidRequestError, SolveRequest,
    SolveResult, SolverService)

from tests.helpers import SCENARIOS, routing_system, scenario_system  # noqa: E402

STREAM = ["circuit", "banded", "denseish", "singleton"]
CPU = HyluOptions(device="cpu")


def _port(aj):
    return CSR(aj.n, aj.indptr, aj.indices, aj.data)


def _system(name, n=30, seed=0):
    aj, _, b, _ = scenario_system(name, n=n, seed=seed)
    return _port(aj), b


def _svc(tmp_path=None, **kw):
    kw.setdefault("opts", CPU)
    if "cache" not in kw:
        kw["cache_dir"] = None if tmp_path is None else str(tmp_path)
    return SolverService(**kw)


def _mixed_stream(reps=3, n=30, seed=0):
    """Interleaved requests over four patterns with per-request value
    drift; ``seed`` drifts values and RHS only, never the patterns."""
    rng = np.random.default_rng(seed)
    pats = {name: _system(name, n=n)[0] for name in STREAM}
    reqs, per_pattern = [], {}
    for rep in range(reps):
        for name in STREAM:
            a = pats[name]
            vals = a.data * rng.uniform(0.9, 1.1, a.nnz)
            reqs.append(SolveRequest(a=CSR(a.n, a.indptr, a.indices, vals),
                                     b=rng.normal(size=a.n), tag=(name, rep)))
            per_pattern.setdefault(name, []).append(len(reqs) - 1)
    return reqs, per_pattern


def test_mixed_stream_residuals_and_bit_identity(tmp_path):
    svc = _svc(tmp_path, batch_size=4)
    reqs, per_pattern = _mixed_stream(reps=3)
    res = svc.solve_batch(reqs)
    assert len(res) == len(reqs)
    for r, req in zip(res, reqs):
        assert isinstance(r, SolveResult) and r.tag == req.tag
        assert r.residual < 1e-10, r.tag
    assert svc.stats["patterns_seen"] == len(STREAM)
    for name, idxs in per_pattern.items():
        a0 = reqs[idxs[0]].a
        an = svc.cache.get_or_analyze(a0, svc.opts)
        vb = np.stack([reqs[i].a.data for i in idxs] + [a0.data])
        bb = np.stack([reqs[i].b for i in idxs] + [np.zeros(a0.n)])
        x, _ = solve_batched(factor_batched(an, a0, vb), bb)
        for j, i in enumerate(idxs):
            assert np.abs(res[i].x - x[j]).max() == 0.0, (name, j)


def test_results_match_scalar_solver(tmp_path):
    svc = _svc(tmp_path, batch_size=4)
    reqs, _ = _mixed_stream(reps=1)
    for r, req in zip(svc.solve_batch(reqs), reqs):
        x_ref, _ = solve(factor(analyze(req.a, CPU), req.a), req.b)
        assert np.abs(r.x - x_ref).max() < 1e-8, r.tag


def test_warm_stream_skips_analyze(tmp_path):
    svc = _svc(tmp_path, batch_size=4)
    svc.solve_batch(_mixed_stream(reps=1, seed=0)[0])
    assert svc.cache.stats["analyze_calls"] == len(STREAM)
    res2 = svc.solve_batch(_mixed_stream(reps=2, seed=99)[0])
    assert svc.cache.stats["analyze_calls"] == len(STREAM)
    assert svc.cache.stats["hits"] >= len(STREAM)
    assert all(r.residual < 1e-10 for r in res2)


def test_disk_warm_second_service(tmp_path):
    reqs, _ = _mixed_stream(reps=1)
    res1 = _svc(tmp_path, batch_size=4).solve_batch(reqs)
    svc2 = _svc(tmp_path, batch_size=4)
    res2 = svc2.solve_batch(reqs)
    assert svc2.cache.stats["analyze_calls"] == 0
    assert svc2.cache.stats["disk_hits"] == len(STREAM)
    for r1, r2 in zip(res1, res2):
        assert np.abs(r1.x - r2.x).max() == 0.0


def test_batch_size_chunking_and_padding(tmp_path):
    """5 requests of one pattern at batch_size=2: 3 dispatches, 1 padded
    system, and one engine at one batch shape for all of them."""
    svc = _svc(tmp_path, batch_size=2)
    rng = np.random.default_rng(5)
    a, _ = _system("circuit", seed=5)
    reqs = [SolveRequest(a=CSR(a.n, a.indptr, a.indices,
                               a.data * rng.uniform(0.9, 1.1, a.nnz)),
                         b=rng.normal(size=a.n), tag=i) for i in range(5)]
    res = svc.solve_batch(reqs)
    assert (svc.stats["dispatches"], svc.stats["padded_systems"],
            svc.stats["groups"]) == (3, 1, 1)
    for i, r in enumerate(res):
        assert r.tag == i and r.residual < 1e-10 and r.group_size == 5
    assert len(svc.cache.get_or_analyze(a, svc.opts).engine_cache) == 1


def test_multirhs_and_mixed_shapes(tmp_path):
    svc = _svc(tmp_path, batch_size=4)
    rng = np.random.default_rng(11)
    a, _ = _system("circuit", seed=11)
    res = svc.solve_batch([SolveRequest(a=a, b=rng.normal(size=a.n)),
                           SolveRequest(a=a, b=rng.normal(size=(a.n, 3)))])
    assert svc.stats["groups"] == 2
    assert res[0].x.shape == (a.n,) and np.ndim(res[0].residual) == 0
    assert res[1].x.shape == (a.n, 3)
    assert np.asarray(res[1].residual).shape == (3,)
    assert float(np.max(res[1].residual)) < 1e-10


def test_submit_flush_and_pairs(tmp_path):
    svc = _svc(tmp_path, batch_size=4)
    a, b = _system("circuit", seed=2)
    assert svc.submit(a, b, tag="q0") == 0
    assert svc.submit(a, np.random.default_rng(2).normal(size=a.n)) == 1
    res = svc.flush()
    assert len(res) == 2 and res[0].tag == "q0" and svc._pending == []
    assert svc.solve_batch([(a, b)])[0].residual < 1e-10
    # scipy matrices convert through tocsr()
    _, a_sp, _, _ = scenario_system("circuit", n=30, seed=2)
    assert svc.solve_batch([(a_sp, b)])[0].status == STATUS_SOLVED


def test_bad_requests_get_typed_rejections(tmp_path):
    svc = _svc(tmp_path)
    a, b = _system("circuit")
    res = svc.solve_batch([SolveRequest(a=a, b=np.zeros(a.n + 1)),
                           SolveRequest(a=np.eye(3), b=np.zeros(3)),
                           SolveRequest(a=a, b=b)])
    assert (res[0].status, res[0].error.code) == (STATUS_REJECTED,
                                                  ERR_SHAPE_MISMATCH)
    assert (res[1].status, res[1].error.code) == (STATUS_REJECTED,
                                                  ERR_BAD_MATRIX)
    assert res[2].status == STATUS_SOLVED and res[2].residual < 1e-10
    assert svc.stats["rejected"] == 2
    with pytest.raises(ValueError, match="batch_size"):
        _svc(batch_size=0)


def test_submit_validates_eagerly_and_flush_never_loses_the_window(
        tmp_path):
    svc = _svc(tmp_path, batch_size=4)
    a, b = _system("circuit")
    svc.submit(a, b, tag="good")
    with pytest.raises(InvalidRequestError) as ei:
        svc.submit(a, np.zeros(a.n + 1))
    assert ei.value.error.code == ERR_SHAPE_MISMATCH
    bad = a.data.copy()
    bad[0] = np.nan
    with pytest.raises(InvalidRequestError) as ei:
        svc.submit(CSR(a.n, a.indptr, a.indices, bad), b)
    assert ei.value.error.code == ERR_NONFINITE_VALUES
    assert len(svc._pending) == 1
    res = svc.flush()
    assert len(res) == 1 and res[0].tag == "good" and res[0].residual < 1e-10
    assert svc._pending == []


def test_shared_cache_across_services(tmp_path):
    cache = PlanCache(directory=str(tmp_path))
    a, b = _system("circuit")
    _svc(cache=cache, batch_size=2).solve_batch([(a, b)])
    _svc(cache=cache, batch_size=2).solve_batch([(a, b)])
    assert cache.stats["analyze_calls"] == 1 and cache.stats["hits"] == 1


@pytest.mark.parametrize("name,expected", [("circuit", "rowrow"),
                                           ("banded", "hybrid"),
                                           ("denseish", "hybrid")])
def test_service_routes_kernel_modes_end_to_end(tmp_path, name, expected):
    aj, b, expected2 = routing_system(name, seed=0)
    assert expected2 == expected == SCENARIOS[name][2]
    svc = _svc(tmp_path, batch_size=2)
    a = _port(aj)
    assert svc.solve_batch([(a, b)])[0].residual < 1e-10
    assert svc.pattern_modes[plan_fingerprint(a, svc.opts)] == expected


def test_force_mode_wins_through_service(tmp_path):
    a, b = _system("circuit")
    routed = _svc(tmp_path, batch_size=2)
    forced = _svc(opts=HyluOptions(device="cpu", force_mode="supernodal"),
                  cache=routed.cache, batch_size=2)
    r0 = routed.solve_batch([(a, b)])[0]
    r1 = forced.solve_batch([(a, b)])[0]
    assert r0.fingerprint != r1.fingerprint
    assert routed.pattern_modes[r0.fingerprint] == "rowrow"
    assert forced.pattern_modes[r1.fingerprint] == "supernodal"
    assert routed.cache.stats["analyze_calls"] == 2
    assert r1.residual < 1e-10 and np.abs(r0.x - r1.x).max() < 1e-8


def test_mixed_fault_stream_matches_the_jax_service():
    """One fault-laced, mixed-pattern, mixed-RHS stream through the JAX
    service (Pallas interpreted) and the port's: per request the same
    status, error code and counts, solutions within 1e-10."""
    stream = faultinject.make_stream(24, fault_rate=0.4, seed=3, n=24)
    assert {it.kind for it in stream if it.kind} >= {
        "singular_values", "ill_conditioned", "nan_values"}
    reqs = [(it.a, it.b) for it in stream]
    port = _svc(batch_size=4).solve_batch(reqs)
    jax_reqs = [(_jax_csr(a), b) for a, b in reqs]
    ref = JaxService(opts=JaxOptions(engine="jax", use_pallas=True),
                     cache_dir=None, batch_size=4).solve_batch(jax_reqs)
    assert len(port) == len(ref) == len(stream)
    for it, rp, rj in zip(stream, port, ref):
        what = (it.kind, it.tag)
        assert rp.status == rj.status, what
        assert (rp.error and rp.error.code) == (rj.error and rj.error.code)
        assert (rp.n_retries, rp.n_perturb, rp.n_refine, rp.refine_failed,
                rp.fingerprint) == (rj.n_retries, rj.n_perturb, rj.n_refine,
                                    rj.refine_failed, rj.fingerprint), what
        if rp.status == STATUS_SOLVED:
            xj = np.asarray(rj.x)
            assert np.abs(rp.x - xj).max() / max(np.abs(xj).max(),
                                                  1.0) <= 1e-10, what


def _jax_csr(a):
    from repro.core.matrix import CSR as JaxCSR

    return JaxCSR(a.n, a.indptr, a.indices, a.data)
