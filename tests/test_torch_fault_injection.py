"""The port's serving robustness contract under injected faults: the
contracts of ``tests/test_fault_injection.py`` on ``repro_torch.serve``
(``device="cpu"``), and the harness's streams against the JAX package's.

* every submitted request receives exactly one terminal result;
* no non-converged solution is returned as ``solved``;
* healthy requests batched with poisoned neighbours match the dense fp64
  oracle within 1e-10;
* one group's dispatch exception cannot lose another group's results;
* the ladder runs end to end: refine → perturbed retries → quarantine.
"""
import asyncio
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import faultinject as jax_faultinject  # noqa: E402
from repro_torch.core import HyluOptions, PlanCache  # noqa: E402
from repro_torch.core.options import (plan_fingerprint,  # noqa: E402
                                      resolve_perturb_eps,
                                      resolve_retry_perturb)
from repro_torch.serve import faultinject  # noqa: E402
from repro_torch.serve.async_server import AsyncSolverServer  # noqa: E402
from repro_torch.serve.faultinject import (  # noqa: E402
    FAULT_KINDS, _with_values, build_pattern, check_report, fp64_oracle,
    healthy_values, inject, make_stream, run_stream)
from repro_torch.serve.solver_service import (  # noqa: E402
    ERR_DISPATCH, ERR_NONFINITE_RHS, ERR_NONFINITE_VALUES, ERR_QUARANTINED,
    ERR_QUEUE_FULL, ERR_SHAPE_MISMATCH, STATUS_FAILED, STATUS_QUARANTINED,
    STATUS_REJECTED, STATUS_SOLVED, TERMINAL_STATUSES, InvalidRequestError,
    SolverService)

N = 24

# one shared in-memory plan cache: the suite's patterns analyze once
_CACHE = PlanCache(capacity=64, directory=None)


def _service(batch_size=4, **opt_kw):
    return SolverService(opts=HyluOptions(device="cpu", **opt_kw),
                         cache=_CACHE, batch_size=batch_size)


def test_fault_storm_exactly_one_terminal_result_each():
    async def main():
        async with AsyncSolverServer(_service(), max_queue_per_group=128,
                                     max_pending=256,
                                     max_linger_ms=20.0) as server:
            stream = make_stream(40, fault_rate=0.35, seed=5, n=N)
            return await run_stream(server, stream), stream

    report, stream = asyncio.run(main())
    assert len({item.kind for item in stream if item.kind}) >= 5
    violations = check_report(report)
    assert not violations, "\n".join(violations)
    assert report["lost"] == 0 and report["n_outcomes"] == len(stream)
    assert set(report["by_status"]) <= set(TERMINAL_STATUSES)
    assert report["by_status"][STATUS_SOLVED] > 0
    assert report["by_status"][STATUS_REJECTED] > 0
    assert report["worst_healthy_err"] <= faultinject.ORACLE_RTOL
    assert report["n_healthy_checked"] > 0


def test_healthy_neighbors_keep_fp64_parity_in_poisoned_batch():
    pat = build_pattern("circuit", n=N, seed=1)
    rng = np.random.default_rng(7)
    healthy = [(_with_values(pat, healthy_values(pat, 100 + i)),
                rng.standard_normal(N)) for i in range(3)]
    singular = inject("singular_values", pat, seed=8)
    ill = inject("ill_conditioned", pat, seed=9)
    res = _service(batch_size=8).solve_batch(
        [healthy[0], (singular.a, singular.b), healthy[1], (ill.a, ill.b),
         healthy[2]])
    assert all(r.status in TERMINAL_STATUSES for r in res)
    for (a, b), r in zip(healthy, (res[0], res[2], res[4])):
        assert r.status == STATUS_SOLVED and not r.refine_failed
        x0 = fp64_oracle(a, b)
        assert np.abs(r.x - x0).max() / np.abs(x0).max() <= 1e-10
    for r in (res[1], res[3]):
        assert r.status in (STATUS_QUARANTINED, STATUS_FAILED, STATUS_SOLVED)
        if r.status == STATUS_SOLVED:
            assert not r.refine_failed


def test_admission_rejects_are_typed():
    pat = build_pattern("banded", n=N, seed=1)
    svc = _service()
    cases = dict(nan_values=ERR_NONFINITE_VALUES,
                 inf_values=ERR_NONFINITE_VALUES,
                 nan_rhs=ERR_NONFINITE_RHS,
                 wrong_shape_rhs=ERR_SHAPE_MISMATCH)
    for kind, code in cases.items():
        bad = inject(kind, pat, seed=11)
        with pytest.raises(InvalidRequestError) as ei:
            svc.submit(bad.a, bad.b)
        assert ei.value.error.code == code
    assert svc.flush() == []
    good = (_with_values(pat, healthy_values(pat, 12)),
            np.random.default_rng(12).standard_normal(N))
    bad = inject("nan_values", pat, seed=13)
    res = svc.solve_batch([good, (bad.a, bad.b)])
    assert res[0].status == STATUS_SOLVED
    assert (res[1].status, res[1].error.code, res[1].x) == (
        STATUS_REJECTED, ERR_NONFINITE_VALUES, None)
    assert svc.stats["rejected"] == 1

    async def main():
        async with AsyncSolverServer(_service()) as server:
            with pytest.raises(InvalidRequestError) as ei:
                await server.submit(bad.a, bad.b)
            return ei.value.error.code

    assert asyncio.run(main()) == ERR_NONFINITE_VALUES


def test_queue_overflow_backpressure_is_typed_not_unbounded():
    pat = build_pattern("circuit", n=N, seed=1)
    rng = np.random.default_rng(3)

    async def main():
        server = AsyncSolverServer(_service(batch_size=None),
                                   max_queue_per_group=4, max_pending=64,
                                   max_linger_ms=10_000.0)
        futs = []
        async with server:
            for i in range(10):
                a = _with_values(pat, healthy_values(pat, 200 + i))
                futs.append(await server.submit(a, rng.standard_normal(N),
                                                tag=i))
            done = [f for f in futs if f.done()]
            assert len(done) == 6
            for f in done:
                r = f.result()
                assert (r.status, r.error.code) == (STATUS_REJECTED,
                                                    ERR_QUEUE_FULL)
                assert r.error.detail["scope"] == "group"
        return [await f for f in futs], server.stats()

    results, stats = asyncio.run(main())
    assert sum(r.status == STATUS_SOLVED for r in results) == 4
    assert sum(r.status == STATUS_REJECTED for r in results) == 6
    assert stats["rejected_full"] == 6
    assert stats["reject_rate"] == pytest.approx(0.6)
    assert stats["queue_depth"] == 0


def test_global_bound_rejects_across_groups():
    """The second backpressure tier: many small groups cannot pile up past
    ``max_pending`` either."""
    rng = np.random.default_rng(4)

    async def main():
        server = AsyncSolverServer(_service(batch_size=None),
                                   max_queue_per_group=8, max_pending=3,
                                   max_linger_ms=10_000.0)
        async with server:
            futs = []
            for i, name in enumerate(("circuit", "banded", "denseish",
                                      "circuit")):
                pat = build_pattern(name, n=N, seed=1)
                a = _with_values(pat, healthy_values(pat, 600 + i))
                futs.append(await server.submit(a, rng.standard_normal(N)))
            r = futs[-1].result()
            assert r.error.code == ERR_QUEUE_FULL
            assert r.error.detail["scope"] == "global"
        return [await f for f in futs]

    results = asyncio.run(main())
    assert [r.status for r in results] == [STATUS_SOLVED] * 3 + [
        STATUS_REJECTED]


def test_deadline_storm_flushes_and_flags_misses():
    pat = build_pattern("banded", n=N, seed=1)
    rng = np.random.default_rng(4)

    async def main():
        server = AsyncSolverServer(_service(batch_size=8),
                                   max_queue_per_group=64, max_pending=64,
                                   max_linger_ms=10_000.0,
                                   deadline_margin_ms=0.5)
        async with server:
            futs = [await server.submit(
                _with_values(pat, healthy_values(pat, 300 + i)),
                rng.standard_normal(N), tag=i, deadline_ms=1e-3)
                for i in range(6)]
            results = [await f for f in futs]
        return results, server.stats()

    results, stats = asyncio.run(main())
    assert all(r.status == STATUS_SOLVED and not r.refine_failed
               for r in results)
    assert all(r.deadline_missed and r.latency_s is not None
               for r in results)
    assert stats["deadline_misses"] == 6
    assert stats["deadline_miss_rate"] == pytest.approx(1.0)


def test_singular_values_walk_the_ladder_to_quarantine():
    pat = build_pattern("circuit", n=N, seed=1)
    bad = inject("singular_values", pat, seed=21)
    svc = _service(batch_size=4, retry_max=2)
    r = svc.solve_batch([(bad.a, bad.b)])[0]
    assert (r.status, r.error.code, r.n_retries) == (
        STATUS_QUARANTINED, ERR_QUARANTINED, 2)
    assert svc.stats["retries"] == 2 and svc.stats["quarantined"] == 1
    d = r.error.detail
    assert d["n_retries"] == 2 and "residual" in d and "n_perturb" in d


def test_retry_opts_route_through_distinct_fingerprints():
    pat = build_pattern("circuit", n=N, seed=1)
    opts = HyluOptions(device="cpu")
    e1 = resolve_retry_perturb(opts, 1)
    e2 = resolve_retry_perturb(opts, 2)
    assert e1 == pytest.approx(resolve_perturb_eps(opts)
                               * opts.retry_perturb_boost)
    assert e2 > e1
    fps = {plan_fingerprint(pat, opts)} | {
        plan_fingerprint(pat, dataclasses.replace(opts, perturb_eps=e))
        for e in (e1, e2)}
    assert len(fps) == 3
    with pytest.raises(ValueError):
        resolve_retry_perturb(opts, 0)


def test_dispatch_exception_in_one_group_cannot_lose_other_groups(
        monkeypatch):
    import repro_torch.serve.solver_service as ss

    pat_ok = build_pattern("circuit", n=N, seed=1)
    pat_boom = build_pattern("denseish", n=N, seed=1)
    svc = _service(batch_size=4)
    fp_boom = plan_fingerprint(pat_boom, svc.opts)
    real = ss.factor_batched

    def exploding(an, pattern, vb, *a, **kw):
        if an.fingerprint == fp_boom:
            raise RuntimeError("injected dispatch explosion")
        return real(an, pattern, vb, *a, **kw)

    monkeypatch.setattr(ss, "factor_batched", exploding)
    rng = np.random.default_rng(6)
    reqs, kinds = [], []
    for i in range(6):
        pat = (pat_boom, pat_ok)[i % 2]
        kinds.append("boom" if pat is pat_boom else "ok")
        reqs.append((_with_values(pat, healthy_values(pat, 400 + i)),
                     rng.standard_normal(N)))
    res = svc.solve_batch(reqs)
    assert len(res) == 6 and all(r is not None for r in res)
    for kind, r in zip(kinds, res):
        if kind == "ok":
            assert r.status == STATUS_SOLVED and r.x is not None
        else:
            assert (r.status, r.error.code, r.x) == (STATUS_FAILED,
                                                     ERR_DISPATCH, None)
            assert "injected dispatch explosion" in r.error.message
            assert r.error.detail["stage"] == "dispatch"
    assert svc.stats["failed"] == 3
    for a, b in reqs:
        svc.submit(a, b)
    assert len(svc.flush()) == 6 and svc.flush() == []


def test_async_window_survives_service_level_exception():
    class ExplodingService:
        opts = HyluOptions(device="cpu")
        batch_size = 4
        stats = dict(rejected=0, retries=0, quarantined=0, failed=0)

        def _opts_for(self, req, retry_attempt=0):
            return self.opts

        def solve_batch(self, reqs):
            raise RuntimeError("whole-window explosion")

    pat = build_pattern("circuit", n=N, seed=1)

    async def main():
        async with AsyncSolverServer(ExplodingService(),
                                     max_linger_ms=5.0) as server:
            fut = await server.submit(
                _with_values(pat, healthy_values(pat, 500)),
                np.random.default_rng(9).standard_normal(N))
            return await fut

    r = asyncio.run(main())
    assert (r.status, r.error.code) == (STATUS_FAILED, ERR_DISPATCH)
    assert r.error.detail["stage"] == "window"
    assert "whole-window explosion" in r.error.message


@pytest.mark.parametrize("seed,rate", [(0, 0.2), (5, 0.35), (9, 0.5)])
def test_streams_are_the_jax_packages_bit_for_bit(seed, rate):
    """The same seed builds the same stream in both packages: kinds,
    expectations, tags, deadlines, patterns, values, right-hand sides and
    oracle solutions, every bit."""
    ours = make_stream(30, fault_rate=rate, seed=seed, n=N)
    ref = jax_faultinject.make_stream(30, fault_rate=rate, seed=seed, n=N)
    assert len(ours) == len(ref)
    assert {it.kind for it in ours if it.kind} <= set(FAULT_KINDS)
    for x, y in zip(ours, ref):
        assert (x.kind, x.expect, x.tag, x.deadline_ms) == \
            (y.kind, y.expect, y.tag, y.deadline_ms)
        for f in ("indptr", "indices", "data"):
            a, b = getattr(x.a, f), getattr(y.a, f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
        assert x.b.dtype == y.b.dtype and x.b.tobytes() == y.b.tobytes()
        assert (x.oracle_x is None) == (y.oracle_x is None)
        if x.oracle_x is not None:
            assert x.oracle_x.tobytes() == y.oracle_x.tobytes()
