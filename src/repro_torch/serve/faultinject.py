"""Fault-injection harness for the serving tier.

Adapted from ``src/repro/serve/faultinject.py``; the same seeds give the
same streams, bit for bit, as the JAX package's.

Serving robustness is a property you *demonstrate*, not assert: this
module builds mixed-pattern request streams laced with every fault class
the taxonomy names, drives them through an :class:`AsyncSolverServer`,
and checks the serving contract — **zero lost requests, zero
silently-wrong results**, healthy requests matching an independent fp64
oracle even when their batch neighbors are poisoned.

The harness is deliberately independent of the solver stack's own
numerics: the oracle is a dense ``np.linalg.solve`` on the fp64 values,
so a bug that corrupts both the engine and its residual reporting still
gets caught.

Fault matrix (``FAULT_KINDS``):

====================  =====================================================
kind                  what is injected → expected terminal outcome
====================  =====================================================
``nan_values``        NaN in the matrix values → rejected at admission
                      (``nonfinite_values``)
``inf_values``        Inf in the matrix values → rejected
                      (``nonfinite_values``)
``nan_rhs``           NaN in the RHS → rejected (``nonfinite_rhs``)
``wrong_shape_rhs``   RHS of the wrong length → rejected
                      (``shape_mismatch``)
``singular_values``   a structurally-fine pattern whose values zero out a
                      row → numerically singular; survives admission, must
                      come back quarantined/failed, never as silent garbage
``ill_conditioned``   diagonal scaled across ~12 orders of magnitude →
                      solved (refinement earns it) or honestly quarantined
``tiny_deadline``     healthy system with a microscopic latency budget →
                      still solved; only ``deadline_missed`` may be set
====================  =====================================================

Use :func:`make_stream` to build a reproducible stream,
:func:`run_stream` to drive it, and :func:`check_report` to turn the
outcome into a list of contract violations (empty = pass).  The chaos
tests (``tests/test_torch_fault_injection.py``), the ``launch/serve.py``
load generator and ``chip_smoke.py``'s serving_solver phase share this
one harness.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from ..core.matrix import CSR
from .solver_service import (STATUS_FAILED, STATUS_QUARANTINED,
                             STATUS_REJECTED, STATUS_SOLVED,
                             TERMINAL_STATUSES, InvalidRequestError)

# every injected fault kind; ``make_stream`` interleaves all of them
FAULT_KINDS = ("nan_values", "inf_values", "nan_rhs", "wrong_shape_rhs",
               "singular_values", "ill_conditioned", "tiny_deadline")

# how tightly healthy requests must match the dense fp64 oracle
ORACLE_RTOL = 1e-10

PATTERNS = ("circuit", "banded", "denseish")


# ------------------------------------------------------------- test systems
def build_pattern(name: str, n: int = 32, seed: int = 0) -> CSR:
    """A structurally-nonsingular CSR with healthy (diagonally dominant,
    well-conditioned) values.  Three pattern families keep the stream
    genuinely mixed-pattern: 'circuit' (sparse random + diagonal),
    'banded' (tridiagonal + sparse long-range), 'denseish' (~20% fill)."""
    # zlib.crc32, not hash(): str hashing is salted per process, and the
    # streams must be bit-reproducible across runs
    rng = np.random.default_rng(seed * 1000 + zlib.crc32(name.encode()))
    rows: list[np.ndarray] = []
    for i in range(n):
        if name == "circuit":
            k = int(rng.integers(1, 4))
            cols = rng.choice(n, size=k, replace=False)
        elif name == "banded":
            cols = np.array([c for c in (i - 1, i + 1) if 0 <= c < n])
            if rng.random() < 0.2:
                cols = np.append(cols, rng.integers(0, n))
        elif name == "denseish":
            k = max(2, n // 5)
            cols = rng.choice(n, size=k, replace=False)
        else:
            raise ValueError(f"unknown pattern family {name!r}; "
                             f"expected one of {PATTERNS}")
        rows.append(np.unique(np.append(cols, i)))  # always keep the diagonal
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.cumsum([len(r) for r in rows])
    indices = np.concatenate(rows).astype(np.int64)
    data = np.empty(indptr[-1], dtype=np.float64)
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        vals = rng.uniform(-1.0, 1.0, size=e - s)
        diag = int(np.searchsorted(indices[s:e], i))
        vals[diag] = np.abs(vals).sum() + 1.0 + rng.uniform(0.0, 1.0)
        data[s:e] = vals
    return CSR(n=n, indptr=indptr, indices=indices, data=data)


def healthy_values(pattern: CSR, seed: int) -> np.ndarray:
    """A fresh healthy value set on an existing pattern (same structure,
    diagonally dominant): the per-request values of the stream."""
    rng = np.random.default_rng(seed)
    data = rng.uniform(-1.0, 1.0, size=pattern.nnz)
    for i in range(pattern.n):
        s, e = pattern.indptr[i], pattern.indptr[i + 1]
        diag = s + int(np.searchsorted(pattern.indices[s:e], i))
        data[diag] = np.abs(data[s:e]).sum() + 1.0 + rng.uniform(0.0, 1.0)
    return data


def fp64_oracle(a: CSR, b: np.ndarray) -> np.ndarray:
    """Dense fp64 reference solution — deliberately independent of the
    whole solver stack (ordering, factorization, refinement)."""
    return np.linalg.solve(a.to_dense().astype(np.float64),
                           np.asarray(b, dtype=np.float64))


# ------------------------------------------------------------- fault stream
@dataclasses.dataclass
class Injected:
    """One stream element: the request plus the contract it must satisfy.

    kind        — a ``FAULT_KINDS`` member, or None for healthy traffic
    expect      — the set of admissible terminal statuses for this request
    oracle_x    — dense fp64 reference (healthy requests only)
    deadline_ms — per-request latency budget override (tiny_deadline)"""
    a: CSR
    b: np.ndarray
    kind: str | None = None
    expect: tuple = (STATUS_SOLVED,)
    oracle_x: np.ndarray | None = None
    deadline_ms: float | None = None
    tag: object = None


def _with_values(pattern: CSR, data: np.ndarray) -> CSR:
    return CSR(n=pattern.n, indptr=pattern.indptr, indices=pattern.indices,
               data=data)


def inject(kind: str, pattern: CSR, seed: int, tag=None,
           oracle=fp64_oracle) -> Injected:
    """Build one faulty request of the given kind on ``pattern``.
    ``oracle(a, b)`` gives the reference solution of the one kind that is
    checked against one (``tiny_deadline``); a large pattern passes a
    sparse solve in place of the dense default."""
    rng = np.random.default_rng(seed)
    data = healthy_values(pattern, seed)
    n = pattern.n
    b = rng.standard_normal(n)
    if kind == "nan_values":
        data = data.copy()
        data[rng.integers(0, data.size)] = np.nan
        return Injected(_with_values(pattern, data), b, kind,
                        expect=(STATUS_REJECTED,), tag=tag)
    if kind == "inf_values":
        data = data.copy()
        data[rng.integers(0, data.size)] = np.inf
        return Injected(_with_values(pattern, data), b, kind,
                        expect=(STATUS_REJECTED,), tag=tag)
    if kind == "nan_rhs":
        b = b.copy()
        b[rng.integers(0, n)] = np.nan
        return Injected(_with_values(pattern, data), b, kind,
                        expect=(STATUS_REJECTED,), tag=tag)
    if kind == "wrong_shape_rhs":
        return Injected(_with_values(pattern, data),
                        rng.standard_normal(n + 3), kind,
                        expect=(STATUS_REJECTED,), tag=tag)
    if kind == "singular_values":
        data = data.copy()
        row = n // 2
        data[pattern.indptr[row]:pattern.indptr[row + 1]] = 0.0
        return Injected(_with_values(pattern, data), b, kind,
                        expect=(STATUS_QUARANTINED, STATUS_FAILED), tag=tag)
    if kind == "ill_conditioned":
        data = data.copy()
        scale = np.logspace(0, -12, n)   # rows span ~12 orders of magnitude
        for i in range(n):
            s, e = pattern.indptr[i], pattern.indptr[i + 1]
            data[s:e] *= scale[i]
        return Injected(_with_values(pattern, data), b, kind,
                        expect=(STATUS_SOLVED, STATUS_QUARANTINED), tag=tag)
    if kind == "tiny_deadline":
        a = _with_values(pattern, data)
        return Injected(a, b, kind, expect=(STATUS_SOLVED,),
                        oracle_x=oracle(a, b), deadline_ms=1e-3,
                        tag=tag)
    raise ValueError(f"unknown fault kind {kind!r}; "
                     f"expected one of {FAULT_KINDS}")


def make_stream(n_requests: int, fault_rate: float = 0.25, seed: int = 0,
                n: int = 32, multi_rhs_rate: float = 0.15,
                kinds=FAULT_KINDS) -> list:
    """A reproducible mixed-pattern stream of ``n_requests`` elements:
    healthy diag-dominant systems across the three pattern families, with
    ``fault_rate`` of the stream replaced by faults cycling through
    ``kinds``.  Healthy requests carry their dense-fp64 oracle solution;
    a ``multi_rhs_rate`` fraction use an (n, 2) RHS to exercise the
    RHS-shape grouping axis."""
    rng = np.random.default_rng(seed)
    patterns = {name: build_pattern(name, n=n, seed=seed)
                for name in PATTERNS}
    stream: list = []
    fault_i = 0
    for i in range(n_requests):
        pat = patterns[PATTERNS[int(rng.integers(0, len(PATTERNS)))]]
        if rng.random() < fault_rate:
            kind = kinds[fault_i % len(kinds)]
            fault_i += 1
            stream.append(inject(kind, pat, seed=seed * 7919 + i,
                                 tag=("fault", kind, i)))
            continue
        a = _with_values(pat, healthy_values(pat, seed * 7919 + i))
        if rng.random() < multi_rhs_rate:
            b = rng.standard_normal((pat.n, 2))
        else:
            b = rng.standard_normal(pat.n)
        stream.append(Injected(a, b, kind=None, expect=(STATUS_SOLVED,),
                               oracle_x=fp64_oracle(a, b),
                               tag=("healthy", i)))
    return stream


# ------------------------------------------------------ driving a stream
async def run_stream(server, stream, warmup: bool = True) -> dict:
    """Drive ``stream`` through an (already started) AsyncSolverServer and
    return a structured report.  With ``warmup`` (default), one healthy
    request per distinct pattern is solved first so cold-path analysis is
    seeded by healthy values, mirroring a warmed production server.

    Every stream element is accounted for exactly once: requests the
    server refuses at admission (``InvalidRequestError``) are recorded as
    rejected outcomes; everything else resolves through its future.  The
    report's ``lost`` field is ``len(stream) - outcomes`` — the
    exactly-one-terminal-result contract reduced to one number."""
    warm_seen: set = set()
    if warmup:
        for item in stream:
            if item.kind is not None:
                continue
            key = (id(item.a.indptr), item.b.shape[1:])
            if key in warm_seen:
                continue
            warm_seen.add(key)
            await server.solve(item.a, item.b, tag=("warmup",))

    outcomes: list = []   # (item, status, error_code, result-or-None)
    futures: list = []    # (item, future)
    for item in stream:
        try:
            fut = await server.submit(item.a, item.b, tag=item.tag,
                                      deadline_ms=item.deadline_ms)
        except InvalidRequestError as e:
            outcomes.append((item, STATUS_REJECTED, e.error.code, None))
            continue
        futures.append((item, fut))
    for item, fut in futures:
        r = await fut
        outcomes.append((item, r.status,
                         r.error.code if r.error is not None else None, r))

    return dict(score_outcomes(stream, outcomes),
                server_stats=server.stats())


def score_outcomes(stream, outcomes) -> dict:
    """The report of one run of ``stream``: ``outcomes`` holds one
    ``(item, status, error_code, result-or-None)`` per request that got a
    terminal result.  ``lost`` is ``len(stream) - len(outcomes)``;
    ``violations`` lists every status outside its item's expectation and
    every ``solved`` result that is missing, non-finite or off its oracle
    by more than ``ORACLE_RTOL``."""
    by_status: dict = {s: 0 for s in TERMINAL_STATUSES}
    violations: list = []
    worst_healthy_err = 0.0
    n_healthy_checked = 0
    for item, status, code, r in outcomes:
        by_status[status] = by_status.get(status, 0) + 1
        if status not in TERMINAL_STATUSES:
            violations.append(f"non-terminal status {status!r} for "
                              f"tag={item.tag}")
        if status not in item.expect:
            violations.append(
                f"kind={item.kind or 'healthy'} tag={item.tag}: got "
                f"status={status} (error={code}), expected one of "
                f"{item.expect}")
        if status == STATUS_SOLVED and r is not None:
            if r.x is None or not np.all(np.isfinite(np.asarray(r.x))):
                violations.append(f"tag={item.tag}: status=solved but the "
                                  f"solution is missing or non-finite — "
                                  f"silent garbage")
            elif item.oracle_x is not None:
                err = (np.abs(np.asarray(r.x) - item.oracle_x).max()
                       / max(np.abs(item.oracle_x).max(), 1.0))
                worst_healthy_err = max(worst_healthy_err, float(err))
                n_healthy_checked += 1
                if err > ORACLE_RTOL:
                    violations.append(
                        f"tag={item.tag}: healthy request diverged from the "
                        f"fp64 oracle (rel err {err:.3e} > {ORACLE_RTOL:g})")
    return dict(
        n_requests=len(stream),
        n_outcomes=len(outcomes),
        lost=len(stream) - len(outcomes),
        by_status=by_status,
        worst_healthy_err=worst_healthy_err,
        n_healthy_checked=n_healthy_checked,
        violations=violations,
    )


def check_report(report: dict) -> list:
    """The serving robustness contract as a list of violations (empty =
    pass): zero lost requests, zero silently-wrong results, healthy
    fp64-oracle parity, and per-kind expected terminal statuses."""
    violations = list(report["violations"])
    if report["lost"] != 0:
        violations.insert(0, f"{report['lost']} request(s) received no "
                             f"terminal result — losses")
    return violations
