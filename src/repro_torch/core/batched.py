"""Batched repeated solve: K value sets of one pattern on one device.

Adapted from ``src/repro/core/batched.py``: ``factor_batched``,
``solve_batched`` (with the non-finite guard ``_nonfinite_failed`` and the
per-system fp64 escape hatch ``_fp64_redo``) and ``solve_sequence`` (one
step, or a T-step sequence).  Inputs may be host arrays or torch tensors;
results come back as numpy arrays, as the JAX package returns them.

Not in this slice (``NotImplementedError``, see ROADMAP.md): buffer
donation, multi-device sharding, and the double-buffered sequence
pipeline — a T-step sequence runs its steps one after another.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .matrix import CSR
from .analysis import Analysis, _sync, analyze, torch_repeated_engine
from .options import HyluOptions, resolve_refine_tol


@dataclasses.dataclass
class BatchedFactorState:
    """K factorizations of one sparsity pattern, held as device tensors."""
    analysis: Analysis
    a_pattern: tuple           # (indptr, indices) of the original matrices
    values_dev: torch.Tensor   # (K, nnz) A values, refine dtype, on device
    vals: torch.Tensor         # (K, total_slots) factored panels
    inode_perm: torch.Tensor   # (K, n) in-node pivot permutations
    n_perturb: np.ndarray      # (K,) perturbation counts
    timings: dict
    k: int
    _values_host: np.ndarray | None = dataclasses.field(default=None,
                                                        repr=False)

    @property
    def values_batch(self) -> np.ndarray:
        """(K, nnz) host copy of the A values (copied on first access)."""
        if self._values_host is None:
            self._values_host = self.values_dev.cpu().numpy()
        return self._values_host


def _pattern_of(a_pattern) -> tuple:
    if isinstance(a_pattern, CSR):
        return (a_pattern.indptr, a_pattern.indices)
    indptr, indices = a_pattern
    return (np.asarray(indptr), np.asarray(indices))


def _np_dtype(tdtype):
    return torch.empty((), dtype=tdtype).numpy().dtype


def _stage_values(eng, values_batch):
    """(K, nnz) values on the engine's device in its values (refine) dtype;
    returns ``(values_dev, values_host | None, k)``.  A tensor already on
    the device in that dtype is used in place."""
    if isinstance(values_batch, torch.Tensor):
        v = values_batch if values_batch.ndim > 1 else values_batch[None]
        v = v.to(device=eng.device, dtype=eng.values_dtype)
        return v, None, int(v.shape[0])
    host = np.ascontiguousarray(np.atleast_2d(
        np.asarray(values_batch, dtype=_np_dtype(eng.values_dtype))))
    return torch.from_numpy(host).to(eng.device), host, host.shape[0]


def _stage_rhs(eng, b_batch, k: int) -> torch.Tensor:
    """Right-hand sides (K, n), (n,) broadcast or (K, n, m) on the device;
    a leading dimension that matches neither K nor 1 raises."""
    if getattr(b_batch, "ndim", 1) > 1 and b_batch.shape[0] != k:
        raise ValueError(f"b_batch has leading (batch) dimension "
                         f"{b_batch.shape[0]} but the factorization batch "
                         f"size is {k}")
    if isinstance(b_batch, torch.Tensor):
        b = b_batch.to(device=eng.device, dtype=eng.values_dtype)
    else:
        b = torch.from_numpy(np.ascontiguousarray(
            np.asarray(b_batch, dtype=_np_dtype(eng.values_dtype))))
        b = b.to(eng.device)
    if b.ndim == 1:
        b = b.expand(k, b.shape[0])
    return b


def factor_batched(an: Analysis, a_pattern, values_batch) -> BatchedFactorState:
    """K numeric factorizations (one pattern, K value sets) on the
    analysis' device.  ``values_batch`` is a host (K, nnz) array or a
    tensor."""
    eng = torch_repeated_engine(an)
    t0 = time.perf_counter()
    values_dev, values_host, k = _stage_values(eng, values_batch)
    f = eng.refactor_batched(values_dev)
    n_perturb = f.n_perturb.cpu().numpy()          # waits for the factor
    return BatchedFactorState(
        analysis=an, a_pattern=_pattern_of(a_pattern),
        values_dev=values_dev, vals=f.vals, inode_perm=f.inode_perm,
        n_perturb=n_perturb,
        timings={"factor_batched": time.perf_counter() - t0}, k=k,
        _values_host=values_host)


def solve_batched(bst: BatchedFactorState, b_batch,
                  refine: bool | None = None, donate: bool = False) -> tuple:
    """Batched substitution + iterative refinement against the K stored
    factorizations: X[k] solves A_k x = b_k.

    b_batch: (K, n), (n,) broadcast, or (K, n, m) multi-RHS.  Returns
    (X, info) with the keys of the JAX package's ``solve_batched``:
    ``residual`` (K,) or (K, m), ``n_refine``, ``n_refine_per_system``,
    ``refine_failed``/``refine_stalled`` masks, ``fallback_mask`` and
    ``n_fp64_fallback``.  refine=False skips refinement.  On a
    reduced-precision engine refining in float64, refinement-failed systems
    are re-factored and re-solved in float64 when ``opts.fp64_fallback``."""
    if donate:
        raise NotImplementedError("solve_batched(donate=True) is not ported "
                                  "yet; see ROADMAP.md")
    an = bst.analysis
    opts = an.opts
    eng = torch_repeated_engine(an)
    t0 = time.perf_counter()
    max_iter = 0 if refine is False else opts.refine_max_iter
    fallback_armed = (
        max_iter > 0 and bool(opts.fp64_fallback)
        and eng.factor_dtype != torch.float64
        and eng.values_dtype == torch.float64)
    b_dev = _stage_rhs(eng, b_batch, bst.k)
    solver = eng.refined_batched_solver(*bst.a_pattern)
    x, resid, n_iter, n_ref_sys, stalled, failed = solver(
        bst.vals, bst.inode_perm, bst.values_dev, b_dev, max_iter,
        resolve_refine_tol(opts, eng.refine_dtype))
    x = x.cpu().numpy()
    info = dict(residual=resid.cpu().numpy(), n_refine=int(n_iter),
                n_refine_per_system=n_ref_sys.cpu().numpy(),
                n_perturb=bst.n_perturb,
                refine_stalled=stalled.cpu().numpy(),
                refine_failed=failed.cpu().numpy(),
                factor_dtype=str(eng.factor_dtype).replace("torch.", ""),
                fallback_mask=np.zeros(bst.k, bool), n_fp64_fallback=0,
                solve_time=time.perf_counter() - t0,
                escalation=(["refine"] if max_iter > 0 else []))
    if max_iter > 0:
        # NaN compares False against tol: a non-finite residual or solution
        # must still count as failed (batched.py:290–295 of the JAX package)
        info["refine_failed"] = _nonfinite_failed(x, info)
    if fallback_armed and info["refine_failed"].any():
        x = _fp64_redo(bst, b_dev, x, info)
        info["escalation"].append("fp64_fallback")
        info["refine_failed"] = _nonfinite_failed(x, info)
        info["solve_time"] = time.perf_counter() - t0
    return x, info


def _nonfinite_failed(x: np.ndarray, info: dict) -> np.ndarray:
    """``refine_failed`` OR non-finite residuals OR non-finite solutions."""
    failed = np.asarray(info["refine_failed"])
    resid = np.asarray(info["residual"])
    bad = ~np.isfinite(resid)
    x_bad = ~np.isfinite(x.reshape(x.shape[0], -1)).all(axis=1)
    return failed | bad | (x_bad if bad.ndim == 1 else x_bad[:, None])


def _fp64_redo(bst: BatchedFactorState, b_dev: torch.Tensor, x: np.ndarray,
               info: dict) -> np.ndarray:
    """Re-factor and re-solve the refinement-failed subset in float64 and
    splice the results back (the escape hatch of :func:`solve_batched`)."""
    an = bst.analysis
    opts = an.opts
    t0 = time.perf_counter()
    failed_h = info["refine_failed"]
    sys_mask = failed_h if failed_h.ndim == 1 else failed_h.any(axis=1)
    idx = np.nonzero(sys_mask)[0]
    eng64 = torch_repeated_engine(an, dtype="float64", refine_dtype="float64")
    sel = torch.from_numpy(idx).to(eng64.device)
    v_sub = bst.values_dev.to(eng64.device, torch.float64)[sel]
    f = eng64.refactor_batched(v_sub)
    solver = eng64.refined_batched_solver(*bst.a_pattern)
    x64, resid64, _, n_ref64, st64, fl64 = solver(
        f.vals, f.inode_perm, v_sub, b_dev.to(torch.float64)[sel],
        opts.refine_max_iter, resolve_refine_tol(opts, "float64"))
    x = np.array(x)
    x[idx] = x64.cpu().numpy().astype(x.dtype)
    for key, new in (("residual", resid64), ("n_refine_per_system", n_ref64),
                     ("refine_stalled", st64), ("refine_failed", fl64)):
        merged = np.array(info[key])
        merged[idx] = new.cpu().numpy()
        info[key] = merged
    info["fallback_mask"] = sys_mask
    info["n_fp64_fallback"] = int(len(idx))
    info["fallback_time"] = time.perf_counter() - t0
    return x


def _seed_values(values_batch) -> np.ndarray:
    """The (nnz,) float64 host values of system 0 that seed the analysis."""
    v0 = values_batch
    while isinstance(v0, (list, tuple)) or getattr(v0, "ndim", 1) > 1:
        v0 = v0[0]
    if isinstance(v0, torch.Tensor):
        v0 = v0.detach().cpu().numpy()
    return np.asarray(v0, dtype=np.float64).copy()


def _is_step_sequence(values_batch) -> bool:
    """True for a T-step sequence: a list/tuple of 2-D (K, nnz) value sets
    or a (T, K, nnz) array.  A list of 1-D value sets is ONE step."""
    if isinstance(values_batch, (list, tuple)):
        if not values_batch:
            return False
        first = values_batch[0]
        ndim = getattr(first, "ndim", None)
        return (np.asarray(first).ndim if ndim is None else ndim) >= 2
    return getattr(values_batch, "ndim", None) == 3


def solve_sequence(a_pattern, values_batch, b_batch,
                   opts: HyluOptions | None = None) -> tuple:
    """Repeated-solve convenience (the paper's §3.2 scenario, batched): one
    analysis seeded by the first value set, then batched factorizations and
    solves.

    values_batch is (K, nnz) — one step — or a T-step sequence ((T, K, nnz)
    or a list of (K, nnz)); b_batch is one RHS batch reused every step or,
    for a sequence, a list with one entry per step.  One step returns
    (x (K, n[, m]), info); a sequence returns (x (T, K, n[, m]), info) with
    info["residual"] (T, K[, m]) and per-step counts.  The sequence path
    reports the failure masks but runs no fp64 escape hatch, as the JAX
    package's pipeline."""
    pattern = _pattern_of(a_pattern)
    n = len(pattern[0]) - 1
    if not _is_step_sequence(values_batch):
        an = analyze(CSR(n, pattern[0], pattern[1],
                         _seed_values(values_batch)), opts)
        bst = factor_batched(an, pattern, values_batch)
        x, info = solve_batched(bst, b_batch)
        info.update(timings={"preprocess": an.timings,
                             "factor": bst.timings},
                    mode=an.choice.mode, ordering=an.ordering_name,
                    engine="torch-batched", k=bst.k)
        return x, info

    steps_v = (list(values_batch) if isinstance(values_batch, (list, tuple))
               else [values_batch[t] for t in range(values_batch.shape[0])])
    per_step_b = isinstance(b_batch, (list, tuple))
    if per_step_b and len(b_batch) != len(steps_v):
        raise ValueError(f"got {len(b_batch)} per-step right-hand sides "
                         f"for {len(steps_v)} steps")
    an = analyze(CSR(n, pattern[0], pattern[1], _seed_values(steps_v[0])),
                 opts)
    opts = an.opts
    eng = torch_repeated_engine(an)
    solver = eng.refined_batched_solver(*pattern)
    tol = resolve_refine_tol(opts, eng.refine_dtype)
    t_all = time.perf_counter()
    outs, n_pert, k = [], [], None
    for t, v in enumerate(steps_v):
        v_dev, _, kt = _stage_values(eng, v)
        if k is not None and kt != k:
            raise ValueError(f"step {t} has batch size {kt}, step 0 had {k}")
        k = kt
        b_dev = _stage_rhs(eng, b_batch[t] if per_step_b else b_batch, k)
        f = eng.refactor_batched(v_dev)
        outs.append(solver(f.vals, f.inode_perm, v_dev, b_dev,
                           opts.refine_max_iter, tol))
        n_pert.append(f.n_perturb)
    _sync(eng.device)
    t_all = time.perf_counter() - t_all

    def stack(i):
        return np.stack([o[i].cpu().numpy() for o in outs])

    info = dict(residual=stack(1), n_refine=[int(o[2]) for o in outs],
                n_refine_per_system=stack(3),
                n_perturb=np.stack([p.cpu().numpy() for p in n_pert]),
                refine_stalled=stack(4), refine_failed=stack(5),
                solve_time=t_all,
                timings={"preprocess": an.timings, "pipeline": t_all},
                mode=an.choice.mode, ordering=an.ordering_name,
                engine="torch-batched", k=k, steps=len(steps_v),
                donate=False)
    return stack(0), info
