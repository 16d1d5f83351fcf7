"""Batched repeated solve: K value sets of one pattern on one device.

Adapted from ``src/repro/core/batched.py``: ``factor_batched``,
``solve_batched`` (with the non-finite guard ``_nonfinite_failed``, the
per-system fp64 escape hatch ``_fp64_redo`` and buffer donation, which
spends the state: ``BatchedFactorState.consumed``), ``solve_sequence``
(one step, or a T-step sequence through the double-buffered pipeline
``_solve_sequence_pipelined``, donating with ``opts.donate``), and the
host-side oracles the JAX benchmark holds the fused solve against:
``_batched_matvec`` (numpy residuals) and ``_solve_batched_hostloop``
(device substitution, numpy residuals, a Python refinement loop).  Inputs
may be host arrays or torch tensors; results come back as numpy arrays,
as the JAX package returns them.

The split of K over devices (``HyluOptions.mesh``, the JAX package's
shard over a 1-D mesh, ``src/repro/core/batched.py:98–181``): K is padded
up to a multiple of the shard count, values by replicating system 0 and
right-hand sides by zeros (a padded system converges at iteration 0), and
each contiguous shard is factored and solved on its device by its
device's engine, as one unsplit batch each (``BatchedFactorState.shards``,
one shard when K is not split);
results are gathered and cut back to the caller's K.  The shards run at
once, as the JAX package's ``shard_map`` runs them: every shard's factor
is queued before any perturbation count is read, and the refinement loops
step together (``torch_engine.run_together``: one iteration of every live
shard is queued, then their loop flags are read).  Every system's
arithmetic is its own, so on the CPU the split is bit-identical to the
unsplit run; the reported refinement count is the largest shard's, as the
JAX package's ``pmax``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .matrix import CSR
from .analysis import Analysis, _sync, analyze, torch_repeated_engine
from .options import HyluOptions, resolve_mesh, resolve_refine_tol
from .torch_engine import on_device, run_together


@dataclasses.dataclass
class FactorShard:
    """A contiguous run of ``k`` systems of a :class:`BatchedFactorState`,
    factored on one device by that device's engine."""
    values_dev: torch.Tensor | None   # (k, nnz) A values, refine dtype;
    #                                   None once donated to a solve
    vals: torch.Tensor         # (k, total_slots) factored panels
    inode_perm: torch.Tensor   # (k, n) in-node pivot permutations
    n_perturb: np.ndarray      # (k,) perturbation counts
    k: int
    device: torch.device | None = None   # its engine's (None: opts.device)
    values_host: np.ndarray | None = dataclasses.field(default=None,
                                                       repr=False)

    @property
    def values_batch(self) -> np.ndarray:
        """(k, nnz) host copy of the A values (copied on first access)."""
        if self.values_host is None:
            self.values_host = self.values_dev.cpu().numpy()
        return self.values_host


@dataclasses.dataclass
class BatchedFactorState:
    """K factorizations of one sparsity pattern, held as device tensors in
    ``shards``: one shard when K is not split, else one per device of
    ``HyluOptions.mesh``, each of ``k_pad / len(shards)`` systems.  ``k``
    is the caller's K, and every result is cut back to it."""
    analysis: Analysis
    a_pattern: tuple           # (indptr, indices) of the original matrices
    shards: list               # FactorShard, in order of K
    n_perturb: np.ndarray      # (K,) perturbation counts
    timings: dict
    k: int
    consumed: bool = False     # its buffers were donated to a solve
    _values_host: np.ndarray | None = dataclasses.field(default=None,
                                                        repr=False)

    @property
    def k_pad(self) -> int:
        """K padded to a multiple of the shard count (K unsplit)."""
        return sum(sh.k for sh in self.shards)

    def _gathered(self, name: str):
        """One tensor field over the shards, on the first shard's device and
        cut back to K (unsplit: the shard's own tensor)."""
        ts = [getattr(sh, name) for sh in self.shards]
        if len(ts) == 1:
            return ts[0]
        if any(t is None for t in ts):
            return None
        return torch.cat([t.to(ts[0].device) for t in ts])[:self.k]

    @property
    def values_dev(self) -> torch.Tensor | None:
        """(K, nnz) A values in the refine dtype (None once donated)."""
        return self._gathered("values_dev")

    @property
    def vals(self) -> torch.Tensor:
        """(K, total_slots) factored panels."""
        return self._gathered("vals")

    @property
    def inode_perm(self) -> torch.Tensor:
        """(K, n) in-node pivot permutations."""
        return self._gathered("inode_perm")

    @property
    def values_batch(self) -> np.ndarray:
        """(K, nnz) host copy of the A values (copied on first access)."""
        if len(self.shards) == 1:
            return self.shards[0].values_batch
        if self._values_host is None:
            self._values_host = np.concatenate(
                [sh.values_batch for sh in self.shards])[:self.k]
        return self._values_host


def _engine(an: Analysis, sh: FactorShard, **kw):
    return torch_repeated_engine(an, device=sh.device, **kw)


def _split_rows(x, n: int, fill: str) -> list:
    """(K, ...) rows — a host array or a tensor — in n contiguous shards of
    ceil(K / n) rows, the last ones filled up to that size with system 0's
    row (``fill="first"``) or zeros (``"zeros"``): the padding of
    ``_stage_values`` / ``_stage_rhs`` in ``src/repro/core/batched.py``.
    Full shards are views of x (no copy)."""
    k = x.shape[0]
    s = -(-k // n)
    out = []
    for i in range(n):
        piece = x[i * s:(i + 1) * s]
        short = s - piece.shape[0]
        if short:
            tensor = isinstance(x, torch.Tensor)
            if fill == "first":
                row = x[:1]
                pad = (row.expand((short,) + tuple(x.shape[1:])) if tensor
                       else np.broadcast_to(row, (short,) + x.shape[1:]))
            else:
                pad = (x.new_zeros((short,) + tuple(x.shape[1:])) if tensor
                       else np.zeros((short,) + x.shape[1:], x.dtype))
            piece = (torch.cat([piece, pad]) if tensor
                     else np.concatenate([piece, pad]))
        out.append(piece)
    return out


def _split_rhs(b_batch, k: int, n: int) -> list:
    """A right-hand-side batch in n shards: a 1-D right-hand side goes to
    every shard, a (K, rows[, m]) batch is split and zero-padded; a
    leading dimension that matches neither K nor 1 raises first."""
    _check_rhs(b_batch, k)
    if getattr(b_batch, "ndim", np.ndim(b_batch)) == 1:
        return [b_batch] * n
    if not isinstance(b_batch, torch.Tensor):
        b_batch = np.asarray(b_batch)
    return _split_rows(b_batch, n, "zeros")


def _merge_info(infos: list, k: int) -> dict:
    """The shards' infos of a split solve as one, cut back to K: per-system
    arrays concatenated, the refinement count the largest."""
    out = dict(infos[0])
    for key, v in infos[0].items():
        if isinstance(v, np.ndarray) and v.ndim >= 1:
            out[key] = np.concatenate([i[key] for i in infos])[:k]
    out["n_refine"] = max(int(i["n_refine"]) for i in infos)
    if "n_fp64_fallback" in out:
        out["n_fp64_fallback"] = int(np.asarray(out["fallback_mask"]).sum())
        out["escalation"] = max((i["escalation"] for i in infos), key=len)
    for key in ("solve_time", "fallback_time"):
        if any(key in i for i in infos):
            out[key] = sum(i.get(key, 0.0) for i in infos)
    return out


def _pattern_of(a_pattern) -> tuple:
    if isinstance(a_pattern, CSR):
        return (a_pattern.indptr, a_pattern.indices)
    indptr, indices = a_pattern
    return (np.asarray(indptr), np.asarray(indices))


def _batched_matvec(pattern: tuple, values_batch: np.ndarray,
                    x_batch: np.ndarray) -> np.ndarray:
    """(A_k x_k) for K CSR matrices sharing one pattern, on the host: one
    gather and a row-segment reduction for the whole batch (the JAX
    package's ``_batched_matvec``, ``src/repro/core/batched.py:68``).  The
    fused solve computes residuals on the device
    (``torch_engine.make_csr_matvec_batched``); this stays as the oracle of
    tests and of the host-loop solve.  x_batch is (K, n) or (K, n, m)."""
    indptr, indices = pattern
    if x_batch.ndim == 3:
        prod = values_batch[:, :, None] * x_batch[:, indices]
    else:
        prod = values_batch * x_batch[:, indices]
    counts = np.diff(indptr)
    if len(counts) == 0:
        return np.zeros_like(x_batch)
    if counts.min() > 0:
        return np.add.reduceat(prod, indptr[:-1], axis=1)
    # reduceat mishandles empty rows: a per-system scatter-add instead
    # (np.add.at keeps the batch dtype, where bincount would promote)
    seg = np.repeat(np.arange(len(counts)), counts)
    out = np.zeros((x_batch.shape[0], len(counts)) + x_batch.shape[2:],
                   dtype=prod.dtype)
    for k in range(out.shape[0]):
        np.add.at(out[k], seg, prod[k])
    return out


def _np_dtype(tdtype):
    return np.dtype(str(tdtype).rsplit(".", 1)[1])     # "torch.float64"


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


def _check_rhs(b_batch, k: int) -> None:
    if getattr(b_batch, "ndim", 1) > 1 and b_batch.shape[0] != k:
        raise ValueError(f"b_batch has leading (batch) dimension "
                         f"{b_batch.shape[0]} but the factorization batch "
                         f"size is {k}")


def _stage_rhs(eng, b_batch, k: int, copy: bool = False) -> torch.Tensor:
    """Right-hand sides (K, n), (n,) broadcast or (K, n, m) on the device;
    a leading dimension that matches neither K nor 1 raises.  ``copy``
    gives a buffer of the solve's own even for a tensor that is already on
    the device in the right dtype (a donated buffer is never the
    caller's)."""
    _check_rhs(b_batch, k)
    if isinstance(b_batch, torch.Tensor):
        b = b_batch.to(device=eng.device, dtype=eng.values_dtype, copy=copy)
    else:
        b = torch.from_numpy(np.ascontiguousarray(
            np.asarray(b_batch, dtype=_np_dtype(eng.values_dtype))))
        b = b.to(eng.device, copy=copy)
    if b.ndim == 1:
        b = b.expand(k, b.shape[0])
    return b


def factor_batched(an: Analysis, a_pattern, values_batch) -> BatchedFactorState:
    """K numeric factorizations (one pattern, K value sets) on the
    analysis' device.  ``values_batch`` is a host (K, nnz) array or a
    tensor.  Under ``an.opts.mesh`` K is padded to a multiple of the shard
    count (by system 0's values) and each shard is factored on its
    device; a shard of a tensor on its device is read in place."""
    devices = resolve_mesh(an.opts) or [None]
    for dev in devices:                    # built outside the timing
        torch_repeated_engine(an, device=dev)
    t0 = time.perf_counter()
    if not isinstance(values_batch, torch.Tensor):
        values_batch = np.atleast_2d(np.asarray(values_batch))
    elif values_batch.ndim == 1:
        values_batch = values_batch[None]
    k = int(values_batch.shape[0])
    queued = [_factor_shard(an, piece, dev) for piece, dev
              in zip(_split_rows(values_batch, len(devices), "first"),
                     devices)]
    shards = [FactorShard(n_perturb=npt.cpu().numpy(), **kw)  # waits for it
              for npt, kw in queued]     # every shard queued before a read
    return BatchedFactorState(
        analysis=an, a_pattern=_pattern_of(a_pattern), shards=shards,
        n_perturb=np.concatenate([sh.n_perturb for sh in shards])[:k],
        timings={"factor_batched": time.perf_counter() - t0}, k=k)


def _factor_shard(an, values_batch, device) -> tuple:
    """One shard's batch factored on ``device`` (None: ``an.opts.device``),
    queued only: its perturbation counts on the device and the rest of its
    :class:`FactorShard`'s fields."""
    eng = torch_repeated_engine(an, device=device)
    values_dev, values_host, k = _stage_values(eng, values_batch)
    f = eng.refactor_batched(values_dev)
    return f.n_perturb, dict(values_dev=values_dev, vals=f.vals,
                             inode_perm=f.inode_perm, k=k, device=device,
                             values_host=values_host)


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
    are re-factored and re-solved in float64 when ``opts.fp64_fallback``.

    donate=True gives the state's staged A values and the staged right-hand
    sides to the call (the sequence pipeline's mode, ``batched.py:213–303``
    of the JAX package): the host copy of the values is made first (the
    escape hatch and ``values_batch`` read it), the right-hand sides are
    staged into a buffer of the solve's own even when the caller passed a
    device tensor (a caller's buffer is never given away) and snapshotted
    when the escape hatch is armed; the solve may overwrite both buffers
    (this one reads them only) and drops them at its end, and ``bst`` is
    marked consumed: a later solve against it raises."""
    if bst.consumed:
        raise RuntimeError(
            "this BatchedFactorState was consumed by a donating solve; "
            "refactor (factor_batched) before solving again")
    t0 = time.perf_counter()
    outs = [finish() for finish in run_together([
        _solve_shard(bst.analysis, bst.a_pattern, sh, piece, refine, donate)
        for sh, piece in zip(bst.shards, _split_rhs(b_batch, bst.k,
                                                    len(bst.shards)))])]
    if donate:
        bst.consumed = True
    info = _merge_info([o[1] for o in outs], bst.k)
    info["n_perturb"] = bst.n_perturb
    info["solve_time"] = time.perf_counter() - t0
    return np.concatenate([o[0] for o in outs])[:bst.k], info


def _solve_shard(an: Analysis, pattern, sh: FactorShard, b_batch, refine,
                 donate: bool):
    """:func:`solve_batched` on one shard, a generator for
    :func:`run_together`: its refined solve steps with the other shards'.
    It returns ``finish()``, which reads the shard's results and runs its
    fp64 fallback, after every shard's main solve has ended, and gives
    (x, info) for its k systems."""
    opts = an.opts
    eng = _engine(an, sh)
    t0 = time.perf_counter()
    max_iter = 0 if refine is False else opts.refine_max_iter
    fallback_armed = (
        max_iter > 0 and bool(opts.fp64_fallback)
        and eng.factor_dtype != torch.float64
        and eng.values_dtype == torch.float64)
    if donate:
        _ = sh.values_batch      # the host copy, before the buffer goes
    b_dev = _stage_rhs(eng, b_batch, sh.k, copy=donate)
    b_src = b_dev.clone() if (donate and fallback_armed) else b_dev
    solver = eng.refined_batched_steps(*pattern)
    x, resid, n_iter, n_ref_sys, stalled, failed = yield from solver(
        sh.vals, sh.inode_perm, sh.values_dev, b_dev, max_iter,
        resolve_refine_tol(opts, eng.refine_dtype))
    if donate:
        sh.values_dev = None

    def finish():
        x_h = x.cpu().numpy()
        info = dict(residual=resid.cpu().numpy(), n_refine=int(n_iter),
                    n_refine_per_system=n_ref_sys.cpu().numpy(),
                    n_perturb=sh.n_perturb,
                    refine_stalled=stalled.cpu().numpy(),
                    refine_failed=failed.cpu().numpy(),
                    factor_dtype=str(eng.factor_dtype).replace("torch.", ""),
                    fallback_mask=np.zeros(sh.k, bool), n_fp64_fallback=0,
                    solve_time=time.perf_counter() - t0,
                    escalation=(["refine"] if max_iter > 0 else []))
        if max_iter > 0:
            # NaN compares False against tol: a non-finite residual or
            # solution must still count as failed (batched.py:290–295 of
            # the JAX package)
            info["refine_failed"] = _nonfinite_failed(x_h, info)
        if fallback_armed and info["refine_failed"].any():
            x_h = _fp64_redo(an, pattern, sh, b_src, x_h, info)
            info["escalation"].append("fp64_fallback")
            info["refine_failed"] = _nonfinite_failed(x_h, info)
            info["solve_time"] = time.perf_counter() - t0
        return x_h, info

    return finish


def _nonfinite_failed(x: np.ndarray, info: dict) -> np.ndarray:
    """``refine_failed`` OR non-finite residuals OR non-finite solutions."""
    failed = np.asarray(info["refine_failed"])
    resid = np.asarray(info["residual"])
    bad = ~np.isfinite(resid)
    x_bad = ~np.isfinite(x.reshape(x.shape[0], -1)).all(axis=1)
    return failed | bad | (x_bad if bad.ndim == 1 else x_bad[:, None])


def _fp64_redo(an: Analysis, pattern, sh: FactorShard, b_dev: torch.Tensor,
               x: np.ndarray, info: dict) -> np.ndarray:
    """Re-factor and re-solve a shard's refinement-failed subset in float64
    and splice the results back (the escape hatch of
    :func:`solve_batched`)."""
    opts = an.opts
    t0 = time.perf_counter()
    failed_h = info["refine_failed"]
    sys_mask = failed_h if failed_h.ndim == 1 else failed_h.any(axis=1)
    idx = np.nonzero(sys_mask)[0]
    eng64 = _engine(an, sh, dtype="float64", refine_dtype="float64")
    sel = torch.from_numpy(idx).to(eng64.device)
    values = (sh.values_dev if sh.values_dev is not None
              else torch.from_numpy(sh.values_batch))   # donated: the host copy
    v_sub = values.to(eng64.device, torch.float64)[sel]
    f = eng64.refactor_batched(v_sub)
    solver = eng64.refined_batched_solver(*pattern)
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


def _solve_batched_hostloop(bst: BatchedFactorState, b_batch,
                            refine: bool | None = None) -> tuple:
    """The host-loop form of :func:`solve_batched` (the JAX package's
    ``_solve_batched_hostloop``, ``src/repro/core/batched.py:357``): the
    substitution on the device (``eng.apply_batched``), but numpy
    residuals (:func:`_batched_matvec`) and a Python refinement loop, one
    host round trip per iteration.  The baseline the fused solve is timed
    against, and a parity oracle: the same per-system improved / converged
    masking and the same multi-RHS shapes.  Returns (x, info) with
    ``residual``, ``n_refine``, ``n_perturb``, ``refine_failed``,
    ``refine_stalled`` and ``solve_time``."""
    t0 = time.perf_counter()
    if isinstance(b_batch, torch.Tensor):
        b_batch = b_batch.detach().cpu().numpy()
    for sh in bst.shards:     # the residuals' host values, before any launch
        _ = sh.values_batch
    outs = run_together([
        _hostloop_shard(bst.analysis, bst.a_pattern, sh, piece, refine)
        for sh, piece in zip(bst.shards, _split_rhs(b_batch, bst.k,
                                                    len(bst.shards)))])
    info = _merge_info([o[1] for o in outs], bst.k)
    info["n_perturb"] = bst.n_perturb
    info["solve_time"] = time.perf_counter() - t0
    return np.concatenate([o[0] for o in outs])[:bst.k], info


def _hostloop_shard(an: Analysis, pattern, sh: FactorShard, b_batch,
                    refine):
    """:func:`_solve_batched_hostloop` on one shard, a generator for
    :func:`run_together` (each substitution is yielded, so every shard's
    is queued before any is read); returns (x, info)."""
    opts = an.opts
    eng = _engine(an, sh)
    t0 = time.perf_counter()
    # staged and accumulated in the engine's refine dtype, as the fused
    # path (the substitution runs in the factor dtype inside apply_batched)
    rdt = _np_dtype(eng.refine_dtype)
    tol = resolve_refine_tol(opts, eng.refine_dtype)
    b_batch = np.asarray(b_batch, dtype=rdt)
    if b_batch.ndim == 1:
        b_batch = np.broadcast_to(b_batch, (sh.k, b_batch.shape[0]))

    def apply(r):
        rhs = torch.from_numpy(np.ascontiguousarray(r)).to(eng.device)
        # widened on the device (numpy has no bfloat16)
        return eng.apply_batched(sh.vals, sh.inode_perm,
                                 rhs).to(eng.refine_dtype)

    def residuals(x):
        r = b_batch - _batched_matvec(pattern, sh.values_batch, x)
        return r, np.abs(r).sum(axis=1) / bnorm

    bnorm = np.abs(b_batch).sum(axis=1)          # (K,) or (K, m)
    bnorm = np.where(bnorm == 0.0, 1.0, bnorm)
    x = yield apply(b_batch)
    r, resid = residuals(x)
    n_ref = 0
    alive = np.ones(resid.shape, bool)
    max_iter = 0 if refine is False else opts.refine_max_iter
    for _ in range(max_iter):
        need = alive & (resid > tol)
        if not need.any():
            break
        x2 = x + (yield apply(r))
        r2, resid2 = residuals(x2)
        n_ref += 1
        improved = resid2 < resid
        upd = need & improved                     # the fused masking
        x = np.where(upd[:, None], x2, x)
        r = np.where(upd[:, None], r2, r)
        resid = np.where(upd, resid2, resid)
        alive = alive & (improved | ~need)
    failed = (resid > tol) & (max_iter > 0)
    info = dict(residual=resid, n_refine=n_ref, n_perturb=sh.n_perturb,
                refine_failed=failed, refine_stalled=failed & ~alive,
                solve_time=time.perf_counter() - t0)
    return x, info


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
    (x (K, n[, m]), info); a sequence runs the double-buffered pipeline
    (:func:`_solve_sequence_pipelined`, donating with ``opts.donate``) and
    returns (x (T, K, n[, m]), info) with info["residual"] (T, K[, m]) and
    per-step counts.  The sequence reports the failure masks but runs no
    fp64 escape hatch, as the JAX package's pipeline."""
    pattern = _pattern_of(a_pattern)
    n = len(pattern[0]) - 1
    if _is_step_sequence(values_batch):
        return _solve_sequence_pipelined(pattern, values_batch, b_batch, opts)
    an = analyze(CSR(n, pattern[0], pattern[1], _seed_values(values_batch)),
                 opts)
    bst = factor_batched(an, pattern, values_batch)
    x, info = solve_batched(bst, b_batch)
    info.update(timings={"preprocess": an.timings, "factor": bst.timings},
                mode=an.choice.mode, ordering=an.ordering_name,
                engine="torch-batched", k=bst.k)
    return x, info


class _Staging:
    """Two device buffers filled in turn (double buffering).  On CUDA a host
    array goes through a pinned host buffer of its slot and a
    ``non_blocking`` copy on the copy stream; events order the copy stream
    against the compute stream both ways (a slot is refilled only after the
    step that read it).  A tensor already on the device is used in place,
    or copied into the slot when ``copy`` (a donated buffer is never the
    caller's).  On the CPU the same slots are filled by plain copies."""

    def __init__(self, device, dtype, copy: bool):
        self.device, self.dtype, self.copy = device, dtype, copy
        self.cuda = device.type == "cuda"
        self.dev = [None, None]
        self.pinned = [None, None]
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self.ready = [torch.cuda.Event(), torch.cuda.Event()]
            self.free = [torch.cuda.Event(), torch.cuda.Event()]

    def _slot(self, bufs, slot, shape, pin=False):
        t = bufs[slot]
        if t is None or tuple(t.shape) != tuple(shape):
            t = bufs[slot] = (torch.empty(shape, dtype=self.dtype,
                                          pin_memory=True) if pin
                              else torch.empty(shape, dtype=self.dtype,
                                               device=self.device))
        return t

    def fill(self, slot: int, src) -> torch.Tensor:
        """Queue the copy of ``src`` into ``slot``; returns the tensor the
        step reads (after :meth:`use`)."""
        if isinstance(src, torch.Tensor) and on_device(src, self.device):
            if not self.copy:
                return src.to(self.dtype)
            host = None
        else:
            src = (src.detach().cpu() if isinstance(src, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(np.asarray(
                       src, dtype=_np_dtype(self.dtype)))))
            host = src.to(self.dtype)
        dst = self._slot(self.dev, slot, src.shape)
        if not self.cuda:
            dst.copy_(src if host is None else host)
            return dst
        if host is not None:
            self.ready[slot].synchronize()   # its last copy has left it
            pin = self._slot(self.pinned, slot, host.shape, pin=True)
            pin.copy_(host)
            src = pin
        else:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(self.free[slot])
            dst.copy_(src, non_blocking=True)
            self.ready[slot].record(self.stream)
        return dst

    def use(self, slot: int) -> None:
        """The compute stream waits for the slot's copy."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(
                self.ready[slot])

    def release(self, slot: int) -> None:
        """The step that read the slot is queued: it may be refilled after
        that step."""
        if self.cuda:
            self.free[slot].record(torch.cuda.current_stream(self.device))


def _solve_sequence_pipelined(pattern, values_steps, b_steps,
                              opts: HyluOptions | None = None) -> tuple:
    """The T-step pipeline behind :func:`solve_sequence`
    (``_solve_sequence_pipelined``, ``src/repro/core/batched.py:493–580``).

    Each step's values and right-hand sides go into two device staging
    buffers in turn (:class:`_Staging`): on CUDA from pinned host memory by
    ``non_blocking`` copies on a copy stream, ordered against the compute
    stream by events.  The copy for step t + 1 is queued as soon as step
    t's refactor is queued, so it overlaps step t's factor and solve.  With
    ``opts.donate`` step t + 1's refactor writes into step t's factor
    buffers (``refactor_batched(out=)``) and a device tensor of the caller
    is copied into the staging buffer, never used in place: the stream
    allocates no new factor buffer per step.  The JAX pipeline syncs the
    host once, at the end; here the refinement loop syncs the host once per
    iteration (``torch_engine.py``, ``refined_batched_solver``), so the
    overlap ends at each step's first refinement test, and the host's
    launches of step t + 1 wait for step t's last one.  The sequence runs
    no fp64 escape hatch (a redo mid-stream would stall the buffers), as in
    the JAX package."""
    steps_v = _check_steps(values_steps, b_steps)
    n = len(pattern[0]) - 1
    an = analyze(CSR(n, pattern[0], pattern[1], _seed_values(steps_v[0])),
                 opts)
    return _run_pipeline(an, pattern, steps_v, b_steps)


def _check_steps(values_steps, b_steps) -> list:
    """The steps' value sets as a list; per-step right-hand sides come as
    a list/tuple of one entry per step (a bare array is one RHS reused
    every step, so (K, n, m) stays unambiguous)."""
    steps_v = (list(values_steps) if isinstance(values_steps, (list, tuple))
               else [values_steps[t] for t in range(values_steps.shape[0])])
    if isinstance(b_steps, (list, tuple)) and len(b_steps) != len(steps_v):
        raise ValueError(f"got {len(b_steps)} per-step right-hand sides "
                         f"for {len(steps_v)} steps")
    return steps_v


class _Shard:
    """One shard of the pipeline: its device's engine and solver, its
    staging buffers, its last factors and its per-step results."""

    def __init__(self, an: Analysis, pattern, device, donate: bool):
        self.eng = torch_repeated_engine(an, device=device)
        self.solver = self.eng.refined_batched_steps(*pattern)
        self.vstage = _Staging(self.eng.device, self.eng.values_dtype, donate)
        self.bstage = _Staging(self.eng.device, self.eng.values_dtype, donate)
        self.prev, self.outs, self.n_pert = None, [], []


def _run_pipeline(an: Analysis, pattern, values_steps, b_steps) -> tuple:
    """The pipeline of :func:`_solve_sequence_pipelined` on an analysis of
    the pattern (``an.opts`` decides donation): ``chip_smoke.py`` runs
    several streams on one analysis of fem2d_10k.  Under ``an.opts.mesh``
    each step's K is padded and split as :func:`factor_batched` splits it,
    and every shard runs the pipeline on its device with its own staging
    buffers (all shards' refactors of a step are queued, then the next
    step's copies, then the solves, which step together)."""
    steps_v = _check_steps(values_steps, b_steps)
    n_steps = len(steps_v)
    per_step_b = isinstance(b_steps, (list, tuple))

    def b_of(t):
        return b_steps[t] if per_step_b else b_steps

    opts = an.opts
    donate = bool(opts.donate)
    shards = [_Shard(an, pattern, dev, donate)
              for dev in (resolve_mesh(opts) or (None,))]
    n_sh = len(shards)
    max_iter = opts.refine_max_iter
    tol = resolve_refine_tol(opts, shards[0].eng.refine_dtype)

    k = len(steps_v[0])                 # every step is (K, nnz)

    def stage(t):
        """Queue step t's copies; per shard (values, right-hand sides)."""
        if len(steps_v[t]) != k:
            raise ValueError(f"step {t} has batch size {len(steps_v[t])}, "
                             f"step 0 had {k}")
        v, b = steps_v[t], b_of(t)
        if n_sh == 1:
            _check_rhs(b, k)
            vs, bs = [v], [b]
        else:
            vs = _split_rows(v if isinstance(v, torch.Tensor)
                             else np.asarray(v), n_sh, "first")
            bs = _split_rhs(b, k, n_sh)
        return [(sh.vstage.fill(t % 2, v_), sh.bstage.fill(t % 2, b_))
                for sh, v_, b_ in zip(shards, vs, bs)]

    t_all = time.perf_counter()
    cur = stage(0)
    for t in range(n_steps):
        fs = []
        for sh, (v_dev, _) in zip(shards, cur):
            sh.vstage.use(t % 2)
            sh.bstage.use(t % 2)
            fs.append(sh.eng.refactor_batched(
                v_dev, out=sh.prev if donate else None))
        nxt = stage(t + 1) if t + 1 < n_steps else None
        solves = []
        for sh, f, (v_dev, b_dev) in zip(shards, fs, cur):
            ks = v_dev.shape[0]
            b = b_dev if b_dev.ndim > 1 else b_dev.expand(ks, b_dev.shape[0])
            solves.append(sh.solver(f.vals, f.inode_perm, v_dev, b,
                                    max_iter, tol))
        for sh, f, out in zip(shards, fs, run_together(solves)):
            sh.outs.append(out)
            sh.vstage.release(t % 2)
            sh.bstage.release(t % 2)
            sh.n_pert.append(f.n_perturb)
            sh.prev = f
        if nxt is not None:
            cur = nxt
    for sh in shards:
        _sync(sh.eng.device)
    t_all = time.perf_counter() - t_all

    def stack(get):
        """(T, K, ...) of one result over the steps, the shards gathered
        and cut back to K."""
        return np.stack([np.concatenate([get(sh, t).cpu().numpy()
                                         for sh in shards])[:k]
                         for t in range(n_steps)])

    info = dict(residual=stack(lambda sh, t: sh.outs[t][1]),
                n_refine=[max(int(sh.outs[t][2]) for sh in shards)
                          for t in range(n_steps)],
                n_refine_per_system=stack(lambda sh, t: sh.outs[t][3]),
                n_perturb=stack(lambda sh, t: sh.n_pert[t]),
                refine_stalled=stack(lambda sh, t: sh.outs[t][4]),
                refine_failed=stack(lambda sh, t: sh.outs[t][5]),
                solve_time=t_all,
                timings={"preprocess": an.timings, "pipeline": t_all},
                mode=an.choice.mode, ordering=an.ordering_name,
                engine="torch-batched", k=k, steps=n_steps, donate=donate)
    return stack(lambda sh, t: sh.outs[t][0]), info
