"""SolverService: mixed-pattern serving on top of the batched engines.

Adapted from ``src/repro/serve/solver_service.py``.  The batched
repeated-solve path factors and solves K systems of ONE sparsity pattern
on one device.  Serving traffic mixes patterns arbitrarily; this module is
the dispatcher that makes the mixed stream look like per-pattern batches:

    requests (a_i, b_i)  ──validate──►  typed rejection | accepted
        │                                      │  group by plan_fingerprint
        ▼                                      ▼  chunk + pad to batch_size
    PlanCache (memory → checkpoints/ → analyze)   factor_batched+solve_batched
        │                                      │
        └── Analysis + its engines             └── scatter back to
                                                   request order

Padding replicates the chunk's first value set with a zero RHS (it
converges on refinement iteration 0 and is sliced away), so every
(pattern, batch_size) pair runs one engine at one batch shape however the
group sizes fluctuate.  Per-request results are those of running the
request's group through ``factor_batched``/``solve_batched`` directly.

Fault tolerance (the serving robustness contract):

* **Admission validation** — every request is validated before it can
  reach a batch (:func:`validate_request`): matrix type/shape, real
  numeric dtypes, finite values/RHS, RHS shape, structural
  non-singularity.  ``solve_batch`` turns a failed validation into a
  typed per-request result (``status="rejected"``, ``error.code`` from
  the taxonomy below); ``submit`` raises :class:`InvalidRequestError`
  immediately so a malformed request never enters the queued window.
* **Error isolation** — each pattern group's analysis and each chunk's
  dispatch run under their own exception barrier: a raise marks *that*
  group's requests ``status="failed"`` (``error.code="dispatch_error"``,
  with the stage and exception in ``error.detail``) and every other
  group's results are returned untouched.  A kernel that fails to build
  or launch therefore surfaces as its group's ``dispatch_error``.
* **Escalation ladder** — a request whose refinement exits above
  tolerance (after the fp64 fallback of ``core.batched.solve_batched``)
  is re-dispatched up to ``opts.retry_max`` times with a boosted
  pivot-perturbation threshold (``options.resolve_retry_perturb``; a
  distinct plan fingerprint, so retries never touch the healthy traffic's
  plans).  What still fails is returned ``status="quarantined"`` with
  diagnostics in ``error.detail``; its ``x`` is the best attempt, flagged
  untrustworthy.

Every request therefore receives exactly one terminal result:
``solved`` | ``rejected`` | ``failed`` | ``quarantined``.

A missing card is not a per-request fault: ``SolverService`` resolves
``opts.device`` when it is built, so a service asked for the card on a
machine without one raises there instead of failing every request.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core.batched import factor_batched, solve_batched
from ..core.matrix import CSR
from ..core.options import (HyluOptions, plan_fingerprint, resolve_device,
                            resolve_mesh,
                            resolve_dtype_names, resolve_retry_perturb)
from ..core.plan_cache import DEFAULT_CACHE_DIR, PlanCache


# ------------------------------------------------------------ error taxonomy
# Admission-time rejections — the request never reaches a batch:
ERR_BAD_MATRIX = "bad_matrix"              # not a CSR / nothing with tocsr()
ERR_BAD_DTYPE = "bad_dtype"                # values/RHS not real numeric
ERR_NONFINITE_VALUES = "nonfinite_values"  # NaN/Inf in the matrix values
ERR_NONFINITE_RHS = "nonfinite_rhs"        # NaN/Inf in the right-hand side
ERR_SHAPE_MISMATCH = "shape_mismatch"      # RHS shape incompatible with n
ERR_SINGULAR_PATTERN = "singular_pattern"  # structurally singular pattern
                                           # (empty row or column)
ERR_QUEUE_FULL = "queue_full"              # async admission control: bounded
                                           # queue is full (backpressure)
# Dispatch-time failure — the request's pattern group raised:
ERR_DISPATCH = "dispatch_error"
# Post-ladder quarantine — dispatched, but never reached tolerance:
ERR_QUARANTINED = "quarantined"

# Terminal statuses: every request gets exactly one result in exactly one
# of these states.
STATUS_SOLVED = "solved"            # dispatched, refinement at tolerance
STATUS_REJECTED = "rejected"        # refused at admission (typed error)
STATUS_FAILED = "failed"            # its group's dispatch raised
STATUS_QUARANTINED = "quarantined"  # dispatched; tolerance unreachable even
                                    # after the full escalation ladder
TERMINAL_STATUSES = (STATUS_SOLVED, STATUS_REJECTED, STATUS_FAILED,
                     STATUS_QUARANTINED)


@dataclasses.dataclass
class SolveError:
    """Typed per-request error: a taxonomy ``code`` (the ``ERR_*``
    constants), a human-readable ``message``, and a ``detail`` dict of
    structured diagnostics (offending index, residual, retry count, …)."""
    code: str
    message: str
    detail: dict = dataclasses.field(default_factory=dict)


class InvalidRequestError(ValueError):
    """Raised by ``SolverService.submit`` when a request fails admission
    validation — carries the typed ``SolveError`` as ``.error`` so callers
    can branch on ``error.code`` instead of parsing the message."""

    def __init__(self, error: SolveError):
        super().__init__(f"{error.code}: {error.message}")
        self.error = error


@dataclasses.dataclass
class SolveRequest:
    """One serving request: solve ``a x = b`` for this request's matrix.

    a    — CSR (pattern + values); anything with ``tocsr()`` is converted
    b    — (n,) right-hand side or (n, m) multi-RHS
    tag  — opaque caller id, passed through to the result
    factor_dtype — per-request precision routing: None uses the service's
           options template; a dtype name ("float32"/"float64"/"bfloat16")
           overrides it for this request.  The dtype is part of the plan
           fingerprint, so mixed-precision traffic groups into separate
           dispatches per dtype automatically."""
    a: CSR
    b: np.ndarray
    tag: object = None
    factor_dtype: str | None = None


@dataclasses.dataclass
class SolveResult:
    """Per-request terminal outcome, in the original request order.

    ``status`` is one of ``TERMINAL_STATUSES``; anything except
    ``"solved"`` carries a typed ``error`` and (for rejected/failed
    requests) ``x=None``.  Quarantined results keep the best-attempt ``x``
    for diagnostics, explicitly flagged untrustworthy."""
    x: np.ndarray | None = None  # solution; None for rejected/failed
    residual: object = None      # float or (m,) — scaled 1-norm residual(s)
    n_refine: int = 0            # accepted refinement steps for this system
    n_perturb: int = 0           # pivot perturbations in this factorization
    fingerprint: str = ""        # the plan-cache key this request hit
    group_size: int = 0          # how many requests shared the dispatch group
    tag: object = None
    refine_failed: bool = False   # refinement exited above tolerance (after
                                  # any fp64 fallback redo) — an honest
                                  # per-request quality flag
    factor_dtype: str = "float64"  # precision this request was factored in
    status: str = STATUS_SOLVED    # terminal state (TERMINAL_STATUSES)
    error: SolveError | None = None  # typed error for non-solved statuses
    n_retries: int = 0             # perturbed re-factor retries consumed
    latency_s: float | None = None  # submit→result latency (async server)
    deadline_missed: bool = False   # completed after its deadline (async)

    @property
    def ok(self) -> bool:
        """True iff this request solved at tolerance (``status=="solved"``
        and refinement converged)."""
        return self.status == STATUS_SOLVED and not self.refine_failed


def _residual_key(r: SolveResult) -> float:
    """Max residual as a comparison key; NaN/Inf ranks worst, so a retry
    with any finite residual beats a NaN original."""
    v = float(np.max(r.residual))
    return v if np.isfinite(v) else float("inf")


def _as_csr(a) -> CSR:
    if isinstance(a, CSR):
        return a
    if hasattr(a, "tocsr"):
        return CSR.from_scipy(a.tocsr())
    raise TypeError(f"request matrix must be a CSR (or scipy sparse), got "
                    f"{type(a).__name__}")


def validate_request(a, b):
    """Admission-time validation of one request: returns
    ``(a_csr, b_arr, None)`` for an admissible request or
    ``(None, None, SolveError)`` with a typed taxonomy error.

    Checks, in order: the matrix converts to :class:`CSR`; values and RHS
    are real numeric dtypes; the RHS is ``(n,)`` or ``(n, m)``; values and
    RHS are finite (NaN/Inf never reach a batch, where they would come
    back as silent garbage); the pattern is structurally nonsingular
    (no empty row or column — such a system cannot be factored at all)."""
    try:
        a = _as_csr(a)
    except TypeError as e:
        return None, None, SolveError(ERR_BAD_MATRIX, str(e))
    vals = np.asarray(a.data)
    if not (np.issubdtype(vals.dtype, np.floating)
            or np.issubdtype(vals.dtype, np.integer)):
        return None, None, SolveError(
            ERR_BAD_DTYPE, f"matrix values must be real numeric, got dtype "
            f"{vals.dtype}", dict(dtype=str(vals.dtype), field="a"))
    b = np.asarray(b)
    if not (np.issubdtype(b.dtype, np.floating)
            or np.issubdtype(b.dtype, np.integer)):
        return None, None, SolveError(
            ERR_BAD_DTYPE, f"RHS must be real numeric, got dtype {b.dtype}",
            dict(dtype=str(b.dtype), field="b"))
    if b.ndim not in (1, 2) or b.shape[0] != a.n:
        return None, None, SolveError(
            ERR_SHAPE_MISMATCH,
            f"request RHS shape {b.shape} does not match its matrix "
            f"(n={a.n}; expected (n,) or (n, m))",
            dict(rhs_shape=tuple(b.shape), n=a.n))
    finite = np.isfinite(vals)
    if not finite.all():
        bad = int(np.argmin(finite))
        return None, None, SolveError(
            ERR_NONFINITE_VALUES,
            f"matrix values contain {int((~finite).sum())} non-finite "
            f"entries (first at nnz index {bad})",
            dict(n_nonfinite=int((~finite).sum()), first_index=bad))
    finite_b = np.isfinite(b)
    if not finite_b.all():
        bad = int(np.argmin(finite_b.ravel()))
        return None, None, SolveError(
            ERR_NONFINITE_RHS,
            f"RHS contains {int((~finite_b).sum())} non-finite entries "
            f"(first at flat index {bad})",
            dict(n_nonfinite=int((~finite_b).sum()), first_index=bad))
    counts = np.diff(a.indptr)
    if (counts == 0).any():
        row = int(np.argmin(counts > 0))
        return None, None, SolveError(
            ERR_SINGULAR_PATTERN,
            f"structurally singular: row {row} has no entries",
            dict(kind="empty_row", index=row))
    col_hits = np.bincount(np.asarray(a.indices, dtype=np.int64),
                           minlength=a.n)
    if (col_hits == 0).any():
        col = int(np.argmin(col_hits > 0))
        return None, None, SolveError(
            ERR_SINGULAR_PATTERN,
            f"structurally singular: column {col} has no entries",
            dict(kind="empty_column", index=col))
    return a, b, None


class SolverService:
    """Front-end for heterogeneous (pattern, values, b) solve traffic.

    opts           — HyluOptions template applied to every request
                     (device, mesh, refinement, kernel thresholds, retry
                     ladder, …); its device and its split of K over
                     devices (``opts.mesh``: every dispatch is split over
                     them) are resolved here, so a missing card raises at
                     construction
    cache          — a PlanCache to share across services; built from
                     cache_dir/cache_capacity when None
    cache_dir      — artifact-store directory for the internally-built
                     cache (None disables disk persistence; the default
                     sentinel resolves under ``opts.cache_root`` /
                     ``$HYLU_CACHE_ROOT`` / the repo's ``checkpoints``
                     dir — see ``repro_torch.core.plan_cache.
                     resolve_cache_dir``)
    cache_capacity — LRU bound of the internally-built cache
    batch_size     — fixed dispatch batch: every group is chunked and
                     padded up to this many systems, so each pattern runs
                     at one batch shape however the traffic mix
                     fluctuates; None dispatches each group at its
                     natural size

    Use ``solve_batch(requests)`` for one-shot dispatch, or
    ``submit(a, b)`` + ``flush()`` to accumulate a serving window first.
    ``solve_batch`` never raises for a per-request problem — it returns a
    typed terminal result per request (see the module docstring's fault-
    tolerance contract); ``submit`` raises :class:`InvalidRequestError`
    eagerly so the queued window only ever holds admissible requests.
    """

    def __init__(self, opts: HyluOptions | None = None,
                 cache: PlanCache | None = None,
                 cache_dir: str | None = DEFAULT_CACHE_DIR,
                 cache_capacity: int = 32,
                 batch_size: int | None = 8):
        self.opts = opts or HyluOptions()
        self.device = resolve_device(self.opts.device)
        self.mesh = resolve_mesh(self.opts)
        self.cache = cache if cache is not None else PlanCache(
            capacity=cache_capacity, directory=cache_dir,
            cache_root=self.opts.cache_root)
        if batch_size is not None and batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.batch_size = batch_size
        self.stats = dict(requests=0, groups=0, dispatches=0,
                          padded_systems=0, patterns_seen=0, solve_s=0.0,
                          refine_failed=0, fp64_fallbacks=0,
                          rejected=0, failed=0, quarantined=0, retries=0)
        self._pattern_modes: dict[str, str] = {}   # fingerprint → kernel mode
        self._pending: list[SolveRequest] = []

    # ---------------------------------------------------------------- queue
    def submit(self, a, b, tag=None, factor_dtype=None) -> int:
        """Validate and enqueue one request; returns its position in the
        next flush.  A request that fails admission validation raises
        :class:`InvalidRequestError` (with the typed ``SolveError`` as
        ``.error``) *here*, before it can enter the window — the queue
        only ever holds admissible requests."""
        a, b, err = validate_request(a, b)
        if err is not None:
            raise InvalidRequestError(err)
        self._pending.append(SolveRequest(a=a, b=b, tag=tag,
                                          factor_dtype=factor_dtype))
        return len(self._pending) - 1

    def flush(self) -> list:
        """Dispatch every queued request; results in submit order.  Every
        request receives a terminal result (``solve_batch`` isolates
        per-group failures instead of raising), so the window is always
        cleared — nothing is ever silently dropped."""
        results = self.solve_batch(self._pending)
        self._pending = []
        return results

    # ------------------------------------------------------------- dispatch
    def solve_batch(self, requests) -> list:
        """Group a heterogeneous request list by plan fingerprint, dispatch
        each group through the cached batched engine, and scatter results
        back to request order.  Requests may be ``SolveRequest`` objects or
        bare ``(a, b)`` pairs.  Returns ``list[SolveResult]`` aligned with
        ``requests`` — one terminal result per request (rejected / failed /
        quarantined results carry a typed ``error``; this method does not
        raise for per-request problems)."""
        t0 = time.perf_counter()
        reqs: list = []
        results: list = [None] * len(requests)
        for i, r in enumerate(requests):
            if not isinstance(r, SolveRequest):
                a, b = r
                r = SolveRequest(a=a, b=b)
            a, b, err = validate_request(r.a, r.b)
            if err is not None:
                self.stats["rejected"] += 1
                results[i] = SolveResult(status=STATUS_REJECTED, error=err,
                                         tag=r.tag)
                reqs.append(None)
                continue
            reqs.append(SolveRequest(a=a, b=b, tag=r.tag,
                                     factor_dtype=r.factor_dtype))

        valid = [i for i, r in enumerate(reqs) if r is not None]
        self._group_and_dispatch(reqs, valid, results)
        self._escalate(reqs, results)

        self.stats["requests"] += len(reqs)
        self.stats["refine_failed"] += sum(
            1 for r in results if r is not None and r.refine_failed)
        self.stats["solve_s"] += time.perf_counter() - t0
        return results

    def _opts_for(self, req: SolveRequest, retry_attempt: int = 0):
        """The effective HyluOptions for one request: the service template,
        a per-request factor_dtype override, and — for escalation-ladder
        retries — the boosted pivot-perturbation threshold (an explicit
        perturb_eps ⇒ a distinct plan fingerprint)."""
        opts = (self.opts if req.factor_dtype is None else
                dataclasses.replace(self.opts,
                                    factor_dtype=req.factor_dtype))
        if retry_attempt > 0:
            opts = dataclasses.replace(
                opts, perturb_eps=resolve_retry_perturb(opts, retry_attempt))
        return opts

    def _group_and_dispatch(self, reqs, idx_list, results,
                            retry_attempt: int = 0):
        """Group the given request indices by (fingerprint, RHS tail shape),
        preserving request order within each group, and dispatch each group
        through the cached batched engines under per-group error isolation.
        Differing multi-RHS widths of one pattern dispatch separately (the
        batched RHS must be rectangular); factor_dtype is a
        PLAN_OPTION_FIELDS member, so a per-request dtype override lands in
        a different fingerprint — mixed-precision traffic routes into
        separate groups with no extra machinery."""
        groups: dict[tuple, list[int]] = {}
        group_opts: dict[str, HyluOptions] = {}
        for i in idx_list:
            r = reqs[i]
            opts_i = self._opts_for(r, retry_attempt)
            fp = plan_fingerprint(r.a, opts_i)
            group_opts[fp] = opts_i
            groups.setdefault((fp, r.b.shape[1:]), []).append(i)

        for (fp, _tail), idxs in groups.items():
            new_pattern = fp not in self._pattern_modes
            try:
                an = self.cache.get_or_analyze(reqs[idxs[0]].a,
                                               group_opts[fp],
                                               fingerprint=fp)
            except Exception as e:      # noqa: BLE001 — isolation barrier
                self._fail_group(reqs, idxs, results, fp, "analyze", e)
                continue
            if new_pattern:
                self.stats["patterns_seen"] += 1
            self.stats["groups"] += 1
            self._pattern_modes[fp] = an.choice.mode
            step = self.batch_size or len(idxs)
            for c0 in range(0, len(idxs), step):
                chunk = idxs[c0:c0 + step]
                try:
                    self._dispatch(an, fp, reqs, chunk, pad_to=step,
                                   group_size=len(idxs), results=results)
                except Exception as e:  # noqa: BLE001 — isolation barrier
                    self._fail_group(reqs, chunk, results, fp, "dispatch", e)

    def _fail_group(self, reqs, idxs, results, fp, stage, exc):
        """One pattern group (or chunk) raised: every affected request gets
        a typed ``failed`` result; every other group is untouched."""
        err_type = type(exc).__name__
        for i in idxs:
            self.stats["failed"] += 1
            results[i] = SolveResult(
                status=STATUS_FAILED, tag=reqs[i].tag, fingerprint=fp,
                error=SolveError(
                    ERR_DISPATCH,
                    f"{stage} raised {err_type}: {exc}",
                    dict(stage=stage, exception=err_type,
                         fingerprint=fp, group_size=len(idxs))))

    def _escalate(self, reqs, results):
        """The escalation ladder's serving half.  Stage 1 (refinement) and
        stage 2 (the batched fp64 fallback) already ran inside
        ``solve_batched``; what reaches here still carrying
        ``refine_failed`` gets stage 3 — up to ``opts.retry_max``
        re-dispatches with a boosted pivot-perturbation threshold — and
        what survives all of that becomes stage 4: a quarantined result
        with diagnostics."""
        retry_max = max(0, int(self.opts.retry_max))
        for attempt in range(1, retry_max + 1):
            todo = [i for i, r in enumerate(results)
                    if r is not None and r.status == STATUS_SOLVED
                    and r.refine_failed]
            if not todo:
                break
            retry_results: list = [None] * len(reqs)
            self._group_and_dispatch(reqs, todo, retry_results,
                                     retry_attempt=attempt)
            for i in todo:
                self.stats["retries"] += 1
                results[i].n_retries = attempt
                rr = retry_results[i]
                if rr is None or rr.status != STATUS_SOLVED:
                    continue            # retry dispatch itself failed: keep
                    #                     the original attempt's answer
                rr.n_retries = attempt
                if not rr.refine_failed or (
                        _residual_key(rr) < _residual_key(results[i])):
                    results[i] = rr
        for r in results:
            if r is not None and r.status == STATUS_SOLVED and r.refine_failed:
                self.stats["quarantined"] += 1
                r.status = STATUS_QUARANTINED
                r.error = SolveError(
                    ERR_QUARANTINED,
                    "refinement never reached tolerance (after the fp64 "
                    f"fallback and {r.n_retries} perturbed re-factor "
                    "retries) — solution quarantined",
                    dict(residual=float(np.max(r.residual)),
                         n_refine=r.n_refine, n_perturb=r.n_perturb,
                         n_retries=r.n_retries,
                         factor_dtype=r.factor_dtype))

    def _dispatch(self, an, fp, reqs, chunk, pad_to, group_size, results):
        """One padded batched factor+solve for ``chunk`` (request indices
        of one pattern/RHS-shape group), scattered into ``results``."""
        g = len(chunk)
        k = max(pad_to, g)
        a0 = reqs[chunk[0]].a
        # stage in the engine's staging (= refine) dtype: "auto" is float64,
        # so one cast on the host and none on the device
        sdt = np.dtype(resolve_dtype_names(an.opts)[1])
        vb = np.empty((k, a0.nnz), dtype=sdt)
        bb = np.zeros((k,) + reqs[chunk[0]].b.shape, dtype=sdt)
        for j, i in enumerate(chunk):
            vb[j] = reqs[i].a.data
            bb[j] = reqs[i].b
        # pad with the chunk's first system + zero RHS: well-conditioned,
        # converges on iteration 0 under the per-system alive-masking
        vb[g:] = vb[0]

        bst = factor_batched(an, (a0.indptr, a0.indices), vb)
        x, info = solve_batched(bst, bb)
        self.stats["dispatches"] += 1
        self.stats["padded_systems"] += k - g
        self.stats["fp64_fallbacks"] += int(info.get("n_fp64_fallback", 0))
        failed = np.asarray(info["refine_failed"])
        for j, i in enumerate(chunk):
            req_failed = bool(np.any(failed[j]))
            results[i] = SolveResult(
                x=x[j],
                residual=(float(info["residual"][j])
                          if np.ndim(info["residual"][j]) == 0
                          else np.asarray(info["residual"][j])),
                n_refine=int(info["n_refine_per_system"][j].max()
                             if np.ndim(info["n_refine_per_system"][j])
                             else info["n_refine_per_system"][j]),
                n_perturb=int(info["n_perturb"][j]),
                fingerprint=fp, group_size=group_size, tag=reqs[i].tag,
                refine_failed=req_failed,
                factor_dtype=info["factor_dtype"])

    # ------------------------------------------------------------ introspect
    @property
    def pattern_modes(self) -> dict:
        """fingerprint → kernel mode chosen for that pattern (rowrow /
        hybrid / supernodal) — the routing record tests assert on."""
        return dict(self._pattern_modes)
