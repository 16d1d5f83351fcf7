"""Analyze, the per-analysis engine cache, and the one-system lifecycle
analyze → factor → refactor → solve.

Adapted from ``src/repro/core/analysis.py``.  ``analyze`` runs the same
matching, ordering, symbolic factorization and plan build (numpy on the
host, module for module copied from the JAX package), so it returns the
same plan for the same matrix and options.  ``torch_repeated_engine`` takes
the place of ``jax_repeated_engine``: it builds the PyTorch engine of an
analysis on its device once and caches it on the analysis.  ``factor`` /
``refactor`` / ``solve`` / ``solve_system`` are the JAX package's, with the
engine ``"torch"`` (the default) in place of ``"jax"``; ``"ref"`` runs the
copied numpy reference engine on the host.

With Dr=diag(r), Ds=diag(s) from matching, column permutation q, symmetric
ordering p and the in-node pivot permutation inode_perm:

    M = (P_p (Dr A Ds) Q_q P_pᵀ),     L U = M[inode_perm, :]
    A x = b   ⇒   w = U⁻¹ L⁻¹ ((r·b)[p][inode_perm]) ;  z[p]=w ; y[q]=z ; x = s·y
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from . import ref_engine
from .matrix import CSR
from .matching import max_weight_matching, MatchResult
from .ordering import select_ordering
from .kernel_select import select_kernel, KernelChoice
from .plan import build_plan, FactorPlan
from .symbolic import Symbolic
from .options import (HyluOptions, pattern_key, plan_fingerprint,
                      check_supported, dtype_name, resolve_device,
                      resolve_dtype_names, resolve_perturb_eps,
                      resolve_refine_tol)


@dataclasses.dataclass
class Analysis:
    """The reusable product of :func:`analyze`: matching, ordering,
    symbolic structure, the static FactorPlan and the refactor gather maps
    (``M.data = A.data[src_map] * scale_map``).  ``engine_cache`` holds the
    engines built for it, keyed by (factor dtype, refine dtype, use_kernels,
    factor schedule, device)."""
    n: int
    opts: HyluOptions
    match: MatchResult
    q: np.ndarray
    p: np.ndarray
    ordering_name: str
    choice: KernelChoice
    sym: Symbolic
    plan: FactorPlan
    src_map: np.ndarray
    scale_map: np.ndarray
    m_pattern: tuple
    timings: dict
    pattern_key: str = ""
    fingerprint: str = ""
    engine_cache: dict = dataclasses.field(default_factory=dict, repr=False)


def analyze(a: CSR, opts: HyluOptions | None = None, reuse=None) -> Analysis:
    """Preprocessing phase (HYLU §2.1), identical to the JAX package's.

    reuse: a prior Analysis of the same sparsity pattern whose matching and
    ordering are reused; a pattern mismatch raises ``ValueError``."""
    opts = opts or HyluOptions()
    pkey = pattern_key(a)
    if reuse is not None and getattr(reuse, "pattern_key", "") != pkey:
        raise ValueError(
            "analyze(reuse=...): the reused analysis was built for a "
            f"different sparsity pattern (n={reuse.n} vs {a.n})")
    t: dict[str, float] = {}
    t0 = time.perf_counter()
    match = reuse.match if reuse is not None else max_weight_matching(a)
    t["matching"] = time.perf_counter() - t0

    # permute/scale with index-tracking data so refactor is a pure gather
    t0 = time.perf_counter()
    seg = np.repeat(np.arange(a.n), np.diff(a.indptr))
    scale_entry = match.row_scale[seg] * match.col_scale[a.indices]
    tracker = CSR(a.n, a.indptr.copy(), a.indices.copy(),
                  np.arange(a.nnz, dtype=np.float64))
    q = match.col_of_row.copy()
    b2_track = tracker.permute(np.arange(a.n), q)
    pat2 = CSR(a.n, b2_track.indptr, b2_track.indices,
               np.ones(a.nnz)).sym_pattern()
    if reuse is not None:
        p, ord_name = reuse.p, reuse.ordering_name
    else:
        p, ord_name = select_ordering(pat2, candidates=opts.orderings)
    t["ordering"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    m_track = b2_track.permute(p, p)
    src_map = m_track.data.astype(np.int64)
    scale_map = scale_entry[src_map]
    pat_m = pat2.permute(p, p)
    choice, sym = select_kernel(pat_m, force_mode=opts.force_mode,
                                relax=opts.relax, max_super=opts.max_super)
    t["symbolic"] = time.perf_counter() - t0

    if opts.amalg_fill_tol > 0:
        from .structure import amalgamate_supernodes
        t0 = time.perf_counter()
        sym, amalg_stats = amalgamate_supernodes(
            sym, fill_tol=opts.amalg_fill_tol, max_super=opts.max_super)
        choice.stats["amalg"] = amalg_stats
        t["amalgamate"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    m = CSR(a.n, m_track.indptr, m_track.indices, np.ones(a.nnz))
    plan = build_plan(pat_m, m, sym, mode=choice.mode,
                      bulk_min_width=opts.bulk_min_width)
    t["plan"] = time.perf_counter() - t0
    t["total"] = sum(t.values())

    return Analysis(n=a.n, opts=opts, match=match, q=q, p=p,
                    ordering_name=ord_name, choice=choice, sym=sym, plan=plan,
                    src_map=src_map, scale_map=scale_map,
                    m_pattern=(m_track.indptr, m_track.indices), timings=t,
                    pattern_key=pkey,
                    fingerprint=plan_fingerprint(a, opts, pkey=pkey))


def torch_dtype(name):
    import torch

    return {"float64": torch.float64, "float32": torch.float32,
            "bfloat16": torch.bfloat16}[dtype_name(name)]


@dataclasses.dataclass
class FactorState:
    """One numeric factorization of one value set — what :func:`solve`
    consumes and :func:`refactor` refreshes (ref engine: numpy factors and
    solve plan; torch engine: the device ``TorchFactors``)."""
    analysis: Analysis
    factors: ref_engine.Factors | None
    solve_plan: ref_engine.SolvePlan | None
    a: CSR                     # the matrix these factors correspond to
    timings: dict
    engine: str = "ref"
    torch_factors: object = None   # torch_engine.TorchFactors ("torch")


def torch_repeated_engine(an: Analysis, dtype=None, refine_dtype=None,
                          device=None, use_kernels=None, schedule=None):
    """The repeated-solve engine of this analysis, built on first use and
    cached on it.  ``dtype`` (default ``an.opts.factor_dtype``) is the
    factor/substitution precision, ``refine_dtype`` (default
    ``an.opts.refine_dtype``, "auto" → float64) the residual/accumulation
    precision, ``device`` (default ``an.opts.device``) where it runs — a
    CUDA device that is missing raises — and ``use_kernels`` /
    ``schedule`` (defaults ``an.opts.use_kernels`` /
    ``an.opts.factor_schedule``) the kernel route and the factor schedule.
    Every one of them is part of the cache key, the device by its index
    (``"cuda"`` is the current card), so the shards of a split of K
    (``HyluOptions.mesh``) share one engine per device, as the JAX
    package keys its engines on the mesh's devices."""
    import torch

    from .structure import build_solve_structure
    from .torch_engine import RepeatedSolveEngine

    opts = an.opts
    dev = resolve_device(opts.device if device is None else device)
    check_supported(opts, dev)
    fname = dtype_name(opts.factor_dtype if dtype is None else dtype)
    rname = (resolve_dtype_names(opts)[1] if refine_dtype is None
             else dtype_name(refine_dtype))
    use_kernels = bool(opts.use_kernels if use_kernels is None
                       else use_kernels)
    schedule = opts.factor_schedule if schedule is None else schedule
    # one engine per physical device: "cuda" keys as the current device
    idx = (torch.cuda.current_device() if dev.type == "cuda"
           and dev.index is None else dev.index)
    key = (fname, rname, use_kernels, schedule,
           dev.type if idx is None else f"{dev.type}:{idx}")
    eng = an.engine_cache.get(key)
    if eng is None:
        ss = build_solve_structure(an.plan, bulk_min_width=opts.bulk_min_width)
        eng = RepeatedSolveEngine(
            an.plan, ss, src_map=an.src_map, scale_map=an.scale_map,
            p=an.p, q=an.q, row_scale=an.match.row_scale,
            col_scale=an.match.col_scale,
            perturb_eps=resolve_perturb_eps(opts, fname),
            dtype=torch_dtype(fname), refine_dtype=torch_dtype(rname),
            device=dev, bulk_min_width=opts.bulk_min_width,
            use_kernels=use_kernels, schedule=schedule)
        an.engine_cache[key] = eng
    return eng


def _m_values(an: Analysis, a: CSR) -> CSR:
    data = a.data[an.src_map] * an.scale_map
    return CSR(a.n, an.m_pattern[0], an.m_pattern[1], data)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _factor_torch(an: Analysis, a: CSR) -> FactorState:
    import torch

    eng = torch_repeated_engine(an)
    t = {}
    t0 = time.perf_counter()
    tf = eng.refactor(torch.from_numpy(np.asarray(a.data)).to(
        device=eng.device, dtype=eng.values_dtype))
    _sync(eng.device)
    t["factor"] = time.perf_counter() - t0
    return FactorState(analysis=an, factors=None, solve_plan=None, a=a,
                       timings=t, engine="torch", torch_factors=tf)


def _factor_ref(an: Analysis, a: CSR, mod) -> FactorState:
    t = {}
    t0 = time.perf_counter()
    f = mod.factor(an.plan, _m_values(an, a), perturb_eps=an.opts.perturb_eps)
    t["factor"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sp = ref_engine.build_solve_plan(f, bulk_min_width=an.opts.bulk_min_width)
    t["solve_plan"] = time.perf_counter() - t0
    return FactorState(analysis=an, factors=f, solve_plan=sp, a=a, timings=t)


def factor(an: Analysis, a: CSR, engine=None) -> FactorState:
    """Numeric factorization of one value set.

    engine: "torch" (the device engine of :func:`torch_repeated_engine`),
    "ref" (the numpy reference engine on the host, with its solve plan), a
    ref-compatible engine module, or None → ``an.opts.engine``."""
    engine = an.opts.engine if engine is None else engine
    if engine == "torch":
        return _factor_torch(an, a)
    if engine == "ref":
        return _factor_ref(an, a, ref_engine)
    if hasattr(engine, "factor"):
        return _factor_ref(an, a, engine)
    raise ValueError(f"unknown engine {engine!r}: expected 'ref', 'torch', "
                     "or an engine module with a factor() function")


def refactor(st: FactorState, a_new: CSR) -> FactorState:
    """Repeated-solve path: same pattern, new values; the analysis (and,
    on the torch engine, the engine) is reused."""
    an = st.analysis
    if st.engine == "torch":
        return _factor_torch(an, a_new)
    return _factor_ref(an, a_new, ref_engine)


def solve(st: FactorState, b: np.ndarray, refine: bool | None = None) -> tuple:
    """Substitution + iterative refinement on the host in float64 (auto when
    a pivot was perturbed or the residual is above the target, paper §2.3).
    Returns (x, info).

    As in the JAX package (``src/repro/core/analysis.py:272–327``),
    ``refine_failed`` is ``do_refine and resid > rtol``: a NaN residual
    compares False, so a non-finite solution is not flagged here (the
    batched path flags it; ROADMAP.md, Queue C)."""
    an = st.analysis
    opts = an.opts
    t0 = time.perf_counter()

    if st.engine == "torch":
        import torch

        eng = torch_repeated_engine(an)
        tf = st.torch_factors
        n_perturb = int(tf.n_perturb)
        rtol = resolve_refine_tol(opts, dtype_name(eng.refine_dtype))

        def lu_apply(rhs: np.ndarray) -> np.ndarray:
            rhs_dev = torch.from_numpy(np.ascontiguousarray(rhs)).to(
                eng.device)
            # widened on the device: numpy has no bfloat16
            return eng.apply(tf.vals, tf.inode_perm,
                             rhs_dev).double().cpu().numpy()
    else:
        f = st.factors
        n_perturb = f.n_perturb
        rtol = resolve_refine_tol(opts, "float64")

        def lu_apply(rhs: np.ndarray) -> np.ndarray:
            c = (an.match.row_scale * rhs)[an.p][f.inode_perm]
            w = ref_engine.solve_lu(st.solve_plan, c)
            z = np.empty_like(w); z[an.p] = w
            y = np.empty_like(z); y[an.q] = z
            return an.match.col_scale * y

    # x and the residual accumulate in float64 on the host whatever the
    # factor dtype
    x = np.asarray(lu_apply(b), dtype=np.float64)
    n_ref = 0
    bnorm = float(np.abs(b).sum()) or 1.0
    resid = float(np.abs(b - st.a.matvec(x)).sum()) / bnorm
    do_refine = refine if refine is not None else (
        n_perturb > 0 or resid > rtol)
    if do_refine:
        for _ in range(opts.refine_max_iter):
            if resid <= rtol:
                break
            r = b - st.a.matvec(x)
            x2 = x + lu_apply(r)
            resid2 = float(np.abs(b - st.a.matvec(x2)).sum()) / bnorm
            n_ref += 1
            if resid2 >= resid:
                break
            x, resid = x2, resid2
    info = dict(residual=resid, n_refine=n_ref, n_perturb=n_perturb,
                refine_failed=bool(do_refine and resid > rtol),
                solve_time=time.perf_counter() - t0)
    return x, info


def solve_system(a: CSR, b: np.ndarray, opts: HyluOptions | None = None):
    """One-call convenience: analyze + factor + solve."""
    an = analyze(a, opts)
    st = factor(an, a)
    x, info = solve(st, b)
    info["timings"] = {"preprocess": an.timings, "factor": st.timings}
    info["mode"] = an.choice.mode
    info["ordering"] = an.ordering_name
    info["engine"] = st.engine
    return x, info
