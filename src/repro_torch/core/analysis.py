"""Analyze: the host preprocessing phase, and the per-analysis engine cache.

Adapted from ``src/repro/core/analysis.py:37–210``.  ``analyze`` runs the
same matching, ordering, symbolic factorization and plan build (numpy on
the host, module for module copied from the JAX package), so it returns
the same plan for the same matrix and options.  ``torch_repeated_engine``
takes the place of ``jax_repeated_engine``: it builds the PyTorch engine of
an analysis on its device once and caches it on the analysis.

With Dr=diag(r), Ds=diag(s) from matching, column permutation q, symmetric
ordering p and the in-node pivot permutation inode_perm:

    M = (P_p (Dr A Ds) Q_q P_pᵀ),     L U = M[inode_perm, :]
    A x = b   ⇒   w = U⁻¹ L⁻¹ ((r·b)[p][inode_perm]) ;  z[p]=w ; y[q]=z ; x = s·y
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from .matrix import CSR
from .matching import max_weight_matching, MatchResult
from .ordering import select_ordering
from .kernel_select import select_kernel, KernelChoice
from .plan import build_plan, FactorPlan
from .symbolic import Symbolic
from .options import (HyluOptions, pattern_key, plan_fingerprint,
                      check_supported, dtype_name, resolve_device,
                      resolve_dtype_names, resolve_perturb_eps)


@dataclasses.dataclass
class Analysis:
    """The reusable product of :func:`analyze`: matching, ordering,
    symbolic structure, the static FactorPlan and the refactor gather maps
    (``M.data = A.data[src_map] * scale_map``).  ``engine_cache`` holds the
    engines built for it, keyed by (factor dtype, refine dtype, device)."""
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


def torch_repeated_engine(an: Analysis, dtype=None, refine_dtype=None,
                          device=None):
    """The repeated-solve engine of this analysis, built on first use and
    cached on it.  ``dtype`` (default ``an.opts.factor_dtype``) is the
    factor/substitution precision, ``refine_dtype`` (default
    ``an.opts.refine_dtype``, "auto" → float64) the residual/accumulation
    precision, ``device`` (default ``an.opts.device``) where it runs — a
    CUDA device that is missing raises."""
    from .structure import build_solve_structure
    from .torch_engine import RepeatedSolveEngine

    opts = an.opts
    dev = resolve_device(opts.device if device is None else device)
    check_supported(opts, dev)
    fname = dtype_name(opts.factor_dtype if dtype is None else dtype)
    rname = (resolve_dtype_names(opts)[1] if refine_dtype is None
             else dtype_name(refine_dtype))
    key = (fname, rname, str(dev))
    eng = an.engine_cache.get(key)
    if eng is None:
        ss = build_solve_structure(an.plan, bulk_min_width=opts.bulk_min_width)
        eng = RepeatedSolveEngine(
            an.plan, ss, src_map=an.src_map, scale_map=an.scale_map,
            p=an.p, q=an.q, row_scale=an.match.row_scale,
            col_scale=an.match.col_scale,
            perturb_eps=resolve_perturb_eps(opts, fname),
            dtype=torch_dtype(fname), refine_dtype=torch_dtype(rname),
            device=dev, bulk_min_width=opts.bulk_min_width)
        an.engine_cache[key] = eng
    return eng
