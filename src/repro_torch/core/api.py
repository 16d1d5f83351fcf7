"""Public facade of the port's core: analyze → factor → refactor → solve
(one system), analyze → factor_batched → solve_batched / solve_sequence
(the batched repeated-solve path) and the plan cache that persists
analyses across processes.

Mirrors ``src/repro/core/api.py`` for the names the port has, the
host-side oracles ``_batched_matvec`` and ``_solve_batched_hostloop``
included (the JAX tests and benchmark import them from ``api``); the
paper's baseline presets are ``repro_torch.core.baselines``; solver
serving lives in ``repro_torch.serve``; the differentiable solve is
``make_sparse_solve`` (``core/autodiff.py``)."""
from __future__ import annotations

from .options import (HyluOptions, PLAN_OPTION_FIELDS, plan_options_key,
                      pattern_key, plan_fingerprint, dtype_name,
                      resolve_device, resolve_perturb_eps,
                      resolve_refine_tol, resolve_dtype_names,
                      resolve_retry_perturb)
from .analysis import (Analysis, FactorState, analyze, factor, refactor,
                       solve, solve_system, torch_repeated_engine)
from .batched import (BatchedFactorState, factor_batched, solve_batched,
                      solve_sequence, _batched_matvec,
                      _solve_batched_hostloop)
from .autodiff import make_sparse_solve
from .convert import analysis_from_arrays
from .plan_cache import (PlanCache, PlanCacheFormatError, load_analysis,
                         save_analysis)

__all__ = [
    "HyluOptions", "PLAN_OPTION_FIELDS", "plan_options_key", "pattern_key",
    "plan_fingerprint", "dtype_name", "resolve_device",
    "resolve_perturb_eps", "resolve_refine_tol", "resolve_dtype_names",
    "resolve_retry_perturb",
    "Analysis", "FactorState", "analyze", "factor", "refactor", "solve",
    "solve_system", "torch_repeated_engine",
    "BatchedFactorState", "factor_batched", "solve_batched",
    "solve_sequence", "_batched_matvec", "_solve_batched_hostloop",
    "make_sparse_solve", "analysis_from_arrays", "PlanCache",
    "PlanCacheFormatError", "save_analysis", "load_analysis",
]
