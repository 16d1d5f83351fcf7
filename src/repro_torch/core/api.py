"""Public facade of the port's core: analyze → factor → refactor → solve
(one system), analyze → factor_batched → solve_batched / solve_sequence
(the batched repeated-solve path) and the plan cache that persists
analyses across processes.

Mirrors ``src/repro/core/api.py`` for the names the port has; solver
serving lives in ``repro_torch.serve``, and the differentiable solve is
still to be ported (ROADMAP.md)."""
from __future__ import annotations

from .options import (HyluOptions, PLAN_OPTION_FIELDS, plan_options_key,
                      pattern_key, plan_fingerprint, dtype_name,
                      resolve_device, resolve_perturb_eps,
                      resolve_refine_tol, resolve_dtype_names,
                      resolve_retry_perturb)
from .analysis import (Analysis, FactorState, analyze, factor, refactor,
                       solve, solve_system, torch_repeated_engine)
from .batched import (BatchedFactorState, factor_batched, solve_batched,
                      solve_sequence)
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
    "solve_sequence", "analysis_from_arrays", "PlanCache",
    "PlanCacheFormatError", "save_analysis", "load_analysis",
]
