"""Public facade of the port's core: analyze → factor → refactor → solve
(one system) and analyze → factor_batched → solve_batched /
solve_sequence (the batched repeated-solve path).

Mirrors ``src/repro/core/api.py`` for the names the port has; the plan
cache, serving and the differentiable solve are still to be ported
(ROADMAP.md)."""
from __future__ import annotations

from .options import (HyluOptions, PLAN_OPTION_FIELDS, plan_options_key,
                      pattern_key, plan_fingerprint, dtype_name,
                      resolve_device, resolve_perturb_eps,
                      resolve_refine_tol, resolve_dtype_names)
from .analysis import (Analysis, FactorState, analyze, factor, refactor,
                       solve, solve_system, torch_repeated_engine)
from .batched import (BatchedFactorState, factor_batched, solve_batched,
                      solve_sequence)
from .convert import analysis_from_arrays

__all__ = [
    "HyluOptions", "PLAN_OPTION_FIELDS", "plan_options_key", "pattern_key",
    "plan_fingerprint", "dtype_name", "resolve_device",
    "resolve_perturb_eps", "resolve_refine_tol", "resolve_dtype_names",
    "Analysis", "FactorState", "analyze", "factor", "refactor", "solve",
    "solve_system", "torch_repeated_engine",
    "BatchedFactorState", "factor_batched", "solve_batched",
    "solve_sequence", "analysis_from_arrays",
]
