"""repro_torch.core — HYLU's solve lifecycle in PyTorch.

    CSR                        sparse container
    HyluOptions                solver options (``device``, ``use_kernels``)
    analyze                    host preprocessing → Analysis
    factor / refactor / solve / solve_system
                               one value set, factored on the device and
                               solved with host refinement (FactorState)
    factor_batched / solve_batched / solve_sequence
                               K value sets of one pattern, factored and
                               solved on the device
    torch_repeated_engine      the per-analysis engine
    analysis_from_arrays       an analysis written by either package
    PlanCache / save_analysis / load_analysis
                               the content-addressed plan cache and its
                               artifacts (the JAX package's format)
"""
from .matrix import CSR
from .api import (HyluOptions, Analysis, BatchedFactorState, FactorState,
                  analyze, factor, refactor, solve, solve_system,
                  factor_batched, solve_batched, solve_sequence,
                  torch_repeated_engine, analysis_from_arrays,
                  pattern_key, plan_fingerprint, PlanCache, save_analysis,
                  load_analysis)

__all__ = ["CSR", "HyluOptions", "Analysis", "BatchedFactorState",
           "FactorState", "analyze", "factor", "refactor", "solve",
           "solve_system", "factor_batched", "solve_batched",
           "solve_sequence", "torch_repeated_engine", "analysis_from_arrays",
           "pattern_key", "plan_fingerprint", "PlanCache", "save_analysis",
           "load_analysis"]
