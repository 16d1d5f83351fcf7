"""The one decoder of a saved analysis artifact.

The numeric inputs of the system are values and right-hand sides; its
"weights" are the analysis artifact.  ``analysis_from_arrays`` rebuilds the
port's :class:`~repro_torch.core.analysis.Analysis` from the arrays and the
meta record that ``save_analysis`` writes (format version 1; this
package's :mod:`~repro_torch.core.plan_cache` and the JAX package's
``repro.core.plan_cache`` write the same ``.npz``) without re-running
matching or ordering, so both packages can run the very same plan.
``np.load`` of an artifact is enough input::

    with np.load(path) as z:
        an = analysis_from_arrays(z, z["meta"], HyluOptions(...))

:func:`~repro_torch.core.plan_cache.load_analysis` decodes through this
function too.
"""
from __future__ import annotations

import json

import numpy as np

from .analysis import Analysis
from .kernel_select import KernelChoice
from .matching import MatchResult
from .options import HyluOptions, plan_options_key
from .plan import Edge, FactorPlan, NodePlan
from .symbolic import Symbolic

FORMAT_VERSION = 1


class PlanCacheFormatError(ValueError):
    """A saved analysis artifact that cannot be trusted: unknown format
    version, fingerprint or plan-option mismatch, or a malformed file."""

REQUIRED_ARRAYS = (
    "match_col_of_row", "match_row_scale", "match_col_scale", "q", "p",
    "src_map", "scale_map", "m_indptr", "m_indices", "sym_parent",
    "sym_lrow_ptr", "sym_lrow_idx", "sym_lcol_ptr", "sym_lcol_idx",
    "sym_cc", "sym_row_flops", "sym_snode_of", "sym_snode_start",
    "sym_snode_end", "plan_panel_offset", "plan_a_scatter",
    "plan_row_perm_slots", "node_r0", "node_r1", "node_level",
    "node_lsize", "node_usize", "node_pat_ptr", "node_pat",
    "edge_ptr", "edge_src", "edge_cm_ptr", "edge_cm")


def analysis_from_arrays(arrays, meta, opts: HyluOptions | None = None,
                         expected_fingerprint: str | None = None
                         ) -> Analysis:
    """Build an Analysis from a saved artifact.

    ``arrays`` maps the artifact's array names to numpy arrays (a dict, or
    the ``NpzFile`` of ``np.load``); ``meta`` is its meta record, as a dict
    or as the JSON string (or 0-d array) stored under ``"meta"``.  ``opts``
    must agree with the artifact on every plan-affecting option
    (``use_kernels=True`` stands for the JAX package's
    ``use_pallas=True``); ``expected_fingerprint`` also pins its content
    address.  A mismatch, an unknown format version or a missing array
    raises :class:`PlanCacheFormatError` (a ``ValueError``)."""
    opts = opts or HyluOptions()
    if not isinstance(meta, dict):
        meta = json.loads(str(np.asarray(meta)[()]))
    if meta.get("format_version") != FORMAT_VERSION:
        raise PlanCacheFormatError(
            f"format version {meta.get('format_version')!r} != supported "
            f"{FORMAT_VERSION}")
    if (expected_fingerprint is not None
            and meta.get("fingerprint") != expected_fingerprint):
        raise PlanCacheFormatError(
            f"stored fingerprint {meta.get('fingerprint')!r} does not "
            f"match expected {expected_fingerprint!r}")
    if meta.get("options_key") != repr(plan_options_key(opts)):
        raise PlanCacheFormatError(
            f"artifact was analyzed under plan options "
            f"{meta.get('options_key')} but is being loaded with "
            f"{plan_options_key(opts)!r}")
    names = set(arrays.files if hasattr(arrays, "files") else arrays)
    missing = set(REQUIRED_ARRAYS) - names
    if missing:
        raise PlanCacheFormatError(
            f"artifact is missing arrays {sorted(missing)}")
    z = {name: np.asarray(arrays[name]) for name in REQUIRED_ARRAYS}

    n = int(meta["n"])
    match = MatchResult(
        col_of_row=z["match_col_of_row"], row_scale=z["match_row_scale"],
        col_scale=z["match_col_scale"],
        structurally_singular=bool(meta["match_structurally_singular"]))
    cm = meta["choice"]
    choice = KernelChoice(mode=cm["mode"], relax=cm["relax"],
                          max_super=cm["max_super"], stats=cm["stats"],
                          reason=cm["reason"])
    sym = Symbolic(
        n=n, parent=z["sym_parent"],
        lrow_ptr=z["sym_lrow_ptr"], lrow_idx=z["sym_lrow_idx"],
        lcol_ptr=z["sym_lcol_ptr"], lcol_idx=z["sym_lcol_idx"],
        cc=z["sym_cc"], flops=float(meta["sym"]["flops"]),
        row_flops=z["sym_row_flops"], snode_of=z["sym_snode_of"],
        snode_start=z["sym_snode_start"], snode_end=z["sym_snode_end"],
        nnz_l=int(meta["sym"]["nnz_l"]))

    pat_ptr, pat = z["node_pat_ptr"], z["node_pat"]
    edge_ptr, edge_src = z["edge_ptr"], z["edge_src"]
    cm_ptr, cm_cat = z["edge_cm_ptr"], z["edge_cm"]
    node_level = z["node_level"]
    nodes = []
    for t in range(len(z["node_r0"])):
        edges = [Edge(src=int(edge_src[j]),
                      col_map=cm_cat[int(cm_ptr[j]):int(cm_ptr[j + 1])])
                 for j in range(int(edge_ptr[t]), int(edge_ptr[t + 1]))]
        nodes.append(NodePlan(
            nid=t, r0=int(z["node_r0"][t]), r1=int(z["node_r1"][t]),
            pattern=pat[int(pat_ptr[t]):int(pat_ptr[t + 1])],
            lsize=int(z["node_lsize"][t]), usize=int(z["node_usize"][t]),
            edges=edges, level=int(node_level[t])))
    n_levels = int(node_level.max()) + 1 if len(node_level) else 0
    pm = meta["plan"]
    plan = FactorPlan(
        n=n, nodes=nodes, panel_offset=z["plan_panel_offset"],
        total_slots=int(pm["total_slots"]), a_scatter=z["plan_a_scatter"],
        levels=[np.where(node_level == lv)[0] for lv in range(n_levels)],
        n_bulk_levels=int(pm["n_bulk_levels"]), mode=pm["mode"],
        useful_flops=float(pm["useful_flops"]),
        padded_flops=float(pm["padded_flops"]),
        row_perm_slots=z["plan_row_perm_slots"])
    return Analysis(
        n=n, opts=opts, match=match, q=z["q"], p=z["p"],
        ordering_name=meta["ordering_name"], choice=choice, sym=sym,
        plan=plan, src_map=z["src_map"], scale_map=z["scale_map"],
        m_pattern=(z["m_indptr"], z["m_indices"]),
        timings={"analyzed_total": float(meta["timings"].get("total", 0.0))},
        pattern_key=meta["pattern_key"], fingerprint=meta["fingerprint"])

