"""The port's host analysis against the JAX package's, exactly.

Both packages run the same numpy analysis (repro_torch keeps its own copy
of every host module), so every array they produce must be identical:
matching, ordering, scales, refactor maps, the FactorPlan, the bucketed
factor schedule, the node-block solve schedule and the plan fingerprint.
No tolerance: the arithmetic is the same code on the same inputs.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import CSR as JaxCSR, HyluOptions as JaxOptions  # noqa: E402
from repro.core import analyze as jax_analyze  # noqa: E402
from repro.core.plan_cache import save_analysis  # noqa: E402
from repro.core.structure import (block_schedule as jax_block_schedule,  # noqa: E402
                                  get_bucket_schedule as jax_bucket_schedule)
from repro_torch.core import CSR, HyluOptions, analyze  # noqa: E402
from repro_torch.core.convert import analysis_from_arrays  # noqa: E402
from repro_torch.core.options import PLAN_OPTION_FIELDS  # noqa: E402
from repro_torch.core.structure import (block_schedule,  # noqa: E402
                                        get_bucket_schedule)
from repro_torch.matrices import fem2d  # noqa: E402

from tests.helpers import SCENARIOS  # noqa: E402

CASES = sorted(SCENARIOS) + ["fem2d_12_supernodal"]


def _case(name):
    """(scipy matrix, plan option kwargs) of one case."""
    if name == "fem2d_12_supernodal":
        return (fem2d(12, 12, seed=1),
                dict(force_mode="supernodal", bulk_min_width=2))
    gen, routing_n, _, kwargs = SCENARIOS[name]
    return gen(n=routing_n, seed=0, **kwargs), {}


def _both(name):
    a, kw = _case(name)
    a = a.tocsr()
    aj = JaxCSR.from_scipy(a)
    at = CSR(aj.n, aj.indptr.copy(), aj.indices.copy(), aj.data.copy())
    an_j = jax_analyze(aj, JaxOptions(engine="jax", use_pallas=True, **kw))
    return an_j, aj, at, kw


def _eq(x, y, what):
    np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=what)


def assert_same_analysis(an_j, an_t):
    """Every value-independent product of two analyses is identical."""
    for f in ("q", "p", "src_map", "scale_map"):
        _eq(getattr(an_j, f), getattr(an_t, f), f)
    for f in ("col_of_row", "row_scale", "col_scale"):
        _eq(getattr(an_j.match, f), getattr(an_t.match, f), f)
    _eq(an_j.m_pattern[0], an_t.m_pattern[0], "m_indptr")
    _eq(an_j.m_pattern[1], an_t.m_pattern[1], "m_indices")
    assert an_j.choice.mode == an_t.choice.mode
    assert an_j.ordering_name == an_t.ordering_name
    assert an_j.fingerprint == an_t.fingerprint
    assert an_j.pattern_key == an_t.pattern_key

    pj, pt = an_j.plan, an_t.plan
    assert (pj.n, pj.total_slots, pj.n_bulk_levels, pj.mode) == \
        (pt.n, pt.total_slots, pt.n_bulk_levels, pt.mode)
    for f in ("panel_offset", "a_scatter", "row_perm_slots"):
        _eq(getattr(pj, f), getattr(pt, f), f)
    assert len(pj.levels) == len(pt.levels)
    for lj, lt in zip(pj.levels, pt.levels):
        _eq(lj, lt, "levels")
    assert len(pj.nodes) == len(pt.nodes)
    for nj, nt in zip(pj.nodes, pt.nodes):
        assert (nj.r0, nj.r1, nj.lsize, nj.usize, nj.level) == \
            (nt.r0, nt.r1, nt.lsize, nt.usize, nt.level)
        _eq(nj.pattern, nt.pattern, "node pattern")
        assert [e.src for e in nj.edges] == [e.src for e in nt.edges]
        for ej, et in zip(nj.edges, nt.edges):
            _eq(ej.col_map, et.col_map, "edge col_map")

    bw = an_j.opts.bulk_min_width
    sj, st = jax_bucket_schedule(pj, bw), get_bucket_schedule(pt, bw)
    assert (sj.n_ext, sj.zero_slot, sj.one_slot, sj.scratch_slot) == \
        (st.n_ext, st.zero_slot, st.one_slot, st.scratch_slot)
    assert len(sj.steps) == len(st.steps)
    for a, b in zip(sj.steps, st.steps):
        assert (a.diag is None) == (b.diag is None)
        if a.diag is not None:
            _eq(a.diag.slots, b.diag.slots, "diag slots")
        _eq(a.seq, b.seq, "seq")
        assert len(a.panels) == len(b.panels)
        for x, y in zip(a.panels, b.panels):
            assert (x.nr, x.wu, x.wt) == (y.nr, y.wu, y.wt)
            for f in ("nids", "gather", "scatter", "rows"):
                _eq(getattr(x, f), getattr(y, f), f"panel {f}")
        assert len(a.edges) == len(b.edges)
        for x, y in zip(a.edges, b.edges):
            assert (x.k, x.nr, x.m) == (y.k, y.nr, y.m)
            for f in ("srcs", "tgts", "src_idx", "x_idx", "write_idx"):
                _eq(getattr(x, f), getattr(y, f), f"edge {f}")
    assert len(sj.scan_chunks) == len(st.scan_chunks)
    for x, y in zip(sj.scan_chunks, st.scan_chunks):
        assert (x.lv0, x.lv1) == (y.lv0, y.lv1)
        for f in ("dsl", "x_idx", "src_idx", "write_idx"):
            _eq(getattr(x, f), getattr(y, f), f"scan {f}")

    bj, bt = jax_block_schedule(pj), block_schedule(pt)
    assert len(bj) == len(bt)
    for x, y in zip(bj, bt):
        assert (x.r0, x.nr) == (y.r0, y.nr)
        for f in ("pre_cols", "pre_slots", "suf_cols", "suf_slots",
                  "blk_slots"):
            _eq(getattr(x, f), getattr(y, f), f"block {f}")


@pytest.mark.parametrize("name", CASES)
def test_analyze_matches_jax(name):
    an_j, _, at, kw = _both(name)
    an_t = analyze(at, HyluOptions(device="cpu", **kw))
    assert_same_analysis(an_j, an_t)


def _carry(path, opts):
    with np.load(path) as z:
        return analysis_from_arrays(z, z["meta"], opts)


@pytest.mark.parametrize("name", CASES)
def test_analysis_from_jax_artifact(name, tmp_path):
    """A JAX-written save_analysis artifact carried across reproduces the
    JAX analysis without re-running matching or ordering."""
    an_j, _, _, kw = _both(name)
    path = save_analysis(an_j, str(tmp_path / "plan.npz"))
    assert_same_analysis(an_j, _carry(path, HyluOptions(device="cpu", **kw)))


def test_artifact_rejects_other_plan_options(tmp_path):
    an_j, _, _, kw = _both("circuit")
    path = save_analysis(an_j, str(tmp_path / "plan.npz"))
    with pytest.raises(ValueError, match="plan options"):
        _carry(path, HyluOptions(device="cpu", relax=3, **kw))


def test_plan_option_fields_align_with_jax():
    """use_kernels sits where use_pallas sits, so both packages hash the
    same options to the same fingerprint; ``mesh`` (the split of K, as the
    JAX package's) is runtime-only in both, never in the key."""
    from repro.core.options import PLAN_OPTION_FIELDS as JAX_FIELDS
    from repro.core.options import plan_options_key as jax_key
    from repro_torch.core.options import plan_options_key

    assert [f.replace("use_pallas", "use_kernels") for f in JAX_FIELDS] == \
        list(PLAN_OPTION_FIELDS)
    for kw in ({}, {"factor_dtype": "float32"}, {"perturb_eps": 1e-2},
               {"force_mode": "supernodal", "bulk_min_width": 2}):
        assert jax_key(JaxOptions(use_pallas=True, **kw)) == \
            plan_options_key(HyluOptions(**kw))
    torch_fields = {f.name for f in dataclasses.fields(HyluOptions)}
    assert {"device", "use_kernels", "mesh"} <= torch_fields
    assert "use_pallas" not in torch_fields
    assert "mesh" not in PLAN_OPTION_FIELDS and "mesh" not in JAX_FIELDS
    assert plan_options_key(HyluOptions(mesh=["cpu"] * 2)) == \
        plan_options_key(HyluOptions())
