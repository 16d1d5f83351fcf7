"""The port's roofline (``repro_torch.roofline``): ``op_cost`` against the
JAX package's HLO cost parse, the kernels' work formulas against the
bounds PERF.md §6 records, the H100's constants and the report, on the
CPU.

``op_cost`` counts what runs; ``hlo_cost`` parses what XLA compiled.  On
``tanh(x @ w1) @ w2`` their FLOPs agree within 5%, and an 11-step loop
counts 11 bodies (the JAX test's 0.9–1.2 window).  The kernel formulas
reproduce PERF.md §6's bound column at the recorded shapes (H100 SXM:
3.35 TB/s, 67 TFLOP/s float64 / float32, 989 bfloat16).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.roofline import hlo_cost  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.roofline import analysis as RA  # noqa: E402
from repro_torch.roofline import kernel_cost as kc  # noqa: E402
from repro_torch.roofline import report  # noqa: E402
from repro_torch.roofline.op_cost import OpCost  # noqa: E402


def _jax_flops(f, *shapes):
    c = jax.jit(f).lower(*(jax.ShapeDtypeStruct(s, jnp.float32)
                           for s in shapes)).compile()
    return hlo_cost.analyze(c.as_text()).flops


def test_op_cost_flops_match_hlo_cost():
    rng = np.random.default_rng(0)
    x, w1, w2 = (rng.normal(size=s).astype(np.float32)
                 for s in ((32, 64), (64, 128), (128, 16)))
    with OpCost() as c:
        out = torch.tanh(torch.from_numpy(x) @ torch.from_numpy(w1)) \
            @ torch.from_numpy(w2)
    mine = c.total_flops
    ref = _jax_flops(lambda a, b, d: jnp.tanh(a @ b) @ d, (32, 64),
                     (64, 128), (128, 16))
    assert out.shape == (32, 16)
    assert abs(mine - ref) / ref < 0.05, (mine, ref)
    assert c.flops == {"float32": mine}
    # operands plus outputs of each op: x @ w1, tanh, then @ w2
    assert c.bytes == 4 * ((32 * 64 + 64 * 128 + 32 * 128) + 2 * 32 * 128
                           + (32 * 128 + 128 * 16 + 32 * 16))


def test_op_cost_counts_every_loop_trip():
    w = torch.randn(32, 32)
    with OpCost() as c:
        y = torch.randn(32, 32)
        for _ in range(11):
            y = y @ w
        y.sum()
    expect = 11 * 2 * 32 * 32 * 32
    assert 0.9 < c.total_flops / expect < 1.2


def test_op_cost_by_dtype_and_views():
    """bf16 FLOPs are kept apart (they run at the tensor cores' peak);
    views move no bytes; a scatter counts the update, not the target."""
    a = torch.randn(64, 64, dtype=torch.bfloat16)
    big = torch.zeros(1000, 64)
    with OpCost() as c:
        (a @ a).float()
        a.view(-1).view(64, 64).t()
        big.index_add_(0, torch.tensor([1, 5]), torch.ones(2, 64))
    assert c.flops["bfloat16"] == 2 * 64 ** 3
    assert c.by_op["index_add_"][2] == 3 * 2 * 64 * 4 + 2 * 8
    assert "view" not in c.by_op and "t" not in c.by_op


def test_op_cost_least_traffic():
    """``min_bytes``: the arguments read once, as far as their views were
    read (a stacked weight by the layers read, a cache by the rows read,
    a table by the rows gathered), in-place writes once, the results
    once; the intermediates nothing."""
    x, w1, w2 = torch.randn(8, 16), torch.randn(16, 32), torch.randn(32, 4)
    with OpCost() as c:
        y = torch.tanh(x @ w1) @ w2
    assert c.min_bytes(y) == 4 * (8 * 16 + 16 * 32 + 32 * 4 + 8 * 4)
    assert c.min_bytes(y) < c.bytes
    stacked, g = torch.randn(6, 10, 10), torch.randn(6, 10, 10)
    with OpCost() as c:
        for i in range(3):                    # three of six layers
            stacked[i].add_(g[i], alpha=-0.1)
    assert c.min_bytes() == 4 * (300 + 300)   # g read, stacked written
    cache, row = torch.zeros(2, 8, 3, 4), torch.randn(2, 3, 4)
    table = torch.randn(100, 12)
    with OpCost() as c:
        cache[:, 5] = row
        s = cache[:, :6].sum() + table[torch.tensor([3, 7])].sum()
    assert c.min_bytes(s) == 4 * (2 * 6 * 12 + 2 * 12 + 2 * 12 + 2 * 12
                                  + 1) + 8 * 2


def test_kernel_launches_report_their_work():
    """``_build.launch`` hands the observer each launch's work: counted
    by entry point under op_cost, into ``uncounted`` without a formula
    (nothing is launched: the library call itself is replaced)."""
    calls = []
    orig_lib = _build._lib
    _build._lib = type("Lib", (), {"hylu_x": lambda self, *a: 0,
                                   "hylu_y": lambda self, *a: 0})()
    try:
        with OpCost() as c:
            _build.launch("hylu_x", 1, work=lambda: kc.as_work(
                4, kc.bmm(2, 3, 4, 5, 4)))
            _build.launch("hylu_y", 1)
            calls.append(_build.launch_observer is not None)
        calls.append(_build.launch_observer is None)
    finally:
        _build._lib = orig_lib
    assert calls == [True, True]
    assert c.kernels["hylu_x"] == {"launches": 1, "flops": 240.0,
                                   "bytes": 4 * 2 * (12 + 20 + 15)}
    assert c.flops["float32"] == 240.0
    assert c.uncounted == {"hylu_y": 1}


def _bound_ms(flops_bytes, dtype):
    flops, nbytes = flops_bytes
    return max(flops / RA.PEAK_FLOPS[dtype], nbytes / RA.HBM_BW) * 1e3


@pytest.mark.parametrize("case,dtype,recorded", [
    # K2 at 32 x 128 x 2,347 (PERF.md §6: 0.0459 / 0.0230)
    (lambda e: kc.panel_work(32, 128, 2347, 2219, 2347, e), "float64",
     0.0459),
    (lambda e: kc.panel_work(32, 128, 2347, 2219, 2347, e), "float32",
     0.0230),
    # K3 left, 32 blocks of 128 x 128, m = 1 (0.000641 / 0.000650)
    (lambda e: kc.trsm_left(True, 32, 128, 1, e), "float64", 0.000641),
    (lambda e: kc.trsm_left(False, 32, 128, 1, e), "float64", 0.000650),
    (lambda e: kc.trsm_left(False, 32, 128, 1, e), "float32", 0.000325),
    # K4, 64 products (128 x 64) @ (64 x 104) (0.00430 / 0.00215)
    (lambda e: kc.bmm(64, 128, 64, 104, e), "float64", 0.00430),
    (lambda e: kc.bmm(64, 128, 64, 104, e), "float32", 0.00215),
    # K6 at k 128, m 300, 32 rows (0.00363 / 0.00182)
    (lambda e: kc.suprow(32, 128, 300, e), "float64", 0.00363),
    (lambda e: kc.suprow(32, 128, 300, e), "float32", 0.00182),
    # K7, phi3-medium-14b layer 0: q (4, 40, 2,048, 128), kv heads 10
    (lambda e: kc.flash(4, 40, 10, 2048, 2048, 128, e), "bfloat16", 0.174),
    (lambda e: kc.flash(4, 40, 10, 2048, 2048, 128, e), "float32", 2.565),
    # K8, rwkv6-1.6b layer 0: (4, 32, 2,048, 64), u (32, 64) (0.1008)
    (lambda e: kc.wkv(4, 32, 2048, 64, 32 * 64), "float32", 0.1008),
])
def test_kernel_formulas_reproduce_the_recorded_bounds(case, dtype,
                                                       recorded):
    elem = {"float64": 8, "float32": 4, "bfloat16": 2}[dtype]
    got = _bound_ms(case(elem), dtype)
    assert math.isclose(got, recorded, rel_tol=6e-3), (got, recorded)


def test_kernel_formulas_of_k1_and_k5():
    """K1's bucket on real descriptors (one member of nr 3 with a U
    suffix of 2) and K5's node step on two edges, against their
    definitions written out."""
    desc = np.array([[0, 3, 5, 0, 2]])
    flops, nbytes = kc.bucket_work(desc, 4, 2, 8)
    assert flops == kc.lu_flops(2, 3, 0, 5)
    assert flops == 2 * ((2 * (1 + 2 * 4)) + (1 * (1 + 2 * 3)))
    assert nbytes == 2 * 2 * 15 * 8 + 2 * 8 + 4 * 2 * 1 * 5 + 4 * 5
    edges = [(2, np.array([0, 1, 4, 6])), (1, np.array([1, 3]))]
    f, b = kc.node_step(3, edges, 4, 2)
    assert f == 2 * 3 * ((4 + 2 * 2 * 2) + (1 + 2 * 1 * 1))
    touched = 5                                  # columns 0, 1, 3, 4, 6
    assert b == 2 * (2 * 3 * touched * 4 + (3 + 4 + 1 + 1) * 4) \
        + 8 * (4 + 5) + 8 * (2 + 5)


def _blocked_pieces(solve, n, nr, k, m, elem):
    """The work of K3's former blocked route past 128 columns, summed over
    its launches: the k <= 128 solve on each diagonal block of at most 128
    and K5's GEMM update of the columns (right solve) or rows (left
    solves) still to be solved."""
    flops = nbytes = 0.0
    for s in range(0, k, 128):
        e = min(s + 128, k)
        if solve == "right":
            pieces = (kc.trsm_right(n, nr, e - s, elem),
                      kc.gemm_update(n, nr, e - s, k - e, elem))
        else:
            rest = s if solve == "upper" else k - e
            pieces = (kc.trsm_left(solve == "lower", n, e - s, m, elem),
                      kc.gemm_update(n, rest, e - s, m, elem))
        for f, b in pieces:
            flops, nbytes = flops + f, nbytes + b
    return flops, nbytes


@pytest.mark.parametrize("k", [150, 256])
@pytest.mark.parametrize("solve", ["right", "lower", "upper"])
def test_wide_trsm_work_is_the_blocked_route_summed(solve, k):
    """One wide K3 launch counts the operations of the blocked route's
    pieces summed, at the wide records' shapes; its bytes are the
    function's (each input read once, the output written once), at most
    the pieces' sum, which re-reads and re-writes the columns or rows
    still to be solved between blocks."""
    n, nr, m, elem = 32, 256, 1, 8
    wide = (kc.trsm_right(n, nr, k, elem) if solve == "right" else
            kc.trsm_left(solve == "lower", n, k, m, elem))
    flops, nbytes = _blocked_pieces(solve, n, nr, k, m, elem)
    assert wide[0] == flops
    assert wide[1] <= nbytes
    if solve == "right":
        assert wide[1] == (n * k * (k + 1) // 2 + 2 * n * nr * k) * elem


def test_h100_constants_and_terms():
    assert RA.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12,
                             "float64": 67e12}
    assert (RA.HBM_BW, RA.LINK_BW) == (3.35e12, 50e9)
    t, bott = RA.terms({"bfloat16": 989e12, "float32": 67e12}, 3.35e12, 0.0)
    assert t == {"compute": 2.0, "memory": 1.0, "collective": 0.0}
    assert bott == "compute"
    assert RA.terms({}, 0, 1e9)[1] == "collective"


def test_report_renders_the_three_tables():
    rec = dict(arch="a", shape="s", mesh="pod16x16", status="ok",
               t_compute=2e-3, t_memory=5e-4, t_collective=1e-6,
               bottleneck="compute", flops_per_device=1e12,
               useful_ratio=0.5, peak_live_gib=1.5, t_trace_s=3.0,
               mem_args_gib=2.0, coll_bytes_per_device=1e6,
               coll_by_kind={"all-reduce": 1e6})
    skip = dict(arch="b", shape="long_500k", mesh="pod16x16",
                status="skipped", reason="x")
    summary = report.render_dryrun_summary([rec, skip])
    assert "1 traced ok, 1 documented skips, 0 errors" in summary
    assert "| a | s | pod16x16 | 3.0 | 1.50 | 2.00 | 1.00e+06 | all-reduce |" \
        in summary
    table = report.render([rec, skip], "pod16x16")
    assert "**compute**" in table and "- b × long_500k" in table
    card = report.render_card([dict(name="x", t_compute=1e-3,
                                    t_memory=2e-3, min_t_memory=5e-4,
                                    eager_bound_ms=2.0, min_bound_ms=1.0,
                                    ms=4.0, busy=0.9)])
    assert ("| x | 1.0ms | 2.0ms | 500µs | 2.000 | 1.000 | 4.000 | 0.500 | "
            "0.250 | 0.900 |") in card


def test_recurrence_operators_equal_the_plain_functions():
    """The recurrences' custom operators (one op each on fake tensors, for
    the dry run) give the plain functions' values and gradients bit for
    bit on real tensors, and count by formula under op_cost."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.wkv.ref import wkv_plain
    from repro_torch.models import recurrence as R

    gen = torch.Generator().manual_seed(0)
    a = torch.rand(2, 9, 3, 4, generator=gen, requires_grad=True)
    bx, g = (torch.randn(2, 9, 3, 4, generator=gen) for _ in range(2))
    bx.requires_grad_()
    h0 = torch.randn(2, 3, 4, generator=gen, requires_grad=True)
    plain = R.ssm_scan_plain(a, bx, h0)
    op = R.ssm_scan_op(a, bx, h0)
    assert torch.equal(plain, op)
    for x, y in zip(torch.autograd.grad(plain, (a, bx, h0), g),
                    torch.autograd.grad(op, (a, bx, h0), g)):
        assert torch.equal(x, y)
    r, k, v, w = (torch.rand(2, 3, 7, 8, generator=gen, requires_grad=True)
                  for _ in range(4))
    u = torch.rand(3, 8, generator=gen, requires_grad=True)
    y1, s1 = wkv_plain(r, k, v, w, u)
    y2, s2 = R.wkv_scan_op(r, k, v, w, u)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    gy, gs = torch.randn_like(y1), torch.randn_like(s1)
    for x, y in zip(torch.autograd.grad((y1, s1), (r, k, v, w, u), (gy, gs)),
                    torch.autograd.grad((y2, s2), (r, k, v, w, u),
                                        (gy, gs))):
        assert torch.equal(x, y)
    with FakeTensorMode() as fm:
        a = torch.empty(2, 128, 3, 4, requires_grad=True)
        bx = torch.empty(2, 128, 3, 4, requires_grad=True)
        with OpCost(fm) as c:
            R.ssm_scan(a, bx, torch.empty(2, 3, 4)).sum().backward()
    assert c.by_op["ssm_scan"][:2] == [1, 2.0 * bx.numel()]
    assert c.by_op["ssm_scan_backward"][:2] == [1, 4.0 * bx.numel()]
