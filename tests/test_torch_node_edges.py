"""The unrolled schedule's node step (K5's ``node_edges_inplace``) against
the JAX package's.

On the CPU the wrapper runs its plain version, ``node_edges_plain``, in
place on the value buffer.  Each case builds one target node fed by
finished source panels, with values from a numpy seed, and runs the node
step on both sides: here ``node_edges_inplace`` and then, for nr > 1, the
port's K2 (its plain version); on the JAX side
``repro.core.jax_engine._node_step_unrolled`` with ``use_pallas=True`` in
interpret mode, one system at a time.  Tolerances are those of
``tests/test_kernels.py``: 1e-10 in float64 (the two sides sum in another
order), 1e-4 in float32.  Pivot permutations and perturbation counts must
match exactly, and every slot outside the node's panel must keep its bits.

The CUDA kernel itself is held against ``node_edges_plain`` on the card by
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import jax_engine  # noqa: E402
from repro.core.plan import Edge, NodePlan  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import (HyluOptions, analyze,  # noqa: E402
                              torch_repeated_engine)
from repro_torch.kernels.panel import ops as tpanel  # noqa: E402
from repro_torch.kernels.supsup import ops as supsup  # noqa: E402
from repro_torch.kernels.trisolve.ref import trsm_plain  # noqa: E402
from repro_torch.matrices import fem2d, to_csr  # noqa: E402

DTYPES = {"float64": (jnp.float64, torch.float64, 1e-10),
          "float32": (jnp.float32, torch.float32, 1e-4)}
K_SYS = 2                 # systems in the port's value buffer
GAP = 3                   # slots between panels, outside every panel


def _node_case(rng, nr, ks, lsize=12, usize=5):
    """Source panels of ks[i] rows (each feeding one edge, in order) and a
    target node of nr rows at the end, in one value buffer of K_SYS
    systems with GAP random slots between panels.  Sources: an L prefix
    of 2, then [U block | suffix], the block's strict upper part scaled by
    1/sqrt(k) over 3 I on the diagonal (garbage below it, which nobody may
    read).  Returns (vals (K_SYS, slots) numpy, nodes, offs, target)."""
    w = lsize + nr + usize
    nodes, offs, pos, parts = [], [], GAP, []
    for i, k in enumerate(ks):
        m = int(rng.integers(0, min(w - k, 8) + 1))
        sw = 2 + k + m
        p = rng.normal(size=(K_SYS, k, sw))
        p[:, :, 2:2 + k] = (np.triu(rng.normal(size=(K_SYS, k, k)), 1)
                            / np.sqrt(k) + 3 * np.eye(k)
                            + np.tril(rng.normal(size=(K_SYS, k, k)), -1))
        nodes.append(NodePlan(nid=i, r0=0, r1=k, pattern=np.arange(sw),
                              lsize=2, usize=m, edges=[]))
        offs.append(pos)
        parts.append((pos, p))
        pos += k * sw + GAP
    tgt = len(ks)
    edges = []
    for i, nd in enumerate(nodes):
        k, m = nd.nr, nd.usize
        edges.append(Edge(src=i, col_map=np.sort(
            rng.choice(w, size=k + m, replace=False))))
    p = rng.normal(size=(K_SYS, nr, w))
    p[:, :, lsize:lsize + nr] += 3 * np.eye(nr)
    nodes.append(NodePlan(nid=tgt, r0=3, r1=3 + nr, pattern=np.arange(w),
                          lsize=lsize, usize=usize, edges=edges))
    offs.append(pos)
    parts.append((pos, p))
    pos += nr * w + GAP
    vals = rng.normal(size=(K_SYS, pos))
    for o, p in parts:
        vals[:, o:o + p[0].size] = p.reshape(K_SYS, -1)
    offs = np.asarray(offs + [pos], np.int64)
    return vals, nodes, offs, nodes[tgt]


def _port_table(nodes, offs, nd):
    table = supsup.edge_table(
        [(int(offs[e.src]), nodes[e.src].nr, nodes[e.src].width,
          nodes[e.src].lsize, e.col_map) for e in nd.edges], "cpu")
    step = supsup.node_step(int(offs[nd.nid]), nd.nr, nd.width, nd.lsize,
                            0, len(nd.edges),
                            max((nodes[e.src].nr for e in nd.edges),
                                default=0))
    return table, step


def _port_node(vals, nodes, offs, nd, eps, tdt):
    """The port's node step on a (K_SYS, slots) buffer: the wrapper (its
    plain version on the CPU), then K2 for nr > 1.  Returns (vals, local
    perm (K_SYS, nr), nper (K_SYS,))."""
    v = torch.tensor(vals, dtype=tdt)
    e = torch.tensor(eps, dtype=tdt)
    nper = torch.zeros(K_SYS, dtype=torch.int32)
    table, step = _port_table(nodes, offs, nd)
    kernels.reset_launch_counts()
    supsup.node_edges_inplace(v, table, step, e, nper)
    assert kernels.launch_counts()["node_edges_inplace"] == 0   # the CPU
    perm = torch.arange(nd.nr, dtype=torch.int32).repeat(K_SYS, 1)
    if nd.nr > 1:
        off, nr, w = step.off, nd.nr, nd.width
        panel = v[:, off:off + nr * w].view(K_SYS, nr, w)
        P, perm, npn = tpanel.panel_lu(panel, nr, nd.lsize, e)
        panel.copy_(P)
        nper += npn
    return v, perm, nper


def _jax_node(vals, nodes, offs, nd, eps, jdt):
    """``_node_step_unrolled`` (Pallas, interpret mode) per system."""
    out = []
    for s in range(K_SYS):
        n = nd.r0 + nd.nr
        v, inode, nper = jax_engine._node_step_unrolled(
            jnp.asarray(vals[s], jdt), jnp.arange(n, dtype=jnp.int32),
            jnp.int32(0), nd, nodes, offs, jnp.asarray(eps[s], jdt), True,
            True)
        out.append((np.asarray(v), np.asarray(inode)[nd.r0:] - nd.r0,
                    int(nper)))
    return out


def _held(port, ref, vals, offs, nd, tdt, tol):
    v, perm, nper = port
    off = int(offs[nd.nid])
    inside = np.zeros(vals.shape[1], bool)
    inside[off:off + nd.nr * nd.width] = True
    before = torch.tensor(vals, dtype=tdt)
    assert torch.equal(v[:, ~inside].view(torch.int64 if tdt == torch.float64
                                          else torch.int32),
                       before[:, ~inside].view(
                           torch.int64 if tdt == torch.float64
                           else torch.int32))
    for s, (jv, jperm, jnper) in enumerate(ref):
        assert np.array_equal(perm[s].numpy(), jperm)
        assert int(nper[s]) == jnper
        torch.testing.assert_close(v[s, inside],
                                   torch.from_numpy(jv[inside]).to(tdt),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("nr", [1, 3, 17])
@pytest.mark.parametrize("k", [1, 2, 5])
def test_node_step_matches_jax(k, nr, dt):
    """A node fed by sources of k, 1 and k rows (for nr = 1 and k > 1 the
    sup-row edges), in place, against the JAX node step.  A width-1 node
    perturbs its pivot in the second system (eps 1e6) and not the first."""
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(100 * k + nr)
    vals, nodes, offs, nd = _node_case(rng, nr, (k, 1, k))
    eps = np.array([1e-8, 1e6 if nr == 1 else 1e-6])
    port = _port_node(vals, nodes, offs, nd, eps, tdt)
    ref = _jax_node(vals, nodes, offs, nd, eps, jdt)
    _held(port, ref, vals, offs, nd, tdt, tol)
    if nr == 1:
        assert port[2].tolist() == [0, 1]


@pytest.mark.parametrize("nr", [1, 24])
def test_bf16_node_step_matches_jax(nr):
    """bfloat16: a node fed by 16 sources of 1 to 16 rows, against the JAX
    node step.  The JAX package runs a sup-sup edge of a node of more than
    one row through the Pallas GEMM update (C − A·B summed in float32 and
    rounded once) and every other product as bfloat16 ops (the product
    rounded, then the difference); the plain node step must round at the
    same places.  Equal pivots and counts, no slot outside the panel
    written, and each panel value within two bf16 ulps of its own entry of
    the JAX result (the two sum their float32 dots in other orders)."""
    rng = np.random.default_rng(300 + nr)
    ks = tuple(int(k) for k in rng.integers(1, 17, size=16))
    vals, nodes, offs, nd = _node_case(rng, nr, ks, lsize=40, usize=24)
    vals = torch.tensor(vals).to(torch.bfloat16).double().numpy()
    eps = np.array([1e-8, 1e-6])
    v, perm, nper = _port_node(vals, nodes, offs, nd, eps, torch.bfloat16)
    ref = _jax_node(vals, nodes, offs, nd, eps, jnp.bfloat16)
    off = int(offs[nd.nid])
    inside = np.zeros(vals.shape[1], bool)
    inside[off:off + nd.nr * nd.width] = True
    before = torch.tensor(vals, dtype=torch.bfloat16)
    assert torch.equal(v[:, ~inside].view(torch.int16),
                       before[:, ~inside].view(torch.int16))
    for s, (jv, jperm, jnper) in enumerate(ref):
        assert np.array_equal(perm[s].numpy(), jperm)
        assert int(nper[s]) == jnper
        got = v[s, inside].float().numpy()
        want = jv[inside].astype(np.float32)
        assert np.isfinite(want).all() and np.isfinite(got).all()
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want),
                                                  2.0 ** -126))) - 7)
        assert (np.abs(got - want) <= 2 * ulp + 2.0 ** -126).all(), \
            np.max(np.abs(got - want) / ulp)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_width1_node_without_edges(dt):
    """A width-1 node with no edge only perturbs its pivot: a positive and
    a negative pivot below eps, and a NaN, which stays and is not
    counted."""
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(5)
    vals, nodes, offs, nd = _node_case(rng, 1, ())
    piv = int(offs[nd.nid]) + nd.lsize
    vals[:, piv] = [-1e-3, 2e-3]
    eps = np.array([1e-2, 1e-2])
    port = _port_node(vals, nodes, offs, nd, eps, tdt)
    _held(port, _jax_node(vals, nodes, offs, nd, eps, jdt), vals, offs, nd,
          tdt, tol)
    assert port[0][:, piv].tolist() == pytest.approx([-1e-2, 1e-2])
    vals[0, piv] = np.nan
    port = _port_node(vals, nodes, offs, nd, eps, tdt)
    assert torch.isnan(port[0][0, piv]) and port[2].tolist() == [0, 1]


def _held_nonfinite(port, ref, offs, nd, tdt, tol):
    """The node's panel in each system: NaN and inf positions and the
    infinities equal, the finite values within tol; returns the count of
    non-finite entries."""
    off = int(offs[nd.nid])
    bad = 0
    for s, (jv, _, jnper) in enumerate(ref):
        got = port[0][s, off:off + nd.nr * nd.width]
        want = torch.tensor(jv[off:off + nd.nr * nd.width], dtype=tdt)
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.isinf(), want.isinf())
        assert torch.equal(got[got.isinf()], want[want.isinf()])
        fin = want.isfinite()
        torch.testing.assert_close(got[fin], want[fin], rtol=tol, atol=tol)
        assert int(port[2][s]) == jnper
        bad += int((~fin).sum())
    return bad


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("k", [2, 3, 6])
def test_suprow_edge_zero_divisor_matches_jax(k, dt):
    """A width-1 node fed by sup-row edges (sources of k > 1 rows) whose
    source U has an exact zero on its diagonal, under eps = 0, against the
    JAX node step, which solves such an edge by ``_trsm_upper_jax``
    (``src/repro/core/jax_engine.py:53``): the same NaN and inf positions,
    infinities and finite values.  System 0: U[j, j] = 0 at the first
    source's last-but-one row, with a zero right of it that meets the
    infinite quotient; system 1: 0 / 0 at the last source's first step."""
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(11 * k)
    vals, nodes, offs, nd = _node_case(rng, 1, (k, 1, k))
    j = k - 2
    for i, s, r, c in ((0, 0, j, j), (0, 0, j, j + 1), (2, 1, 0, 0)):
        vals[s, offs[i] + r * nodes[i].width + nodes[i].lsize + c] = 0.0
    cm = nd.edges[2].col_map
    vals[1, int(offs[nd.nid]) + int(cm[0])] = 0.0      # the 0 of 0 / 0
    eps = np.zeros(K_SYS)
    port = _port_node(vals, nodes, offs, nd, eps, tdt)
    ref = _jax_node(vals, nodes, offs, nd, eps, jdt)
    assert _held_nonfinite(port, ref, offs, nd, tdt, tol) > 0


def _engine():
    a = to_csr(fem2d(10, 10, seed=2))
    an = analyze(a, HyluOptions(device="cpu", force_mode="supernodal",
                                max_super=4, bulk_min_width=2,
                                factor_schedule="unrolled"))
    vals = a.data[None] * np.random.default_rng(4).uniform(0.8, 1.2,
                                                            (K_SYS, a.nnz))
    return torch_repeated_engine(an), torch.from_numpy(vals)


def _edge_loop(vals, plan, t, j):
    """The unrolled schedule's per-edge loop over the first j edges of
    node t, written out edge by edge as the plain node step runs it
    (gather through col_map, divide or triangular solve, product, write
    back; a sup-row edge's solve in ``_trsm_upper_jax``'s order)."""
    K = vals.shape[0]
    nodes, offs = plan.nodes, plan.panel_offset
    nd = nodes[t]
    off = int(offs[nd.nid])
    panel = vals[:, off:off + nd.nr * nd.width].view(K, nd.nr, nd.width)
    for e in nd.edges[:j]:
        snd = nodes[e.src]
        k, soff = snd.nr, int(offs[snd.nid])
        src = vals[:, soff:soff + k * snd.width].view(
            K, k, snd.width)[:, :, snd.lsize:]
        cm = torch.from_numpy(np.asarray(e.col_map, np.int64))
        x = panel[:, :, cm]
        if k == 1:
            lts = x[:, :, :1] / src[:, :, :1]
            xr = x[:, :, 1:] - lts * src[:, :, 1:]
        elif nd.nr > 1:
            lts, xr = supsup.supsup_update_plain(x, src, k)
        else:
            lts = trsm_plain(src[:, :, :k], x[:, :, :k])
            xr = x[:, :, k:] - torch.matmul(lts, src[:, :, k:])
        panel[:, :, cm] = torch.cat([lts, xr], dim=2)
    return vals


def test_stop_inside_a_node_matches_the_edge_loop():
    """``refactor_batched(stop=(t, j))`` returns the buffer just before
    edge j of node t: the node run over its first j edges, as the
    per-edge loop leaves it, bit for bit on the CPU, for a sup-sup node
    and a width-1 node."""
    eng, a = _engine()
    nodes = eng.plan.nodes
    sup = max((t for t, nd in enumerate(nodes) if nd.nr > 1),
              key=lambda t: len(nodes[t].edges))
    row = max((t for t, nd in enumerate(nodes) if nd.nr == 1),
              key=lambda t: len(nodes[t].edges))
    for t in (sup, row):
        n_e = len(nodes[t].edges)
        assert n_e >= 3
        v0, eps0 = eng.refactor_batched(a, stop=(t, 0))
        j = n_e // 2
        vj, epsj = eng.refactor_batched(a, stop=(t, j))
        assert torch.equal(eps0, epsj)
        assert torch.equal(vj, _edge_loop(v0.clone(), eng.plan, t, j))


def test_unrolled_routes_agree_on_the_cpu():
    """The node step on both routes of the unrolled schedule: the kernel
    route (the wrapper's plain version) and ``use_kernels=False`` give the
    same pivots and perturbation counts and factors within 1e-10."""
    eng, a = _engine()
    a_csr = to_csr(fem2d(10, 10, seed=2))
    an = analyze(a_csr, HyluOptions(device="cpu", force_mode="supernodal",
                                    max_super=4, bulk_min_width=2,
                                    factor_schedule="unrolled",
                                    use_kernels=False))
    eng_plain = torch_repeated_engine(an)
    fk, fp = eng.refactor_batched(a), eng_plain.refactor_batched(a)
    assert torch.equal(fk.inode_perm, fp.inode_perm)
    assert torch.equal(fk.n_perturb, fp.n_perturb)
    torch.testing.assert_close(fk.vals, fp.vals, rtol=1e-10, atol=1e-10)


def test_edge_table_refuses_what_the_kernel_does_not_take():
    """An edge needs a source row and a col_map of at least k columns, a
    node step a panel and, with edges, its widest source; a source of any
    rows is taken (more than 128: the kernel's wide instance)."""
    table = supsup.edge_table([(0, 129, 130, 0, np.arange(130))], "cpu")
    assert table.edges[0][1] == 129
    with pytest.raises(ValueError, match="k >= 1"):
        supsup.edge_table([(0, 0, 4, 2, np.arange(2))], "cpu")
    with pytest.raises(ValueError, match="len"):
        supsup.edge_table([(0, 3, 4, 2, np.arange(2))], "cpu")
    with pytest.raises(ValueError, match="not a panel"):
        supsup.node_step(0, 4, 5, 2, 0, 1, 3)
    with pytest.raises(ValueError, match="not a panel"):
        supsup.node_step(0, 2, 5, 2, 0, 1, 0)
