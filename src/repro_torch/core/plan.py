# Copy of src/repro/core/plan.py (numpy only), kept so that repro_torch never
# imports the JAX package.  Keep the two in step.
"""Static factorization plan (the TPU-native data structure of this port).

HYLU's data structure is "elaborated to support the hybrid numerical kernels
in a common way" (§2.2).  On TPU the analogue is a *static execution plan*
computed once at analysis time:

  - every node (supernode or standalone row) owns a dense panel
    ``nr × |P_T|`` where ``P_T`` is the sorted union column pattern of the
    node's rows: [ L-part cols < r0 | diagonal block r0..r1 | U-part cols > r1 ].
    Panels are zero-initialized; structural zeros inside the union pattern
    carry exact numeric zeros, which makes relaxed supernode amalgamation and
    full-panel updates *numerically exact* (see notes below).
  - every dependency edge S → T carries one small int vector ``col_map``:
    positions of S's (block ∪ U-struct) columns inside P_T.  The numeric
    update is then

        X           = panel_T[:, col_map]                (gather)
        L_TS        = X[:, :k] @ inv(U_SS)               (dense TRSM, k = nr_S)
        X[:, k:]   -= L_TS @ U_S,rest                    (GEMM  — sup-sup)
        panel_T[:, col_map] = [L_TS | X[:, k:]]          (scatter)

    For a standalone source row (k == 1) this degenerates to the row-row /
    sup-row kernels (a divide + an axpy / GEMV); for supernode sources it is
    the sup-sup kernel (TRSM+GEMM on the MXU).  One code path, three kernels —
    exactly the paper's "common data structure" idea, expressed as shapes.

Exactness of full-panel updates: if row t of T is not in struct(U row s) for
any s in S, then the gathered X[t, S-block] is exactly zero (its entries would
otherwise be symbolic fill — contradiction), so the TRSM row is zero and the
GEMM adds zeros.  Hence updating *all* rows of the target panel is exact; the
cost is redundant-flop padding, which is the honest TPU price for regularity
and is reported by ``plan_stats`` (useful_flops vs padded_flops).

Node-level symbolic structures are computed here bottom-up (P_T from A-rows
plus incoming W_S cliques), which keeps edge scatter maps consistent by
construction, including under relaxed amalgamation.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from .matrix import CSR
from .symbolic import Symbolic


@dataclasses.dataclass
class Edge:
    src: int
    col_map: np.ndarray     # (k_src + m_src,) positions into target pattern


@dataclasses.dataclass
class NodePlan:
    nid: int
    r0: int
    r1: int                 # exclusive; nr = r1 - r0
    pattern: np.ndarray     # sorted global col ids, len w
    lsize: int              # cols < r0
    usize: int              # cols >= r1
    edges: list             # list[Edge], ascending src
    level: int = -1

    @property
    def nr(self) -> int:
        return self.r1 - self.r0

    @property
    def width(self) -> int:
        return len(self.pattern)


@dataclasses.dataclass
class FactorPlan:
    n: int
    nodes: list                 # list[NodePlan]
    panel_offset: np.ndarray    # (n_nodes+1,) flat offsets; panel T occupies
                                # [off[T], off[T] + nr*w) row-major
    total_slots: int
    a_scatter: np.ndarray       # (nnz_B,) flat positions of B entries
    levels: list                # list[np.ndarray] node ids per level
    n_bulk_levels: int          # prefix of `levels` executed in bulk mode
    mode: str                   # "hybrid" | "supernodal" | "rowrow"
    useful_flops: float
    padded_flops: float
    row_perm_slots: np.ndarray  # (n,) flat position of each row's diag entry

    @property
    def n_nodes(self):
        return len(self.nodes)


def build_plan(pat_sym: CSR, numeric: CSR, sym: Symbolic, mode: str = "hybrid",
               bulk_min_width: int = 8) -> FactorPlan:
    """Build the static plan.

    pat_sym — symmetrized pattern (B+Bᵀ+I) the symbolic analysis ran on;
              node structures MUST use it (fill comes from the symmetric
              pattern even where B itself has a numeric zero).
    numeric — the actual matrix pattern (drives the A-value scatter map).
    """
    n = pat_sym.n
    n_nodes = sym.n_nodes
    starts, ends = sym.snode_start, sym.snode_end

    # ---------------- node-level pattern recursion (ascending) -------------
    patterns: list[np.ndarray] = [None] * n_nodes      # type: ignore
    w_structs: list[np.ndarray] = [None] * n_nodes     # type: ignore
    src_lists: list[list[int]] = [[] for _ in range(n_nodes)]

    snode_of = sym.snode_of
    for t in range(n_nodes):
        r0, r1 = int(starts[t]), int(ends[t])
        cols_parts = [np.arange(r0, r1, dtype=np.int64)]
        for i in range(r0, r1):
            idx, _ = pat_sym.row(i)
            cols_parts.append(idx.astype(np.int64))
        for s in src_lists[t]:
            sp = patterns[s]
            node_s0 = int(starts[s])
            # all of S's block + U cols (suffix of its pattern from lsize on)
            cols_parts.append(sp[np.searchsorted(sp, node_s0):])
        pat = np.unique(np.concatenate(cols_parts))
        patterns[t] = pat
        w = pat[np.searchsorted(pat, r1):]
        w_structs[t] = w
        # register this node as a source of every node its W hits
        hit_nodes = np.unique(snode_of[w])
        for h in hit_nodes:
            src_lists[int(h)].append(t)

    # ---------------- edges + maps ----------------------------------------
    nodes: list[NodePlan] = []
    useful = 0.0
    padded = 0.0
    for t in range(n_nodes):
        r0, r1 = int(starts[t]), int(ends[t])
        pat = patterns[t]
        lsize = int(np.searchsorted(pat, r0))
        usize = int(len(pat) - np.searchsorted(pat, r1))
        edges = []
        for s in sorted(src_lists[t]):
            sp = patterns[s]
            s0 = int(starts[s])
            src_cols = sp[np.searchsorted(sp, s0):]      # block + W_S
            pos = np.searchsorted(pat, src_cols)
            assert np.array_equal(pat[pos], src_cols), \
                "plan inconsistency: source cols missing from target pattern"
            edges.append(Edge(src=s, col_map=pos.astype(np.int64)))
            k = int(ends[s] - s0)
            m = len(src_cols) - k
            nr = r1 - r0
            h = int(np.sum((w_structs[s] >= r0) & (w_structs[s] < r1)))
            useful += 2.0 * h * k * (k + m)   # trsm+gemm on hit rows
            padded += 2.0 * nr * k * (k + m)
        nr = r1 - r0
        wdt = len(pat)
        useful += 2.0 / 3.0 * nr ** 3 + 2.0 * nr * nr * (wdt - lsize - nr)
        padded += 2.0 / 3.0 * nr ** 3 + 2.0 * nr * nr * (wdt - lsize - nr)
        nodes.append(NodePlan(nid=t, r0=r0, r1=r1, pattern=pat,
                              lsize=lsize, usize=usize, edges=edges))

    # ---------------- flat panel layout ------------------------------------
    panel_offset = np.zeros(n_nodes + 1, dtype=np.int64)
    for t, nd in enumerate(nodes):
        panel_offset[t + 1] = panel_offset[t] + nd.nr * nd.width
    total_slots = int(panel_offset[-1])

    # ---------------- A-value scatter map ----------------------------------
    a_scatter = np.empty(numeric.nnz, dtype=np.int64)
    for i in range(n):
        t = int(snode_of[i])
        nd = nodes[t]
        s, e = numeric.indptr[i], numeric.indptr[i + 1]
        pos = np.searchsorted(nd.pattern, numeric.indices[s:e])
        assert np.array_equal(nd.pattern[pos], numeric.indices[s:e]), \
            "numeric entry outside node pattern"
        a_scatter[s:e] = (panel_offset[t] + (i - nd.r0) * nd.width + pos)

    row_perm_slots = np.empty(n, dtype=np.int64)
    for i in range(n):
        t = int(snode_of[i])
        nd = nodes[t]
        dpos = nd.lsize + (i - nd.r0)
        row_perm_slots[i] = panel_offset[t] + (i - nd.r0) * nd.width + dpos

    # ---------------- levelization: dual-mode schedule ----------------------
    level = np.zeros(n_nodes, dtype=np.int64)
    for t, nd in enumerate(nodes):
        lv = 0
        for e in nd.edges:
            lv = max(lv, level[e.src] + 1)
        level[t] = lv
        nd.level = int(lv)
    n_levels = int(level.max()) + 1 if n_nodes else 0
    levels = [np.where(level == lv)[0] for lv in range(n_levels)]
    n_bulk = 0
    for lv in range(n_levels):
        if len(levels[lv]) >= bulk_min_width:
            n_bulk = lv + 1
        else:
            break

    return FactorPlan(n=n, nodes=nodes, panel_offset=panel_offset,
                      total_slots=total_slots, a_scatter=a_scatter,
                      levels=levels, n_bulk_levels=n_bulk, mode=mode,
                      useful_flops=useful, padded_flops=padded,
                      row_perm_slots=row_perm_slots)


def memory_stats(plan: FactorPlan, bulk_min_width: int = 8, k: int = 1,
                 dtype_bytes: int = 8) -> dict:
    """Deterministic plan-derived byte accounting of the numeric phase —
    what the repeated-solve engine resident set looks like BEFORE running
    it, so scale benchmarks can report (and CI can regression-check) a
    footprint that does not depend on allocator noise.

    ``panel_bytes``     one set of factor values (``total_slots`` slots);
    ``workspace_bytes`` the factor working buffer incl. the zero/one/scratch
                        sentinel slots (``n_ext``);
    ``schedule_index_bytes``  every static gather/scatter index array of the
                        bucketed schedule (the compile-time trace payload);
    ``batched_bytes``   value + RHS + solution buffers for a system batch of
                        ``k`` (the batched refactor path's per-K cost);
    ``total_bytes``     the sum — the engine's steady-state floor."""
    from .structure import get_bucket_schedule

    sched = get_bucket_schedule(plan, bulk_min_width=bulk_min_width)
    idx = 0
    for s in sched.steps:
        if s.diag is not None:
            idx += s.diag.nids.nbytes + s.diag.slots.nbytes
        idx += s.seq.nbytes
        for pb in s.panels:
            idx += (pb.nids.nbytes + pb.gather.nbytes + pb.scatter.nbytes
                    + pb.rows.nbytes)
        for eb in s.edges:
            idx += (eb.srcs.nbytes + eb.tgts.nbytes + eb.src_idx.nbytes
                    + eb.x_idx.nbytes + eb.write_idx.nbytes)
    for c in sched.scan_chunks:
        idx += (c.dsl.nbytes + c.x_idx.nbytes + c.src_idx.nbytes
                + c.write_idx.nbytes)
    panel = plan.total_slots * dtype_bytes
    workspace = sched.n_ext * dtype_bytes
    batched = k * (sched.n_ext + 2 * plan.n) * dtype_bytes
    return dict(
        panel_bytes=int(panel),
        workspace_bytes=int(workspace),
        schedule_index_bytes=int(idx),
        batched_bytes=int(batched),
        total_bytes=int(panel + workspace + idx + batched),
    )


def plan_stats(plan: FactorPlan, include_buckets: bool = True,
               bulk_min_width: int = 8) -> dict:
    """Plan statistics; with ``include_buckets`` (default) also the
    level-bucketed factor schedule's bucket counts, pad-waste fraction and
    bulk-node coverage — the numbers to revisit ``kernel_select``
    thresholds against (a mode that looks good on padded_flops can still
    lose on pad_waste_frac / trace size).  Pass the analysis's
    ``opts.bulk_min_width`` so the bucket stats describe the schedule the
    engine actually runs."""
    widths = np.array([nd.width for nd in plan.nodes])
    nrs = np.array([nd.nr for nd in plan.nodes])
    n_edges = sum(len(nd.edges) for nd in plan.nodes)
    bucket = {}
    mem = {}
    if include_buckets:
        from .structure import bucket_stats
        bucket = bucket_stats(plan, bulk_min_width=bulk_min_width)
        mem = memory_stats(plan, bulk_min_width=bulk_min_width)
    return dict(
        **bucket,
        **mem,
        mode=plan.mode,
        n_nodes=plan.n_nodes,
        n_edges=n_edges,
        total_slots=plan.total_slots,
        mean_panel_width=float(widths.mean()) if len(widths) else 0.0,
        mean_nr=float(nrs.mean()) if len(nrs) else 0.0,
        n_levels=len(plan.levels),
        n_bulk_levels=plan.n_bulk_levels,
        bulk_node_frac=float(sum(len(plan.levels[i]) for i in range(plan.n_bulk_levels))
                             / max(plan.n_nodes, 1)),
        useful_flops=plan.useful_flops,
        padded_flops=plan.padded_flops,
        padding_overhead=plan.padded_flops / max(plan.useful_flops, 1.0),
    )
