# Copy of src/repro/core/structure.py (numpy only), kept so that repro_torch never
# imports the JAX package.  Keep the two in step.
"""Static L/U structure + slot maps derived from a FactorPlan.

The factored values live in the flat panel buffer ``vals``; every L/U entry
has a *static* slot there (in-node pivoting permutes which original row a
panel row holds, never the slot layout).  These maps let the JAX solve,
transpose-solve (adjoint) and refactorization paths gather L/U values with
compile-time-constant indices.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from .plan import FactorPlan
from .symbolic import Symbolic


# --------------------------------------------------------------------------
# supernode amalgamation (panel fattening under a fill tolerance)
# --------------------------------------------------------------------------
def _node_fill_pattern(sym: Symbolic, r0: int, r1: int) -> np.ndarray:
    """Filled column pattern of the row run [r0, r1): union over its rows of
    {i} ∪ struct(L row i) ∪ struct(U row i) — under the symmetrized pattern
    struct(U row i) beyond the diagonal equals struct(L col i) transposed,
    which the symbolic analysis already carries (``lcol``).  This is the
    partition-independent lower bound of the plan's panel width (merged
    upstream sources can only widen it)."""
    parts = [np.arange(r0, r1, dtype=np.int64)]
    for i in range(r0, r1):
        parts.append(sym.lrow_idx[sym.lrow_ptr[i]:sym.lrow_ptr[i + 1]])
        parts.append(sym.lcol_idx[sym.lcol_ptr[i]:sym.lcol_ptr[i + 1]])
    return np.unique(np.concatenate(parts))


def amalgamate_supernodes(sym: Symbolic, fill_tol: float,
                          max_super: int = 128) -> tuple[Symbolic, dict]:
    """Merge *independent* adjacent supernodes with near-identical column
    patterns into fatter panels (CKTSO-style relaxation, one knob past the
    fundamental / ``relax`` amalgamation of ``symbolic_factorize``).

    A run of consecutive nodes is grown greedily while (a) the candidate
    does not depend on the run — no filled L/U entry couples its rows to
    the run's rows, checked on the filled structures — and (b) the extra
    explicit zeros the merged panel stores — ``(nr_merged × w_merged) − Σ
    separate slots`` — stay within ``fill_tol`` of the run's separate
    storage, and the merged block height stays ≤ ``max_super``.

    Why independence: near-identical adjacent columns in circuit matrices
    are overwhelmingly *sibling* columns (parallel device terminals, tied
    nets) — independent, at the same elimination depth — and merging them
    fattens the level's panels without touching the level structure, so
    the bucketed schedule's long scanned width-1 tail (its compile-time
    lifeline at n≥10^4) survives.  Merging *dependent* chain nodes instead
    collapses levels but converts the scanned tail into thousands of
    unrolled level steps, which does not compile in reasonable time on
    XLA:CPU; dependent parent/child fattening is the existing ``relax``
    knob's job inside ``symbolic_factorize``.

    Structural zeros inside a union pattern carry exact numeric zeros (see
    :mod:`repro.core.plan`), so the coarsening is numerically exact: the
    amalgamated plan factors to the same L/U values and solves
    bit-identically; only panel geometry (node count, pad waste, kernel
    shapes) changes.

    Returns the coarsened ``Symbolic`` plus a stats dict
    (``n_nodes_before/after``, ``n_merges``, ``est_extra_slots``,
    ``est_base_slots``, ``fill_tol``).  ``fill_tol <= 0`` returns the input
    partition unchanged (and the stats record zero merges), so the default
    plan is bit-for-bit the historical one."""
    starts, ends = sym.snode_start, sym.snode_end
    n_nodes = len(starts)
    base_slots = 0
    stats = dict(n_nodes_before=int(n_nodes), n_nodes_after=int(n_nodes),
                 n_merges=0, est_extra_slots=0, est_base_slots=0,
                 fill_tol=float(fill_tol))
    if fill_tol <= 0 or n_nodes <= 1:
        return sym, stats

    new_starts = []
    est_extra = 0
    n_merges = 0
    cur_r0, cur_r1 = int(starts[0]), int(ends[0])
    cur_pat = _node_fill_pattern(sym, cur_r0, cur_r1)
    cur_sep = (cur_r1 - cur_r0) * len(cur_pat)   # separate-storage sum of run
    base_slots = cur_sep

    def _close_run():
        nonlocal est_extra
        new_starts.append(cur_r0)
        est_extra += (cur_r1 - cur_r0) * len(cur_pat) - cur_sep

    for t in range(1, n_nodes):
        r0, r1 = int(starts[t]), int(ends[t])
        pat_t = _node_fill_pattern(sym, r0, r1)
        sep_t = (r1 - r0) * len(pat_t)
        base_slots += sep_t
        nr_m = r1 - cur_r0
        if nr_m <= max_super:
            # independence: the candidate's pattern must not reach back
            # into the run's rows (entries < r0 in pat_t are exactly its
            # filled L-row structure = its in-factor dependencies), and
            # the run's pattern must not reach into the candidate's rows
            lo = np.searchsorted(pat_t, cur_r0)
            hi = np.searchsorted(pat_t, r0)
            lo2 = np.searchsorted(cur_pat, r0)
            hi2 = np.searchsorted(cur_pat, r1)
            if lo == hi and lo2 == hi2:
                pat_m = np.union1d(cur_pat, pat_t)
                extra = nr_m * len(pat_m) - (cur_sep + sep_t)
                if extra <= fill_tol * (cur_sep + sep_t):
                    cur_pat, cur_r1 = pat_m, r1
                    cur_sep += sep_t
                    n_merges += 1
                    continue
        _close_run()
        cur_r0, cur_r1, cur_pat, cur_sep = r0, r1, pat_t, sep_t
    _close_run()

    new_starts = np.asarray(new_starts, dtype=np.int64)
    new_ends = np.append(new_starts[1:], sym.n)
    snode_of = np.zeros(sym.n, dtype=np.int64)
    for t in range(len(new_starts)):
        snode_of[new_starts[t]:new_ends[t]] = t
    stats.update(n_nodes_after=len(new_starts), n_merges=int(n_merges),
                 est_extra_slots=int(est_extra),
                 est_base_slots=int(base_slots))
    out = dataclasses.replace(sym, snode_of=snode_of,
                              snode_start=new_starts, snode_end=new_ends)
    return out, stats


@dataclasses.dataclass
class LUStructure:
    n: int
    # L strictly-lower (unit diag implicit), CSR by rows
    l_indptr: np.ndarray
    l_indices: np.ndarray
    l_slots: np.ndarray
    # U strictly-upper, CSR by rows, diag separate
    u_indptr: np.ndarray
    u_indices: np.ndarray
    u_slots: np.ndarray
    u_diag_slots: np.ndarray


def lu_structure(plan: FactorPlan) -> LUStructure:
    n = plan.n
    lr_pt = [0]; lr_ix = []; lr_sl = []
    ur_pt = [0]; ur_ix = []; ur_sl = []
    ud_sl = np.empty(n, dtype=np.int64)
    for nd in plan.nodes:
        off = int(plan.panel_offset[nd.nid])
        nr, w, ls = nd.nr, nd.width, nd.lsize
        pat = nd.pattern
        for q in range(nr):
            g = nd.r0 + q
            base = off + q * w
            # L: prefix cols + in-block strictly-lower
            lr_ix.extend(pat[:ls].tolist())
            lr_sl.extend(range(base, base + ls))
            lr_ix.extend(range(nd.r0, nd.r0 + q))
            lr_sl.extend(range(base + ls, base + ls + q))
            lr_pt.append(len(lr_ix))
            # U: strictly-upper in-block + suffix; diag separate
            ud_sl[g] = base + ls + q
            ur_ix.extend(range(g + 1, nd.r0 + nr))
            ur_sl.extend(range(base + ls + q + 1, base + ls + nr))
            ur_ix.extend(pat[ls + nr:].tolist())
            ur_sl.extend(range(base + ls + nr, base + w))
            ur_pt.append(len(ur_ix))
    return LUStructure(
        n=n,
        l_indptr=np.array(lr_pt, dtype=np.int64),
        l_indices=np.array(lr_ix, dtype=np.int64),
        l_slots=np.array(lr_sl, dtype=np.int64),
        u_indptr=np.array(ur_pt, dtype=np.int64),
        u_indices=np.array(ur_ix, dtype=np.int64),
        u_slots=np.array(ur_sl, dtype=np.int64),
        u_diag_slots=ud_sl,
    )


def transpose_csr(n, indptr, indices, slots):
    """CSC view == CSR of the transpose, keeping slot association."""
    rows = np.repeat(np.arange(n), np.diff(indptr))
    order = np.lexsort((rows, indices))
    t_rows = indices[order]
    t_cols = rows[order]
    t_slots = slots[order]
    t_indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(t_indptr, t_rows + 1, 1)
    return np.cumsum(t_indptr), t_cols, t_slots


@dataclasses.dataclass
class TriSched:
    """Level schedule for one triangular solve, flattened per level.
    Per level k: rows[k] (unknowns finalized), cols[k]/slot[k]/seg[k]
    (dependencies; slot indexes the flat panel buffer)."""
    rows: list
    cols: list
    slot: list
    seg: list
    n_bulk: int
    n_levels: int


def tri_schedule(n, indptr, indices, slots, lower: bool,
                 bulk_min_width: int = 8) -> TriSched:
    """Levelize a triangular system given as strictly-tri CSR. ``lower``
    selects dependency direction (forward vs backward substitution)."""
    lev = np.zeros(n, dtype=np.int64)
    rng = range(n) if lower else range(n - 1, -1, -1)
    for i in rng:
        s, e = indptr[i], indptr[i + 1]
        if e > s:
            lev[i] = 1 + lev[indices[s:e]].max()
    nl = int(lev.max()) + 1 if n else 0
    rows_l, cols_l, slot_l, seg_l = [], [], [], []
    n_bulk = 0
    for k in range(nl):
        rows = np.where(lev == k)[0]
        cnt = (indptr[rows + 1] - indptr[rows]).astype(np.int64)
        seg = np.repeat(np.arange(len(rows)), cnt)
        take = (np.concatenate([np.arange(indptr[i], indptr[i + 1]) for i in rows])
                if cnt.sum() else np.empty(0, np.int64))
        rows_l.append(rows); cols_l.append(indices[take])
        slot_l.append(slots[take]); seg_l.append(seg)
        if len(rows) >= bulk_min_width:
            n_bulk += 1
    return TriSched(rows_l, cols_l, slot_l, seg_l, n_bulk, nl)


@dataclasses.dataclass
class BlockNode:
    """Static per-node gather maps for the block (panel) substitution path.

    The dense diagonal block (``blk_slots``) and the off-block L-prefix /
    U-suffix rectangles are read straight out of the flat panel buffer with
    these compile-time index matrices, so a solve can run node-by-node as
    dense GEMV/TRSM ops — the shape the Pallas TRSM kernel wants — instead
    of row-by-row levels."""
    r0: int
    nr: int
    pre_cols: np.ndarray    # (lsize,)  global cols of the L prefix
    pre_slots: np.ndarray   # (nr, lsize) flat slots of the L prefix
    suf_cols: np.ndarray    # (usize,)  global cols of the U suffix
    suf_slots: np.ndarray   # (nr, usize) flat slots of the U suffix
    blk_slots: np.ndarray   # (nr, nr) flat slots of the dense diagonal block
                            # (strict lower = L values, upper incl. diag = U)


def block_schedule(plan: FactorPlan) -> list:
    """Per-node block maps, ascending r0 (forward L order; reverse for U)."""
    nodes = []
    for nd in plan.nodes:
        off = int(plan.panel_offset[nd.nid])
        nr, w, ls = nd.nr, nd.width, nd.lsize
        row = off + np.arange(nr, dtype=np.int64)[:, None] * w
        nodes.append(BlockNode(
            r0=nd.r0, nr=nr,
            pre_cols=nd.pattern[:ls].astype(np.int64),
            pre_slots=row + np.arange(ls, dtype=np.int64)[None, :],
            suf_cols=nd.pattern[ls + nr:].astype(np.int64),
            suf_slots=row + ls + nr + np.arange(nd.usize, dtype=np.int64)[None, :],
            blk_slots=row + ls + np.arange(nr, dtype=np.int64)[None, :],
        ))
    return nodes


# --------------------------------------------------------------------------
# level-bucketed factorization schedule: the O(levels) trace data structure
# --------------------------------------------------------------------------
#
# The unrolled jax factor path emits O(nodes + edges) XLA ops, which caps
# compile time at toy sizes.  This schedule regroups the plan's level
# schedule into static shape buckets so the traced program is
# O(levels × shape-buckets):
#
#   per level ℓ (ascending):
#     1. internal factorization of every level-ℓ node — width-1 nodes are one
#        vectorized diagonal perturbation (DiagBucket); wider nodes on wide
#        (bulk) levels are one vmapped dense panel LU per padded shape
#        (PanelBucket); wider nodes on narrow levels keep the per-node dense
#        panel LU (the paper's sequential mode — `seq` on the step);
#     2. application of every edge OUT of level-ℓ sources — one batched
#        gather + TRSM + GEMM + scatter per padded shape (EdgeBucket).
#        Edges are bucketed on *every* level, narrow ones included: in a
#        sparse LU the late narrow levels own the densest edge lists, so
#        leaving them unrolled would keep the trace O(edges).
#
# Correctness of the right-looking per-level sweep: two same-level nodes
# never share an edge, so (a) an edge's multiplier columns (the source's
# block columns inside the target pattern) receive no further updates once
# the source level is factored, and (b) same-level edges into one target
# touch disjoint multiplier columns and purely-additive trailing columns.
# The gathered values therefore equal the left-looking ones exactly; only
# the floating-point summation order of trailing updates differs.
#
# Padding never changes the arithmetic: index matrices point padded gather
# positions at a constant 0-slot (or an identity-pivot sentinel slot — a
# huge constant that behaves as an un-pickable, never-"small" pivot and
# divides padded zeros to exact zeros — on padded block diagonals, so
# padded pivots are exact identity no-ops) and padded scatter positions at a
# write-only scratch slot.  All three live past the end of the value buffer.
_PAD_ZERO, _PAD_ONE, _PAD_SCRATCH = 0, 1, 2     # offsets past total_slots


def _pad_dim(v: int) -> int:
    """Round a bucket dimension up to the next power of two (small static
    shape vocabulary → few distinct traced subcomputations)."""
    return 1 if v <= 1 else int(2 ** np.ceil(np.log2(v)))


def _pad8(v: int) -> int:
    """Round a merged (max-within-bucket) dimension up to a sublane
    multiple; 0 stays 0 (empty part)."""
    return 0 if v <= 0 else -(-v // 8) * 8


def segment_levels(dims: list, max_groups: int = 12) -> list:
    """Partition an ordered list of per-level dimension tuples into runs
    whose per-dim max/min ratio is bounded — the shared chunking heuristic
    of the factor scan and the tri-solve scan.

    Group count is trace size, so the allowed pad ratio escalates (4, 16,
    64, …) until at most ``max_groups`` runs remain; padded work on the
    tiny narrow-tail levels stays negligible.  Returns a list of
    (start, end) index pairs (end exclusive)."""
    dims = [tuple(max(int(d), 1) for d in t) for t in dims]

    def _segment(ratio):
        groups = []
        i = 0
        while i < len(dims):
            j = i
            lo = hi = None
            while j < len(dims):
                d = dims[j]
                if lo is None:
                    lo, hi = d, d
                else:
                    nlo = tuple(min(a, b) for a, b in zip(lo, d))
                    nhi = tuple(max(a, b) for a, b in zip(hi, d))
                    if any(h > ratio * l for l, h in zip(nlo, nhi)):
                        break
                    lo, hi = nlo, nhi
                j += 1
            groups.append((i, j))
            i = j
        return groups

    ratio = 4
    groups = _segment(ratio)
    while len(groups) > max_groups and ratio < 1 << 30:
        ratio *= 4
        groups = _segment(ratio)
    return groups


@dataclasses.dataclass
class DiagBucket:
    """All width-1 nodes of one level: internal LU degenerates to pivot
    perturbation of the diagonal slot."""
    level: int
    nids: np.ndarray        # (B,)
    slots: np.ndarray       # (B,) flat diagonal slots


@dataclasses.dataclass
class PanelBucket:
    """Width>1 nodes of one level sharing a padded panel shape.

    The gathered panel is column-reordered to [diagonal block | U suffix |
    L prefix] so the elimination window is the static range [0, wu) for
    every node regardless of its lsize; the L prefix rides along at the end
    purely so in-block row pivoting permutes it too."""
    level: int
    nr: int                 # padded block rows
    wu: int                 # elimination width: padded nr + padded usize
    wt: int                 # gathered width: wu + padded lsize
    nids: np.ndarray        # (B,)
    gather: np.ndarray      # (B, nr, wt) flat slots (pads → 0/1 slots)
    scatter: np.ndarray     # (B, nr, wt) flat slots (pads → scratch)
    rows: np.ndarray        # (B, nr) global row ids (pads → n)


@dataclasses.dataclass
class EdgeBucket:
    """Edges out of one level's sources sharing a padded (k, nr, m) shape:
    one batched TRSM + GEMM and ONE combined scatter-add per bucket.

    The multiplier columns' ``.set(lts)`` is expressed as ``.add(lts - X)``
    (their pre-update value is exactly the gathered X — no other same-level
    edge touches them), so multiplier write-back and trailing update fuse
    into a single duplicate-accumulating scatter over ``write_idx`` —
    XLA:CPU compile time is dominated by scatter op count."""
    src_level: int
    k: int                  # padded source block width
    nr: int                 # padded target rows
    m: int                  # padded source U-suffix width
    srcs: np.ndarray        # (E,) source nids
    tgts: np.ndarray        # (E,) target nids
    src_idx: np.ndarray     # (E, k, k+m) source rows [diag block | U suffix]
                            # (block-diagonal pads → 1, others → 0)
    x_idx: np.ndarray       # (E, nr, k) target multiplier columns (pads → 0)
    write_idx: np.ndarray   # (E, nr*(k+m)) combined scatter: first nr*k
                            # entries are the multiplier positions, the rest
                            # the trailing positions (pads → scratch)


@dataclasses.dataclass
class LevelStep:
    level: int
    diag: DiagBucket | None
    panels: list            # list[PanelBucket]
    seq: np.ndarray         # node ids factored per-node (narrow-level wide
                            # nodes); their edges are still bucketed
    edges: list             # list[EdgeBucket]


@dataclasses.dataclass
class ScanChunk:
    """A run of consecutive all-width-1 levels executed as ONE ``lax.scan``
    whose body is traced once — the trace-size endgame for the long narrow
    tail of circuit-style level schedules.

    All levels in the chunk are padded to shared (D, E, M) shapes; the
    sentinel slots make the padding maskless (padded diagonal slots read
    the huge identity-pivot sentinel — never "small", rewritten verbatim;
    padded gathers read 0 → zero multipliers and zero updates; padded
    writes land in scratch)."""
    lv0: int
    lv1: int                # exclusive
    dsl: np.ndarray         # (L, D) diag slots, pads → one slot
    x_idx: np.ndarray       # (L, E) multiplier gathers, pads → zero slot
    src_idx: np.ndarray     # (L, E, 1+M) source rows [diag | U], pads:
                            # col 0 → one slot, cols 1: → zero slot
    write_idx: np.ndarray   # (L, E, 1+M) combined scatter, pads → scratch


@dataclasses.dataclass
class BucketSchedule:
    n: int
    total_slots: int
    n_ext: int              # total_slots + 3 (zero / one / scratch slots)
    zero_slot: int
    one_slot: int
    scratch_slot: int
    n_bulk_levels: int
    steps: list             # list[LevelStep], unrolled level prefix
    scan_chunks: list       # list[ScanChunk], the scanned width-1 suffix


def build_bucket_schedule(plan: FactorPlan,
                          bulk_min_width: int = 8) -> BucketSchedule:
    """Pre-flatten the plan's level schedule into static per-(level, shape)
    index arrays (see module comment above for the execution semantics).
    ``bulk_min_width`` is the dual-mode threshold: levels with fewer nodes
    run their wide-node internal LUs per-node (sequential mode)."""
    nodes = plan.nodes
    offs = plan.panel_offset
    n, n_nodes = plan.n, plan.n_nodes
    total = plan.total_slots
    assert total + 3 < np.iinfo(np.int32).max, "plan too large for int32 maps"
    zero, one, scr = (total + _PAD_ZERO, total + _PAD_ONE,
                      total + _PAD_SCRATCH)

    # ------- group all edges by (source level, padded k/nr class) ----------
    # m (the source U-suffix width) is NOT part of the key: every (level,
    # k, nr) class forms one bucket, padded to its max m, and is then split
    # only where padding waste would exceed 4x (``_waste_split``).  Bucket
    # count — i.e. trace size — is what compile time scales with; bounded
    # m-padding waste is just zero lanes through the gather/GEMM/scatter.
    edge_groups: dict = {}
    for nd in nodes:
        for e in nd.edges:
            snd = nodes[e.src]
            key = (snd.level, _pad_dim(snd.nr), _pad_dim(nd.nr))
            edge_groups.setdefault(key, []).append((e, nd))

    def _edge_m(pair):
        e, _ = pair
        return len(e.col_map) - nodes[e.src].nr

    def _waste_split(pairs, ratio=4):
        """Split a bucket's edge list into runs whose max/min m ratio is
        bounded — bounded pad waste at a bounded bucket-count increase."""
        pairs = sorted(pairs, key=_edge_m, reverse=True)
        out, cur = [], [pairs[0]]
        cap = max(_edge_m(pairs[0]), 1)
        for p in pairs[1:]:
            if cap > ratio * max(_edge_m(p), 1):
                out.append(cur)
                cur, cap = [], max(_edge_m(p), 1)
            cur.append(p)
        out.append(cur)
        return out

    def _edge_bucket(key, pairs) -> EdgeBucket:
        lv, kp, nrp = key
        mp = _pad8(max(_edge_m(p) for p in pairs))
        ne = len(pairs)
        src_idx = np.full((ne, kp, kp + mp), zero, dtype=np.int32)
        src_idx[:, np.arange(kp), np.arange(kp)] = one
        x_idx = np.full((ne, nrp, kp), zero, dtype=np.int32)
        lts_idx = np.full((ne, nrp, kp), scr, dtype=np.int32)
        upd_idx = np.full((ne, nrp, mp), scr, dtype=np.int32)
        srcs = np.empty(ne, dtype=np.int64)
        tgts = np.empty(ne, dtype=np.int64)
        for i, (e, nd) in enumerate(pairs):
            snd = nodes[e.src]
            k, m, nr = snd.nr, len(e.col_map) - snd.nr, nd.nr
            srcs[i], tgts[i] = snd.nid, nd.nid
            srow = (offs[snd.nid] + snd.lsize
                    + np.arange(k, dtype=np.int64)[:, None] * snd.width)
            src_idx[i, :k, :k] = srow + np.arange(k)[None, :]
            src_idx[i, :k, kp:kp + m] = srow + k + np.arange(m)[None, :]
            trow = (offs[nd.nid]
                    + np.arange(nr, dtype=np.int64)[:, None] * nd.width)
            x_idx[i, :nr, :k] = trow + e.col_map[None, :k]
            lts_idx[i, :nr, :k] = trow + e.col_map[None, :k]
            upd_idx[i, :nr, :m] = trow + e.col_map[None, k:]
        write_idx = np.concatenate([lts_idx.reshape(ne, -1),
                                    upd_idx.reshape(ne, -1)], axis=1)
        return EdgeBucket(src_level=lv, k=kp, nr=nrp, m=mp, srcs=srcs,
                          tgts=tgts, src_idx=src_idx, x_idx=x_idx,
                          write_idx=write_idx)

    def _panel_bucket(lv, nrp, nids) -> PanelBucket:
        usp = _pad8(max(nodes[t].usize for t in nids))
        lsp = _pad8(max(nodes[t].lsize for t in nids))
        wu, wt = nrp + usp, nrp + usp + lsp
        nbk = len(nids)
        gather = np.full((nbk, nrp, wt), zero, dtype=np.int32)
        gather[:, np.arange(nrp), np.arange(nrp)] = one   # identity diag pads
        scatter = np.full((nbk, nrp, wt), scr, dtype=np.int32)
        rows = np.full((nbk, nrp), n, dtype=np.int32)
        for i, t in enumerate(nids):
            nd = nodes[t]
            nr, w, ls, us = nd.nr, nd.width, nd.lsize, nd.usize
            base = (offs[t]
                    + np.arange(nr, dtype=np.int64)[:, None] * w)
            # column-reordered [block | suffix | prefix] slot map
            cols = np.concatenate([ls + np.arange(nr),            # block
                                   np.full(nrp - nr, -1),         # diag pads
                                   ls + nr + np.arange(us),       # suffix
                                   np.full(usp - us, -1),
                                   np.arange(ls),                 # prefix
                                   np.full(lsp - ls, -1)])
            real = cols >= 0
            slots = base + cols[real][None, :]                    # (nr, n_real)
            gather[i][:nr, real] = slots
            scatter[i][:nr, real] = slots
            rows[i, :nr] = nd.r0 + np.arange(nr)
        return PanelBucket(level=lv, nr=nrp, wu=wu, wt=wt,
                           nids=np.asarray(nids, dtype=np.int64),
                           gather=gather, scatter=scatter, rows=rows)

    # ------- scannable suffix: maximal run of all-width-1 levels -----------
    # (sources AND targets width 1 — target levels of a suffix edge are
    # later levels, themselves in the suffix, so checking node widths per
    # level suffices).  These levels' work collapses to one lax.scan body
    # per chunk instead of one traced step per level.
    n_levels = len(plan.levels)
    scan_start = n_levels
    while (scan_start > 0
           and all(nodes[int(t)].nr == 1
                   for t in plan.levels[scan_start - 1])
           and len(plan.levels[scan_start - 1]) < bulk_min_width):
        scan_start -= 1

    steps = []
    for lv in range(scan_start):
        nids = plan.levels[lv]
        bulk = len(nids) >= bulk_min_width
        ones = [int(t) for t in nids if nodes[t].nr == 1]
        diag = None
        if ones:
            diag = DiagBucket(
                level=lv, nids=np.asarray(ones, dtype=np.int64),
                slots=plan.row_perm_slots[
                    [nodes[t].r0 for t in ones]].astype(np.int32))
        wide = [int(t) for t in nids if nodes[t].nr > 1]
        panels, seq = [], []
        if bulk:
            wide_groups: dict = {}
            for t in wide:
                wide_groups.setdefault(_pad_dim(nodes[t].nr), []).append(t)
            panels = [_panel_bucket(lv, nrp, nids_g)
                      for nrp, nids_g in sorted(wide_groups.items())]
        else:
            seq = wide
        edges = [_edge_bucket(key, sub)
                 for key, pairs in sorted(edge_groups.items(),
                                          key=lambda kv: kv[0])
                 if key[0] == lv
                 for sub in _waste_split(pairs)]
        steps.append(LevelStep(level=lv, diag=diag, panels=panels,
                               seq=np.asarray(seq, dtype=np.int64),
                               edges=edges))

    # ------- scan chunks over the width-1 suffix ---------------------------
    def _level_raw(lv):
        """(diag_slots, [(x, src_row_base, m, col_map, toff, tw)]) of one
        scanned level — everything is width 1."""
        dsl = plan.row_perm_slots[
            [nodes[int(t)].r0 for t in plan.levels[lv]]].astype(np.int64)
        epairs = []
        for key, pairs in edge_groups.items():
            if key[0] == lv:
                epairs.extend(pairs)
        return dsl, epairs

    raw = {lv: _level_raw(lv) for lv in range(scan_start, n_levels)}

    def _dims(lv):
        dsl, epairs = raw[lv]
        return (len(dsl), len(epairs),
                max((_edge_m(p) for p in epairs), default=0))

    groups = [(i + scan_start, j + scan_start)
              for i, j in segment_levels(
                  [_dims(lv) for lv in range(scan_start, n_levels)])]

    chunks = []
    for lv0, lv1 in groups:
        dmax, emax, mmax = (max(max(vs), 1) for vs in zip(
            *(_dims(lv) for lv in range(lv0, lv1))))
        L = lv1 - lv0
        dsl_a = np.full((L, dmax), one, dtype=np.int32)
        x_a = np.full((L, emax), zero, dtype=np.int32)
        src_a = np.full((L, emax, 1 + mmax), zero, dtype=np.int32)
        src_a[:, :, 0] = one
        wr_a = np.full((L, emax, 1 + mmax), scr, dtype=np.int32)
        for l, lvx in enumerate(range(lv0, lv1)):
            dsl, epairs = raw[lvx]
            dsl_a[l, :len(dsl)] = dsl
            for i, (e, nd) in enumerate(epairs):
                snd = nodes[e.src]
                m = len(e.col_map) - 1
                srow = offs[snd.nid] + snd.lsize
                src_a[l, i, 0] = srow
                src_a[l, i, 1:1 + m] = srow + 1 + np.arange(m)
                toff = offs[nd.nid]
                x_a[l, i] = toff + e.col_map[0]
                wr_a[l, i, 0] = toff + e.col_map[0]
                wr_a[l, i, 1:1 + m] = toff + e.col_map[1:]
        chunks.append(ScanChunk(lv0=lv0, lv1=lv1, dsl=dsl_a, x_idx=x_a,
                                src_idx=src_a, write_idx=wr_a))

    return BucketSchedule(n=n, total_slots=total, n_ext=total + 3,
                          zero_slot=zero, one_slot=one, scratch_slot=scr,
                          n_bulk_levels=plan.n_bulk_levels, steps=steps,
                          scan_chunks=chunks)


def get_bucket_schedule(plan: FactorPlan,
                        bulk_min_width: int = 8) -> BucketSchedule:
    """Build-once cache of the bucket schedule on the plan object."""
    cache = getattr(plan, "_bucket_schedules", None)
    if cache is None:
        cache = {}
        plan._bucket_schedules = cache
    sched = cache.get(bulk_min_width)
    if sched is None:
        sched = build_bucket_schedule(plan, bulk_min_width=bulk_min_width)
        cache[bulk_min_width] = sched
    return sched


def bucket_stats(plan: FactorPlan, bulk_min_width: int = 8) -> dict:
    """Bucket-count / padding statistics of the bucketed factor schedule
    (consumed by ``plan.plan_stats`` so kernel_select thresholds can be
    revisited against real pad-waste numbers)."""
    sched = get_bucket_schedule(plan, bulk_min_width=bulk_min_width)
    n_panel = sum(len(s.panels) for s in sched.steps)
    n_diag = sum(1 for s in sched.steps if s.diag is not None)
    n_edge = sum(len(s.edges) for s in sched.steps)
    n_seq = sum(len(s.seq) for s in sched.steps)
    n_scanned = sum(c.lv1 - c.lv0 for c in sched.scan_chunks)
    gathered = 0
    real = 0
    for s in sched.steps:
        for pb in s.panels:
            gathered += pb.gather.size
            real += int((pb.gather < sched.total_slots).sum())
        for eb in s.edges:
            for arr in (eb.src_idx, eb.x_idx, eb.write_idx):
                gathered += arr.size
                real += int((arr < sched.total_slots).sum())
    for c in sched.scan_chunks:
        for arr in (c.dsl, c.x_idx, c.src_idx, c.write_idx):
            gathered += arr.size
            real += int((arr < sched.total_slots).sum())
    return dict(
        n_seq_nodes=n_seq,
        n_diag_buckets=n_diag,
        n_panel_buckets=n_panel,
        n_edge_buckets=n_edge,
        n_scan_chunks=len(sched.scan_chunks),
        n_scanned_levels=n_scanned,
        bulk_node_coverage=1.0 - n_seq / max(plan.n_nodes, 1),
        pad_waste_frac=(gathered - real) / max(gathered, 1),
    )


@dataclasses.dataclass
class SolveStructure:
    """Everything the JAX solve/adjoint needs, all static."""
    n: int
    lu: LUStructure
    l_fwd: TriSched       # L y = c      (forward)
    u_bwd: TriSched       # U w = y      (backward)
    lt_bwd: TriSched      # Lᵀ w = y     (backward; adjoint path)
    ut_fwd: TriSched      # Uᵀ y = c     (forward;  adjoint path)
    blocks: list          # list[BlockNode] — dense-block path (Pallas TRSM)


def build_solve_structure(plan: FactorPlan, bulk_min_width: int = 8) -> SolveStructure:
    lu = lu_structure(plan)
    n = plan.n
    l_fwd = tri_schedule(n, lu.l_indptr, lu.l_indices, lu.l_slots, lower=True,
                         bulk_min_width=bulk_min_width)
    u_bwd = tri_schedule(n, lu.u_indptr, lu.u_indices, lu.u_slots, lower=False,
                         bulk_min_width=bulk_min_width)
    lt_ip, lt_ix, lt_sl = transpose_csr(n, lu.l_indptr, lu.l_indices, lu.l_slots)
    ut_ip, ut_ix, ut_sl = transpose_csr(n, lu.u_indptr, lu.u_indices, lu.u_slots)
    lt_bwd = tri_schedule(n, lt_ip, lt_ix, lt_sl, lower=False,
                          bulk_min_width=bulk_min_width)
    ut_fwd = tri_schedule(n, ut_ip, ut_ix, ut_sl, lower=True,
                          bulk_min_width=bulk_min_width)
    return SolveStructure(n=n, lu=lu, l_fwd=l_fwd, u_bwd=u_bwd,
                          lt_bwd=lt_bwd, ut_fwd=ut_fwd,
                          blocks=block_schedule(plan))
