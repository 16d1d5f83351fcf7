"""PyTorch engine: the batched execution of a FactorPlan on one device.

The counterpart of ``src/repro/core/jax_engine.py``: both factor schedules
(the level-bucketed ``_make_factor_fn_bucketed`` :178–285 and the unrolled
per-node program of ``make_factor_fn`` :303–326), both substitutions (the
node-block ``_block_lu_solve_batched`` :501–534 and the level-scheduled
``_tri_solve_batched`` :444–498 with its chunked narrow tail
``_tri_scan_chunks`` :329–379), ``make_csr_matvec_batched`` :557–579,
``_output_perm`` :582 and ``RepeatedSolveEngine`` :616–906.
``use_kernels`` stands for ``use_pallas``: with it the factor programs run
the hand-written kernels and the batched solve the node-block
substitution; without it every step is plain PyTorch (the caller's choice,
never a fallback) and the batched solve is level-scheduled.  The solve of
one system (``apply``, ``lut_solve``) is level-scheduled either way, as in
the JAX package.  What differs:

* JAX ``vmap``s one system's program over K; here the batch dimension is
  written out: value buffers are (K, slots), right-hand sides (K, n) or
  (K, n, m).
* Every schedule index map becomes a device tensor once, at construction
  (XLA's compile-time constants); the program itself runs eagerly, one
  launch per op.  The scanned width-1 tail is a Python loop over each
  chunk's levels.
* The Pallas kernels become the hand-written CUDA kernels of
  :mod:`repro_torch.kernels` — the panel LUs (bucketed and per node), the
  TRSM (edge buckets and both block substitution sweeps), the batched
  GEMM and the unrolled schedule's node step (a node's whole edge loop,
  its C − A·B updates among them, in one launch, in place).  On the CPU
  the same wrappers run their plain PyTorch versions.
  The bucketed panel LU reads each bucket's members from the value buffer
  and writes them back in place (no gather, scatter or per-panel
  threshold copy on the kernel route); its plain version runs the JAX
  engine's gather, LU and scatter.
* Each system perturbs pivots against its own ``perturb_eps · max|A_k|``
  (under ``vmap`` the JAX threshold is per system too), so the panel
  kernels take one threshold per panel.
* The refinement loop tests ``any(alive & (resid > tol))`` on the host: one
  device→host sync per iteration, where the JAX ``lax.while_loop`` has
  none.  A device-side loop or a CUDA graph is later work.

Scatter-adds with duplicate indices (edge-bucket ``write_idx``, the matvec
rows, the level substitution's ``rows[seg]``) run on CUDA through
``index_add_``'s atomics, so their summation order — and the last bits of
the factors and solutions — may change from run to run (ROADMAP.md,
Queue C): the port's tests hold them to 1e-10, not to bit-identity.  The
bucketed factor's scatter-adds in bfloat16 are the exception
(:func:`scatter_passes`): there one last bit moves a pivot, so each slot's
addends are summed in float32 from its value in source order, in passes of
unique indices, and rounded once, on every device alike.  A bfloat16
substitution's scatter-adds run in ordered passes too
(:func:`row_passes`), each add rounded as the CPU's ``index_add_`` rounds
it, so its x has the same bits on every device.

The refined solve's loop is a generator (:meth:`RepeatedSolveEngine.
refined_batched_steps`) that yields its loop flag to the host: under a
split of K, :func:`run_together` queues one iteration of every shard
before it reads any shard's flag.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .plan import FactorPlan
from .structure import get_bucket_schedule, segment_levels
from ..kernels.panel import ops as panel_ops
from ..kernels.supsup import ops as supsup_ops
from ..kernels.trisolve import ops as trisolve_ops
from ..kernels.trisolve import ref as trisolve_ref

IDENTITY_PIVOT = 1e30     # padded block diagonals (jax_engine.py:197–201)


class TorchFactors(NamedTuple):
    vals: torch.Tensor         # (K, total_slots) factored panels
    inode_perm: torch.Tensor   # (K, n) int64 in-node pivot permutations
    n_perturb: torch.Tensor    # (K,) int32 perturbed pivots per system
    # the whole (vals, inode_perm) storage that vals / inode_perm lead, the
    # buffers a later refactor_batched(out=) overwrites; None: not reusable
    buffers: tuple | None = None


def on_device(t: torch.Tensor, dev: torch.device) -> bool:
    """Whether ``t`` lies on ``dev``.  A tensor's own device always carries
    its index (``cuda:0``); ``dev`` without one (``cuda``) is the current
    CUDA device, where torch puts what is made on it."""
    if t.device.type != dev.type:
        return False
    if dev.type != "cuda":
        return True
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    return t.device.index == idx


def _index(a, device) -> torch.Tensor:
    """A host index array as an int64 device tensor (uploaded once)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)


def _ranks(inv: np.ndarray) -> list:
    """Positions of a duplicate-index scatter, by pass: pass r holds the
    addends that are the r-th, in source order, to reach their index
    (``inv``: each addend's index), so no pass writes one index twice."""
    order = np.argsort(inv, kind="stable")
    starts = np.flatnonzero(np.r_[True, np.diff(inv[order]) != 0])
    rank = np.empty(inv.size, np.int64)
    rank[order] = np.arange(inv.size) - np.repeat(
        starts, np.diff(np.r_[starts, inv.size]))
    return [np.flatnonzero(rank == r)
            for r in range(int(rank.max(initial=-1)) + 1)]


def scatter_passes(write_idx, device, skip: int) -> tuple:
    """A scatter-add with duplicate indices as ``(targets, passes)``: the
    unique indices written, and per pass ``(positions, where)``, the
    addends that are the r-th to reach their slot and their slots'
    positions in ``targets``, so that no pass writes one slot twice.
    Writes to the slot ``skip`` (the schedule's write-only scratch slot,
    where every padded entry goes) are dropped."""
    idx = np.asarray(write_idx, np.int64).reshape(-1)
    keep = np.flatnonzero(idx != skip)
    tgt, inv = np.unique(idx[keep], return_inverse=True)
    passes = [(_index(keep[pos], device), _index(inv[pos], device))
              for pos in _ranks(inv)]
    return _index(tgt, device), passes


def row_passes(rowmap) -> tuple:
    """A level substitution's duplicate-index row scatter as host arrays
    ``(order, rows_0, rows_1, ...)``: the addends' positions in pass
    order, then per pass of :func:`_ranks` its rows (unique within a
    pass), the pass's addends being the next ``len(rows_r)`` of
    ``order``.  :func:`add_rows` adds pass by pass, each add rounded once,
    in source order — the bits of the CPU's ``index_add_``, which adds in
    source order and rounds each add."""
    idx = np.asarray(rowmap, np.int64)
    passes = _ranks(idx)
    order = np.concatenate(passes) if passes else np.zeros(0, np.int64)
    return (order,) + tuple(idx[pos] for pos in passes)


def add_rows(w: torch.Tensor, rowmap, upd: torch.Tensor) -> None:
    """w[:, rowmap] += upd (K, L, m) in place: ``index_add_`` for an index
    tensor, else pass by pass over :func:`row_passes`' passes (the
    addends put in pass order once; a pass of one row is an add into
    that row's view, a wider one a gather of its rows, an add and a
    write-back: no atomics)."""
    if isinstance(rowmap, torch.Tensor):
        w.index_add_(1, rowmap, upd)
        return
    upd = upd.index_select(1, rowmap[0])
    views, a = {}, 0                   # one-row passes: w's views made once
    for rows in rowmap[1:]:
        if isinstance(rows, int):
            view = views.get(rows)
            if view is None:
                view = views[rows] = w.select(1, rows)
            view.add_(upd.select(1, a))
            a += 1
            continue
        b = a + rows.shape[0]
        w.index_copy_(1, rows, w.index_select(1, rows).add_(upd[:, a:b]))
        a = b


def add_at(vals: torch.Tensor, write, w: torch.Tensor) -> None:
    """vals[:, write] += w (K, L) in place: ``index_add_`` for an index
    tensor; for :func:`scatter_passes`, each slot's addends summed in
    float32 from its value in source order and rounded once."""
    if isinstance(write, torch.Tensor):
        vals.index_add_(1, write, w)
        return
    tgt, passes = write
    acc = vals[:, tgt].float()
    for pos, where in passes:
        acc.index_add_(1, where, w.index_select(1, pos).float())
    vals[:, tgt] = acc.to(vals.dtype)


def run_together(gens: list) -> list:
    """Run device programs written as generators side by side and return
    their results in order.  Each yields a tensor whose host value it needs
    and receives it as a numpy array.  A round runs every live program up
    to its next yield, so all of them queue their launches, and only then
    reads what they yielded: no host read falls between two programs'
    launches of one round, and the shards of a split K run at once on
    their devices."""
    out, got, live = [None] * len(gens), [None] * len(gens), range(len(gens))
    while live:
        asks = {}
        for i in live:
            try:
                asks[i] = gens[i].send(got[i])
            except StopIteration as stop:
                out[i] = stop.value
        for i, t in asks.items():
            got[i] = t.cpu().numpy()
        live = list(asks)
    return out


def _index_views(arrays, device) -> list:
    """Many small host index arrays as views of one int64 device tensor:
    one host→device copy instead of one per array."""
    arrays = [np.asarray(a, np.int64) for a in arrays]
    flat = _index(np.concatenate([a.reshape(-1) for a in arrays])
                  if arrays else np.zeros(0, np.int64), device)
    out, o = [], 0
    for a in arrays:
        out.append(flat[o:o + a.size].view(a.shape))
        o += a.size
    return out


def tri_scan_chunks(sched, n: int, bulk_min_width: int = 8):
    """The level schedule's narrow tail packed into padded chunks
    (``jax_engine._tri_scan_chunks``): the trailing levels with fewer than
    ``bulk_min_width`` rows, grouped by ``segment_levels`` and padded to
    shared (rows, deps) shapes.  Padding is maskless: padded rows and
    columns point at an extra row n of the unknowns, which stays zero, and
    padded slots at slot 0.  Returns (n_head_levels, [(rows, rowmap, cols,
    slot), ...]) with (levels, width) numpy arrays."""
    levels = list(zip(sched.rows, sched.cols, sched.slot, sched.seg))
    s = len(levels)
    while s > 0 and len(levels[s - 1][0]) < bulk_min_width:
        s -= 1
    groups = [levels[s + i:s + j] for i, j in segment_levels(
        [(len(lv[0]), len(lv[1])) for lv in levels[s:]])]
    chunks = []
    for group in groups:
        rmax = max(max(len(g[0]) for g in group), 1)
        dmax = max(max(len(g[1]) for g in group), 1)
        nl = len(group)
        rows_a = np.full((nl, rmax), n, np.int64)
        rowmap_a = np.full((nl, dmax), n, np.int64)
        cols_a = np.full((nl, dmax), n, np.int64)
        slot_a = np.zeros((nl, dmax), np.int64)
        for i, (r, c, sl, sg) in enumerate(group):
            rows_a[i, :len(r)] = r
            rowmap_a[i, :len(sg)] = r[sg]
            cols_a[i, :len(c)] = c
            slot_a[i, :len(sl)] = sl
        chunks.append((rows_a, rowmap_a, cols_a, slot_a))
    return s, chunks


class _TriLevels(NamedTuple):
    """One triangular substitution's level schedule on the device."""
    head: list        # per bulk level: (rows, rowmap, cols, slot, diag)
    chunks: list      # per tail chunk: (rows, rowmap, cols, slot, diag)
    upper: bool       # divides by the diagonal (U, Uᵀ) or not (L, Lᵀ)


def output_perm(p, q) -> np.ndarray:
    """z[p]=w; y[q]=z composed into one gather: y = w[p⁻¹[q⁻¹]]
    (``jax_engine._output_perm``)."""
    return np.argsort(p)[np.argsort(q)]


def make_csr_matvec_batched(indptr, indices, device):
    """``(A_k x_k)`` for K matrices of one pattern, x (K, n) or (K, n, m):
    one gather and one ``index_add_`` on dim 1; empty rows stay zero."""
    indptr = np.asarray(indptr)
    n = len(indptr) - 1
    seg = _index(np.repeat(np.arange(n), np.diff(indptr)), device)
    idx = _index(indices, device)

    def matvec(a_vals, x):
        prod = (a_vals[:, :, None] * x[:, idx] if x.ndim == 3
                else a_vals * x[:, idx])
        out = torch.zeros((x.shape[0], n) + tuple(x.shape[2:]),
                          dtype=prod.dtype, device=prod.device)
        return out.index_add_(1, seg, prod)

    return matvec


class RepeatedSolveEngine:
    """Repeated-solve engine for one analysis pattern on one device.

      refactor_batched(a_batch)          -> TorchFactors for K value sets
      apply_batched(vals, inode, b)      -> x solving A_k x_k = b_k with the
                                            stored factors; b (K, n) or
                                            (K, n, m)
      refined_batched_solver(ip, ix)     -> the batched solve with residual
                                            matvec and iterative refinement
      refactor(a_data)                   -> TorchFactors of one value set
      apply(vals, inode, b)              -> x solving A x = b, b (n,)
      lut_solve(vals, c)                 -> L⁻ᵀ U⁻ᵀ c (the adjoint solve)

    ``dtype`` is the factor/substitution dtype; ``refine_dtype`` the dtype
    of staged A values and right-hand sides, of x and of the residual.
    ``schedule`` is the factor schedule ("bucketed" or "unrolled");
    ``use_kernels`` chooses the hand-written kernels (and, for the batched
    solve, the node-block substitution) or plain PyTorch throughout."""

    def __init__(self, plan: FactorPlan, ss, *, src_map, scale_map, p, q,
                 row_scale, col_scale, perturb_eps: float = 1e-8,
                 dtype=torch.float64, refine_dtype=torch.float64,
                 device, bulk_min_width: int = 8, use_kernels: bool = True,
                 schedule: str = "bucketed"):
        if schedule not in ("bucketed", "unrolled"):
            raise ValueError(f"unknown factor schedule {schedule!r}: "
                             "expected 'bucketed' or 'unrolled'")
        dev = torch.device(device)
        self.device = dev
        self.n = plan.n
        self.plan = plan
        self.ss = ss
        self.dtype = self.factor_dtype = dtype
        self.refine_dtype = self.values_dtype = refine_dtype
        self.bulk_min_width = bulk_min_width
        self.perturb_eps = float(perturb_eps)
        self.use_kernels = bool(use_kernels)
        self.schedule = schedule

        sched = get_bucket_schedule(plan, bulk_min_width=bulk_min_width)
        self.sched = sched
        self._src = _index(src_map, dev)
        self._scl = torch.as_tensor(np.asarray(scale_map, np.float64),
                                    device=dev).to(dtype)
        self._a_scatter = _index(plan.a_scatter, dev)
        if schedule == "bucketed":
            self._steps = [self._upload_step(step) for step in sched.steps]
            self._chunks = [tuple(_index(a, dev) for a in
                                  (ch.dsl, ch.x_idx, ch.src_idx))
                            + (self._level_writes(ch.write_idx),)
                            for ch in sched.scan_chunks]
        else:
            self._upload_unrolled()

        self._p = _index(p, dev)
        self._out_perm = _index(output_perm(p, q), dev)
        self._r = torch.as_tensor(np.asarray(row_scale, np.float64),
                                  device=dev).to(dtype)
        self._s = torch.as_tensor(np.asarray(col_scale, np.float64),
                                  device=dev).to(dtype)
        if self.use_kernels:
            self._upload_blocks(ss.blocks)
        self._tris: dict = {}
        self._matvecs: dict = {}

    # ------------------------------------------------------------ set-up
    def _upload_step(self, step):
        dev = self.device
        nodes, offs = self.plan.nodes, self.plan.panel_offset
        diag = _index(step.diag.slots, dev) if step.diag is not None else None
        panels = []
        for pb in step.panels:                 # K1's descriptors, per member
            desc = [(int(offs[t]), nodes[t].nr, nodes[t].width,
                     nodes[t].lsize, nodes[t].usize)
                    for t in pb.nids.tolist()]
            panels.append((panel_ops.bucket_layout(
                desc, pb.nr, pb.wu, pb.wt, self.sched.zero_slot,
                self.sched.one_slot, pb.gather, pb.scatter, dev),
                _index(pb.rows, dev)))
        seq = [(nodes[int(t)].nr, nodes[int(t)].width, nodes[int(t)].lsize,
                int(offs[int(t)]), nodes[int(t)].r0) for t in step.seq]
        edges = [(eb.k, eb.nr, eb.m, _index(eb.src_idx, dev),
                  _index(eb.x_idx, dev), self._writes(eb.write_idx))
                 for eb in step.edges]
        return diag, panels, seq, edges

    def _writes(self, write_idx):
        """A scatter-add's slots for :func:`add_at`: an index tensor, or
        for a bfloat16 factor its :func:`scatter_passes`."""
        if self.dtype == torch.bfloat16:
            return scatter_passes(write_idx, self.device,
                                  self.sched.scratch_slot)
        return _index(write_idx, self.device).view(-1)

    def _level_writes(self, write_idx):
        """The width-1 tail chunk's scatter-adds, one per level: rows of one
        index tensor, or a bfloat16 factor's :func:`scatter_passes`."""
        if self.dtype == torch.bfloat16:
            return [scatter_passes(w, self.device, self.sched.scratch_slot)
                    for w in write_idx]
        return _index(write_idx, self.device).view(len(write_idx), -1)

    def _upload_unrolled(self):
        """The unrolled program's per-node and per-edge constants: one
        edge table (every ``col_map`` a view of one device tensor) and per
        node its :class:`~repro_torch.kernels.supsup.ops.NodeStep`, with
        the rows of its widest edge source (over 128, K5's wide
        instance)."""
        nodes, offs = self.plan.nodes, self.plan.panel_offset
        self._edges = supsup_ops.edge_table(
            [(int(offs[e.src]), nodes[e.src].nr, nodes[e.src].width,
              nodes[e.src].lsize, e.col_map) for nd in nodes
             for e in nd.edges], self.device)
        self._nodes, e0 = [], 0
        for nd in nodes:
            e1 = e0 + len(nd.edges)
            kmax = max((nodes[e.src].nr for e in nd.edges), default=0)
            self._nodes.append((nd.r0, supsup_ops.node_step(
                int(offs[nd.nid]), nd.nr, nd.width, nd.lsize, e0, e1,
                kmax)))
            e0 = e1

    def _upload_blocks(self, blocks):
        """The node-block schedule: per node (r0, nr, pre_cols, pre_slots,
        suf_cols, suf_slots, blk_slots), the index maps as views of one
        device tensor, so a solve issues no host→device copy per node."""
        names = ("pre_cols", "pre_slots", "suf_cols", "suf_slots",
                 "blk_slots")
        views = _index_views([getattr(nd, name) for nd in blocks
                              for name in names], self.device)
        self._blocks = [(nd.r0, nd.nr) + tuple(views[5 * i:5 * i + 5])
                        for i, nd in enumerate(blocks)]

    def _row_passes(self, groups) -> list:
        """:func:`row_passes` of every level's row map (a list of levels
        per group) on the device: the index arrays as views of one
        tensor, a pass of one row as its int."""
        passes = [[row_passes(rm) for rm in g] for g in groups]

        def one_row(j, a):
            return j > 0 and a.size == 1

        flat = iter(_index_views([a for g in passes for lv in g
                                  for j, a in enumerate(lv)
                                  if not one_row(j, a)], self.device))
        return [[[int(a[0]) if one_row(j, a) else next(flat)
                  for j, a in enumerate(lv)] for lv in g] for g in passes]

    def _tri(self, name: str) -> _TriLevels:
        """The device schedule of one of the solve structure's triangular
        substitutions ("l_fwd", "u_bwd", "ut_fwd", "lt_bwd"), uploaded on
        first use: the bulk levels one by one, the narrow tail as the
        padded chunks of :func:`tri_scan_chunks`."""
        tri = self._tris.get(name)
        if tri is not None:
            return tri
        sched = getattr(self.ss, name)
        upper = name in ("u_bwd", "ut_fwd")
        diag = np.asarray(self.ss.lu.u_diag_slots, np.int64)
        dpad = np.concatenate([diag, diag[:1]])
        n_head, chunks = tri_scan_chunks(sched, self.n)
        arrays = []
        for r, c, sl, sg in zip(sched.rows[:n_head], sched.cols[:n_head],
                                sched.slot[:n_head], sched.seg[:n_head]):
            arrays.append((r, r[sg], c, sl, diag[r]))
        for rows, rowmap, cols, slot in chunks:
            arrays.append((rows, rowmap, cols, slot, dpad[rows]))
        views = _index_views([a for group in arrays for a in group],
                             self.device)
        groups = [list(views[5 * i:5 * i + 5]) for i in range(len(arrays))]
        if self.dtype == torch.bfloat16:      # ordered row scatters
            passes = self._row_passes(
                [[rm] if i < n_head else list(rm)
                 for i, (_, rm, _, _, _) in enumerate(arrays)])
            for i, (g, pg) in enumerate(zip(groups, passes)):
                g[1] = pg[0] if i < n_head else pg
        groups = [tuple(g) for g in groups]
        tri = _TriLevels(head=groups[:n_head], chunks=groups[n_head:],
                         upper=upper)
        self._tris[name] = tri
        return tri

    # ------------------------------------------------------------ factor
    def refactor_batched(self, a_batch: torch.Tensor, stop=None, out=None):
        """K numeric factorizations: ``a_batch`` (K, nnz) original-A values
        on the engine's device.  M.data = A.data[src] · scale, then the
        factor program of the engine's schedule.

        ``out``, the :class:`TorchFactors` of an earlier call of this
        engine at the same K, gives its buffers (``vals``, ``inode_perm``)
        to this factorization, which overwrites them (the counterpart of
        ``refactor_batched_reuse``, ``jax_engine.py:755–765``): a stream of
        refactors then allocates no new factor buffer per step.  The
        factors are the same as without ``out``.

        ``stop`` ends the program early and returns ``(vals, eps)``: the
        value buffer, (K, n_ext) with its sentinel slots in the bucketed
        schedule and (K, total_slots) in the unrolled one, and the
        per-system pivot threshold (K,) — the inputs the kernels of that
        point are handed.  Bucketed: ``stop = (step, phase)``, phase one of
        "panels", "seq", "edges", just before that phase of that level
        step.  Unrolled: ``stop = (node, edge)``, just before that edge of
        that node's edge loop."""
        b = a_batch.to(self.dtype)[:, self._src] * self._scl
        if self.schedule == "unrolled":
            return self._factor_unrolled(b, stop, out)
        return self._factor(b, stop, out)

    def _buffers(self, K: int, n_vals: int, n_inode: int, out):
        """The value buffer (K, n_vals), zeroed, and the in-node pivot map
        (K, n_inode), the identity: ``out.buffers``, the whole storage of
        an earlier batched factorization's vals / inode_perm, when ``out``
        is given, else new tensors."""
        dev = self.device
        if out is None:
            return (torch.zeros((K, n_vals), dtype=self.dtype, device=dev),
                    torch.arange(n_inode, device=dev).repeat(K, 1))
        bufs = out.buffers
        want = ((K, n_vals), (K, n_inode))
        if bufs is None or any(tuple(t.shape) != w or not on_device(t, dev)
                               for t, w in zip(bufs, want)):
            raise ValueError(
                f"refactor_batched(out=): need the factors of this engine "
                f"at K = {K} on {dev}, got buffers "
                f"{None if bufs is None else [tuple(t.shape) for t in bufs]}"
                f" on {out.vals.device}")
        vals, inode = bufs
        if vals.dtype != self.dtype:
            raise TypeError(f"refactor_batched(out=): vals is {vals.dtype}, "
                            f"the engine factors in {self.dtype}")
        vals.zero_()
        inode.copy_(torch.arange(n_inode, device=dev).expand(K, n_inode))
        return vals, inode

    def refactor(self, a_data: torch.Tensor) -> TorchFactors:
        """One numeric factorization: ``a_data`` (nnz,) → TorchFactors with
        vals (total_slots,), inode_perm (n,) and n_perturb ()."""
        f = self.refactor_batched(a_data[None])
        return TorchFactors(vals=f.vals[0], inode_perm=f.inode_perm[0],
                            n_perturb=f.n_perturb[0])

    def _panel_lu_bucket(self, vals, layout, eps):
        if self.use_kernels:
            return panel_ops.panel_lu_bucket_inplace(vals, layout, eps)
        return panel_ops.panel_lu_bucket_plain(vals, layout, eps)

    def _panel_lu(self, P, nr, lsize, eps):
        if self.use_kernels:
            return panel_ops.panel_lu(P, nr, lsize, eps)
        return panel_ops.panel_lu_plain(P, lsize, P.shape[2], eps)

    def _factor(self, b: torch.Tensor, stop=None, out=None):
        sched, dt, dev = self.sched, self.dtype, self.device
        K = b.shape[0]
        eps = self.perturb_eps * b.abs().amax(dim=1)        # (K,) per system
        eps_c = eps[:, None]
        vals, inode = self._buffers(K, sched.n_ext, self.n + 1, out)
        vals[:, self._a_scatter] = b
        vals[:, sched.one_slot] = IDENTITY_PIVOT
        nper = torch.zeros(K, dtype=torch.int32, device=dev)

        def perturb(slots):
            d = vals[:, slots]
            small = d.abs() < eps_c
            vals[:, slots] = torch.where(
                small, torch.where(d >= 0, eps_c, -eps_c), d)
            return small.sum(dim=1, dtype=torch.int32)

        for i, (diag, panels, seq, edges) in enumerate(self._steps):
            if diag is not None:                 # width-1: perturb diagonals
                nper += perturb(diag)
            if stop == (i, "panels"):
                return vals, eps
            for layout, rows in panels:           # K1 reads vals in place
                B, nr = rows.shape
                perm, npb = self._panel_lu_bucket(vals, layout, eps)
                nper += npb.view(K, B).sum(dim=1, dtype=torch.int32)
                seg = inode[:, rows]                           # (K, B, nr)
                inode[:, rows] = torch.gather(seg, 2,
                                              perm.view(K, B, nr).long())
            if stop == (i, "seq"):
                return vals, eps
            for nr, w, lsize, off, r0 in seq:     # narrow level: per node
                panel = vals[:, off:off + nr * w].view(K, nr, w)  # a view
                P, lperm, npn = self._panel_lu(panel, nr, lsize, eps)
                nper += npn
                inode[:, r0:r0 + nr] = torch.gather(
                    inode[:, r0:r0 + nr], 1, lperm.long())
                vals[:, off:off + nr * w] = P.view(K, -1)
            if stop == (i, "edges"):
                return vals, eps
            for k, nr, m, src_idx, x_idx, write_idx in edges:
                S = vals[:, src_idx]                       # (K, E, k, k+m)
                X = vals[:, x_idx]                         # (K, E, nr, k)
                E = S.shape[1]
                U, Us = S[..., :k], S[..., k:]
                if k == 1:                                 # row-row/sup-row
                    lts = X / U[..., 0, 0][..., None, None]
                    delta = lts * Us
                elif self.use_kernels:                     # sup-sup: K3, K4
                    lts = trisolve_ops.trsm_batched(   # U: a view of S
                        U.reshape(K * E, k, k), X.view(K * E, nr, k))
                    delta = supsup_ops.gemm_batched(
                        lts, Us.reshape(K * E, k, m).contiguous())
                    lts = lts.view(K, E, nr, k)
                    delta = delta.view(K, E, nr, m)
                elif dt == torch.bfloat16:     # sup-sup, plain: no bf16
                    lts = trisolve_ref.trsm_plain(   # solve_triangular
                        U.reshape(K * E, k, k),
                        X.reshape(K * E, nr, k)).view(K, E, nr, k)
                    delta = torch.matmul(lts, Us)
                else:                                      # sup-sup, plain
                    lts = torch.linalg.solve_triangular(U, X, upper=True,
                                                        left=False)
                    delta = torch.matmul(lts, Us)
                # one combined scatter: multipliers as an add of (lts - X),
                # the trailing update as -delta (jax_engine.py:252–257)
                w_vals = torch.cat([(lts - X).reshape(K, E, -1),
                                    (-delta).reshape(K, E, -1)], dim=2)
                add_at(vals, write_idx, w_vals.view(K, -1))

        for dsl, x_idx, src_idx, write_idx in self._chunks:   # width-1 tail
            for lv in range(dsl.shape[0]):
                nper += perturb(dsl[lv])
                S = vals[:, src_idx[lv]]                   # (K, E, 1+M)
                X = vals[:, x_idx[lv]]                     # (K, E)
                lts = X / S[..., 0]
                upd = torch.cat([(lts - X)[..., None],
                                 -lts[..., None] * S[..., 1:]], dim=2)
                add_at(vals, write_idx[lv], upd.view(K, -1))

        return TorchFactors(vals=vals[:, :self.plan.total_slots],
                            inode_perm=inode[:, :self.n], n_perturb=nper,
                            buffers=(vals, inode))

    def _factor_unrolled(self, b: torch.Tensor, stop=None, out=None):
        """The unrolled schedule (``make_factor_fn`` :303–326): node by node,
        a left-looking loop over the node's edges, then the node's own LU
        (``_node_step_unrolled`` :132–161, ``_node_lu_writeback`` :113–129).
        The value buffer is ``total_slots`` long, with no sentinel slots.
        The edge loop and, for a width-1 node, the pivot perturbation are
        one node step: with kernels one ``node_edges_inplace`` launch per
        node (K5, in place), else ``node_edges_plain`` (per edge, the
        target panel's columns gathered through ``col_map`` and written
        back).  A node with nr > 1 is then factored by K2 (or its plain
        version)."""
        dt, dev = self.dtype, self.device
        K = b.shape[0]
        eps = self.perturb_eps * b.abs().amax(dim=1)
        vals, inode = self._buffers(K, self.plan.total_slots, self.n, out)
        vals[:, self._a_scatter] = b
        nper = torch.zeros(K, dtype=torch.int32, device=dev)
        for t, (r0, step) in enumerate(self._nodes):
            n_edges = None                     # stop = (t, j): j edges only
            if stop is not None and stop[0] == t \
                    and 0 <= stop[1] < step.e1 - step.e0:
                n_edges = stop[1]
            if self.use_kernels:
                supsup_ops.node_edges_inplace(vals, self._edges, step, eps,
                                              nper, n_edges)
            else:
                supsup_ops.node_edges_plain(vals, self._edges, step, eps,
                                            nper, n_edges, use_kernels=False)
            if n_edges is not None:
                return vals, eps
            nr, w, off = step.nr, step.w, step.off
            if nr == 1:                                # perturbed only
                continue
            panel = vals[:, off:off + nr * w].view(K, nr, w)   # a view
            P, lperm, npn = self._panel_lu(panel, nr, step.lsize, eps)
            nper += npn
            inode[:, r0:r0 + nr] = torch.gather(inode[:, r0:r0 + nr], 1,
                                                lperm.long())
            panel.copy_(P)
        return TorchFactors(vals=vals, inode_perm=inode, n_perturb=nper,
                            buffers=(vals, inode))

    # ------------------------------------------------------------- solve
    def _block_solve(self, vals: torch.Tensor, c: torch.Tensor):
        """L U w = c by the node-block schedule (c (K, n, m), factor dtype):
        per node a dense product against the L-prefix / U-suffix rectangle
        and a dense triangular solve of the diagonal block on the TRSM
        kernel; width-1 nodes take a divide."""
        w = c.clone()

        def rect(cols, slots):
            return torch.einsum("kns,ksm->knm", vals[:, slots], w[:, cols])

        for r0, nr, pre_c, pre_s, _, _, blk_s in self._blocks:  # forward: L
            if pre_c.numel() == 0 and nr == 1:
                continue                                  # nothing to do
            b_blk = w[:, r0:r0 + nr]
            if pre_c.numel():
                b_blk = b_blk - rect(pre_c, pre_s)
            if nr > 1:
                b_blk = trisolve_ops.trsm_left_unit_lower_batched(
                    vals[:, blk_s], b_blk.contiguous())
            w[:, r0:r0 + nr] = b_blk
        for r0, nr, _, _, suf_c, suf_s, blk_s in reversed(self._blocks):  # U
            b_blk = w[:, r0:r0 + nr]
            if suf_c.numel():
                b_blk = b_blk - rect(suf_c, suf_s)
            blk = vals[:, blk_s]
            if nr > 1:
                b_blk = trisolve_ops.trsm_left_upper_batched(
                    blk, b_blk.contiguous())
            else:
                b_blk = b_blk / blk[:, :, 0:1]
            w[:, r0:r0 + nr] = b_blk
        return w

    def _tri_solve(self, name: str, vals: torch.Tensor, w: torch.Tensor):
        """One level-scheduled triangular substitution (``_tri_solve_batched``
        :444–498) on w (K, n, m), factor dtype.  Per level, the dependencies'
        products go to their rows in one duplicate-index ``index_add_``
        (``rows[seg]``; for a bfloat16 factor in the ordered passes of
        :func:`row_passes`), then an upper solve divides the level's rows
        by their diagonal.  The narrow tail runs chunk by chunk, level by
        level, on w padded with the zero row n."""
        tri = self._tri(name)
        n = self.n
        w = w.clone()

        def level(rows, rowmap, cols, slot, diag):
            if cols.numel():
                add_rows(w, rowmap, -(vals[:, slot, None] * w[:, cols]))
            if tri.upper:
                w[:, rows] = w[:, rows] / vals[:, diag, None]

        for lv in tri.head:
            level(*lv)
        if tri.chunks:
            w = torch.cat([w, w.new_zeros((w.shape[0], 1, w.shape[2]))],
                          dim=1)
            for ch in tri.chunks:
                for i in range(ch[0].shape[0]):
                    level(*(a[i] for a in ch))
            w = w[:, :n]
        return w

    def _level_solve(self, vals: torch.Tensor, c: torch.Tensor):
        """U⁻¹ L⁻¹ c by the level schedules (``make_lu_solver`` :423–441,
        ``make_batched_lu_solver`` :551–554)."""
        return self._tri_solve("u_bwd", vals,
                               self._tri_solve("l_fwd", vals, c))

    def _apply(self, solve, vals, inode_perm, b):
        multi = b.ndim == 3
        r = self._r[:, None] if multi else self._r
        c = (b.to(self.dtype) * r)[:, self._p]
        idx = inode_perm[:, :, None].expand(c.shape) if multi else inode_perm
        c = torch.gather(c, 1, idx)
        w = solve(vals, c if multi else c[..., None])
        y = w[:, self._out_perm]
        y = y if multi else y[..., 0]
        return y * (self._s[:, None] if multi else self._s)

    def apply_batched(self, vals, inode_perm, b: torch.Tensor):
        """x = s · (U⁻¹ L⁻¹ ((r·b)[p][inode_perm]))[out_perm] for every
        system; b (K, n) or (K, n, m), computed in the factor dtype — by the
        node-block substitution with kernels, else level-scheduled."""
        solve = self._block_solve if self.use_kernels else self._level_solve
        return self._apply(solve, vals, inode_perm, b)

    def apply(self, vals, inode_perm, b: torch.Tensor):
        """x solving A x = b for one system (vals (total_slots,), inode_perm
        (n,), b (n,) or (n, m)), by the level-scheduled substitution."""
        return self._apply(self._level_solve, vals[None], inode_perm[None],
                           b[None])[0]

    def lut_solve(self, vals, c: torch.Tensor):
        """L⁻ᵀ U⁻ᵀ c for one system (vals (total_slots,), c (n,) or (n, m)):
        ``ut_fwd`` with U's diagonal, then ``lt_bwd`` — the adjoint solve of
        ``make_lu_solver``, without permutations or scaling."""
        w = c.to(self.dtype)[None]
        w = w if w.ndim == 3 else w[..., None]
        w = self._tri_solve("lt_bwd", vals[None],
                            self._tri_solve("ut_fwd", vals[None], w))
        return w[0] if c.ndim == 2 else w[0, :, 0]

    def refined_batched_solver(self, indptr, indices):
        """The batched solve for K systems of the given original-A pattern:

            solver(vals, inode_perm, a_vals, b, max_iter, tol)
                -> (x, resid, n_iter, n_ref_sys, stalled, failed)

        with the semantics of ``jax_engine.RepeatedSolveEngine.
        refined_batched_solver``: iteration 0 is the base solve and is
        always accepted; ``n_ref_sys`` does not count it; a system stops
        when its residual is at or below ``tol`` or an iteration fails to
        improve it; ``failed = (resid > tol) & (max_iter > 0)`` and
        ``stalled = failed & ~alive``.  b, the A values, x and the residual
        are carried in ``refine_dtype``; substitution runs in the factor
        dtype.  It runs :meth:`refined_batched_steps` to its end."""
        steps = self.refined_batched_steps(indptr, indices)

        def solve_refined(*args):
            return run_together([steps(*args)])[0]

        return solve_refined

    def refined_batched_steps(self, indptr, indices):
        """:meth:`refined_batched_solver`'s solve as a generator function
        of the same arguments: before each iteration it yields its loop
        flag, ``any(alive & (resid > tol))`` on the device, and receives
        the flag's host value; it returns the solver's tuple, on the
        device.  :func:`run_together` runs several (the shards of a split
        K) side by side."""
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        key = (indptr.tobytes(), indices.tobytes())
        matvec = self._matvecs.get(key)
        if matvec is None:
            matvec = make_csr_matvec_batched(indptr, indices, self.device)
            self._matvecs[key] = matvec
        rdtype = self.refine_dtype
        apply_b = self.apply_batched

        def solve_steps(vals, inode_perm, a_vals, b, max_iter, tol):
            multi = b.ndim == 3
            b = b.to(rdtype)
            a_vals = a_vals.to(rdtype)
            bnorm = b.abs().sum(dim=1)                     # (K,) | (K, m)
            bnorm = torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)

            def expand(mask):
                return mask[:, None, :] if multi else mask[:, None]

            x = torch.zeros_like(b)
            r = b
            resid = torch.full(bnorm.shape, float("inf"), dtype=rdtype,
                               device=b.device)
            alive = torch.ones(resid.shape, dtype=torch.bool,
                               device=b.device)
            n_ref = torch.zeros(resid.shape, dtype=torch.int32,
                                device=b.device)
            it = 0
            # the loop test is a host read per iteration (see module doc)
            while it < max_iter + 1 and (yield (alive & (resid > tol)).any()):
                need = alive & (resid > tol)
                x2 = x + apply_b(vals, inode_perm, r).to(rdtype)
                r2 = b - matvec(a_vals, x2)
                resid2 = r2.abs().sum(dim=1) / bnorm
                # iteration 0 IS the base solve: accepted unconditionally
                improved = (torch.ones_like(need) if it == 0
                            else resid2 < resid)
                upd = need & improved
                x = torch.where(expand(upd), x2, x)
                r = torch.where(expand(upd), r2, r)
                resid = torch.where(upd, resid2, resid)
                alive = alive & (improved | ~need)
                if it > 0:
                    n_ref = n_ref + upd.to(torch.int32)
                it += 1
            n_iter = max(it - 1, 0)
            failed = (resid > tol) & (int(max_iter) > 0)
            stalled = failed & ~alive
            return x, resid, n_iter, n_ref, stalled, failed

        return solve_steps
