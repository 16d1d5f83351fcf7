"""PyTorch engine: the batched execution of a FactorPlan on one device.

The counterpart of ``src/repro/core/jax_engine.py`` with ``use_pallas=True``
(``_make_factor_fn_bucketed`` :178–285, ``_block_lu_solve_batched``
:501–534, ``make_csr_matvec_batched`` :557–579, ``_output_perm`` :582 and
``RepeatedSolveEngine`` :616–906).  What differs:

* JAX ``vmap``s one system's program over K; here the batch dimension is
  written out: value buffers are (K, slots), right-hand sides (K, n) or
  (K, n, m).
* Every schedule index map becomes a device tensor once, at construction
  (XLA's compile-time constants); the program itself runs eagerly, one
  launch per op.  The scanned width-1 tail is a Python loop over each
  chunk's levels.
* The four Pallas kernels become the hand-written CUDA kernels of
  :mod:`repro_torch.kernels` — the panel LUs (bucketed and per node), the
  TRSM (edge buckets and both substitution sweeps) and the batched GEMM.
  On the CPU the same wrappers run their plain PyTorch versions.
* Each system perturbs pivots against its own ``perturb_eps · max|A_k|``
  (under ``vmap`` the JAX threshold is per system too), so the panel
  kernels take one threshold per panel.
* The refinement loop tests ``any(alive & (resid > tol))`` on the host: one
  device→host sync per iteration, where the JAX ``lax.while_loop`` has
  none.  A device-side loop or a CUDA graph is later work.

Scatter-adds with duplicate indices (edge-bucket ``write_idx``, the matvec
rows) run on CUDA through ``index_add_``'s atomics, so their summation
order — and the last bits of the factors — may change from run to run.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .plan import FactorPlan
from .structure import get_bucket_schedule
from ..kernels.panel import ops as panel_ops
from ..kernels.supsup import ops as supsup_ops
from ..kernels.trisolve import ops as trisolve_ops

IDENTITY_PIVOT = 1e30     # padded block diagonals (jax_engine.py:197–201)


class TorchFactors(NamedTuple):
    vals: torch.Tensor         # (K, total_slots) factored panels
    inode_perm: torch.Tensor   # (K, n) int64 in-node pivot permutations
    n_perturb: torch.Tensor    # (K,) int32 perturbed pivots per system


def _index(a, device) -> torch.Tensor:
    """A host index array as an int64 device tensor (uploaded once)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)


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

    ``dtype`` is the factor/substitution dtype; ``refine_dtype`` the dtype
    of staged A values and right-hand sides, of x and of the residual."""

    def __init__(self, plan: FactorPlan, ss, *, src_map, scale_map, p, q,
                 row_scale, col_scale, perturb_eps: float = 1e-8,
                 dtype=torch.float64, refine_dtype=torch.float64,
                 device, bulk_min_width: int = 8):
        dev = torch.device(device)
        self.device = dev
        self.n = plan.n
        self.plan = plan
        self.dtype = self.factor_dtype = dtype
        self.refine_dtype = self.values_dtype = refine_dtype
        self.bulk_min_width = bulk_min_width
        self.perturb_eps = float(perturb_eps)

        sched = get_bucket_schedule(plan, bulk_min_width=bulk_min_width)
        self.sched = sched
        self._src = _index(src_map, dev)
        self._scl = torch.as_tensor(np.asarray(scale_map, np.float64),
                                    device=dev).to(dtype)
        self._a_scatter = _index(plan.a_scatter, dev)
        self._steps = [self._upload_step(step) for step in sched.steps]
        self._chunks = [tuple(_index(a, dev) for a in
                              (ch.dsl, ch.x_idx, ch.src_idx, ch.write_idx))
                        for ch in sched.scan_chunks]

        self._p = _index(p, dev)
        self._out_perm = _index(output_perm(p, q), dev)
        self._r = torch.as_tensor(np.asarray(row_scale, np.float64),
                                  device=dev).to(dtype)
        self._s = torch.as_tensor(np.asarray(col_scale, np.float64),
                                  device=dev).to(dtype)
        self._upload_blocks(ss.blocks)
        self._matvecs: dict = {}

    # ------------------------------------------------------------ set-up
    def _upload_step(self, step):
        dev = self.device
        nodes, offs = self.plan.nodes, self.plan.panel_offset
        diag = _index(step.diag.slots, dev) if step.diag is not None else None
        panels = [(pb.wu, pb.gather.shape, _index(pb.gather, dev).view(-1),
                   _index(pb.scatter, dev).view(-1), _index(pb.rows, dev))
                  for pb in step.panels]
        seq = [(nodes[int(t)].nr, nodes[int(t)].width, nodes[int(t)].lsize,
                int(offs[int(t)]), nodes[int(t)].r0) for t in step.seq]
        edges = [(eb.k, eb.nr, eb.m, _index(eb.src_idx, dev),
                  _index(eb.x_idx, dev), _index(eb.write_idx, dev).view(-1))
                 for eb in step.edges]
        return diag, panels, seq, edges

    def _upload_blocks(self, blocks):
        """The node-block schedule as five flat device tensors plus host
        offsets: slicing a flat tensor is free, so a solve issues no
        host→device copy per node."""
        parts = {name: [] for name in ("pre_cols", "pre_slots", "suf_cols",
                                       "suf_slots", "blk_slots")}
        lens = {name: 0 for name in parts}
        self._blocks = []
        for nd in blocks:
            entry = [nd.r0, nd.nr]
            for name in parts:
                a = np.asarray(getattr(nd, name), np.int64).reshape(-1)
                entry.append((lens[name], lens[name] + a.size))
                parts[name].append(a)
                lens[name] += a.size
            self._blocks.append(tuple(entry))
        self._bflat = {name: _index(np.concatenate(v) if v else
                                    np.zeros(0, np.int64), self.device)
                       for name, v in parts.items()}

    # ------------------------------------------------------------ factor
    def refactor_batched(self, a_batch: torch.Tensor, stop=None):
        """K numeric factorizations: ``a_batch`` (K, nnz) original-A values
        on the engine's device.  M.data = A.data[src] · scale, then the
        level-bucketed factor program.

        ``stop = (step, phase)``, phase one of "panels", "seq", "edges",
        ends the program just before that phase of that level step and
        returns ``(vals, eps)``: the value buffer with its sentinel slots,
        (K, n_ext), and the per-system pivot threshold (K,) — the inputs
        the kernels of that phase are handed."""
        b = a_batch.to(self.dtype)[:, self._src] * self._scl
        return self._factor(b, stop)

    def _factor(self, b: torch.Tensor, stop=None):
        sched, dt, dev = self.sched, self.dtype, self.device
        K = b.shape[0]
        eps = self.perturb_eps * b.abs().amax(dim=1)        # (K,) per system
        eps_c = eps[:, None]
        vals = torch.zeros((K, sched.n_ext), dtype=dt, device=dev)
        vals[:, self._a_scatter] = b
        vals[:, sched.one_slot] = IDENTITY_PIVOT
        inode = torch.arange(self.n + 1, device=dev).repeat(K, 1)
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
            for wu, (B, nr, wt), gather, scatter, rows in panels:
                P = vals[:, gather].view(K * B, nr, wt)
                P, perm, npb = panel_ops.panel_lu_batched(
                    P, wu, eps.repeat_interleave(B))
                vals[:, scatter] = P.view(K, -1)
                nper += npb.view(K, B).sum(dim=1, dtype=torch.int32)
                seg = inode[:, rows]                           # (K, B, nr)
                inode[:, rows] = torch.gather(seg, 2,
                                              perm.view(K, B, nr).long())
            if stop == (i, "seq"):
                return vals, eps
            for nr, w, lsize, off, r0 in seq:     # narrow level: per node
                panel = vals[:, off:off + nr * w].reshape(K, nr, w)
                P, lperm, npn = panel_ops.panel_lu(panel.contiguous(), nr,
                                                   lsize, eps)
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
                else:                                      # sup-sup
                    lts = trisolve_ops.trsm_batched(
                        U.reshape(K * E, k, k).contiguous(),
                        X.view(K * E, nr, k))
                    delta = supsup_ops.gemm_batched(
                        lts, Us.reshape(K * E, k, m).contiguous())
                    lts = lts.view(K, E, nr, k)
                    delta = delta.view(K, E, nr, m)
                # one combined scatter: multipliers as an add of (lts - X),
                # the trailing update as -delta (jax_engine.py:252–257)
                w_vals = torch.cat([(lts - X).reshape(K, E, -1),
                                    (-delta).reshape(K, E, -1)], dim=2)
                vals.index_add_(1, write_idx, w_vals.view(K, -1))

        for dsl, x_idx, src_idx, write_idx in self._chunks:   # width-1 tail
            for lv in range(dsl.shape[0]):
                nper += perturb(dsl[lv])
                S = vals[:, src_idx[lv]]                   # (K, E, 1+M)
                X = vals[:, x_idx[lv]]                     # (K, E)
                lts = X / S[..., 0]
                upd = torch.cat([(lts - X)[..., None],
                                 -lts[..., None] * S[..., 1:]], dim=2)
                vals.index_add_(1, write_idx[lv].view(-1), upd.view(K, -1))

        return TorchFactors(vals=vals[:, :self.plan.total_slots],
                            inode_perm=inode[:, :self.n], n_perturb=nper)

    # ------------------------------------------------------------- solve
    def _block_solve(self, vals: torch.Tensor, c: torch.Tensor):
        """L U w = c by the node-block schedule (c (K, n, m), factor dtype):
        per node a dense product against the L-prefix / U-suffix rectangle
        and a dense triangular solve of the diagonal block on the TRSM
        kernel; width-1 nodes take a divide."""
        f = self._bflat
        w = c.clone()

        def rect(name_cols, name_slots, span_c, span_s, nr):
            cols = f[name_cols][span_c[0]:span_c[1]]
            slots = f[name_slots][span_s[0]:span_s[1]].view(nr, -1)
            return torch.einsum("kns,ksm->knm", vals[:, slots], w[:, cols])

        for r0, nr, pre_c, pre_s, _, _, blk_s in self._blocks:  # forward: L
            if pre_c[1] == pre_c[0] and nr == 1:
                continue                                  # nothing to do
            b_blk = w[:, r0:r0 + nr]
            if pre_c[1] > pre_c[0]:
                b_blk = b_blk - rect("pre_cols", "pre_slots", pre_c, pre_s, nr)
            if nr > 1:
                blk = vals[:, f["blk_slots"][blk_s[0]:blk_s[1]].view(nr, nr)]
                b_blk = trisolve_ops.trsm_left_unit_lower_batched(
                    blk, b_blk.contiguous())
            w[:, r0:r0 + nr] = b_blk
        for r0, nr, _, _, suf_c, suf_s, blk_s in reversed(self._blocks):  # U
            b_blk = w[:, r0:r0 + nr]
            if suf_c[1] > suf_c[0]:
                b_blk = b_blk - rect("suf_cols", "suf_slots", suf_c, suf_s, nr)
            blk = vals[:, f["blk_slots"][blk_s[0]:blk_s[1]].view(nr, nr)]
            if nr > 1:
                b_blk = trisolve_ops.trsm_left_upper_batched(
                    blk, b_blk.contiguous())
            else:
                b_blk = b_blk / blk[:, :, 0:1]
            w[:, r0:r0 + nr] = b_blk
        return w

    def apply_batched(self, vals, inode_perm, b: torch.Tensor):
        """x = s · (U⁻¹ L⁻¹ ((r·b)[p][inode_perm]))[out_perm] for every
        system; b (K, n) or (K, n, m), computed in the factor dtype."""
        multi = b.ndim == 3
        r = self._r[:, None] if multi else self._r
        c = (b.to(self.dtype) * r)[:, self._p]
        idx = inode_perm[:, :, None].expand(c.shape) if multi else inode_perm
        c = torch.gather(c, 1, idx)
        w = self._block_solve(vals, c if multi else c[..., None])
        y = w[:, self._out_perm]
        y = y if multi else y[..., 0]
        return y * (self._s[:, None] if multi else self._s)

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
        dtype."""
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        key = (indptr.tobytes(), indices.tobytes())
        matvec = self._matvecs.get(key)
        if matvec is None:
            matvec = make_csr_matvec_batched(indptr, indices, self.device)
            self._matvecs[key] = matvec
        rdtype = self.refine_dtype
        apply_b = self.apply_batched

        def solve_refined(vals, inode_perm, a_vals, b, max_iter, tol):
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
            # the loop test is a host sync per iteration (see module doc)
            while it < max_iter + 1 and bool((alive & (resid > tol)).any()):
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

        return solve_refined
