"""Dry run of the solver itself on the production meshes: the counterpart
of ``src/repro/launch/solver_dryrun.py``.

Scenario (paper §3.2 at pod scale): a large batch of independent
same-pattern systems (Monte-Carlo / transient-sweep circuit simulation) is
factored and solved per step, the batch split over the data axes.  The
JAX module lowers ``vmap(one_solve)`` (bucketed float32 factor + one
unrefined ``lu_solve``) sharded over the data axes with no collective.
The port's split of the batch (``HyluOptions.mesh``) is a list of
devices, one shard of K each, with no collective either: so this dry run
runs one device's share for real — K = batch / mesh size systems through
``factor_batched`` and one unrefined ``solve_batched`` in float32 — on the
card (or the CPU with ``--device cpu``) under ``roofline.op_cost``, and
records the same keys as the JAX record, ``coll_bytes_per_device`` 0,
and on the card ``t_run_s``, the seconds of one more uninstrumented run
(None on the CPU).

    python -m repro_torch.launch.solver_dryrun [--n 800] [--batch 4096] \\
        [--multi] [--device cpu] [--out artifacts/dryrun/solver.json]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import scipy.sparse as sp

from ..core import HyluOptions, analyze, factor_batched, solve_batched
from ..core.matrix import CSR
from ..roofline import analysis as RA
from ..roofline.op_cost import OpCost

#: ranks of the production meshes (``launch.mesh.make_production_mesh``)
MESH_SIZE = {False: 256, True: 512}


def build_problem(n: int, seed: int = 0):
    """One representative circuit-like pattern (the JAX module's, same
    seed, same matrix) as a scipy CSR."""
    rng = np.random.default_rng(seed)
    m = int(n * 1.5)
    rows = rng.integers(0, n, m)
    delta = rng.geometric(1.0 / 16, m)
    cols = np.clip(rows + rng.choice([-1, 1], m) * delta, 0, n - 1)
    keep = rows != cols
    a = sp.coo_matrix((rng.uniform(0.1, 10, keep.sum()),
                       (rows[keep], cols[keep])), shape=(n, n))
    a = a + a.T
    d = np.abs(a).sum(axis=1).A.ravel() + rng.uniform(0.1, 1.0, n)
    a = (sp.diags(d) - a).tocsr()
    a.sort_indices()
    return a


def share(n: int = 800, batch: int = 4096, multi: bool = False,
          device: str = "cuda", mode: str | None = None):
    """One device's share of the batch: (record, x (K, n), the problem
    (A as scipy CSR, values (K, nnz), b (K, n)), OpCost).  ``mode``
    forces the factorization mode (``HyluOptions.force_mode``); None
    takes the analysis's choice, as the JAX dry run does (row-row at
    n = 800, where no panel kernel runs)."""
    import torch

    a = build_problem(n)
    A = CSR.from_scipy(a)
    chips = MESH_SIZE[multi]
    k = batch // chips
    rng = np.random.default_rng(1)
    values = A.data[None] * rng.uniform(0.8, 1.2, (k, A.nnz))
    b = rng.normal(size=(k, A.n))
    opts = HyluOptions(factor_dtype="float32", refine_dtype="float32",
                       device=device, force_mode=mode)
    an = analyze(A, opts)
    cost = OpCost()
    with cost:
        bst = factor_batched(an, A, values)
        x, _ = solve_batched(bst, b, refine=False)
    t_run = None                         # a host's time is no card time
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = factor_batched(an, A, values)
        x, _ = solve_batched(bst, b, refine=False)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
    t, bott = RA.terms(cost.flops, cost.bytes, 0.0)
    rec = dict(
        arch=f"hylu-solver-n{n}", shape=f"batch{batch}",
        mesh="pod2x16x16" if multi else "pod16x16", chips=chips,
        k_per_device=k, device=device, status="ok",
        t_run_s=t_run,
        mem_args_gib=(values.size + b.size) * 4 / 2**30,
        flops_per_device=cost.total_flops, bytes_per_device=cost.bytes,
        flops_by_dtype=dict(cost.flops),
        coll_bytes_per_device=0.0, coll_by_kind={},
        t_compute=t["compute"], t_memory=t["memory"],
        t_collective=t["collective"], bottleneck=bott,
        kernels=cost.record()["kernels"],
        uncounted=dict(cost.uncounted),
        useful_flops_per_system=an.plan.useful_flops,
        padded_flops_per_system=an.plan.padded_flops,
        nnz=A.nnz, mode=an.choice.mode, nodes=an.plan.n_nodes,
        levels=len(an.plan.levels))
    return rec, x, (a, values, b), cost


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=800,
                    help="system dimension")
    ap.add_argument("--batch", type=int, default=4096,
                    help="independent systems per step (Monte-Carlo batch)")
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--mode", default=None,
                    help="force rowrow | hybrid | supernodal")
    ap.add_argument("--out", default="artifacts/dryrun/solver.json")
    args = ap.parse_args(argv)
    rec, _, _, _ = share(args.n, args.batch, args.multi, args.device,
                         mode=args.mode)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ("coll_by_kind", "kernels")}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
