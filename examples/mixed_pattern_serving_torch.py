"""Mixed-pattern serving on the PyTorch/CUDA port: heterogeneous solve
traffic through ``SolverService`` with a persistent plan cache.

The port of ``examples/mixed_pattern_serving.py``.  A serving process sees
circuit matrices next to banded PDE operators next to general unsymmetric
systems, interleaved arbitrarily.  This demo builds such a stream and
pushes it through the serving stack three times:

  cold    first touch of every pattern: fingerprint → plan-cache miss →
          host analysis → artifact persisted → engine built → solve
  warm    same patterns, new values: every plan and engine is an
          in-memory cache hit; only the solves remain
  fresh   a NEW SolverService over the same cache directory (a restarted
          process): plans load from the artifact store (the analysis is
          skipped; the counter proves it) and only the engines are built
          again

``--devices N`` splits every dispatch's batch K over N devices
(``HyluOptions.mesh = N``): on the card the first N CUDA devices, with
``--device cpu`` N CPU shards.

    PYTHONPATH=src python examples/mixed_pattern_serving_torch.py \\
        [--requests 24] [--batch-size 8] [--devices 2] [--device cuda|cpu] \\
        [--cache-dir checkpoints/plan_cache_demo_torch]
"""
import argparse
import os
import time

import numpy as np
import scipy.sparse as sp

from repro_torch.core import CSR, HyluOptions
from repro_torch.matrices import circuit_like
from repro_torch.serve.solver_service import SolveRequest, SolverService


def banded(n, bw, seed, fill=0.6):
    """A banded operator with a dominant diagonal (``benchmarks/
    matrices.py``'s ``banded``)."""
    rng = np.random.default_rng(seed)
    diags, offs = [], []
    for k in range(1, bw + 1):
        if rng.random() < fill:
            diags += [rng.normal(size=n - k), rng.normal(size=n - k)]
            offs += [k, -k]
    a = sp.diags(diags, offs, shape=(n, n))
    return (a + sp.diags(rng.uniform(2 * bw, 3 * bw, n))).tocsr()


def unsym_random(n, density, seed):
    """A general unsymmetric system (``benchmarks/matrices.py``'s
    ``unsym_random``)."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=density,
                  random_state=np.random.RandomState(seed), format="csr")
    return (a + sp.diags(rng.uniform(1, 2, n)
                         * rng.choice([-1, 1], n))).tocsr()


def patterns(scale=1.0):
    """Three structurally distinct workloads (the serving mix)."""
    return [
        ("circuit", CSR.from_scipy(circuit_like(int(200 * scale), 1))),
        ("banded", CSR.from_scipy(banded(int(150 * scale), 6, 2))),
        ("unsym", CSR.from_scipy(unsym_random(int(120 * scale), 0.02, 8))),
    ]


def make_stream(pats, n_requests, seed):
    """Interleaved, shuffled requests with per-request value drift."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        name, Ac = pats[i % len(pats)]
        reqs.append(SolveRequest(
            a=CSR(Ac.n, Ac.indptr, Ac.indices,
                  Ac.data * rng.uniform(0.9, 1.1, Ac.nnz)),
            b=rng.normal(size=Ac.n), tag=name))
    rng.shuffle(reqs)
    return reqs


def run_window(svc, reqs, label):
    t0 = time.perf_counter()
    res = svc.solve_batch(reqs)
    dt = time.perf_counter() - t0
    worst = max(float(np.max(r.residual)) for r in res)
    cs = svc.cache.stats
    print(f"[{label:5s}] {len(reqs):3d} requests in {dt:7.2f}s "
          f"({len(reqs) / dt:8.1f} req/s)  worst resid {worst:.1e}  "
          f"cache: mem={cs['hits']} disk={cs['disk_hits']} "
          f"analyze={cs['analyze_calls']}")
    assert all(r.status == "solved" for r in res), [r.status for r in res]
    assert worst < 1e-8
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24,
                    help="requests per serving window")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--devices", type=int, default=1,
                    help="split every dispatch's K over this many devices")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache-dir", default="checkpoints/plan_cache_demo_torch")
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)

    opts = HyluOptions(device=args.device,
                       mesh=args.devices if args.devices > 1 else None)
    pats = patterns(args.scale)
    print("serving mix: "
          + ", ".join(f"{n} (n={A.n}, nnz={A.nnz})" for n, A in pats)
          + (f"  [K split over {args.devices} devices]"
             if args.devices > 1 else ""))

    svc = SolverService(opts=opts, cache_dir=args.cache_dir,
                        batch_size=args.batch_size)
    run_window(svc, make_stream(pats, args.requests, seed=1), "cold")
    run_window(svc, make_stream(pats, args.requests, seed=2), "warm")
    assert svc.cache.stats["analyze_calls"] == len(pats), \
        "the warm window should analyze nothing new"

    # a restarted process: new service, same artifact store
    svc2 = SolverService(opts=opts, cache_dir=args.cache_dir,
                         batch_size=args.batch_size)
    run_window(svc2, make_stream(pats, args.requests, seed=3), "fresh")
    assert svc2.cache.stats["analyze_calls"] == 0, \
        "fresh process should load every plan from the artifact store"
    assert svc2.cache.stats["disk_hits"] == len(pats)

    modes = {name: svc.pattern_modes[svc.cache.fingerprint(Ac, opts)]
             for name, Ac in pats}
    print(f"kernel routing: {modes}")
    print(f"artifact store: {args.cache_dir} "
          f"({len(os.listdir(args.cache_dir))} plans)")
    print("MIXED_PATTERN_SERVING_OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
