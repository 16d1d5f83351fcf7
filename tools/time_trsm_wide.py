"""K3's three solves past 128 columns on the card, for the ``repro_torch``
package under ``--src``: the shapes of ``chip_smoke.py``'s wide records.

    python3 tools/time_trsm_wide.py [--src DIR] [--label NAME] [--pardiso]

Float64, K = 32: the right solve Y U = X on 256 rows of X at k = 140, 256
and 600 (U dominant: 16 on the diagonal), the unit-lower and upper left
solves on 32 blocks of 150 x 150 with one right-hand side (a dominant
block in place of ``pardiso_like``'s root).  Per call: the kernel entry
points one call launches (a spy on ``_build.launch``), its largest
difference from the plain version, its mean time by CUDA events over
back-to-back calls (the least of three windows of at least 50 ms), its
device time by CUDA-graph replay of 20 calls, and
``torch.linalg.solve_triangular``'s two times on the same inputs.  With
``--pardiso``, also ``pardiso_like``'s K = 32 solve at fem2d_10k
(``fem2d(100, 100, seed=930)``, ``chip_smoke.py``'s values and right-hand
sides): ``solve_batched`` ms over five passes after a warm-up.

To compare two commits on one card, unpack the other tree (``git archive
<commit> | tar -x -C artifacts/parent``; ``artifacts/`` is ignored) and run
both in turns in one call: ``--src artifacts/parent/src``, ``--src src``,
``--src src``, ``--src artifacts/parent/src``.  Each package builds its
kernels into its own checkout's ``build/``.  Prints one JSON line with the
card's name and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

K, NRX, REPS = 32, 256, 20


def bench_ms(torch, fn, min_ms=50.0):
    fn()
    torch.cuda.synchronize()
    reps, times = 1, []
    while len(times) < 3:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        el = t0.elapsed_time(t1)
        if not times and el < min_ms and reps < 4096:
            reps *= 4
        else:
            times.append(el / reps)
    return min(times)


def graph_ms(torch, fn):
    """Device ms of one call, by replays of a CUDA graph of REPS calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(REPS):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(5):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (5 * REPS)


def entries_of(build, fn):
    names, launch = [], build.launch

    def spy(name, *args, **kwargs):
        names.append(name)
        return launch(name, *args, **kwargs)

    build.launch = spy
    try:
        fn()
    finally:
        build.launch = launch
    return names


def record(torch, build, call, plain, lib):
    entries = entries_of(build, call)
    err = float((call() - plain()).abs().max())
    try:
        lib_dev = graph_ms(torch, lib)
    except RuntimeError:                 # not capturable: loop time only
        torch.cuda.synchronize()
        lib_dev = None
    return {"entries": entries, "max_abs_err": err,
            "ms": bench_ms(torch, call), "device_ms": graph_ms(torch, call),
            "library_ms": bench_ms(torch, lib), "library_device_ms": lib_dev}


def pardiso_solve_ms(torch, np):
    from repro_torch.core import (analyze, baselines, factor_batched,
                                  solve_batched)
    from repro_torch.matrices import fem2d, to_csr

    A = to_csr(fem2d(100, 100, seed=930))
    rng = np.random.default_rng(2026)
    vals = A.data[None] * rng.uniform(0.8, 1.2, (K, A.nnz))
    b = np.random.default_rng(8).normal(size=(K, A.n))
    an = analyze(A, baselines.pardiso_like_options())
    bst = factor_batched(an, A, vals)
    solve_batched(bst, b)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve_batched(bst, b)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--label", default=None)
    ap.add_argument("--pardiso", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_trsm_wide: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import _build
    from repro_torch.kernels.trisolve import ops as tri

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    out = {"label": args.label or args.src, "smi": smi}
    for k in (140, 256, 600):
        u = torch.from_numpy(rng.normal(size=(K, k, k))
                             + 16 * np.eye(k)).to(dev)
        x = torch.from_numpy(rng.normal(size=(K, NRX, k))).to(dev)
        out[f"right_k{k}"] = record(
            torch, _build, lambda: tri.trsm_batched(u, x),
            lambda: tri.trsm_plain(u, x),
            lambda: torch.linalg.solve_triangular(u, x, upper=True,
                                                  left=False))
    k = 150
    blk = torch.from_numpy(rng.normal(size=(K, k, k)) / np.sqrt(k)
                           + 3 * np.eye(k)).to(dev)
    rhs = torch.from_numpy(rng.normal(size=(K, k, 1))).to(dev)
    lower = torch.tril(blk, -1) + torch.eye(k, dtype=blk.dtype, device=dev)
    out["left_unit_lower_k150"] = record(
        torch, _build, lambda: tri.trsm_left_unit_lower_batched(blk, rhs),
        lambda: tri.trsm_left_unit_lower_plain(blk, rhs),
        lambda: torch.linalg.solve_triangular(lower, rhs, upper=False,
                                              unitriangular=True))
    out["left_upper_k150"] = record(
        torch, _build, lambda: tri.trsm_left_upper_batched(blk, rhs),
        lambda: tri.trsm_left_upper_plain(blk, rhs),
        lambda: torch.linalg.solve_triangular(blk, rhs, upper=True))
    if args.pardiso:
        out["pardiso_like_solve_ms"] = pardiso_solve_ms(torch, np)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
