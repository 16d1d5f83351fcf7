"""Where the time of one batched repeated-solve step goes on the card.

    python -m repro_torch.profile_step

Analyzes the corpus's fem2d_10k (fem2d(100, 100, seed=930)), then, after
one warm-up step of ``factor_batched`` + ``solve_batched`` in float64 at
K = 32 systems:

1. times both entry points by the host clock around work that ends in a
   synchronize, three times each;
2. counts each kernel wrapper's launches in one step;
3. profiles one step under ``torch.profiler`` (CPU and CUDA activity): the
   device time by kernel name, the number of kernels the device ran, and
   the device busy share — summed kernel time over the unprofiled wall
   time of a step (the profiler slows the host, so the share over the
   profiled wall time is printed beside it).

Prints one JSON line with the card's name and power limit.  Needs a CUDA
device.
"""
from __future__ import annotations

import json
import subprocess
import time

GRID, K, REPEATS = 100, 32, 3     # fem2d_10k at K = 32, three timed steps


def main() -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from . import kernels
    from .core import HyluOptions, analyze, factor_batched, solve_batched
    from .matrices import fem2d, to_csr

    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    A = to_csr(fem2d(GRID, GRID, seed=930))
    t0 = time.perf_counter()
    an = analyze(A, HyluOptions())
    analyze_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    values = A.data[None] * rng.uniform(0.8, 1.2, (K, A.nnz))
    b = np.random.default_rng(8).normal(size=(K, A.n))

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = factor_batched(an, A, values)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, info = solve_batched(bst, b)
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1, info

    step()                                   # builds the engine and kernels
    kernels.reset_launch_counts()
    times = [step() for _ in range(REPEATS)]
    launches = {k: v // REPEATS
                for k, v in kernels.launch_counts().items()}
    out = {"matrix": f"fem2d({GRID}, {GRID}, seed=930)",
           "n": A.n, "k": K, "smi": smi, "analyze_s": analyze_s,
           "factor_batched_s": [t[0] for t in times],
           "solve_batched_s": [t[1] for t in times],
           "refine_iters": times[-1][2]["n_refine"],
           "launches_per_step": launches}
    wall = min(t[0] + t[1] for t in times)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        f_s, s_s, _ = step()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    device_s = sum(dev_us(e) for e in kern) * 1e-6
    top = sorted(kern, key=dev_us, reverse=True)[:12]
    out["profile"] = {
        "profiled_factor_s": f_s, "profiled_solve_s": s_s,
        "device_kernel_s": device_s,
        "device_kernels_run": sum(e.count for e in kern),
        "device_busy_share": device_s / wall if device_s else None,
        "device_busy_share_profiled": (device_s / (f_s + s_s)
                                       if device_s else None),
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "device_ms": dev_us(e) * 1e-3} for e in top]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
