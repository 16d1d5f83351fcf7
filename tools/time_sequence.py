"""The T-step sequence on the card: the double-buffered pipeline against the
step-by-step loop it replaced, interleaved and repeated in one process.

    python3 tools/time_sequence.py [--reps 4] [--steps 3]   # one card

Analyzes fem2d_10k (``fem2d(100, 100, seed=930)``, ``chip_smoke.py``'s main
phase: K = 32, float64, the bucketed schedule with kernels) once, then
times three ways of running the same T steps:

- ``loop``: the T-step loop ``solve_sequence`` ran before the pipeline
  (per step ``_stage_values``, ``_stage_rhs``, ``refactor_batched`` and
  the refined solve, one host sync at the end), copied below;
- ``pipeline``: ``_run_pipeline`` without donation;
- ``donate``: ``_run_pipeline`` with donation.

After one warm-up run of each, ``--reps`` rounds run them in the order
loop, pipeline, donate, then reversed, and so on (the host's launch cost
drifts within a process); each run is timed by the host clock from a
device sync to the end of its own sync, as seconds per step, and split by
the host clock into the host's seconds a step in staging (the loop's
``_stage_values`` / ``_stage_rhs``, the pipeline's ``_Staging.fill``),
in ``refactor_batched`` (its launches) and in the refined solve (its
launches and its waits for the device at each refinement test).  Every
run's solutions are held to the first loop run's (1e-10).  With
``--profile``, one run of each under ``torch.profiler`` (minutes: a step
is about 85,000 kernels): the device kernel time, the number of kernels,
and the device busy share (kernel time over the median unprofiled wall
time of that way).  Prints one JSON line with the card's name and power
limit, each way's times, median and spread.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

GRID, K = 100, 32
HOST = collections.defaultdict(float)      # host seconds by phase, one run


@contextlib.contextmanager
def host_time(phase):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        HOST[phase] += time.perf_counter() - t0


def timed_phases():
    """Wrap the engine's refactor and refined solve and the pipeline's
    staging so that each adds its host seconds to ``HOST``."""
    from repro_torch.core import batched
    from repro_torch.core.torch_engine import RepeatedSolveEngine

    def wrap(fn, phase):
        def timed(*a, **kw):
            with host_time(phase):
                return fn(*a, **kw)
        return timed

    RepeatedSolveEngine.refactor_batched = wrap(
        RepeatedSolveEngine.refactor_batched, "refactor")
    make_solver = RepeatedSolveEngine.refined_batched_solver
    RepeatedSolveEngine.refined_batched_solver = (
        lambda self, *a: wrap(make_solver(self, *a), "solve"))
    # the pipeline steps its shards' refined solves by run_together
    batched.run_together = wrap(batched.run_together, "solve")
    batched._Staging.fill = wrap(batched._Staging.fill, "stage")


def loop_steps(an, pattern, values, b):
    """The T-step loop of ``solve_sequence`` before the pipeline: each step
    stages its values and right-hand sides when its turn comes."""
    from repro_torch.core.analysis import _sync, torch_repeated_engine
    from repro_torch.core.batched import _stage_rhs, _stage_values
    from repro_torch.core.options import resolve_refine_tol

    eng = torch_repeated_engine(an)
    solver = eng.refined_batched_solver(*pattern)
    tol = resolve_refine_tol(an.opts, eng.refine_dtype)
    outs = []
    for v in values:
        with host_time("stage"):
            v_dev, _, k = _stage_values(eng, v)
            b_dev = _stage_rhs(eng, b, k)
        f = eng.refactor_batched(v_dev)
        outs.append(solver(f.vals, f.inode_perm, v_dev, b_dev,
                           an.opts.refine_max_iter, tol)[0])
    _sync(eng.device)
    return [o.cpu().numpy() for o in outs]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import HyluOptions, analyze
    from repro_torch.core.batched import _run_pipeline
    from repro_torch.matrices import fem2d, to_csr

    if not torch.cuda.is_available():
        raise SystemExit("time_sequence needs a CUDA device")
    timed_phases()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    A = to_csr(fem2d(GRID, GRID, seed=930))
    pattern = (A.indptr, A.indices)
    an = analyze(A, HyluOptions())
    an_d = dataclasses.replace(an, opts=dataclasses.replace(an.opts,
                                                            donate=True))
    values = A.data[None, None] * np.random.default_rng(7).uniform(
        0.8, 1.2, (args.steps, K, A.nnz))
    b = np.random.default_rng(8).normal(size=(K, A.n))
    ways = {
        "loop": lambda: np.stack(loop_steps(an, pattern, values, b)),
        "pipeline": lambda: _run_pipeline(an, pattern, values, b)[0],
        "donate": lambda: _run_pipeline(an_d, pattern, values, b)[0],
    }

    def timed(name):
        torch.cuda.synchronize()
        HOST.clear()
        t0 = time.perf_counter()
        x = ways[name]()
        return (time.perf_counter() - t0) / args.steps, x

    ref = timed("loop")[1]                  # warm-up, and the reference
    for name in ways:
        timed(name)
    secs = {name: [] for name in ways}
    host = {name: collections.defaultdict(list) for name in ways}
    err = 0.0
    order = list(ways)
    for r in range(args.reps):
        for name in (order if r % 2 == 0 else order[::-1]):
            s, x = timed(name)
            secs[name].append(s)
            for phase in ("stage", "refactor", "solve"):
                host[name][phase].append(HOST[phase] / args.steps)
            err = max(err, float(np.abs(x - ref).max() / np.abs(ref).max()))

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    prof_out = {}
    for name in (ways if args.profile else ()):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            s, _ = timed(name)
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        device_s = sum(dev_us(e) for e in kern) * 1e-6 / args.steps
        prof_out[name] = {
            "profiled_s_per_step": s,
            "device_kernel_s_per_step": device_s,
            "device_kernels_per_step": sum(e.count for e in kern)
            // args.steps,
            "device_busy_share": (device_s / statistics.median(secs[name])
                                  if device_s else None)}
    out = {"matrix": f"fem2d({GRID}, {GRID}, seed=930)", "k": K,
           "steps": args.steps, "reps": args.reps, "smi": smi,
           "s_per_step": secs,
           "median_s_per_step": {k: statistics.median(v)
                                 for k, v in secs.items()},
           "spread_s_per_step": {k: max(v) - min(v)
                                 for k, v in secs.items()},
           "host_s_per_step": host,
           "median_host_s_per_step": {
               k: {p: statistics.median(v) for p, v in h.items()}
               for k, h in host.items()},
           "max_rel_err_vs_loop": err, "profile": prof_out}
    print(json.dumps(out), flush=True)
    if err > 1e-10:
        raise SystemExit(f"time_sequence: the ways disagree ({err})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
