"""End-to-end solver and serving times of two checkouts in turns on one card.

    python -m repro_torch.paired_times OTHER_ROOT [solver|serving]

runs the measurements below (both, or the one named) once per checkout
in the order OTHER, this, this, OTHER, ROUNDS times over (16 processes),
each in its own process that imports ``repro_torch`` from that
checkout's ``src`` (and so builds that checkout's kernels into its own
``build/``), then prints one JSON line per run and a summary line: per
metric and checkout each process's best, and their median and range.
Two versions are only compared inside one such call: the card and its
host are the same, and the turns expose drift.  The host-bound times
spread by up to 1.7x within a call, so one round (two processes a side)
could show no change of that size.

The solver measurement, on fem2d_10k (``fem2d(100, 100, seed=930)``),
float64:

* systems per second of one batched step at K = 32 systems
  (``factor_batched`` + ``solve_batched``, host clock around work that
  ends in a synchronize), three steps after a warm-up step;
* the one-system ``refactor`` ms under the bucketed and the unrolled
  schedule, three calls each after a ``factor``.

The serving measurement, rwkv6-1.6b at full width and depth in bfloat16
(random weights from seed 0), kernels on, at ``chip_smoke.py``'s shape: 4
requests of 2,048 random prompt tokens (seed 0), 16 new tokens each:

* prefill ms (``make_prefill_step``, host clock around work that ends in a
  synchronize), three calls after a warm-up call;
* generated tokens per second of the whole ``greedy_generate`` call
  (prefill and 15 decode steps), three calls after a warm-up call.

Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

K, REPEATS, ROUNDS = 32, 3, 4
SERVING = ("rwkv6-1.6b", 4, 2048, 16)    # model, requests, prompt, new tokens


def measure_serving() -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.serve.serve_step import greedy_generate, make_prefill_step

    name, batch, prompt_len, new = SERVING
    cfg = registry.get(name)
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, prompt_len))).cuda()
    prefill = make_prefill_step(cfg, s_max=prompt_len + new)
    prefill_ms, gen_tps = [], []
    for i in range(REPEATS + 1):                   # the first is a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, tokens=prompt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        greedy_generate(cfg, params, prompt, new)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i:
            prefill_ms.append((t1 - t0) * 1e3)
            gen_tps.append(batch * new / (t2 - t1))
    return {"rwkv6_prefill_ms": prefill_ms,
            "rwkv6_generated_tokens_per_s": gen_tps}


def measure() -> dict:
    import numpy as np
    import torch

    from repro_torch.core import (CSR, HyluOptions, analyze, factor,
                                  factor_batched, refactor, solve_batched)
    from repro_torch.matrices import fem2d, to_csr

    A = to_csr(fem2d(100, 100, seed=930))
    an = analyze(A, HyluOptions())
    an_u = analyze(A, HyluOptions(factor_schedule="unrolled"), reuse=an)
    vals = A.data[None] * np.random.default_rng(7).uniform(0.8, 1.2,
                                                          (K, A.nnz))
    b = np.random.default_rng(8).normal(size=(K, A.n))
    solve_batched(factor_batched(an, A, vals), b)          # warm-up
    steps = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = factor_batched(an, A, vals)
        t1 = time.perf_counter()
        solve_batched(bst, b)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        steps.append((t1 - t0, t2 - t1))
    rng = np.random.default_rng(9)
    v1, v2 = (A.data * rng.uniform(0.8, 1.2, A.nnz) for _ in range(2))
    A1 = CSR(A.n, A.indptr, A.indices, v1)
    A2 = CSR(A.n, A.indptr, A.indices, v2)
    refactor_ms = {}
    for label, a in (("bucketed", an), ("unrolled", an_u)):
        st = factor(a, A1)
        times = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = refactor(st, A2)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        refactor_ms[label] = times
    return {"systems_per_s": [K / (f + s) for f, s in steps],
            "factor_batched_ms": [f * 1e3 for f, _ in steps],
            "solve_batched_ms": [s * 1e3 for _, s in steps],
            "refactor_ms": refactor_ms}


def main(argv) -> int:
    if argv and argv[0] == "--one":                # a child: one checkout
        import torch

        if not torch.cuda.is_available():
            print("paired_times: needs a CUDA device", file=sys.stderr)
            return 2
        out = {"root": argv[1], "kind": torch.cuda.get_device_name(0)}
        if argv[2] in ("both", "solver"):
            out.update(measure())
        if argv[2] in ("both", "serving"):
            out.update(measure_serving())
        print(json.dumps(out), flush=True)
        return 0
    if len(argv) not in (1, 2) or argv[1:] not in ([], ["solver"],
                                                   ["serving"]):
        print(__doc__, file=sys.stderr)
        return 2
    what = argv[1] if len(argv) == 2 else "both"
    this = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    other = os.path.abspath(argv[0])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    runs, order = [], ["other", "this", "this", "other"] * ROUNDS
    for root in (other if side == "other" else this for side in order):
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root, what], env=env, cwd=root,
                             capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {"smi": smi, "order": order}
    best = {}
    if what in ("both", "solver"):
        best["systems_per_s"] = [max(r["systems_per_s"]) for r in runs]
        for label in ("bucketed", "unrolled"):
            best[f"refactor_ms_{label}"] = [min(r["refactor_ms"][label])
                                            for r in runs]
    if what in ("both", "serving"):
        best["rwkv6_prefill_ms"] = [min(r["rwkv6_prefill_ms"]) for r in runs]
        best["rwkv6_generated_tokens_per_s"] = [
            max(r["rwkv6_generated_tokens_per_s"]) for r in runs]
    for key, vals in best.items():
        summary[key] = vals
        for side in ("other", "this"):
            v = sorted(x for x, s in zip(vals, order) if s == side)
            summary[f"{key}_{side}"] = {
                "median": (v[(len(v) - 1) // 2] + v[len(v) // 2]) / 2,
                "min": v[0], "max": v[-1]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
