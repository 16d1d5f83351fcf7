"""K3's three solves on the card, for the ``repro_torch`` package under
``--src``: the shapes of ``chip_smoke.py``'s wide records (and, in
bfloat16, of its kernel records).

    python3 tools/time_trsm_wide.py [--src DIR] [--label NAME] [--pardiso]
                                    [--dtype float64|float32|bfloat16]

K = 32, in ``--dtype`` (float64 by default): the right solve Y U = X on
256 rows of X at k = 140, 256 and 600 (U dominant: 16 on the diagonal),
the unit-lower and upper left solves on 32 blocks of 150 x 150 with one
right-hand side (a dominant block in place of ``pardiso_like``'s root),
and the k <= 128 shapes of ``chip_smoke.py``'s kernel records: the right
solve at U (64, 64, 64), X (64, 128, 64) (fem2d_10k's largest sup-sup
bucket), the left solves on 32 blocks of 128 x 128 with one right-hand
side; in bfloat16 also K4 (``gemm_batched``) at (64, 128, 64) @ (64, 64,
104) beside ``torch.bmm``.  Per call: the kernel entry points one call
launches (a spy on ``_build.launch``), a digest of its result's bits (the
same inputs in another tree give the same digest where the kernels give
the same bits), its largest difference from the
plain version (in bfloat16 also the entries that differ and the largest
difference in bf16 ulps of its entry, and the entries that differ from
the plain version summed in the kernels' order, this checkout's
``ref.*_bf16_ordered``), its mean time by CUDA events over
back-to-back calls (the least of three windows of at least 50 ms), its
device time by CUDA-graph replay of 20 calls, and the library call's two
times on the same inputs (``torch.linalg.solve_triangular``, which takes
no bfloat16 on the card; ``torch.bmm``).  With ``--pardiso``, also
``pardiso_like``'s K = 32 solve at fem2d_10k (``fem2d(100, 100,
seed=930)``, ``chip_smoke.py``'s values and right-hand sides):
``solve_batched`` ms over five passes after a warm-up.

To compare two commits on one card, unpack the other tree (``git archive
<commit> | tar -x -C artifacts/parent``; ``artifacts/`` is ignored) and run
both in turns in one call: ``--src artifacts/parent/src``, ``--src src``,
``--src src``, ``--src artifacts/parent/src``.  Each package builds its
kernels into its own checkout's ``build/``.  Prints one JSON line with the
card's name and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

K, NRX, REPS = 32, 256, 20
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ordered_ref():
    """This checkout's ``kernels/trisolve/ref.py`` (it imports only torch),
    whatever package ``--src`` names: its ``*_bf16_ordered`` solves."""
    spec = importlib.util.spec_from_file_location(
        "ordered_ref", os.path.join(ROOT, "src", "repro_torch", "kernels",
                                    "trisolve", "ref.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def bf16_diff(torch, got, want):
    """Over want's finite entries: the entries that differ and the largest
    difference in bf16 ulps of its own entry (2^-7 of its binade)."""
    g, r = got.float(), want.float()
    fin = torch.isfinite(r)
    err = (g - r).abs()[fin]
    ulp = torch.exp2(torch.floor(torch.log2(
        r.abs().clamp(min=2.0 ** -126))) - 7)[fin]
    return {"entries_differing": int((err > 0).sum()),
            "max_ulps_of_entry": float((err / ulp).max()),
            "same_nonfinite": bool(torch.equal(~torch.isfinite(g), ~fin))}


def record(torch, build, call, plain, lib, ordered=None):
    entries = entries_of(build, call)
    got, want = call(), plain()
    bits = got.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    out = {"entries": entries,
           "digest": hashlib.sha1(bits).hexdigest()[:16],
           "max_abs_err": float((got - want).abs().max())}
    if got.dtype == torch.bfloat16:
        out.update(bf16_diff(torch, got, want))
    if ordered is not None:
        out["entries_differing_ordered"] = int((got != ordered()).sum())
    lib_ms = lib_dev = None
    try:
        lib_ms = bench_ms(torch, lib)
        lib_dev = graph_ms(torch, lib)
    except RuntimeError:      # no bfloat16, or not capturable: loop time
        torch.cuda.synchronize()
    out.update({"ms": bench_ms(torch, call),
                "device_ms": graph_ms(torch, call),
                "library_ms": lib_ms, "library_device_ms": lib_dev})
    return out


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
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default=None)
    ap.add_argument("--pardiso", action="store_true")
    ap.add_argument("--dtype", default="float64",
                    choices=("float64", "float32", "bfloat16"))
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
    dt = getattr(torch, args.dtype)
    rng = np.random.default_rng(23)
    out = {"label": args.label or args.src, "smi": smi, "dtype": args.dtype}

    bf = dt == torch.bfloat16
    seq = ordered_ref() if bf else None

    def on_card(a):
        return torch.from_numpy(a).to(dev, dt)

    def seq_of(name, *args):
        return (lambda: getattr(seq, name)(*args)) if bf else None

    def right(label, n, nr, k):
        u = on_card(rng.normal(size=(n, k, k)) + 16 * np.eye(k))
        x = on_card(rng.normal(size=(n, nr, k)))
        out[label] = record(
            torch, _build, lambda: tri.trsm_batched(u, x),
            lambda: tri.trsm_plain(u, x),
            lambda: torch.linalg.solve_triangular(u, x, upper=True,
                                                  left=False),
            seq_of("trsm_bf16_ordered", u, x))

    def left(sfx, k):
        blk = on_card(rng.normal(size=(K, k, k)) / np.sqrt(k)
                      + 3 * np.eye(k))
        rhs = on_card(rng.normal(size=(K, k, 1)))
        lower = torch.tril(blk, -1) + torch.eye(k, dtype=dt, device=dev)
        out["left_unit_lower" + sfx] = record(
            torch, _build, lambda: tri.trsm_left_unit_lower_batched(blk, rhs),
            lambda: tri.trsm_left_unit_lower_plain(blk, rhs),
            lambda: torch.linalg.solve_triangular(lower, rhs, upper=False,
                                                  unitriangular=True),
            seq_of("trsm_left_unit_lower_bf16_ordered", blk, rhs))
        out["left_upper" + sfx] = record(
            torch, _build, lambda: tri.trsm_left_upper_batched(blk, rhs),
            lambda: tri.trsm_left_upper_plain(blk, rhs),
            lambda: torch.linalg.solve_triangular(blk, rhs, upper=True),
            seq_of("trsm_left_upper_bf16_ordered", blk, rhs))

    for k in (140, 256, 600):
        right(f"right_k{k}", K, NRX, k)
    left("_k150", 150)
    right("right_k64", 64, 128, 64)
    left("_k128", 128)
    if bf:
        from repro_torch.kernels.supsup import ops as supsup

        a = on_card(rng.normal(size=(64, 128, 64)))
        b = on_card(rng.normal(size=(64, 64, 104)))
        out["bmm"] = record(torch, _build,
                            lambda: supsup.gemm_batched(a, b),
                            lambda: supsup.gemm_batched_plain(a, b),
                            lambda: torch.bmm(a, b))
    if args.pardiso:
        out["pardiso_like_solve_ms"] = pardiso_solve_ms(torch, np)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
