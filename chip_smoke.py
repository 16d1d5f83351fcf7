#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each printing one JSON line:

1. device   the card's name and power limit (nvidia-smi);
2. build    nvcc builds the kernel library from ``src/repro_torch/csrc``;
3. analyze  host analysis of fem2d_10k (the corpus's FEM entry: a 100x100
            5-point stencil with a diagonal jitter, seed 930; n = 10,000);
4. kernels  every CUDA kernel of the main path against its plain PyTorch
            version on the card, in float64 and float32, on the operands
            fem2d_10k's factor program hands it (largest panel bucket,
            largest narrow-level node, largest sup-sup edge bucket) and on
            an nr = 128 block of the finished factors, with its time, the
            plain version's, a library call's where one computes the same
            function, and the card's lower bound; each panel LU also on its
            panels with the rows shuffled, where pivoting must move rows;
5. main     the batched repeated-solve path through its entry points at
            K = 32: ``solve_sequence`` for T = 3 float64 steps, then one
            ``factor_batched`` + ``solve_batched`` step in float64 and one
            with float32 factors refined in float64; residuals, agreement
            with scipy's ``spsolve`` and the launch counts are checked;
6. width1   circuit_like(2000, seed 3), K = 8: the scanned width-1 tail.

Then one ``{"kernels": [...]}`` line, the nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero; it also exits non-zero, printing no result, without a CUDA
device or outside a checkout of the repository.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
K_MAIN, T_STEPS, K_WIDTH1 = 32, 3, 8
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float64": 67e12,    # fp64 (tensor core) peak, data sheet
              "float32": 67e12}    # fp32 outside the tensor cores
TOL = {"float64": 1e-10, "float32": 1e-4}
TOL_LEFT = {"float64": 1e-10, "float32": 1e-3}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bench_ms(torch, fn, min_ms=50.0):
    """Mean time of one call by CUDA events over enough back-to-back calls
    to fill ``min_ms``, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    reps = 1
    while True:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        el = t0.elapsed_time(t1)
        if el >= min_ms or reps >= 4096:
            return el / reps
        reps *= 4


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device -------------------------------------------------------
    t = time.perf_counter()
    smi = smi_line()
    emit({"phase": "device", "smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32,
          "seconds": time.perf_counter() - t})

    # ---- 2. build --------------------------------------------------------
    from repro_torch.kernels import _build

    t = time.perf_counter()
    lib_path = _build.build(force=True)
    _build.library()
    ptxas = [ln.strip() for ln in _build.last_build["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "library": os.path.relpath(lib_path, ROOT),
          "nvcc_s": _build.last_build["seconds"],
          "seconds": time.perf_counter() - t, "ptxas": ptxas})

    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import (HyluOptions, analyze, factor_batched,
                                  solve_batched, solve_sequence,
                                  torch_repeated_engine)
    from repro_torch.matrices import circuit_like, fem2d, to_csr

    # ---- 3. analyze ------------------------------------------------------
    t = time.perf_counter()
    a_sp = fem2d(100, 100, seed=930)
    A = to_csr(a_sp)
    opts64 = HyluOptions()                       # device="cuda", kernels on
    an64 = analyze(A, opts64)
    analyze_s = time.perf_counter() - t
    eng64 = torch_repeated_engine(an64)
    sched = eng64.sched
    emit({"phase": "analyze", "matrix": "fem2d_10k", "n": A.n, "nnz": A.nnz,
          "mode": an64.choice.mode, "analyze_s": analyze_s,
          "host_timings": an64.timings, "level_steps": len(sched.steps),
          "panel_buckets": sum(len(s.panels) for s in sched.steps),
          "narrow_nodes": sum(len(s.seq) for s in sched.steps),
          "edge_buckets": sum(len(s.edges) for s in sched.steps),
          "supsup_buckets": sum(1 for s in sched.steps for e in s.edges
                                if e.k > 1),
          "scan_chunks": len(sched.scan_chunks),
          "block_nodes": len(eng64._blocks),
          "seconds": time.perf_counter() - t})

    rng = np.random.default_rng(2026)
    vals0 = A.data[None] * rng.uniform(0.8, 1.2, (K_MAIN, A.nnz))
    records = kernel_phase(torch, np, kernels, eng64, vals0)

    # ---- 5. main path ----------------------------------------------------
    t = time.perf_counter()
    seq_rng = np.random.default_rng(7)
    values = A.data[None, None] * seq_rng.uniform(0.8, 1.2,
                                                  (T_STEPS, K_MAIN, A.nnz))
    b = np.random.default_rng(8).normal(size=(K_MAIN, A.n))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    xs, info_seq = solve_sequence(A, values, b, opts64)
    t_seq = time.perf_counter() - t
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = factor_batched(an64, A, values[0])
    t_factor = time.perf_counter() - t0
    t0 = time.perf_counter()
    x64, info64 = solve_batched(bst, b)
    t_solve = time.perf_counter() - t0
    an32 = analyze(A, HyluOptions(factor_dtype="float32"), reuse=an64)
    torch_repeated_engine(an32)                  # build it outside the timing
    t0 = time.perf_counter()
    bst32 = factor_batched(an32, A, values[0])
    t_factor32 = time.perf_counter() - t0
    t0 = time.perf_counter()
    x32, info32 = solve_batched(bst32, b)
    t_solve32 = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # launches of one refactor and of one substitution (outside the counts
    # of the main path above)
    b_dev = torch.from_numpy(b).to(eng64.device)
    kernels.reset_launch_counts()
    f = eng64.refactor_batched(bst.values_dev)
    per_refactor = kernels.launch_counts()
    kernels.reset_launch_counts()
    eng64.apply_batched(f.vals, f.inode_perm, b_dev)
    per_apply = kernels.launch_counts()

    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    scipy_err = []
    for k in (0, K_MAIN - 1):
        ak = sp.csr_matrix((values[0, k], A.indices, A.indptr),
                           shape=(A.n, A.n)).tocsc()
        xr = spla.spsolve(ak, b[k])
        scipy_err.append(float(np.abs(x64[k] - xr).max() / np.abs(xr).max()))
    mixed_err = float(np.abs(x32 - x64).max() / np.abs(x64).max())
    seq_vs_step = float(np.abs(xs[0] - x64).max() / np.abs(x64).max())
    main = {"phase": "main", "matrix": "fem2d_10k", "k": K_MAIN,
            "steps": T_STEPS, "analyze_s": analyze_s,
            "solve_sequence_s": t_seq,
            "factor_batched_ms": t_factor * 1e3,
            "solve_batched_ms": t_solve * 1e3,
            "systems_per_s": K_MAIN / (t_factor + t_solve),
            "factor_batched_f32_ms": t_factor32 * 1e3,
            "solve_batched_f32_ms": t_solve32 * 1e3,
            "max_residual_seq": float(info_seq["residual"].max()),
            "max_residual_f64": float(info64["residual"].max()),
            "max_residual_f32": float(info32["residual"].max()),
            "refine_iters_seq": info_seq["n_refine"],
            "refine_iters_f64": info64["n_refine"],
            "refine_iters_f32": info32["n_refine"],
            "n_fp64_fallback": info32["n_fp64_fallback"],
            "n_perturb": int(info64["n_perturb"].sum()),
            "scipy_rel_err": scipy_err, "mixed_vs_f64_rel_err": mixed_err,
            "sequence_step0_vs_step_rel_err": seq_vs_step,
            "launches": counts, "launches_per_refactor": per_refactor,
            "launches_per_apply": per_apply, "max_memory_allocated": peak,
            "seconds": time.perf_counter() - t}
    emit(main)
    check(np.isfinite(xs).all() and xs.shape == (T_STEPS, K_MAIN, A.n),
          "sequence solutions are finite and (T, K, n)")
    for key in ("max_residual_seq", "max_residual_f64", "max_residual_f32"):
        check(main[key] <= 1e-10, f"{key} = {main[key]} > 1e-10")
    check(max(scipy_err) <= 1e-10, f"scipy disagreement {scipy_err}")
    check(mixed_err <= 1e-10, f"mixed vs f64 {mixed_err}")
    for name, c in counts.items():
        check(c > 0, f"kernel {name} was not launched on the main path")

    # ---- 6. width-1 path -------------------------------------------------
    t = time.perf_counter()
    C = to_csr(circuit_like(2000, seed=3))
    crng = np.random.default_rng(11)
    cvals = C.data[None] * crng.uniform(0.8, 1.2, (K_WIDTH1, C.nnz))
    cb = crng.normal(size=(K_WIDTH1, C.n))
    kernels.reset_launch_counts()
    anc = analyze(C, opts64)
    n_chunks = len(torch_repeated_engine(anc).sched.scan_chunks)
    xc, infoc = solve_batched(factor_batched(anc, C, cvals), cb)
    emit({"phase": "width1", "matrix": "circuit_like(2000, seed=3)",
          "mode": anc.choice.mode, "k": K_WIDTH1, "scan_chunks": n_chunks,
          "max_residual": float(infoc["residual"].max()),
          "launches": kernels.launch_counts(),
          "seconds": time.perf_counter() - t})
    check(n_chunks > 0, "circuit schedule has no scan chunks")
    check(np.isfinite(xc).all() and infoc["residual"].max() <= 1e-10,
          f"width-1 residual {infoc['residual'].max()}")

    for rec in records:
        rec["launches"] = counts[rec.pop("wrapper")]
    emit({"kernels": records})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def kernel_phase(torch, np, kernels, eng, vals0):
    """Phase 4: each kernel against its plain version on the card."""
    from repro_torch.kernels.panel import ops as panel_ops
    from repro_torch.kernels.supsup import ops as supsup_ops
    from repro_torch.kernels.trisolve import ops as trisolve_ops

    t = time.perf_counter()
    dev = eng.device
    sched, plan = eng.sched, eng.plan
    K = vals0.shape[0]
    a_dev = torch.from_numpy(vals0).to(dev)
    nodes = plan.nodes
    steps = list(enumerate(sched.steps))
    st1, pb = max(((i, p) for i, s in steps for p in s.panels),
                  key=lambda ip: ip[1].gather.size)
    st2, seq_t = max(((i, int(t_)) for i, s in steps for t_ in s.seq),
                     key=lambda it: nodes[it[1]].nr * nodes[it[1]].width)
    nd = nodes[seq_t]
    st3, eb = max(((i, e) for i, s in steps for e in s.edges if e.k > 1),
                  key=lambda ie: (len(ie[1].srcs) * ie[1].nr * ie[1].k
                                  * (ie[1].k + ie[1].m)))
    blk_node = max(eng._blocks, key=lambda b_: b_[1])
    nrb, bs = blk_node[1], blk_node[-1]

    # Each kernel's operands are what the factor program hands it: the
    # value buffer (sentinel slots included) and the per-system thresholds
    # just before the phase of the level step that runs the case.
    vals, eps = eng.refactor_batched(a_dev, stop=(st1, "panels"))
    B, nr, wt = pb.gather.shape
    gidx = torch.from_numpy(pb.gather.reshape(-1).astype(np.int64)).to(dev)
    P1 = vals[:, gidx].view(K * B, nr, wt).contiguous()
    eps1 = eps.repeat_interleave(B)
    vals, eps2 = eng.refactor_batched(a_dev, stop=(st2, "seq"))
    off = int(plan.panel_offset[seq_t])
    P2 = vals[:, off:off + nd.nr * nd.width].reshape(K, nd.nr, nd.width)
    P2 = P2.contiguous()
    vals, _ = eng.refactor_batched(a_dev, stop=(st3, "edges"))
    sidx = torch.from_numpy(eb.src_idx.astype(np.int64)).to(dev)
    xidx = torch.from_numpy(eb.x_idx.astype(np.int64)).to(dev)
    S = vals[:, sidx]
    E = S.shape[1]
    U = S[..., :eb.k].reshape(K * E, eb.k, eb.k).contiguous()
    Us = S[..., eb.k:].reshape(K * E, eb.k, eb.m).contiguous()
    X = vals[:, xidx].reshape(K * E, eb.nr, eb.k).contiguous()
    # the substitution reads the finished factors
    f = eng.refactor_batched(a_dev)
    bslots = eng._bflat["blk_slots"][bs[0]:bs[1]].view(nrb, nrb)
    BLK = f.vals[:, bslots].contiguous()
    RHS = torch.from_numpy(np.random.default_rng(5).normal(
        size=(K, nrb, 1))).to(dev)
    LTS = trisolve_ops.trsm_batched(U, X)
    del vals, S, f
    # The stencil's diagonal blocks may need no row swap at all, so each
    # panel LU is also held to its plain version on the same panels with
    # their rows shuffled: partial pivoting then has to move rows.
    shuf_rng = np.random.default_rng(6)

    def shuffled(P):
        rows = np.argsort(shuf_rng.random(P.shape[:2]), axis=1)
        idx = torch.from_numpy(rows).to(dev)[..., None].expand(P.shape)
        return torch.gather(P, 1, idx).contiguous()

    P1s, P2s = shuffled(P1), shuffled(P2)
    torch.cuda.synchronize()

    def sz(dt):
        return torch.finfo(dt).bits // 8

    def lu_flops(npan, nr_, c0, wlim):
        j = np.arange(nr_)
        return npan * float(np.sum((nr_ - j - 1)
                                   * (1 + 2 * np.maximum(wlim - c0 - j - 1,
                                                         0))))

    # name, wrapper counted on the main path, replaces, source, args,
    # kernel call, plain call, library call, (flops, bytes) of the work,
    # tolerance table, and for a panel LU the (kernel, plain) calls on the
    # row-shuffled panels
    def cases(dt):
        c = lambda t_: t_.to(dt).contiguous()          # noqa: E731
        p1, p2, u, x, us, lts, blk, rhs = map(c, (P1, P2, U, X, Us, LTS, BLK,
                                                  RHS))
        p1s, p2s = c(P1s), c(P2s)
        e1, e2 = eps1.to(dt), eps2.to(dt)
        s = sz(dt)
        lower = torch.tril(blk, -1) + torch.eye(nrb, dtype=dt, device=dev)
        return [
            ("panel_lu_bucketed", "panel_lu_batched",
             "src/repro/kernels/panel/kernel.py:59", "src/repro_torch/csrc/panel_lu.cu",
             f"({K * B}, {nr}, {wt}) wu={pb.wu}",
             lambda: panel_ops.panel_lu_batched(p1, pb.wu, e1),
             lambda: panel_ops.panel_lu_plain(p1, 0, pb.wu, e1), None,
             lu_flops(K * B, nr, 0, pb.wu),
             (2 * p1.numel() + e1.numel()) * s + (p1.shape[0] * (nr + 1)) * 4,
             TOL, (lambda: panel_ops.panel_lu_batched(p1s, pb.wu, e1),
                   lambda: panel_ops.panel_lu_plain(p1s, 0, pb.wu, e1))),
            ("panel_lu", "panel_lu",
             "src/repro/kernels/panel/kernel.py:23", "src/repro_torch/csrc/panel_lu.cu",
             f"({K}, {nd.nr}, {nd.width}) lsize={nd.lsize}",
             lambda: panel_ops.panel_lu(p2, nd.nr, nd.lsize, e2),
             lambda: panel_ops.panel_lu_plain(p2, nd.lsize, nd.width, e2),
             None, lu_flops(K, nd.nr, nd.lsize, nd.width),
             (2 * p2.numel() + e2.numel()) * s + K * (nd.nr + 1) * 4, TOL,
             (lambda: panel_ops.panel_lu(p2s, nd.nr, nd.lsize, e2),
              lambda: panel_ops.panel_lu_plain(p2s, nd.lsize, nd.width, e2))),
            ("trsm_right", "trsm_batched",
             "src/repro/kernels/trisolve/kernel.py:21", "src/repro_torch/csrc/trsm.cu",
             f"U ({K * E}, {eb.k}, {eb.k}) X ({K * E}, {eb.nr}, {eb.k})",
             lambda: trisolve_ops.trsm_batched(u, x),
             lambda: trisolve_ops.trsm_plain(u, x),
             lambda: torch.linalg.solve_triangular(u, x, upper=True,
                                                   left=False),
             float(K * E * eb.nr * eb.k * eb.k),
             (K * E * eb.k * (eb.k + 1) // 2 + 2 * x.numel()) * s, TOL,
             None),
            ("trsm_left_unit_lower", "trsm_left_unit_lower_batched",
             "src/repro/kernels/trisolve/kernel.py:21", "src/repro_torch/csrc/trsm.cu",
             f"blk ({K}, {nrb}, {nrb}) b ({K}, {nrb}, 1)",
             lambda: trisolve_ops.trsm_left_unit_lower_batched(blk, rhs),
             lambda: trisolve_ops.trsm_left_unit_lower_plain(blk, rhs),
             lambda: torch.linalg.solve_triangular(lower, rhs, upper=False,
                                                   unitriangular=True),
             float(K * nrb * (nrb - 1)),
             (K * nrb * (nrb - 1) // 2 + 2 * rhs.numel()) * s, TOL_LEFT,
             None),
            ("trsm_left_upper", "trsm_left_upper_batched",
             "src/repro/kernels/trisolve/kernel.py:21", "src/repro_torch/csrc/trsm.cu",
             f"blk ({K}, {nrb}, {nrb}) b ({K}, {nrb}, 1)",
             lambda: trisolve_ops.trsm_left_upper_batched(blk, rhs),
             lambda: trisolve_ops.trsm_left_upper_plain(blk, rhs),
             lambda: torch.linalg.solve_triangular(blk, rhs, upper=True),
             float(K * nrb * nrb),
             (K * nrb * (nrb + 1) // 2 + 2 * rhs.numel()) * s, TOL_LEFT,
             None),
            ("bmm", "gemm_batched",
             "src/repro/kernels/supsup/kernel.py:34", "src/repro_torch/csrc/bmm.cu",
             f"({K * E}, {eb.nr}, {eb.k}) @ ({K * E}, {eb.k}, {eb.m})",
             lambda: supsup_ops.gemm_batched(lts, us),
             lambda: supsup_ops.gemm_batched_plain(lts, us),
             lambda: torch.bmm(lts, us),
             2.0 * K * E * eb.nr * eb.k * eb.m,
             (lts.numel() + us.numel() + K * E * eb.nr * eb.m) * s, TOL,
             None),
        ]

    def held(name, dname, tol, got, ref, what=""):
        """Check kernel output against plain output; returns the max
        error and, for a panel LU, (rows moved by pivoting, pivots
        perturbed)."""
        torch.cuda.synchronize()
        moved = None
        if isinstance(got, tuple):                  # panel LU outputs
            check(torch.equal(got[1], ref[1]),
                  f"{name} {dname}{what}: pivot permutations differ")
            check(torch.equal(got[2], ref[2]),
                  f"{name} {dname}{what}: perturbation counts differ")
            ident = torch.arange(got[1].shape[-1], device=dev)
            moved = (int((got[1] != ident).sum()), int(got[2].sum()))
            got, ref = got[0], ref[0]
        err = float((got - ref).abs().max())
        check(bool(torch.allclose(got, ref, rtol=tol, atol=tol)),
              f"{name} {dname}{what}: max |kernel - plain| = {err} "
              f"outside rtol=atol={tol}")
        return err, moved

    records = {}
    for dt in (torch.float64, torch.float32):
        dname = str(dt).replace("torch.", "")
        for (name, wrapper, replaces, source, shape, kern, plain, lib, flops,
             nbytes, tol, shuf) in cases(dt):
            err, moved = held(name, dname, tol[dname], kern(), plain())
            rec = records.setdefault(name, {
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "wrapper": wrapper, "shape": shape})
            sfx = "" if dname == "float64" else "_f32"
            if shuf is not None:
                err_s, moved_s = held(name, dname, tol[dname], shuf[0](),
                                      shuf[1](), " (rows shuffled)")
                check(moved_s[0] > 0, f"{name} {dname}: no row moved by "
                                      "pivoting on the shuffled panels")
                rec.update({"rows_moved" + sfx: moved[0],
                            "perturbed" + sfx: moved[1],
                            "max_abs_err_shuffled" + sfx: err_s,
                            "rows_moved_shuffled" + sfx: moved_s[0],
                            "perturbed_shuffled" + sfx: moved_s[1]})
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = flops / PEAK_FLOPS[dname]
            rec.update({
                "max_abs_err" + sfx: err, "tol" + sfx: tol[dname],
                "ms" + sfx: bench_ms(torch, kern),
                "plain_ms" + sfx: bench_ms(torch, plain),
                "bound_ms" + sfx: max(t_bytes, t_ops) * 1e3,
                "bound_by" + sfx: "bytes" if t_bytes >= t_ops
                else "operations",
                "library_ms" + sfx: (bench_ms(torch, lib) if lib is not None
                                     else None)})
    out = list(records.values())
    emit({"phase": "kernels", "dtypes": ["float64", "float32"],
          "records": out, "seconds": time.perf_counter() - t})
    return out


if __name__ == "__main__":
    sys.exit(main())
