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
            K5 (C - A.B) and K6 (sup-row TRSV + GEMV) are held the same
            way at the largest sup-sup and sup-row edge of the unrolled
            schedule, on the operands its program hands that edge; K1 and
            K2 also on panels with an exactly zero pivot under a zero
            threshold, where NaN and inf positions must match;
5. main     the batched repeated-solve path through its entry points at
            K = 32: ``solve_sequence`` for T = 3 float64 steps, then one
            ``factor_batched`` + ``solve_batched`` step in float64 and one
            with float32 factors refined in float64; residuals, agreement
            with scipy's ``spsolve`` and the launch counts are checked;
6. width1   circuit_like(2000, seed 3), K = 8: the scanned width-1 tail;
7. scalar   the one-system lifecycle ``factor`` -> ``refactor`` (new
            values) -> ``solve`` on fem2d_10k under the bucketed and the
            unrolled schedule in float64, and bucketed with float32
            factors: residuals, ``spsolve``, unrolled against bucketed
            (pivots, perturbation counts, factors) and the launches of one
            unrolled refactor against the plan's counts;
8. plain    one batched step at K = 32 with ``use_kernels=False`` (plain
            factor program, level-scheduled substitution): residuals, no
            kernel launched, and its times beside the kernel route's.

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
# K5 and K6 are also held to 1e-12 relative to the plain version's largest
# magnitude in float64
REL_TOL_F64 = {"gemm_update": 1e-12, "suprow_update": 1e-12}
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

    # the wrappers each path launches (suprow_update has no engine caller,
    # as in the JAX package)
    batched_path = ("panel_lu_batched", "panel_lu", "trsm_batched",
                    "trsm_left_unit_lower_batched", "trsm_left_upper_batched",
                    "gemm_batched")

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

    # the same plan under the other schedule and route (matching and
    # ordering reused)
    t = time.perf_counter()
    an_u = analyze(A, HyluOptions(factor_schedule="unrolled"), reuse=an64)
    eng_u = torch_repeated_engine(an_u)
    emit({"phase": "analyze_reuse", "unrolled_s": time.perf_counter() - t})

    rng = np.random.default_rng(2026)
    vals0 = A.data[None] * rng.uniform(0.8, 1.2, (K_MAIN, A.nnz))
    records = kernel_phase(torch, np, kernels, eng64, vals0, eng_u)

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
    for name in batched_path:
        check(counts[name] > 0,
              f"kernel {name} was not launched on the main path")

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

    scalar_counts = scalar_phase(torch, np, kernels, A, an64, an_u, an32)
    plain_phase(torch, np, kernels, A, an64, bst, values[0], b, t_factor,
                t_solve)

    for rec in records:
        w = rec.pop("wrapper")
        rec["launches_by_path"] = {"batched": counts[w],
                                   "scalar": scalar_counts[w]}
        rec["launches"] = counts[w] + scalar_counts[w]
    emit({"kernels": records})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def unrolled_operands(torch, np, eng_u, a_dev, pred):
    """The operands the unrolled program hands its largest edge (by
    nr * k * m, the product's work) among those with ``pred(target nr,
    source nr)``: the gathered target columns x (1, nr, k+m) and the source
    rows src (1, k, k+m), taken from the program stopped just before that
    edge.  Also returns k and the largest k and m of all those edges."""
    plan = eng_u.plan
    nodes, offs = plan.nodes, plan.panel_offset
    shapes = {(t, j): (nd.nr, nodes[e.src].nr,
                       len(e.col_map) - nodes[e.src].nr)
              for t, nd in enumerate(nodes) for j, e in enumerate(nd.edges)
              if pred(nd.nr, nodes[e.src].nr)}
    t, j = max(shapes, key=lambda tj: np.prod(shapes[tj]))
    nd = nodes[t]
    e = nd.edges[j]
    snd = nodes[e.src]
    vals, _ = eng_u.refactor_batched(a_dev, stop=(t, j))
    off, soff = int(offs[nd.nid]), int(offs[snd.nid])
    panel = vals[:, off:off + nd.nr * nd.width].view(1, nd.nr, nd.width)
    cm = torch.from_numpy(e.col_map.astype(np.int64)).to(vals.device)
    x = panel[:, :, cm].contiguous()
    src = vals[:, soff:soff + snd.nr * snd.width].view(
        1, snd.nr, snd.width)[:, :, snd.lsize:].contiguous()
    return x, src, snd.nr, {"edges": len(shapes),
                            "max_k": max(v[1] for v in shapes.values()),
                            "max_m": max(v[2] for v in shapes.values())}


def kernel_phase(torch, np, kernels, eng, vals0, eng_u):
    """Phase 4: each kernel against its plain version on the card."""
    from repro_torch.kernels.panel import ops as panel_ops
    from repro_torch.kernels.suprow import ops as suprow_ops
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
    nrb, bslots = blk_node[1], blk_node[-1]

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
    BLK = f.vals[:, bslots].contiguous()
    RHS = torch.from_numpy(np.random.default_rng(5).normal(
        size=(K, nrb, 1))).to(dev)
    LTS = trisolve_ops.trsm_batched(U, X)
    del vals, S, f
    # K5 and K6 on the unrolled program of system 0, which launches them one
    # system at a time: its largest sup-sup edge (nr, k > 1) and its largest
    # sup-row edge (nr = 1, k > 1)
    X5, S5, k5, edges5 = unrolled_operands(
        torch, np, eng_u, a_dev[:1], lambda nr_, k_: nr_ > 1 and k_ > 1)
    LTS5 = trisolve_ops.trsm_batched(S5[..., :k5].contiguous(),
                                     X5[..., :k5].contiguous())
    X6, S6, k6, edges6 = unrolled_operands(
        torch, np, eng_u, a_dev[:1], lambda nr_, k_: nr_ == 1 and k_ > 1)
    X6 = X6[:, 0]
    nr5, m5, m6 = X5.shape[1], X5.shape[2] - k5, X6.shape[1] - k6
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
        x5c, x5a, s5u, s5b = (c(X5[..., k5:]), c(LTS5), c(S5[..., :k5]),
                              c(S5[..., k5:]))
        x6, s6 = c(X6), c(S6)
        x6k = x6[:, None, :k6].contiguous()
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
            ("gemm_update", "gemm_update",
             "src/repro/kernels/supsup/kernel.py:21",
             "src/repro_torch/csrc/gemm_update.cu",
             f"C (1, {nr5}, {m5}) - A (1, {nr5}, {k5}) @ B (1, {k5}, {m5})",
             lambda: supsup_ops.gemm_update(x5c, x5a, s5b),
             lambda: supsup_ops.gemm_update_plain(x5c, x5a, s5b),
             lambda: torch.baddbmm(x5c, x5a, s5b, alpha=-1),
             2.0 * nr5 * k5 * m5,
             (2 * nr5 * m5 + nr5 * k5 + k5 * m5) * s, TOL, None),
            ("suprow_update", "suprow_update",
             "src/repro/kernels/suprow/kernel.py:21",
             "src/repro_torch/csrc/suprow.cu",
             f"x (1, {k6} + {m6}) src (1, {k6}, {k6} + {m6})",
             lambda: suprow_ops.suprow_update(x6, s6, k6),
             lambda: suprow_ops.suprow_update_plain(x6, s6, k6),
             lambda: (lambda y_: (y_, x6[:, k6:] - torch.matmul(
                 y_, s6[:, :, k6:])[:, 0]))(torch.linalg.solve_triangular(
                     s6[:, :, :k6], x6k, upper=True, left=False)),
             float(k6 * k6 + 2 * k6 * m6),
             (2 * (k6 + m6) + k6 * (k6 + 1) // 2 + k6 * m6) * s, TOL, None),
        ]

    def held(name, dname, tol, got, ref, what=""):
        """Check kernel output against plain output; returns the max
        error and, for a panel LU, (rows moved by pivoting, pivots
        perturbed)."""
        torch.cuda.synchronize()
        moved = None
        if name.startswith("panel_lu"):             # (panels, perm, nper)
            check(torch.equal(got[1], ref[1]),
                  f"{name} {dname}{what}: pivot permutations differ")
            check(torch.equal(got[2], ref[2]),
                  f"{name} {dname}{what}: perturbation counts differ")
            ident = torch.arange(got[1].shape[-1], device=dev)
            moved = (int((got[1] != ident).sum()), int(got[2].sum()))
            got, ref = got[0], ref[0]
        pairs = (list(zip(got, ref)) if isinstance(got, tuple)
                 else [(got, ref)])
        err = max(float((g - r).abs().max()) for g, r in pairs)
        check(all(bool(torch.allclose(g, r, rtol=tol, atol=tol))
                  for g, r in pairs),
              f"{name} {dname}{what}: max |kernel - plain| = {err} "
              f"outside rtol=atol={tol}")
        if dname == "float64" and name in REL_TOL_F64:
            rel = err / max(float(r.abs().max()) for _, r in pairs)
            check(rel <= REL_TOL_F64[name], f"{name} {dname}{what}: "
                  f"relative error {rel} > {REL_TOL_F64[name]}")
            records[name]["max_rel_err"] = rel
        return err, moved

    records = {}
    for dt in (torch.float64, torch.float32):
        dname = str(dt).replace("torch.", "")
        for (name, wrapper, replaces, source, shape, kern, plain, lib, flops,
             nbytes, tol, shuf) in cases(dt):
            rec = records.setdefault(name, {
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "wrapper": wrapper, "shape": shape})
            err, moved = held(name, dname, tol[dname], kern(), plain())
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
    # K1 and K2 with an exactly zero pivot under a zero threshold: the first
    # block column of one panel set to zero.  The Pallas arithmetic turns
    # the masked terms into 0 * inf = NaN (csrc/panel_lu.cu, "Non-finite
    # steps"); the kernel must give the plain version's NaN and inf
    # positions and its finite values.
    zero_cases = [("panel_lu_bucketed", P1[:1], 0, pb.wu,
                   lambda p_, e_: panel_ops.panel_lu_batched(p_, pb.wu, e_)),
                  ("panel_lu", P2[:1], nd.lsize, nd.width,
                   lambda p_, e_: panel_ops.panel_lu(p_, nd.nr, nd.lsize,
                                                     e_))]
    for name, P, c0, wlim, kern in zero_cases:
        for dt in (torch.float64, torch.float32):
            dname = str(dt).replace("torch.", "")
            Z = P.to(dt).clone()
            Z[:, :, c0] = 0.0
            ez = torch.zeros(1, dtype=dt, device=dev)
            got = kern(Z, ez)
            ref = panel_ops.panel_lu_plain(Z, c0, wlim, ez)
            torch.cuda.synchronize()
            what = f"{name} {dname} (zero pivot, eps = 0)"
            check(torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]),
                  f"{what}: pivots or perturbation counts differ")
            g, r = got[0], ref[0]
            check(torch.equal(torch.isnan(g), torch.isnan(r))
                  and torch.equal(torch.isinf(g), torch.isinf(r)),
                  f"{what}: NaN or inf positions differ")
            fin = torch.isfinite(r)
            err = float((g[fin] - r[fin]).abs().max())
            check(bool(torch.allclose(g[fin], r[fin], rtol=TOL[dname],
                                      atol=TOL[dname])),
                  f"{what}: finite values differ by {err}")
            sfx = "" if dname == "float64" else "_f32"
            records[name].update({
                "zero_pivot_nan" + sfx: int(torch.isnan(r).sum()),
                "zero_pivot_finite" + sfx: int(fin.sum()),
                "zero_pivot_max_abs_err" + sfx: err})

    records["gemm_update"]["edges"] = edges5
    records["suprow_update"]["edges"] = edges6
    out = list(records.values())
    emit({"phase": "kernels", "dtypes": ["float64", "float32"],
          "records": out, "seconds": time.perf_counter() - t})
    return out


def scalar_phase(torch, np, kernels, A, an64, an_u, an32):
    """Phase 7: factor -> refactor -> solve of one system at fem2d_10k under
    both schedules (float64) and with float32 factors; returns the launches
    of the whole phase by wrapper."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from repro_torch.core import (CSR, factor, refactor, solve,
                                  torch_repeated_engine)

    t_all = time.perf_counter()
    rng = np.random.default_rng(9)
    v1, v2 = (A.data * rng.uniform(0.8, 1.2, A.nnz) for _ in range(2))
    A1 = CSR(A.n, A.indptr, A.indices, v1)
    A2 = CSR(A.n, A.indptr, A.indices, v2)
    b = rng.normal(size=A.n)
    xr = spla.spsolve(sp.csr_matrix((v2, A.indices, A.indptr),
                                    shape=(A.n, A.n)).tocsc(), b)
    nodes = an64.plan.nodes
    n_supsup = sum(1 for nd in nodes for e in nd.edges
                   if nd.nr > 1 and nodes[e.src].nr > 1)
    n_wide = sum(1 for nd in nodes if nd.nr > 1)
    total = dict.fromkeys(kernels.launch_counts(), 0)
    res, states = {}, {}
    for label, an in (("bucketed", an64), ("unrolled", an_u),
                      ("bucketed_f32", an32)):
        torch_repeated_engine(an)               # built outside the timing
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        st = factor(an, A1)
        t_factor = time.perf_counter() - t0
        per_factor = kernels.launch_counts()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        st = refactor(st, A2)
        t_refactor = time.perf_counter() - t0
        per_refactor = kernels.launch_counts()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        x, info = solve(st, b)
        t_solve = time.perf_counter() - t0
        per_solve = kernels.launch_counts()
        for w in total:
            total[w] += per_factor[w] + per_refactor[w] + per_solve[w]
        states[label] = st.torch_factors
        res[label] = {
            "factor_ms": t_factor * 1e3, "refactor_ms": t_refactor * 1e3,
            "solve_ms": t_solve * 1e3, "residual": info["residual"],
            "n_refine": info["n_refine"], "n_perturb": info["n_perturb"],
            "refine_failed": info["refine_failed"],
            "scipy_rel_err": float(np.abs(x - xr).max() / np.abs(xr).max()),
            "launches_per_refactor": {w: c for w, c in per_refactor.items()
                                      if c}}
    fb, fu = states["bucketed"], states["unrolled"]
    unrolled_vs_bucketed = float((fu.vals - fb.vals).abs().max())
    same_pivots = bool(torch.equal(fu.inode_perm, fb.inode_perm))
    u_counts = res["unrolled"]["launches_per_refactor"]
    emit({"phase": "scalar", "matrix": "fem2d_10k", "runs": res,
          "unrolled_vs_bucketed_max_abs": unrolled_vs_bucketed,
          "same_inode_perm": same_pivots,
          "plan_supsup_edges": n_supsup, "plan_wide_nodes": n_wide,
          "seconds": time.perf_counter() - t_all})
    for label, r in res.items():
        check(r["residual"] <= 1e-10, f"scalar {label}: residual "
                                      f"{r['residual']} > 1e-10")
        check(r["scipy_rel_err"] <= 1e-10, f"scalar {label}: spsolve "
                                           f"disagreement {r['scipy_rel_err']}")
        check(not r["refine_failed"], f"scalar {label}: refine_failed")
    check(same_pivots, "unrolled and bucketed pivots differ")
    check(int(fu.n_perturb) == int(fb.n_perturb),
          "unrolled and bucketed perturbation counts differ")
    check(unrolled_vs_bucketed <= 1e-10,
          f"unrolled vs bucketed factors {unrolled_vs_bucketed} > 1e-10")
    check(u_counts.get("gemm_update", 0) == n_supsup > 0,
          f"K5 launches per unrolled refactor {u_counts} != {n_supsup}")
    check(u_counts.get("trsm_batched", 0) == n_supsup,
          f"K3 launches per unrolled refactor {u_counts} != {n_supsup}")
    check(u_counts.get("panel_lu", 0) == n_wide > 0,
          f"K2 launches per unrolled refactor {u_counts} != {n_wide}")
    b_counts = res["bucketed"]["launches_per_refactor"]
    for w in ("panel_lu_batched", "panel_lu", "trsm_batched",
              "gemm_batched"):
        check(b_counts.get(w, 0) > 0,
              f"kernel {w} was not launched by the bucketed refactor")
    return total


def plain_phase(torch, np, kernels, A, an64, bst, values0, b, t_factor,
                t_solve):
    """Phase 8: one batched step with use_kernels=False (plain factor
    program, level-scheduled substitution) beside the kernel route."""
    from repro_torch.core import (HyluOptions, analyze, factor_batched,
                                  solve_batched, torch_repeated_engine)

    t_all = time.perf_counter()
    an_p = analyze(A, HyluOptions(use_kernels=False), reuse=an64)
    eng_p = torch_repeated_engine(an_p)
    eng_k = torch_repeated_engine(an64)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    bst_p = factor_batched(an_p, A, values0)
    t_factor_p = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_p, info_p = solve_batched(bst_p, b)
    t_solve_p = time.perf_counter() - t0
    moved = {w: c for w, c in kernels.launch_counts().items() if c}
    # one substitution of the same factors by each schedule
    b_dev = torch.from_numpy(b).to(eng_k.device)
    apply_level = bench_ms(torch, lambda: eng_p.apply_batched(
        bst.vals, bst.inode_perm, b_dev), min_ms=0.0)
    apply_block = bench_ms(torch, lambda: eng_k.apply_batched(
        bst.vals, bst.inode_perm, b_dev), min_ms=0.0)
    levels = {name: len(getattr(eng_p.ss, name).rows)
              for name in ("l_fwd", "u_bwd")}
    emit({"phase": "plain", "matrix": "fem2d_10k", "k": K_MAIN,
          "factor_batched_ms": t_factor_p * 1e3,
          "solve_batched_ms": t_solve_p * 1e3,
          "kernel_route_factor_batched_ms": t_factor * 1e3,
          "kernel_route_solve_batched_ms": t_solve * 1e3,
          "apply_level_scheduled_ms": apply_level,
          "apply_node_block_ms": apply_block,
          "levels": levels, "block_nodes": len(eng_k._blocks),
          "max_residual": float(info_p["residual"].max()),
          "refine_iters": info_p["n_refine"], "kernel_launches": moved,
          "seconds": time.perf_counter() - t_all})
    check(not moved, f"use_kernels=False launched kernels: {moved}")
    check(np.isfinite(x_p).all() and info_p["residual"].max() <= 1e-10,
          f"use_kernels=False residual {info_p['residual'].max()}")


if __name__ == "__main__":
    sys.exit(main())
