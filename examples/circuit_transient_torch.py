"""Repeated-solve production scenario (paper §3.2) on the PyTorch port:
transient circuit simulation — one analysis, many refactor + solve steps —
then batched corner and multi-RHS sweeps and a T-step × K-corner stream
(the port of ``examples/circuit_transient.py``).

A linear RC network driven by a time-varying source, backward-Euler
integration:  (G + C/dt) v_t = C/dt v_{t-1} + i(t).  The matrix values
change every step while the sparsity pattern is fixed — HYLU's
repeated-solve case.  The paths:

  ref            the numpy reference engine (looped refactor + solve)
  torch          the port's engine per step (``factor`` → ``refactor`` →
                 ``solve``; on the card, its CUDA kernels)
  torch-batched  K Monte-Carlo conductance corners factored and solved as
                 one batch (``solve_sequence``), also with M right-hand
                 sides per corner

and the finale: T transient steps × K corners through ``solve_sequence``'s
double-buffered pipeline with buffer donation (``HyluOptions(donate=
True)``): each step's values are staged while the step before is factored
and solved, and each refactor reuses the step before's factor buffers.

    PYTHONPATH=src python examples/circuit_transient_torch.py \\
        [--n 240] [--steps 20] [--corners 32] [--device cuda|cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.core import (CSR, HyluOptions, analyze, factor, refactor,
                              solve, solve_sequence)
from repro_torch.matrices import circuit_like


def rc_network(n, seed=0):
    g = circuit_like(n, seed).tocsr()
    rng = np.random.default_rng(seed)
    c = rng.uniform(1e-12, 1e-9, n)          # node capacitances
    return g, c


def transient(an, A0, c, n_steps, dt, engine):
    """Backward-Euler time stepping on one engine; returns (v, refactor s,
    solve s)."""
    n = A0.n
    rng = np.random.default_rng(7)
    diag_idx = np.where(A0.indices == np.repeat(
        np.arange(n), np.diff(A0.indptr)))[0]
    v = np.zeros(n)
    st = None
    t_fac = t_sol = 0.0
    for step in range(n_steps):
        dt_k = dt * (1.0 + 0.5 * np.sin(step / 5.0))     # variable step
        data = A0.data.copy()
        data[diag_idx] += c / dt_k
        Ak = CSR(n, A0.indptr, A0.indices, data)
        t0 = time.perf_counter()
        st = refactor(st, Ak) if st is not None else factor(an, Ak,
                                                            engine=engine)
        t_fac += time.perf_counter() - t0
        i_src = np.zeros(n)
        i_src[rng.integers(0, n, 5)] = rng.normal(size=5)
        rhs = c / dt_k * v + i_src
        t0 = time.perf_counter()
        v, info = solve(st, rhs)
        t_sol += time.perf_counter() - t0
        assert info["residual"] < 1e-8, (engine, step, info)
    return v, t_fac, t_sol


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=240)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--corners", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n, n_steps = args.n, args.steps
    dt = 1e-6
    opts = HyluOptions(device=args.device)

    g, c = rc_network(n)
    A0 = CSR.from_scipy(g)

    t0 = time.perf_counter()
    an = analyze(A0, opts)
    t_analyze = time.perf_counter() - t0
    print(f"analysis: {t_analyze*1e3:.0f} ms "
          f"(n={n}, mode={an.choice.mode}, ordering={an.ordering_name})")

    # ---- sequential transient: ref vs the port's engine -------------------
    v_ref, fac_ref, sol_ref = transient(an, A0, c, n_steps, dt, "ref")
    print(f"[ref]   {n_steps} steps: refactor {fac_ref*1e3:7.1f} ms, "
          f"solve {sol_ref*1e3:7.1f} ms")

    t0 = time.perf_counter()
    st_warm = factor(an, A0, engine="torch")   # build the engine up front
    solve(st_warm, np.zeros(n))
    t_build = time.perf_counter() - t0
    v_dev, fac_dev, sol_dev = transient(an, A0, c, n_steps, dt, "torch")
    print(f"[torch] {n_steps} steps: refactor {fac_dev*1e3:7.1f} ms, "
          f"solve {sol_dev*1e3:7.1f} ms (+{t_build:.1f} s engine build, "
          f"{args.device})")
    assert np.abs(v_ref - v_dev).max() <= 1e-8 * (1 + np.abs(v_ref).max())

    # ---- batched Monte-Carlo corner sweep ---------------------------------
    k = args.corners
    rng = np.random.default_rng(42)
    vb = A0.data[None, :] * rng.uniform(0.8, 1.2, (k, A0.nnz))
    i_dc = np.zeros(n)
    i_dc[rng.integers(0, n, 8)] = rng.normal(size=8)
    t0 = time.perf_counter()
    x, info = solve_sequence(A0, vb, i_dc, opts)
    t_batch = time.perf_counter() - t0
    print(f"[torch-batched] {k} conductance corners in one batch: "
          f"{t_batch*1e3:.0f} ms total (analysis included), "
          f"max residual {float(info['residual'].max()):.2e}")
    assert float(info["residual"].max()) < 1e-8

    # per-corner spread of the DC operating point — the payoff of the sweep
    spread = np.abs(x).max(axis=1)
    print(f"corner spread of |v|max: {spread.min():.3e} … {spread.max():.3e}")

    # ---- multi-RHS: per-corner sensitivity to M source sets, b (K, n, M) --
    m_src = 4
    bm = np.zeros((k, n, m_src))
    for j in range(m_src):
        bm[:, rng.integers(0, n, 6), j] = rng.normal(size=6)
    t0 = time.perf_counter()
    xs, info_m = solve_sequence(A0, vb, bm, opts)
    t_multi = time.perf_counter() - t0
    print(f"[torch-batched] multi-RHS sensitivity sweep x{m_src}: "
          f"x {xs.shape}, residual (K, M) max "
          f"{float(info_m['residual'].max()):.2e}, {t_multi*1e3:.0f} ms")
    assert xs.shape == (k, n, m_src)
    assert float(info_m["residual"].max()) < 1e-8

    # ---- the pipeline: T transient steps × K corners, donating -------------
    # Each step's K corner matrices are factored and solved as one batch
    # while the next step's values are staged; donation lets each refactor
    # reuse the step before's factor buffers.  The right-hand sides are
    # per-step source vectors, independent across steps.
    t_seq_steps = min(args.steps, 8)
    diag_idx = np.where(A0.indices == np.repeat(
        np.arange(n), np.diff(A0.indptr)))[0]
    steps_v, steps_b = [], []
    for step in range(t_seq_steps):
        dt_k = dt * (1.0 + 0.5 * np.sin(step / 5.0))
        data = A0.data.copy()
        data[diag_idx] += c / dt_k
        steps_v.append(data[None, :] * rng.uniform(0.8, 1.2, (k, A0.nnz)))
        b_t = np.zeros((k, n))
        b_t[:, rng.integers(0, n, 5)] = rng.normal(size=5)
        steps_b.append(b_t)
    opts_seq = HyluOptions(device=args.device, donate=True)
    t0 = time.perf_counter()
    xt, info_t = solve_sequence(A0, steps_v, steps_b, opts_seq)
    t_seq = time.perf_counter() - t0
    print(f"[torch-pipeline] {t_seq_steps} steps x {k} corners, "
          f"double-buffered + donating: x {xt.shape}, max residual "
          f"{float(info_t['residual'].max()):.2e}, {t_seq*1e3:.0f} ms total "
          f"(analysis included)")
    assert xt.shape == (t_seq_steps, k, n)
    assert info_t["donate"] and info_t["steps"] == t_seq_steps
    assert float(info_t["residual"].max()) < 1e-8
    print("OK")


if __name__ == "__main__":
    main()
