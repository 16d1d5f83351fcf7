"""Differentiable sparse solve on the PyTorch port: learn circuit
conductances from observed node voltages by gradient descent THROUGH the
HYLU solver (the port of ``examples/learn_conductances.py``).

The forward pass solves G(θ) v = i with the port's engine (on the card,
its CUDA kernels); ``loss.backward()`` runs the adjoint solve on the same
LU factors (``repro_torch.core.make_sparse_solve``) — one factorization and
two pairs of triangular solves per training step.

    PYTHONPATH=src python examples/learn_conductances_torch.py \\
        [--device cuda|cpu] [--iters 150]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import CSR, HyluOptions, analyze, make_sparse_solve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=150)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    rng = np.random.default_rng(0)
    n = 120
    # random resistor network (Laplacian + ground leaks)
    m = 4 * n
    r = rng.integers(0, n, m)
    c = np.clip(r + rng.integers(1, 6, m), 0, n - 1)
    keep = r != c
    r, c = r[keep], c[keep]
    g_true = rng.uniform(0.5, 2.0, len(r))

    def laplacian_data(g):
        # CSR.from_coo keeps the union pattern whatever the values, so the
        # sparsity pattern is the same for every g (one analysis)
        d = np.bincount(r, g, n) + np.bincount(c, g, n) + 0.1
        rows = np.concatenate([r, c, np.arange(n)])
        cols = np.concatenate([c, r, np.arange(n)])
        vals = np.concatenate([-g, -g, d])
        return CSR.from_coo(n, rows, cols, vals)

    A_true = laplacian_data(g_true)
    an = analyze(A_true, HyluOptions(device=args.device))
    solve = make_sparse_solve(an)

    i_src = torch.from_numpy(rng.normal(size=n)).to(dev)
    with torch.no_grad():
        v_obs = solve(torch.from_numpy(A_true.data).to(dev), i_src)

    # differentiable assembly: data = M @ g + d0 (linear in g)
    nnz = laplacian_data(np.ones(len(r))).nnz
    M = np.zeros((nnz, len(r)))
    base = laplacian_data(np.zeros(len(r))).data
    for k in range(len(r)):
        gk = np.zeros(len(r))
        gk[k] = 1.0
        M[:, k] = laplacian_data(gk).data - base
    M = torch.from_numpy(M).to(dev)
    d0 = torch.from_numpy(base).to(dev)
    g_ref = torch.from_numpy(g_true).to(dev)

    def loss_fn(theta):
        v = solve(M @ torch.exp(theta) + d0, i_src)
        return torch.mean((v - v_obs) ** 2)

    # Adam on log-conductances (the update of the JAX example)
    theta = torch.zeros(len(r), dtype=torch.float64, device=dev,
                        requires_grad=True)
    m_ = torch.zeros_like(theta)
    v_ = torch.zeros_like(theta)
    lr = 0.05
    with torch.no_grad():
        l0 = float(loss_fn(theta))
    for it in range(args.iters):
        theta.grad = None
        loss_fn(theta).backward()
        with torch.no_grad():
            g_ = theta.grad
            m_ = 0.9 * m_ + 0.1 * g_
            v_ = 0.999 * v_ + 0.001 * g_ * g_
            theta -= lr * m_ / (torch.sqrt(v_ / (1 - 0.999 ** (it + 1)))
                                + 1e-8) / (1 - 0.9 ** (it + 1)) * \
                (1 - 0.9 ** (it + 1))
            if it % 25 == 0:
                err = float((torch.exp(theta) - g_ref).abs().mean())
                print(f"iter {it:3d} loss {float(loss_fn(theta)):.3e} "
                      f"mean|g-g*| {err:.3f}")
    with torch.no_grad():
        final = float(loss_fn(theta))
    print(f"loss: {l0:.3e} → {final:.3e} ({l0/final:.0f}x reduction)")
    assert final < l0 / 50
    print("OK")


if __name__ == "__main__":
    main()
