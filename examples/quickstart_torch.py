"""Quickstart on the PyTorch/CUDA port: solve a sparse system Ax=b.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]

The port of ``examples/quickstart.py``: the same system through
``repro_torch.core.solve_system`` (host analysis, then the factor and the
refined solve on the device; on the card, its CUDA kernels).
"""
import argparse

import numpy as np
import scipy.sparse as sp

from repro_torch.core import CSR, HyluOptions, solve_system


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--n", type=int, default=2500)
    args = ap.parse_args(argv)

    # build a small FEM-ish system
    nx = int(np.sqrt(args.n))
    e = np.ones(nx)
    t = sp.diags([-e[:-1], 2 * e, -e[:-1]], [-1, 0, 1])
    a = sp.kronsum(t, t).tocsr()
    a = a + sp.diags(np.random.default_rng(0).uniform(0, 0.1, a.shape[0]))
    b = np.random.default_rng(1).normal(size=a.shape[0])

    A = CSR.from_scipy(a)
    x, info = solve_system(A, b, HyluOptions(device=args.device))

    print(f"n={A.n} nnz={A.nnz} device={args.device}")
    print(f"kernel mode selected : {info['mode']}")
    print(f"ordering selected    : {info['ordering']}")
    print(f"residual |Ax-b|/|b|  : {info['residual']:.3e}")
    print(f"pivot perturbations  : {info['n_perturb']}")
    print(f"refinement steps     : {info['n_refine']}")
    t = info["timings"]
    print(f"preprocess {t['preprocess']['total']*1e3:.1f} ms | "
          f"factor {t['factor']['factor']*1e3:.1f} ms")
    assert info["residual"] < 1e-10
    assert np.abs(a @ x - b).max() <= 1e-8 * np.abs(b).max()
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
