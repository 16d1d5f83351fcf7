"""The port's differentiable solve (``repro_torch.core.make_sparse_solve``)
against the JAX package's (``repro.core.autodiff.make_sparse_solve``, a
``jax.custom_vjp``), and the two solver examples that use the port.

On the CPU (``device="cpu"``: the kernels' plain versions), on
``tests.helpers.random_system(40, 0.12, 37)`` in each kernel mode: x and
both gradients of a weighted sum of x against ``jax.grad`` at 1e-10 (the
two packages sum in other orders), multi-RHS b (n, 3) against the JAX
solve ``vmap``ped over columns, a central finite-difference check at 1e-4,
the adjoint pair of the substitution (⟨U⁻¹L⁻¹c, d⟩ = ⟨c, L⁻ᵀU⁻ᵀd⟩ within
1e-9) and the fused multi-RHS ``solve_batched`` within 1e-9.  The examples
run at a small size in a subprocess and must print ``OK``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import HyluOptions as JaxOptions  # noqa: E402
from repro.core import analyze as jax_analyze  # noqa: E402
from repro.core.autodiff import make_sparse_solve as jax_sparse_solve  # noqa: E402
from repro_torch.core import (CSR, HyluOptions, analyze,  # noqa: E402
                              factor_batched, make_sparse_solve,
                              solve_batched, torch_repeated_engine)

from tests.helpers import random_system  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-10
MODES = ["rowrow", "hybrid", "supernodal"]


@pytest.fixture(scope="module")
def system():
    aj, a_sp, b = random_system(40, 0.12, 37)
    at = CSR(aj.n, aj.indptr, aj.indices, aj.data)
    w = np.random.default_rng(11).normal(size=aj.n)
    return aj, at, a_sp, b, w


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return np.abs(x - ref).max() / (np.abs(ref).max() + 1e-300)


def _port_grads(solve, a, b, w):
    """x, ā and b̄ of sum(w · solve(a, b)) through ``backward()``."""
    a_t = torch.tensor(a, requires_grad=True)
    b_t = torch.tensor(b, requires_grad=True)
    x = solve(a_t, b_t)
    (torch.from_numpy(w) * x).sum().backward()
    return x.detach().numpy(), a_t.grad.numpy(), b_t.grad.numpy()


@pytest.mark.parametrize("mode", MODES)
def test_grads_match_jax(mode, system):
    aj, at, a_sp, b, w = system
    fj = jax_sparse_solve(jax_analyze(aj, JaxOptions(force_mode=mode,
                                                     engine="jax")))
    ga, gb = jax.jit(jax.grad(
        lambda a_, b_: jnp.sum(jnp.asarray(w) * fj(a_, b_)),
        argnums=(0, 1)))(jnp.asarray(aj.data), jnp.asarray(b))
    an = analyze(at, HyluOptions(force_mode=mode, device="cpu"))
    assert an.choice.mode == mode
    x, a_bar, b_bar = _port_grads(make_sparse_solve(an), aj.data, b, w)
    assert _rel(x, jax.jit(fj)(jnp.asarray(aj.data), jnp.asarray(b))) < TOL
    assert _rel(a_bar, ga) < TOL
    assert _rel(b_bar, gb) < TOL
    assert _rel(a_sp @ x, b) < TOL


def test_multi_rhs_matches_jax_vmap(system):
    """b (n, 3): the columns solved together, ā summed over them, against
    the JAX solve ``vmap``ped over columns."""
    aj, at, a_sp, b, w = system
    rng = np.random.default_rng(3)
    B = rng.normal(size=(aj.n, 3))
    W = rng.normal(size=(aj.n, 3))
    fj = jax.vmap(jax_sparse_solve(jax_analyze(aj, JaxOptions(
        force_mode="hybrid", engine="jax"))), in_axes=(None, 1), out_axes=1)
    ga, gb = jax.jit(jax.grad(
        lambda a_, b_: jnp.sum(jnp.asarray(W) * fj(a_, b_)),
        argnums=(0, 1)))(jnp.asarray(aj.data), jnp.asarray(B))
    solve = make_sparse_solve(analyze(at, HyluOptions(force_mode="hybrid",
                                                      device="cpu")))
    x, a_bar, b_bar = _port_grads(solve, aj.data, B, W)
    assert x.shape == (aj.n, 3)
    assert _rel(x, jax.jit(fj)(jnp.asarray(aj.data), jnp.asarray(B))) < TOL
    assert _rel(a_bar, ga) < TOL and _rel(b_bar, gb) < TOL


def test_grads_only_for_inputs_that_need_them(system):
    """A b that does not require grad gets none; ā is the same."""
    aj, at, a_sp, b, w = system
    solve = make_sparse_solve(analyze(at, HyluOptions(device="cpu")))
    _, a_bar, _ = _port_grads(solve, aj.data, b, w)
    a_t = torch.tensor(aj.data, requires_grad=True)
    b_t = torch.tensor(b)
    (torch.from_numpy(w) * solve(a_t, b_t)).sum().backward()
    assert b_t.grad is None
    assert np.array_equal(a_t.grad.numpy(), a_bar)


def test_finite_differences(system):
    """ā and b̄ against central differences of the loss (step 1e-6)."""
    aj, at, a_sp, b, w = system
    solve = make_sparse_solve(analyze(at, HyluOptions(force_mode="hybrid",
                                                      device="cpu")))
    _, a_bar, b_bar = _port_grads(solve, aj.data, b, w)

    def loss(a, bb):
        with torch.no_grad():
            return float((torch.from_numpy(w) * solve(
                torch.from_numpy(a), torch.from_numpy(bb))).sum())

    h = 1e-6
    rng = np.random.default_rng(5)
    for i in rng.choice(aj.nnz, 6, replace=False):
        e = np.zeros(aj.nnz)
        e[i] = h
        fd = (loss(aj.data + e, b) - loss(aj.data - e, b)) / (2 * h)
        assert abs(fd - a_bar[i]) < 1e-4 * (1 + abs(fd))
    for i in rng.choice(aj.n, 4, replace=False):
        e = np.zeros(aj.n)
        e[i] = h
        fd = (loss(aj.data, b + e) - loss(aj.data, b - e)) / (2 * h)
        assert abs(fd - b_bar[i]) < 1e-4 * (1 + abs(fd))


def test_lut_solve_is_the_adjoint_of_the_substitution(system):
    """⟨U⁻¹L⁻¹ c, d⟩ = ⟨c, L⁻ᵀU⁻ᵀ d⟩ on the engine's factors, and
    ``lut_solve`` of (n, m) is its columns' solves."""
    aj, at, a_sp, b, w = system
    eng = torch_repeated_engine(analyze(at, HyluOptions(force_mode="hybrid",
                                                        device="cpu")))
    f = eng.refactor(torch.from_numpy(aj.data))
    rng = np.random.default_rng(0)
    for _ in range(3):
        c = torch.from_numpy(rng.normal(size=aj.n))
        d = torch.from_numpy(rng.normal(size=aj.n))
        lhs = float(eng._level_solve(f.vals[None], c[None, :, None])[0, :, 0]
                    @ d)
        rhs = float(c @ eng.lut_solve(f.vals, d))
        assert abs(lhs - rhs) < 1e-9 * (1 + abs(lhs))
    D = torch.from_numpy(rng.normal(size=(aj.n, 3)))
    cols = torch.stack([eng.lut_solve(f.vals, D[:, j]) for j in range(3)], 1)
    torch.testing.assert_close(eng.lut_solve(f.vals, D), cols, rtol=1e-12,
                               atol=1e-12)


def test_fused_multi_rhs_solve_matches(system):
    """The fused batched solve of b (1, n, 3) against ``make_sparse_solve``
    of the same columns."""
    aj, at, a_sp, b, w = system
    an = analyze(at, HyluOptions(device="cpu"))
    B = np.random.default_rng(9).normal(size=(aj.n, 3))
    x_f, info = solve_batched(factor_batched(an, at, aj.data[None]),
                              B[None])
    with torch.no_grad():
        x_d = make_sparse_solve(an)(torch.from_numpy(aj.data),
                                    torch.from_numpy(B)).numpy()
    assert _rel(x_f[0], x_d) < 1e-9
    assert info["residual"].shape == (1, 3)


@pytest.mark.parametrize("script,args", [
    ("learn_conductances_torch.py", ["--device", "cpu"]),
    ("circuit_transient_torch.py", ["--n", "60", "--steps", "3",
                                    "--corners", "4", "--device", "cpu"]),
])
def test_example_runs(script, args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                       script), *args],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "OK"
