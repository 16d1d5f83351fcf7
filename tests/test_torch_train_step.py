"""The port's optimizer and gradient compression against the JAX package,
on the CPU, from the same numpy-seeded params, state and gradients (the
JAX params carried across by ``models.convert``).

Tolerances, stated per check:
  - ``lr_schedule`` over steps 0–200: one float32 ulp of each value, plus,
    in the cosine phase, what one float32 ulp of ``cos`` moves it by
    (lr · (1 − min_lr_ratio) · 2^-25: torch's and XLA's ``cos`` give the
    two floats around the exact value, and 1 + cos near −1 cancels);
  - ``compress_grads`` on the same gradients and error state, over several
    error-feedback rounds: bit-equal (the same float32 operations; bf16 and
    ``round`` both round half to even);
  - ``apply_updates`` on the same gradients: params within 1e-4 of ``lr``
    (the update's scale; measured 1.2e-5: the norms and ``lr`` differ in
    the last bit), m and v within 1e-6 of each leaf's largest entry.
The whole step is held in ``test_torch_train_step_jax.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.optim import compression as JC  # noqa: E402
from repro_torch import tree as tr  # noqa: E402
from repro_torch.models.convert import (opt_state_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim import compression as TC  # noqa: E402

OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes: the suite runs six
    workers on a few cores, where idle-spinning thread pools slow them
    all."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pairs(jtree, ttree):
    """(path, reference leaf, port leaf) in the reference's order."""
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = tr.flatten_with_paths(ttree)
    assert len(jflat) == len(tflat)
    for (jp, a), (p, b) in zip(jflat, tflat):
        jpath = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in jp)
        assert jpath == p
        yield p, np.asarray(a), b.detach().numpy()


def _grads_like(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (rng.normal(size=p.shape) * rng.choice([1e-9, 1e-3, 1.0])
                   ).astype(np.float32), _np(params))


@pytest.fixture(scope="module")
def moe_params():
    cfg = jreg.get("qwen3-moe-30b-a3b").reduced()
    return cfg, JT.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)


# ------------------------------------------------------------------ adamw
def test_lr_schedule_matches_jax_within_one_ulp():
    for cfg in (dict(), dict(warmup_steps=7, total_steps=150),
                dict(lr=3e-3, warmup_steps=0, total_steps=60,
                     min_lr_ratio=0.0)):
        steps = np.arange(0, 201, dtype=np.int32)
        ref = np.asarray(JA.lr_schedule(JA.AdamWConfig(**cfg),
                                        jnp.asarray(steps)))
        got = TA.lr_schedule(TA.AdamWConfig(**cfg),
                             torch.from_numpy(steps)).numpy()
        assert got.dtype == np.float32
        c = TA.AdamWConfig(**cfg)
        cos_ulp = c.lr * (1 - c.min_lr_ratio) * 2.0 ** -25
        warm = steps <= c.warmup_steps
        np.testing.assert_array_max_ulp(got[warm], ref[warm], maxulp=1)
        bound = np.spacing(np.abs(ref)) + cos_ulp
        assert (np.abs(got - ref) <= bound).all(), np.abs(got - ref).max()


def test_global_norm_matches_jax(moe_params):
    _, params = moe_params
    g = _grads_like(params, 0)
    ref = float(JA.global_norm(jax.tree.map(jnp.asarray, g)))
    got = TA.global_norm(params_from_numpy(g, device="cpu"))
    assert got.dtype == torch.float32
    assert abs(float(got) - ref) <= 1e-6 * ref


@pytest.mark.parametrize("clip", [1.0, 1e6])
def test_apply_updates_matches_jax(moe_params, clip):
    """Two updates on the same gradients from the same state: clipped
    (``clip_norm`` 1) and unclipped."""
    _, params = moe_params
    ocfg = dict(OPT, clip_norm=clip)
    jp, jo = params, JA.init_state(params)
    tp = params_from_numpy(_np(params), device="cpu")
    to = opt_state_from_numpy(_np(JA.init_state(params)), device="cpu")
    jupd = jax.jit(lambda p, gg, o: JA.apply_updates(
        JA.AdamWConfig(**ocfg), p, gg, o))
    for s in range(2):
        g = _grads_like(params, 10 + s)
        jp, jo, jm = jupd(jp, jax.tree.map(jnp.asarray, g), jo)
        tp, to, tm = TA.apply_updates(TA.AdamWConfig(**ocfg), tp,
                                      params_from_numpy(g, device="cpu"), to)
        assert int(to.step) == int(jo.step) == s + 1
        np.testing.assert_array_max_ulp(tm["lr"].numpy(),
                                        np.asarray(jm["lr"]), maxulp=1)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
            <= 1e-6 * float(jm["grad_norm"])
    lr = float(jm["lr"])
    for p, a, b in _pairs(jp, tp):
        assert np.abs(a - b).max() <= 1e-4 * lr, p
    for ref, got in ((jo.m, to.m), (jo.v, to.v)):
        for p, a, b in _pairs(ref, got):
            assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max(), p


def test_adamw_state_is_float32_for_bf16_params():
    """bf16 params: float32 m and v, one rounding of the float32 update."""
    ocfg = TA.AdamWConfig(**OPT, clip_norm=1e9)
    p = {"w": torch.linspace(-1, 1, 64, dtype=torch.bfloat16)}
    st = TA.init_state(p)
    assert st.m["w"].dtype == st.v["w"].dtype == torch.float32
    assert st.step.dtype == torch.int32 and st.step.shape == ()
    g = {"w": torch.full((64,), 0.5, dtype=torch.bfloat16)}
    before = p["w"].float().clone()
    TA.apply_updates(ocfg, p, g, st)
    lr = TA.lr_schedule(ocfg, torch.tensor(1))
    upd = 0.5 / (torch.sqrt(torch.tensor(0.25)) + 1e-8) + 0.1 * before
    assert p["w"].dtype == torch.bfloat16
    torch.testing.assert_close(p["w"], (before - lr * upd).to(torch.bfloat16),
                               rtol=0, atol=0)
    torch.testing.assert_close(st.m["w"], torch.full((64,), 0.05),
                               rtol=1e-6, atol=0)


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("ef", [True, False])
def test_compress_grads_bit_equal_to_jax(kind, ef, moe_params):
    _, params = moe_params
    jcfg, tcfg = JC.CompressionConfig(kind, ef), TC.CompressionConfig(kind, ef)
    je = JC.init_error_state(params, jcfg)
    te = TC.init_error_state(params_from_numpy(_np(params), device="cpu"),
                             tcfg)
    assert (je is None) == (te is None) == (not ef)
    for s in range(3):
        g = _grads_like(params, 20 + s)
        jg, je = JC.compress_grads(jcfg, jax.tree.map(jnp.asarray, g), je)
        tg, te = TC.compress_grads(tcfg, params_from_numpy(g, device="cpu"),
                                   te)
        for _, a, b in _pairs(jg, tg):
            np.testing.assert_array_equal(b, a)
        if ef:
            for _, a, b in _pairs(je, te):
                np.testing.assert_array_equal(b, a)


def test_quant_int8_rounds_half_to_even():
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5, -127.0])
    q, scale = TC._quant_int8(g)
    jq, jscale = JC._quant_int8(jnp.asarray(g.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)


def test_compression_none_passes_grads_through():
    g = {"w": torch.ones(4)}
    out, err = TC.compress_grads(TC.CompressionConfig(), g, None)
    assert out["w"] is g["w"] and err is None
