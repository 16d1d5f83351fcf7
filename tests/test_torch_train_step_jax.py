"""Two training steps of the port against the JAX package's
``make_train_step`` (jitted), on the CPU, float32 at ``.reduced()``: with
``microbatch`` 1 and 2 and each compression kind, from the same params,
optimizer state, error state and numpy-seeded batches (the JAX state carried
across by ``models.convert``).

Tolerances: the metrics (``loss``, ``ce``, ``grad_norm``, ``moe_lb``,
``moe_z``) within 1e-5 relative, ``lr`` one float32 ulp; m and v within
1e-3 of each leaf's largest entry (the gradients agree to about 1e-6, a
top-k near-tie of the reduced MoE router can flip after the first update);
params: at least 99.9% of the entries within 1e-3 of ``lr`` (the update's
scale; measured shares beyond it 0.3–1.8e-4) and every entry within
0.2 lr.  Adam's first steps move an entry by about lr · g / (|g| + eps):
an entry whose gradient is noise near eps = 1e-8 moves by a sizeable part
of lr when the float32 summation order changes that noise, so the
entry-by-entry bound sits well above 1e-3 lr (measured worst entries:
0.012 lr without compression, 0.080 lr with it, rwkv6 int8; the bound
keeps 2.5 times the worst).  With compression a gradient that
sits on a rounding boundary rounds the other way in the other package, so
there: the error state, at least 90% of its entries within 1e-2 of the
leaf's largest error (an error is a few thousandths of its gradient, so the
gradients' own 1e-6 shows there as 1e-3; measured medians 0.7–2.2e-3) and
none by more than about one quantization step (|e| <= step / 2, and the
largest error sits near it: 2.5 times the largest error; measured 2.0001);
m and v within 1e-2 of each leaf's largest entry (a step of int8 is 1/127
of the largest gradient); params at least 99% of the entries within 1e-3
of ``lr`` (measured 0.2% for bf16) and every entry within 0.2 lr.
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
from repro.train import train_step as JTS  # noqa: E402
from repro_torch import tree as tr  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models.convert import (opt_state_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim import compression as TC  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

B, S, SEQ_CHUNK = 4, 16, 8
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


# -------------------------------------------------------------- the step
STEP_CASES = [("qwen3-moe-30b-a3b", mb, kind) for mb in (1, 2)
              for kind in ("none", "bf16", "int8")] + [
    ("qwen2-vl-7b", 2, "none"), ("rwkv6-1.6b", 1, "int8")]


def _batch(cfg, step):
    rng = np.random.default_rng(100 + step)
    out = dict(labels=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    out["labels"][0, :3] = -1
    if cfg.embeddings_input:
        out["embeds"] = (rng.normal(size=(B, S, cfg.d_model))
                         * 0.02).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.rope_type == "mrope":
        pos = np.arange(S, dtype=np.int32)[None, None] + np.arange(
            B, dtype=np.int32)[None, :, None]
        out["positions"] = np.stack([pos[0], pos[0] // 2, pos[0] % 5])
    return out


def _hold_error_state(je, te):
    for p, a, b in _pairs(je, te):
        emax = np.abs(a).max()
        d = np.abs(a - b)
        assert d.max() <= 2.5 * emax, p
        assert (d > 1e-2 * emax).mean() <= 0.1, p


@pytest.mark.parametrize("name,microbatch,kind", STEP_CASES)
def test_train_step_matches_jax(name, microbatch, kind):
    jcfg = jreg.get(name).reduced()
    tcfg = treg.get(name).reduced()
    params = JT.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    jstep = jax.jit(JTS.make_train_step(
        jcfg, JA.AdamWConfig(**OPT), JC.CompressionConfig(kind),
        microbatch=microbatch, seq_chunk=SEQ_CHUNK))
    tstep = TS.make_train_step(tcfg, TA.AdamWConfig(**OPT),
                               TC.CompressionConfig(kind),
                               microbatch=microbatch, seq_chunk=SEQ_CHUNK)
    jo = JA.init_state(params)
    je = JC.init_error_state(params, JC.CompressionConfig(kind))
    jp = params
    tp = params_from_numpy(_np(params), device="cpu")
    to = opt_state_from_numpy(_np(jo), device="cpu")
    te = None if je is None else params_from_numpy(_np(je), device="cpu")
    for s in range(2):
        b = _batch(jcfg, s)
        jp, jo, je, jm = jstep(jp, jo, je,
                               {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, te, tm = tstep(tp, to, te,
                               {k: torch.from_numpy(v) for k, v in b.items()})
        assert sorted(tm) == sorted(jm)
        for k in jm:
            if k == "lr":
                np.testing.assert_array_max_ulp(tm[k].numpy(),
                                                np.asarray(jm[k]), maxulp=1)
            else:
                assert abs(float(tm[k]) - float(jm[k])) \
                    <= 1e-5 * max(abs(float(jm[k])), 1.0), (s, k)
    assert int(to.step) == 2
    lr = float(jm["lr"])
    far_share, mv = (1e-3, 1e-3) if kind == "none" else (1e-2, 1e-2)
    n_far = n_all = 0
    for p, a, b in _pairs(jp, tp):
        d = np.abs(a - b) / lr
        assert d.max() <= 0.2, (p, d.max())
        n_far += int((d > 1e-3).sum())
        n_all += d.size
    assert n_far <= far_share * n_all, (n_far, n_all)
    for ref, got in ((jo.m, to.m), (jo.v, to.v)):
        for p, a, b in _pairs(ref, got):
            assert np.abs(a - b).max() <= mv * np.abs(a).max(), p
    if kind == "none":
        assert je is None and te is None
    else:
        _hold_error_state(je, te)


def test_microbatches_split_positions_on_the_batch_axis():
    """A (3, B, S) positions array splits on its second axis, as the JAX
    step's test; the loss of two microbatches is the mean of the halves."""
    x = torch.arange(3 * 4 * 5).reshape(3, 4, 5)
    np.testing.assert_array_equal(TS._split(x, 2, 1).numpy(),
                                  x.numpy()[:, 2:])
    y = torch.arange(4 * 5).reshape(4, 5)
    np.testing.assert_array_equal(TS._split(y, 2, 0).numpy(), y.numpy()[:2])


def test_value_and_grad_gives_zeros_for_unreached_leaves():
    """A config fed by embeddings alone never reads ``embed``: its gradient
    is zeros, as ``jax.value_and_grad`` gives it."""
    cfg = treg.get("musicgen-medium").reduced()
    from repro_torch.models import transformer as T

    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    b = _batch(cfg, 0)
    _, _, g = TS.value_and_grad(cfg, params,
                                {k: torch.from_numpy(v) for k, v in b.items()},
                                SEQ_CHUNK)
    assert torch.count_nonzero(g["embed"]) == 0
    assert g["embed"].shape == params["embed"].shape
    assert torch.count_nonzero(g["lm_head"]) > 0
