"""The port's training loss and its gradients against the JAX package, on
the CPU, float32 at ``.reduced()``: ``ce_loss_chunked``, and ``loss_fn``
(forward on the plain route + chunked CE + the MoE aux terms) against
``jax.value_and_grad`` for a dense, an MoE, a hybrid Mamba + MoE, an RWKV6,
an M-RoPE (embeddings-fed) and an audio (embeddings-fed) config, from the
JAX package's own weights carried across (``models.convert``) and
numpy-seeded batches with −1 labels and a ``seq_chunk`` that does not
divide S.  The JAX loss and gradients are computed once per config
(module-scoped fixture).

Tolerances: the loss and the metrics within 1e-5 relative; each gradient
leaf within 1e-4 of its largest entry (the packages sum in other orders);
``ce_loss_chunked``'s gradients with respect to ``hidden`` and the head
within 1e-5 of their largest entry.  Remat on and off, and a chunk's
checkpoint against none, are bit-equal on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch import tree as tr  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

FAMILIES = ["phi3-medium-14b", "qwen3-moe-30b-a3b", "jamba-1.5-large-398b",
            "rwkv6-1.6b", "qwen2-vl-7b", "musicgen-medium"]
B, S, SEQ_CHUNK = 2, 24, 10            # 24 = 2 · 10 + 4: a padded chunk
LOSS_TOL, GRAD_TOL, CE_TOL = 1e-5, 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes: the suite runs six
    workers on a few cores, where idle-spinning thread pools slow them
    all."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    out = dict(labels=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    out["labels"][0, :3] = -1
    out["labels"][1, -5:] = -1
    if cfg.embeddings_input:
        out["embeds"] = (rng.normal(size=(B, S, cfg.d_model))
                         * 0.02).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.rope_type == "mrope":
        t = np.arange(S, dtype=np.int32)
        out["positions"] = np.broadcast_to(
            np.stack([t, t // 4, t % 4])[:, None], (3, B, S)).copy()
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module", params=FAMILIES)
def ref(request):
    name = request.param
    cfg = jreg.get(name).reduced()
    params = JT.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    b = _batch(cfg)
    f = jax.jit(jax.value_and_grad(
        lambda p, bb: JTS.loss_fn(cfg, p, bb, seq_chunk=SEQ_CHUNK),
        has_aux=True))
    (loss, metrics), g = f(params, {k: jnp.asarray(v) for k, v in b.items()})
    flat = jax.tree_util.tree_flatten_with_path(g)[0]
    grads = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): np.asarray(v) for path, v in flat}
    return dict(name=name, params=jax.tree.map(np.asarray, params), batch=b,
                loss=float(loss), metrics={k: float(v)
                                           for k, v in metrics.items()},
                grads=grads)


def _port(ref):
    return (treg.get(ref["name"]).reduced(),
            params_from_numpy(ref["params"], device="cpu"))


def test_loss_and_grads_match_jax(ref):
    cfg, params = _port(ref)
    loss, metrics, grads = TS.value_and_grad(
        cfg, params, _torch_batch(ref["batch"]), SEQ_CHUNK)
    assert abs(float(loss) - ref["loss"]) <= LOSS_TOL * abs(ref["loss"])
    assert sorted(metrics) == sorted(ref["metrics"])
    for k, v in ref["metrics"].items():
        assert abs(float(metrics[k]) - v) <= LOSS_TOL * max(abs(v), 1.0), k
    flat = tr.flatten_with_paths(grads)
    assert [p for p, _ in flat] == list(ref["grads"])
    for p, g in flat:
        r = ref["grads"][p]
        assert g.shape == r.shape and g.dtype == torch.float32
        err = np.abs(g.numpy() - r).max()
        assert err <= GRAD_TOL * max(np.abs(r).max(), 1e-30), (p, err)


def test_remat_on_and_off_are_bit_equal(ref, monkeypatch):
    """``forward(remat=True)`` recomputes each sub-layer in backward: the
    loss and every gradient equal those of ``remat=False`` bit for bit."""
    cfg, params = _port(ref)
    batch = _torch_batch(ref["batch"])
    calls = []
    real = T.checkpoint

    def counting(fn, *a, **kw):
        calls.append(fn.__name__)
        return real(fn, *a, **kw)

    monkeypatch.setattr(T, "checkpoint", counting)
    out = {}
    for remat in (True, False):
        calls.clear()
        fwd = T.forward
        monkeypatch.setattr(T, "forward", lambda *a, _f=fwd, _r=remat, **kw:
                            _f(*a, remat=_r, **kw))
        out[remat] = TS.value_and_grad(cfg, params, batch, SEQ_CHUNK)
        monkeypatch.setattr(T, "forward", fwd)
        n_sub = calls.count("_sublayer_seq")
        assert n_sub == (cfg.n_layers if remat else 0)
    (l1, m1, g1), (l0, m0, g0) = out[True], out[False]
    assert torch.equal(l1, l0)
    for k in m1:
        assert torch.equal(m1[k], m0[k])
    for a, b in zip(tr.leaves(g1), tr.leaves(g0)):
        assert torch.equal(a, b)


def test_forward_remat_changes_no_value():
    cfg = treg.get("jamba-1.5-large-398b").reduced()
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(_batch(cfg)["tokens"]).long()
    h1, a1, _ = T.forward(cfg, params, tokens=toks, remat=True)
    h0, a0, _ = T.forward(cfg, params, tokens=toks, remat=False)
    assert torch.equal(h1, h0)
    assert all(torch.equal(a1[k], a0[k]) for k in a0)


# -------------------------------------------------------- ce_loss_chunked
@pytest.mark.parametrize("seq_chunk", [5, 7, 24, 32])
@pytest.mark.parametrize("tie", [False, True])
def test_ce_loss_chunked_matches_jax(seq_chunk, tie):
    import dataclasses

    cfg = dataclasses.replace(jreg.get("gemma-7b").reduced(),
                              tie_embeddings=tie)
    tcfg = dataclasses.replace(treg.get("gemma-7b").reduced(),
                               tie_embeddings=tie)
    rng = np.random.default_rng(seq_chunk)
    hidden = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    head = (rng.normal(size=(cfg.vocab, cfg.d_model)) * 0.1).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[:, ::3] = -1
    key = "embed" if tie else "lm_head"

    def jloss(h, w):
        return JT.ce_loss_chunked(cfg, {key: w}, h, jnp.asarray(labels),
                                  seq_chunk=seq_chunk)

    ref, (gh, gw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(head))
    h = torch.from_numpy(hidden).requires_grad_(True)
    w = torch.from_numpy(head).requires_grad_(True)
    loss = T.ce_loss_chunked(tcfg, {key: w}, h, torch.from_numpy(labels),
                             seq_chunk=seq_chunk)
    th, tw = torch.autograd.grad(loss, (h, w))
    assert loss.dtype == torch.float32
    assert abs(float(loss.detach()) - float(ref)) <= CE_TOL * abs(float(ref))
    for got, r in ((th, gh), (tw, gw)):
        r = np.asarray(r)
        assert np.abs(got.numpy() - r).max() <= CE_TOL * np.abs(r).max()


def test_ce_loss_chunk_checkpoint_is_bit_equal(monkeypatch):
    """Each chunk runs under ``checkpoint`` (its logits recomputed in
    backward); without it the loss and gradients are the same bits.  No
    valid label gives 0 (the count clamps to 1)."""
    cfg = treg.get("phi3-medium-14b").reduced()
    rng = np.random.default_rng(0)
    hidden = torch.from_numpy(rng.normal(size=(B, S, cfg.d_model))
                              .astype(np.float32))
    head = torch.from_numpy((rng.normal(size=(cfg.vocab, cfg.d_model)) * 0.1)
                            .astype(np.float32))
    labels = torch.from_numpy(rng.integers(-1, cfg.vocab, (B, S)))
    out = []
    for ckpt in (True, False):
        if not ckpt:
            monkeypatch.setattr(T, "checkpoint",
                                lambda fn, *a, **kw: fn(*a))
        h = hidden.clone().requires_grad_(True)
        w = head.clone().requires_grad_(True)
        loss = T.ce_loss_chunked(cfg, {"lm_head": w}, h, labels, seq_chunk=7)
        out.append((loss, *torch.autograd.grad(loss, (h, w))))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    none = T.ce_loss_chunked(cfg, {"lm_head": head}, hidden,
                             torch.full((B, S), -1), seq_chunk=7)
    assert float(none) == 0.0
