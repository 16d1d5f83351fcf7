"""The port's transformer serving slice against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages; the JAX package's
own random weights (``init_params(cfg.reduced(), PRNGKey(·), float32)``)
are carried across with ``repro_torch.models.convert``.  Every config of
the registry runs at ``.reduced()`` in float32, the MoE and hybrid
(attention + Mamba) ones among them.  Tolerances: 1e-5 for one layer,
1e-4 for a whole model (logits, caches, decode steps, MoE aux losses) —
the two packages sum in another order, nothing else; the greedy tokens
must be identical; decode against the teacher-forced forward keeps the
JAX package's own 2e-3, with MoE capacity_factor 8.0 so that no token is
dropped (``tests/test_archs.py``).  The JAX outputs are computed once per
config (module-scoped fixtures).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import serve_step as JS  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import serve_step as S  # noqa: E402

SLICE = sorted(jreg.ARCHS)
B, S_LEN, N_NEW = 2, 16, 3
LAYER_TOL, MODEL_TOL, DECODE_TOL = 1e-5, 1e-4, 2e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=tol, rtol=tol)


def _inputs(cfg, seed=2):
    """tokens (B, S+N), embeds / positions where the config takes them —
    the inputs of ``tests/test_archs.py::test_decode_matches_forward``."""
    rng = np.random.default_rng(seed)
    n = S_LEN + N_NEW
    toks = rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)
    emb = (rng.normal(size=(B, n, cfg.d_model)) * 0.02).astype(np.float32)
    pos = np.broadcast_to(np.arange(n, dtype=np.int32)[None, None],
                          (3, B, n)).copy()
    return toks, emb, pos


def _kw(cfg, emb, pos, sl, torch_side):
    """forward/prefill/decode keyword arguments for the token slice sl."""
    kw = {}
    if cfg.embeddings_input:
        kw["embeds"] = _t(emb[:, sl]) if torch_side else jnp.asarray(emb[:, sl])
    if cfg.rope_type == "mrope":
        kw["positions"] = (_t(pos[:, :, sl]).long() if torch_side
                           else jnp.asarray(pos[:, :, sl]))
    return kw


def _tokens(cfg, toks, sl, torch_side):
    if cfg.embeddings_input:
        return None
    return _t(toks[:, sl]).long() if torch_side else jnp.asarray(toks[:, sl])


@pytest.fixture(scope="module", params=SLICE)
def ref(request):
    """The JAX package's weights and outputs for one config."""
    name = request.param
    cfg = jreg.get(name).reduced()
    params = JT.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    toks, emb, pos = _inputs(cfg)
    s, n = S_LEN, S_LEN + N_NEW
    hidden, aux, _ = JT.forward(cfg, params, tokens=_tokens(cfg, toks,
                                                            slice(0, s), False),
                                remat=False, **_kw(cfg, emb, pos, slice(0, s),
                                                   False))
    logits = JT.lm_logits(cfg, params, hidden)
    prefill = JS.make_prefill_step(cfg, s_max=n)
    plog, cache = prefill(params, tokens=_tokens(cfg, toks, slice(0, s), False),
                          **_kw(cfg, emb, pos, slice(0, s), False))
    cache0 = _np(cache)
    steps = []
    decode = jax.jit(functools.partial(JT.decode_step, cfg))  # one compile
    for p in range(s, n):
        lg, cache = decode(
            params, _tokens(cfg, toks, slice(p, p + 1), False), cache,
            jnp.asarray(p, jnp.int32),
            **_kw(cfg, emb, pos, slice(p, p + 1), False))
        steps.append(np.asarray(lg))
    greedy = np.asarray(JS.greedy_generate(cfg, params,
                                           jnp.asarray(toks[:, :s]), N_NEW))
    return dict(name=name, cfg=cfg, params=_np(params), inputs=(toks, emb, pos),
                hidden=np.asarray(hidden), logits=np.asarray(logits),
                aux={k: float(v) for k, v in aux.items()},
                prefill_logits=np.asarray(plog), cache=cache0, steps=steps,
                greedy=greedy)


def _port(ref):
    cfg = treg.get(ref["name"]).reduced()
    return cfg, params_from_numpy(ref["params"], device="cpu")


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("name", sorted(jreg.ARCHS))
def test_config_copy_matches(name):
    jc, tc = jreg.get(name), treg.get(name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(jc.reduced())
    assert tc.param_count() == jc.param_count()
    assert tc.layer_kinds() == jc.layer_kinds()
    assert sorted(treg.ARCHS) == sorted(jreg.ARCHS)


# ---------------------------------------------------------------- weights
def test_weights_carried_across(ref):
    _, params = _port(ref)
    jl, jt = jax.tree_util.tree_flatten(ref["params"])
    tl, tt = jax.tree_util.tree_flatten(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert jt == tt
    for a, t in zip(jl, tl):
        assert t.dtype == torch.float32 and tuple(t.shape) == a.shape
        assert np.array_equal(t.numpy(), a)


def test_port_init_params_has_the_jax_tree(ref):
    """The port's own random weights have the JAX tree's structure, shapes
    and (for the constant leaves) values."""
    cfg, _ = _port(ref)
    own = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    jl, jt = jax.tree_util.tree_flatten(ref["params"])
    tl, tt = jax.tree_util.tree_flatten(
        own, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert jt == tt
    for a, t in zip(jl, tl):
        assert tuple(t.shape) == a.shape
        if np.all(a == a.flat[0]):               # norms, mixes, biases
            assert np.array_equal(t.numpy(), a)


# ---------------------------------------------------------------- the model
def test_forward_and_logits_match(ref):
    cfg, params = _port(ref)
    toks, emb, pos = ref["inputs"]
    sl = slice(0, S_LEN)
    hidden, aux, _ = T.forward(cfg, params, tokens=_tokens(cfg, toks, sl, True),
                               **_kw(cfg, emb, pos, sl, True))
    assert sorted(aux) == sorted(ref["aux"]) == (
        ["moe_lb", "moe_z"] if cfg.moe else [])
    for key, val in ref["aux"].items():
        assert abs(float(aux[key]) - val) <= MODEL_TOL * max(1.0, abs(val))
    _close(hidden, ref["hidden"], MODEL_TOL)
    _close(T.lm_logits(cfg, params, hidden), ref["logits"], MODEL_TOL)


def test_prefill_and_decode_match(ref):
    cfg, params = _port(ref)
    toks, emb, pos = ref["inputs"]
    prefill = S.make_prefill_step(cfg, s_max=S_LEN + N_NEW)
    sl = slice(0, S_LEN)
    logits, cache = prefill(params, tokens=_tokens(cfg, toks, sl, True),
                            **_kw(cfg, emb, pos, sl, True))
    _close(logits, ref["prefill_logits"], MODEL_TOL)
    jl, jt = jax.tree_util.tree_flatten(ref["cache"])
    tl, tt = jax.tree_util.tree_flatten(
        cache, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert jt == tt
    for a, t in zip(jl, tl):
        assert tuple(t.shape) == a.shape
        _close(t.float(), a, MODEL_TOL)
    decode = S.make_decode_step(cfg)
    for i, p in enumerate(range(S_LEN, S_LEN + N_NEW)):
        sl = slice(p, p + 1)
        lg, cache = decode(params, _tokens(cfg, toks, sl, True), cache, p,
                           **_kw(cfg, emb, pos, sl, True))
        _close(lg, ref["steps"][i], MODEL_TOL)


def test_greedy_generate_same_tokens(ref):
    cfg, params = _port(ref)
    toks = _t(ref["inputs"][0][:, :S_LEN]).long()
    out = S.greedy_generate(cfg, params, toks, N_NEW)
    assert out.shape == (B, N_NEW)
    assert np.array_equal(out.numpy(), ref["greedy"])


@pytest.mark.parametrize("use_kernels", [True, False])
def test_decode_matches_forward(ref, use_kernels):
    """The port's own decode ≡ teacher-forced forward (both routes; on the
    CPU the kernel route runs the plain versions); MoE without drops."""
    cfg, params = _port(ref)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    toks, emb, pos = ref["inputs"]
    n = S_LEN + N_NEW
    full_sl = slice(0, n)
    hidden, _, _ = T.forward(cfg, params,
                             tokens=_tokens(cfg, toks, full_sl, True),
                             use_kernels=use_kernels,
                             **_kw(cfg, emb, pos, full_sl, True))
    full = T.lm_logits(cfg, params, hidden)
    prefill = S.make_prefill_step(cfg, s_max=n, use_kernels=use_kernels)
    sl = slice(0, S_LEN)
    logits, cache = prefill(params, tokens=_tokens(cfg, toks, sl, True),
                            **_kw(cfg, emb, pos, sl, True))
    errs = [float((logits[:, -1] - full[:, S_LEN - 1]).abs().max())]
    for p in range(S_LEN, n):
        sl = slice(p, p + 1)
        lg, cache = T.decode_step(cfg, params, _tokens(cfg, toks, sl, True),
                                  cache, p, **_kw(cfg, emb, pos, sl, True))
        errs.append(float((lg[:, 0] - full[:, p]).abs().max()))
    assert max(errs) < DECODE_TOL, errs


# ---------------------------------------------------------------- layers
def _layer_params(name, key=3):
    """One layer's params of a reduced config (period slice 0), JAX and
    port side."""
    cfg = jreg.get(name).reduced()
    jp = JT.init_params(cfg, jax.random.PRNGKey(key), dtype=jnp.float32)
    blk = jax.tree.map(lambda a: a[0], jp["blocks"][0])
    return cfg, treg.get(name).reduced(), blk, params_from_numpy(
        _np(blk), device="cpu")


def _x(cfg, s=S_LEN, seed=4):
    return np.random.default_rng(seed).normal(
        size=(B, s, cfg.d_model)).astype(np.float32)


def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, 5, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    _close(L.rms_norm(_t(x), _t(w)), JL.rms_norm(jnp.asarray(x),
                                                 jnp.asarray(w)), LAYER_TOL)


def test_rope_matches():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 100, (B, 7)).astype(np.int32)
    _close(L.apply_rope(_t(x), _t(pos).long(), 10000.0),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0), LAYER_TOL)
    pos3 = rng.integers(0, 100, (3, B, 7)).astype(np.int32)
    _close(L.apply_mrope(_t(x), _t(pos3).long(), 10000.0, (2, 3, 3)),
           JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 10000.0,
                          (2, 3, 3)), LAYER_TOL)


@pytest.mark.parametrize("name", ["phi3-medium-14b", "gemma-7b",
                                  "musicgen-medium"])
def test_mlp_matches(name):
    """swiglu, geglu and gelu."""
    jc, tc, jb, tb = _layer_params(name)
    x = _x(jc)
    _close(L.mlp(tc, tb["ffn"], _t(x)),
           JL.mlp(jc, jb["ffn"], jnp.asarray(x)), LAYER_TOL)


@pytest.mark.parametrize("name", ["phi3-medium-14b", "qwen2-vl-7b",
                                  "musicgen-medium"])
def test_attention_seq_and_step_match(name):
    """std RoPE, M-RoPE with qkv bias, no RoPE; sequence form (both routes)
    and one decode step against a cache."""
    jc, tc, jb, tb = _layer_params(name)
    x = _x(jc)
    if jc.rope_type == "mrope":
        pos = np.broadcast_to(np.arange(S_LEN, dtype=np.int32)[None, None],
                              (3, B, S_LEN)).copy()
    else:
        pos = np.broadcast_to(np.arange(S_LEN, dtype=np.int32)[None],
                              (B, S_LEN)).copy()
    jo, (jk, jv) = JL.attention_seq(jc, jb["attn"], jnp.asarray(x),
                                    jnp.asarray(pos))
    for use_kernels in (True, False):
        o, (k, v) = L.attention_seq(tc, tb["attn"], _t(x), _t(pos).long(),
                                    use_kernels)
        _close(o, jo, LAYER_TOL)
        _close(k, jk, LAYER_TOL)
        _close(v, jv, LAYER_TOL)
    # one step at position 5 against a cache holding rows 0..4
    s_max, p = 8, 5
    ck = np.zeros((B, s_max) + np.asarray(jk).shape[2:], np.float32)
    cv = np.zeros_like(ck)
    ck[:, :p], cv[:, :p] = np.asarray(jk)[:, :p], np.asarray(jv)[:, :p]
    xs = x[:, p:p + 1]
    ps = pos[..., p:p + 1]
    jo, (jck, jcv) = JL.attention_step(jc, jb["attn"], jnp.asarray(xs),
                                       jnp.asarray(ps),
                                       (jnp.asarray(ck), jnp.asarray(cv)), p)
    o, (tck, tcv) = L.attention_step(tc, tb["attn"], _t(xs), _t(ps).long(),
                                     (_t(ck), _t(cv)), p)
    _close(o, jo, LAYER_TOL)
    _close(tck, jck, LAYER_TOL)
    _close(tcv, jcv, LAYER_TOL)


@pytest.mark.parametrize("return_state", [False, True])
def test_rwkv_time_mix_seq_matches(return_state):
    jc, tc, jb, tb = _layer_params("rwkv6-1.6b")
    x = _x(jc)
    jo, jst = JL.rwkv_time_mix_seq(jc, jb["rwkv"], jnp.asarray(x),
                                   return_state=return_state)
    for use_kernels in (True, False):
        o, st = L.rwkv_time_mix_seq(tc, tb["rwkv"], _t(x), return_state,
                                    use_kernels)
        _close(o, jo, LAYER_TOL)
        if return_state:
            _close(st[0], jst[0], LAYER_TOL)
            _close(st[1], jst[1], LAYER_TOL)
        else:
            assert st is None and jst is None


def test_rwkv_time_mix_step_and_channel_mix_match():
    jc, tc, jb, tb = _layer_params("rwkv6-1.6b")
    x = _x(jc)
    _, (xl, st) = JL.rwkv_time_mix_seq(jc, jb["rwkv"], jnp.asarray(x[:, :-1]),
                                       return_state=True)
    xs = x[:, -1:]
    jo, (jx, jst) = JL.rwkv_time_mix_step(jc, jb["rwkv"], jnp.asarray(xs),
                                          (xl, st))
    o, (tx, tst) = L.rwkv_time_mix_step(tc, tb["rwkv"], _t(xs),
                                        (_t(xl), _t(st)))
    _close(o, jo, LAYER_TOL)
    _close(tx, jx, LAYER_TOL)
    _close(tst, jst, LAYER_TOL)
    _close(L.rwkv_channel_mix(tc, tb["rwkv"], _t(x)),
           JL.rwkv_channel_mix(jc, jb["rwkv"], jnp.asarray(x)), LAYER_TOL)
    _close(L.rwkv_channel_mix(tc, tb["rwkv"], _t(x[:, 1]), _t(x[:, 0])),
           JL.rwkv_channel_mix(jc, jb["rwkv"], jnp.asarray(x[:, 1]),
                               x_prev=jnp.asarray(x[:, 0])), LAYER_TOL)


# ---------------------------------------------------------------- MoE
def _moe_cfgs(name, capacity_factor=None):
    """A reduced MoE config, JAX and port side, with its capacity factor
    changed when one is given."""
    jc, tc = jreg.get(name).reduced(), treg.get(name).reduced()
    if capacity_factor is not None:
        jc, tc = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (jc, tc))
    return jc, tc


def _moe_params(jc, key=3):
    jp = JL.init_moe(jc, jax.random.PRNGKey(key), jnp.float32)
    return jp, params_from_numpy(_np(jp), device="cpu")


def _jax_keep(jc, jp, x):
    """The keep mask of ``lax.top_k`` on the JAX router's probabilities,
    each expert's copies ranked in token order and cut at the capacity:
    the rule of the JAX ``moe``, stated in numpy."""
    m = jc.moe
    xf = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = jax.nn.softmax((xf @ jp["router"]).astype(jnp.float32), axis=-1)
    ids = np.asarray(jax.lax.top_k(probs, m.top_k)[1]).reshape(-1)
    rank = np.array([np.count_nonzero(ids[:i] == ids[i])
                     for i in range(ids.size)])
    cap = max(int(np.ceil(xf.shape[0] * m.top_k / m.n_experts
                          * m.capacity_factor)), 1)
    return ids, rank < cap


@pytest.mark.parametrize("capacity_factor", [None, 0.25])
@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "grok-1-314b"])
def test_moe_matches(name, capacity_factor):
    """swiglu and geglu experts, out and aux at 1e-5; at capacity_factor
    0.25 copies are dropped, and the port keeps the copies the JAX rule
    keeps."""
    jc, tc = _moe_cfgs(name, capacity_factor)
    jp, tp = _moe_params(jc)
    x = _x(jc)
    jo, jaux = JL.moe(jc, jp, jnp.asarray(x))
    o, aux = L.moe(tc, tp, _t(x))
    _close(o, jo, LAYER_TOL)
    assert sorted(aux) == sorted(jaux) == ["moe_lb", "moe_z"]
    for key in aux:
        _close(aux[key], jaux[key], LAYER_TOL)
    ids, keep = _jax_keep(jc, jp, x)
    logits = (_t(x).reshape(-1, tc.d_model) @ tp["router"]).float()
    _, _, t_ids, t_keep, _, _ = L.moe_route(tc, logits)
    assert np.array_equal(t_ids.numpy(), ids)
    assert np.array_equal(t_keep.numpy(), keep)
    if capacity_factor is not None:
        assert not keep.all()


def test_moe_router_tie_goes_to_the_lower_expert():
    """Experts 0, 1 and 2 get the same router column, so every token's
    top three probabilities tie exactly; ``lax.top_k`` keeps experts 0
    and 1, and so must the port (experts 1 and 2 differ, so the outputs
    tell them apart)."""
    jc, tc = _moe_cfgs("qwen3-moe-30b-a3b")
    jp, _ = _moe_params(jc)
    router = np.array(jp["router"])
    router[:, 1] = router[:, 2] = router[:, 0] = np.abs(router[:, 0]) + 1.0
    jp = dict(jp, router=jnp.asarray(router))
    tp = params_from_numpy(_np(jp), device="cpu")
    x = np.abs(_x(jc))
    jo, _ = JL.moe(jc, jp, jnp.asarray(x))
    o, _ = L.moe(tc, tp, _t(x))
    _close(o, jo, LAYER_TOL)
    logits = (_t(x).reshape(-1, tc.d_model) @ tp["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    assert torch.equal(probs[:, 0], probs[:, 2])
    _, _, ids, _, _, _ = L.moe_route(tc, logits)
    assert np.array_equal(ids.view(-1, 2).numpy(),
                          np.tile([0, 1], (logits.shape[0], 1)))


# ---------------------------------------------------------------- Mamba
def _mamba_params(key=3):
    jc = jreg.get("jamba-1.5-large-398b").reduced()
    jp = JL.init_mamba(jc, jax.random.PRNGKey(key), jnp.float32)
    return (jc, treg.get("jamba-1.5-large-398b").reduced(), jp,
            params_from_numpy(_np(jp), device="cpu"))


@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("return_state", [False, True])
def test_mamba_seq_matches(return_state, chunk):
    """The chunked scan at the default chunk (one chunk here) and at 4
    (the state carried across chunks, S = 18 padded to 20); with and
    without the returned (conv_buf, h)."""
    jc, tc, jp, tp = _mamba_params()
    x = _x(jc, s=18)
    kw = {} if chunk is None else {"chunk": chunk}
    jout = JL.mamba_seq(jc, jp, jnp.asarray(x), return_state=return_state,
                        **kw)
    out = L.mamba_seq(tc, tp, _t(x), return_state=return_state, **kw)
    if not return_state:
        _close(out, jout, LAYER_TOL)
        return
    _close(out[0], jout[0], LAYER_TOL)
    _close(out[1][0], jout[1][0], LAYER_TOL)
    _close(out[1][1], jout[1][1], LAYER_TOL)


def test_mamba_step_and_scan_match():
    """One decode step from the state of a 15-step prefix, against the JAX
    step; the scan of one chunk against ``_ssm_scan_chunk``'s states."""
    jc, tc, jp, tp = _mamba_params()
    x = _x(jc)
    _, st = JL.mamba_seq(jc, jp, jnp.asarray(x[:, :-1]), return_state=True)
    xs = x[:, -1:]
    jo, (jbuf, jh) = JL.mamba_step(jc, jp, jnp.asarray(xs), st)
    o, (tbuf, th) = L.mamba_step(tc, tp, _t(xs), (_t(st[0]), _t(st[1])))
    _close(o, jo, LAYER_TOL)
    _close(tbuf, jbuf, LAYER_TOL)
    _close(th, jh, LAYER_TOL)
    rng = np.random.default_rng(5)
    a = rng.uniform(0.5, 1.0, (B, 6, 8, 4)).astype(np.float32)
    bx = rng.normal(size=(B, 6, 8, 4)).astype(np.float32)
    h0 = rng.normal(size=(B, 8, 4)).astype(np.float32)
    jhs, _ = JL._ssm_scan_chunk(jnp.asarray(a), jnp.asarray(bx),
                                jnp.asarray(h0))
    _close(L._ssm_scan_chunk(_t(a), _t(bx), _t(h0)), jhs, LAYER_TOL)


ARCH_MODULES = sorted(
    m.name for m in __import__("pkgutil").iter_modules(
        __import__("repro.configs", fromlist=["_"]).__path__)
    if m.name not in ("base", "registry", "shapes"))


@pytest.mark.parametrize("module", ARCH_MODULES)
def test_config_module_copy_matches(module):
    """Each one-line ``configs/<arch>.py`` of the port names the JAX
    module's config."""
    import importlib

    jc = importlib.import_module(f"repro.configs.{module}").CONFIG
    tc = importlib.import_module(f"repro_torch.configs.{module}").CONFIG
    assert tc is treg.get(tc.name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
