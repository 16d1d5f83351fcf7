"""Unified decoder model over the arch-config family: the counterpart of
``src/repro/models/transformer.py`` for every family of the registry
(attention, MoE, hybrid attention + Mamba, RWKV6).

Params tree (the JAX tree's layout, so weights carry across as copies):
  embed (V, d) [+ lm_head unless tied] · final_norm
  blocks: list over period positions, each a dict of leaves stacked
  (n_periods, ...): {ln1, attn | mamba | rwkv, ln2, ffn (mlp or moe)}

The JAX package scans over ``n_periods``; here a Python loop over the
periods takes each period's slice (a view) of the stacks.  ``forward``'s
``constrain`` pins the residual stream's layout on a mesh at the JAX
forward's places (``models.sharding.activation_constrainer``); without
one it is the identity.  ``remat`` recomputes each sub-layer in backward
(``torch.utils.checkpoint``, as the JAX ``jax.checkpoint`` with
``nothing_saveable``), so only the sub-layers' inputs stay saved.
``use_kernels`` sends the prefill's attention through K7 and its WKV
recurrence through K8 on CUDA tensors; MoE and Mamba layers and decode run
no kernel, as the JAX package runs no Pallas kernel there.  Neither kernel
has a backward: a loss passes ``use_kernels=False`` (``train.train_step``),
the plain route the JAX ``forward`` always takes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import tree as tr
from ..configs.base import ArchConfig, MambaCfg
from ..core.options import resolve_device
from . import layers as L
from .sharding import (ctx_embed, ctx_gather_data, ctx_gather_model,
                       ctx_like, ctx_take_last)

F32 = torch.float32


def layer_slice(tree, i):
    """Period i's slice of a tree of stacked leaves (views)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda"):
    """Random weights with the JAX package's scales, drawn on ``device``
    from ``torch.Generator(device).manual_seed(seed)`` (not the JAX
    package's numbers: carry those across with ``models.convert``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def embed_like():
        return L._dense(gen, (cfg.vocab, cfg.d_model), dtype, dev, 0.02)

    def ones(lead=()):
        return torch.ones((*lead, cfg.d_model), dtype=dtype, device=dev)

    params = dict(embed=embed_like(), final_norm=ones())
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_like()
    lead = (cfg.n_periods,)
    blocks = []
    for kind, fkind in zip(cfg.layer_kinds(), cfg.ffn_kinds()):
        sub = {"ln1": ones(lead)}
        if kind == "attn":
            sub["attn"] = L.init_attention(cfg, gen, dtype, dev, lead)
        elif kind == "mamba":
            sub["mamba"] = L.init_mamba(cfg, gen, dtype, dev, lead)
        else:
            sub["rwkv"] = L.init_rwkv(cfg, gen, dtype, dev, lead)
        if kind != "rwkv":           # rwkv carries its own channel mix
            sub["ln2"] = ones(lead)
            if fkind == "moe":
                sub["ffn"] = L.init_moe(cfg, gen, dtype, dev, lead)
            elif cfg.d_ff:
                sub["ffn"] = L.init_mlp(cfg, gen, dtype, dev, lead)
        blocks.append(sub)
    params["blocks"] = blocks
    return params


# --------------------------------------------------------------------------
# sub-layer application (sequence / step)
# --------------------------------------------------------------------------
def _ffn(cfg, fkind, sub, x, aux=None):
    """The sub-layer's feed-forward on its normed input (MLP or MoE); the
    MoE aux losses go into ``aux`` when one is given."""
    h = ctx_gather_model(L.rms_norm(x, sub["ln2"], cfg.norm_eps))
    if fkind != "moe":
        return L.mlp(cfg, sub["ffn"], h)
    o, moe_aux = L.moe(cfg, sub["ffn"], h)
    if aux is not None:
        aux.update(moe_aux)
    return o


def _sublayer_seq(cfg, kind, fkind, sub, x, positions, collect_cache,
                  use_kernels):
    """One sub-layer over the sequence: (x, aux, cache)."""
    aux, cache = {}, None
    h = ctx_gather_model(L.rms_norm(x, sub["ln1"], cfg.norm_eps))
    if kind == "attn":
        o, kv = L.attention_seq(cfg, sub["attn"], h, positions, use_kernels)
        if collect_cache:
            cache = kv
        x = x + ctx_like(o, x)
    elif kind == "mamba":
        o = L.mamba_seq(cfg, sub["mamba"], h, return_state=collect_cache)
        if collect_cache:
            o, cache = o
        x = x + ctx_like(o, x)
    else:
        o, st = L.rwkv_time_mix_seq(cfg, sub["rwkv"], h, collect_cache,
                                    use_kernels)
        x = x + ctx_like(o, x)
        h2 = ctx_gather_model(L.rms_norm(x, sub["rwkv"]["ln_cm"],
                                         cfg.norm_eps))
        x = x + ctx_like(L.rwkv_channel_mix(cfg, sub["rwkv"], h2), x)
        if collect_cache:
            cache = (st[0], st[1], h2[:, -1].clone())   # a copy: a view keeps h2 alive
        return x, aux, cache
    if "ffn" in sub:
        x = x + ctx_like(_ffn(cfg, fkind, sub, x, aux), x)
    return x, aux, cache


def _sublayer_step(cfg, kind, fkind, sub, x, positions, state, pos):
    """One token through one sub-layer; writes its new cache state into the
    ``state`` tensors in place.  On a mesh the residual keeps its layout
    (replicated over 'model'): each sub-layer's input is gathered over
    'model' and its output, a partial sum, reduced to the residual's
    layout before the add."""
    h = ctx_gather_model(L.rms_norm(x, sub["ln1"], cfg.norm_eps))
    if kind == "attn":
        o, _ = L.attention_step(cfg, sub["attn"], h, positions, state, pos)
        x = x + ctx_like(o, x)
    elif kind == "mamba":
        o, st = L.mamba_step(cfg, sub["mamba"], h, state)
        for dst, src in zip(state, st):
            dst.copy_(src)
        x = x + ctx_like(o, x)
    else:
        o, st_t = L.rwkv_time_mix_step(cfg, sub["rwkv"], h, state[:2])
        x = x + ctx_like(o, x)
        h2 = ctx_gather_model(L.rms_norm(x, sub["rwkv"]["ln_cm"],
                                         cfg.norm_eps))
        x = x + ctx_like(L.rwkv_channel_mix(
            cfg, sub["rwkv"], h2[:, 0], x_prev=state[2])[:, None, :], x)
        for dst, src in zip(state, (st_t[0], st_t[1], h2[:, 0])):
            dst.copy_(src)
        return x
    if "ffn" in sub:
        x = x + ctx_like(_ffn(cfg, fkind, sub, x), x)
    return x


def _embed(cfg, params, tokens, embeds):
    if embeds is None:
        return ctx_embed(params["embed"], tokens)
    if tokens is not None:       # mixed stub: tokens embedded + added
        return embeds + ctx_embed(params["embed"], tokens).to(embeds.dtype)
    return embeds


# --------------------------------------------------------------------------
# forward (prefill)
# --------------------------------------------------------------------------
def forward(cfg: ArchConfig, params, tokens=None, embeds=None, positions=None,
            collect_cache=False, use_kernels=True, remat=None,
            constrain=None):
    """Returns (hidden (B,S,d), aux, caches|None).  Logits via
    lm_logits().  aux holds the MoE layers' ``moe_lb`` and ``moe_z``, each
    summed over the sub-layers of a period and then over the periods, as
    the JAX scan sums them (empty without MoE).  caches: list over period
    positions, leaves stacked (n_periods, B, ...).  ``remat`` (default
    ``cfg.remat``) recomputes each sub-layer in backward when a gradient
    is being taken; it changes no value.  ``constrain`` (a function of
    x) is applied to the residual stream before every sub-layer and after
    each period, as the JAX forward applies it."""
    remat = cfg.remat if remat is None else remat
    constrain = constrain or (lambda v: v)
    x = _embed(cfg, params, tokens, embeds)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        if cfg.rope_type == "mrope":
            positions = positions[None].expand(3, b, s)
    kinds, fkinds = cfg.layer_kinds(), cfg.ffn_kinds()
    per_layer = [[] for _ in kinds]
    period_aux = []
    for i in range(cfg.n_periods):
        auxes = {}
        for pos, kind in enumerate(kinds):
            x = constrain(x)
            sub = ctx_gather_data(layer_slice(params["blocks"][pos], i))
            args = (cfg, kind, fkinds[pos], sub, x, positions, collect_cache,
                    use_kernels)
            if remat and L.grad_wanted(x, *tr.leaves(sub)):
                x, aux, cache = checkpoint(_sublayer_seq, *args,
                                           use_reentrant=False)
            else:
                x, aux, cache = _sublayer_seq(*args)
            for k, v in aux.items():
                auxes[k] = auxes.get(k, 0.0) + v
            per_layer[pos].append(cache)
        x = constrain(x)
        period_aux.append(auxes)
    aux = {k: torch.stack([a[k] for a in period_aux]).sum()
           for k in period_aux[0]} if period_aux else {}
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    caches = None
    if collect_cache:
        caches = [tuple(torch.stack(leaves) for leaves in zip(*rows))
                  for rows in per_layer]
    return x, aux, caches


def lm_logits(cfg: ArchConfig, params, hidden):
    """(B, S, V) logits; on a mesh split over 'model' by vocab, as the
    head is (the hidden state replicated over 'model' first)."""
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return ctx_gather_model(hidden) @ head.T


def _chunk_ce(hidden_c, labels_c, head):
    """One chunk's summed cross-entropy and its count of valid labels:
    logits in the params' dtype, then float32 reductions."""
    logits = (ctx_gather_model(hidden_c) @ head.T).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = ctx_take_last(logits, labels_c.clamp_min(0))
    valid = (labels_c >= 0).float()
    return ((lse - tgt) * valid).sum(), valid.sum()


def ce_loss_chunked(cfg: ArchConfig, params, hidden, labels, seq_chunk=512):
    """Mean next-token cross-entropy over the labels that are >= 0, without
    the (B, S, V) logits: the sequence is padded to whole chunks of
    ``seq_chunk`` (labels with -1) and each chunk's (B, chunk, V) logits are
    recomputed in backward (``checkpoint``, as the JAX function's
    ``nothing_saveable``).  The chunks' sums run in order from 0, as the
    JAX scan carries them."""
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    b, s, _ = hidden.shape
    nch = -(-s // seq_chunk)
    sp = nch * seq_chunk
    labels = labels.long()
    if sp != s:
        hidden = F.pad(hidden, (0, 0, 0, sp - s))
        labels = F.pad(labels, (0, sp - s), value=-1)
    tot = torch.zeros((), dtype=F32, device=hidden.device)
    cnt = torch.zeros((), dtype=F32, device=hidden.device)
    grad = L.grad_wanted(hidden, head)
    for c0 in range(0, sp, seq_chunk):
        args = (hidden[:, c0:c0 + seq_chunk], labels[:, c0:c0 + seq_chunk],
                head)
        loss, n = (checkpoint(_chunk_ce, *args, use_reentrant=False)
                   if grad else _chunk_ce(*args))
        tot, cnt = tot + loss, cnt + n
    return tot / cnt.clamp_min(1.0)


# --------------------------------------------------------------------------
# decode path
# --------------------------------------------------------------------------
def cache_specs(cfg: ArchConfig, batch: int, s_max: int,
                dtype=torch.bfloat16):
    """(shape, dtype) of each decode-cache leaf: a list over the ``period``
    sub-layer positions, leaves stacked over periods (n_periods, ...) — the
    layout ``forward(collect_cache=True)`` produces and ``decode_step``
    reads."""
    hd = cfg.resolved_head_dim
    m = cfg.mamba or MambaCfg()
    di = m.expand * cfg.d_model
    nh = cfg.d_model // cfg.rwkv_head_size if cfg.rwkv6 else 0
    np_ = cfg.n_periods
    out = []
    for kind in cfg.layer_kinds():
        if kind == "attn":
            kv = ((np_, batch, s_max, cfg.n_kv_heads, hd), dtype)
            out.append((kv, kv))
        elif kind == "mamba":
            out.append((((np_, batch, m.d_conv - 1, di), dtype),
                        ((np_, batch, di, m.d_state), F32)))
        else:
            xs = ((np_, batch, cfg.d_model), dtype)
            out.append((xs, ((np_, batch, nh, cfg.rwkv_head_size,
                              cfg.rwkv_head_size), F32), xs))
    return out


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=torch.bfloat16,
               device="cuda"):
    dev = resolve_device(device)
    return [tuple(torch.zeros(shape, dtype=dt, device=dev)
                  for shape, dt in leaves)
            for leaves in cache_specs(cfg, batch, s_max, dtype)]


def decode_step(cfg: ArchConfig, params, tokens, cache, pos: int, embeds=None,
                positions=None):
    """One token for every sequence in the batch.  Returns (logits, cache).
    The cache is updated in place (the JAX function returns a new one).
    Decode runs no kernel on either route, as the JAX decode runs no
    Pallas kernel, so it takes no ``use_kernels``."""
    x = _embed(cfg, params, tokens, embeds)
    b = x.shape[0]
    if positions is None:
        positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
        if cfg.rope_type == "mrope":
            positions = positions[None].expand(3, b, 1)
    kinds, fkinds = cfg.layer_kinds(), cfg.ffn_kinds()
    for i in range(cfg.n_periods):
        for posn, kind in enumerate(kinds):
            sub = ctx_gather_data(layer_slice(params["blocks"][posn], i))
            state = tuple(leaf[i] for leaf in cache[posn])
            x = _sublayer_step(cfg, kind, fkinds[posn], sub, x, positions,
                               state, pos)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, x), cache
