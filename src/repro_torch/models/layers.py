"""Model-zoo layers on tensors: the counterpart of ``src/repro/models/layers.py``
for the attention, MoE, Mamba and RWKV6 families.

Every layer comes in two execution forms, as in the JAX package:
  - sequence form (prefill): full (B, S, ...) tensors;
  - step form (decode): one token against a carried cache or state.

Params are dicts of tensors, weights laid out (in, out) so ``x @ W`` (the
JAX tree's layout).  ``use_kernels`` routes the sequence form through the
hand-written kernels on CUDA tensors: attention through K7
(``kernels.flashattn``), the WKV recurrence through K8 (``kernels.wkv``).
On CPU tensors, or with ``use_kernels=False``, they run what the JAX
``forward`` runs: the chunked online-softmax attention and the scan.  The
step forms are plain PyTorch, as they are plain XLA in the JAX package.
So are the MoE and Mamba layers in both forms: the JAX package computes
them outside any Pallas kernel.  K7 and K8 have no backward: under grad,
with an input that requires grad, the kernel route raises instead of
returning an output that carries no gradient to the projections (training
passes ``use_kernels=False``, the route the JAX training step takes).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig, MambaCfg
from ..kernels.flashattn.ops import flash_attention
from ..kernels.wkv.ops import wkv
from .recurrence import ssm_scan as _ssm_scan_chunk
from .recurrence import wkv_scan
from .sharding import (ctx_by_heads, ctx_constrain, ctx_gather_model,
                       ctx_groups, ctx_local, ctx_model_last, ctx_seq_split,
                       ctx_split_heads, ctx_write_row, data_local)

F32 = torch.float32
ATTN_CHUNK_K = 1024          # KV chunk of the chunked attention (JAX default)
MAMBA_CHUNK = 128            # time chunk of the selective scan (JAX default)


# --------------------------------------------------------------------------
# basics
# --------------------------------------------------------------------------
def rms_norm(x, w, eps=1e-5):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def _dense(gen, shape, dtype, device, scale=None, lead=()):
    """Normal(0, 1) · scale drawn in float32 on ``device`` and cast, scale
    1/sqrt(fan_in) by default; ``lead`` stacks independent draws (one per
    period) without a float32 copy of the whole stack."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale or 1.0 / math.sqrt(fan_in)
    out = torch.empty((*lead, *shape), dtype=dtype, device=device)
    for sub in out.view(-1, *shape):
        sub.copy_(torch.randn(shape, generator=gen, dtype=F32, device=device)
                  * scale)
    return out


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# --------------------------------------------------------------------------
# RoPE / M-RoPE: interleaved pairs x[..., ::2], x[..., 1::2]
# --------------------------------------------------------------------------
def rope_freqs(head_dim, theta, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=F32,
                                         device=device) / head_dim))


def _rotate(x, ang):
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_rope(x, positions, theta):
    """x: (B, S, H, D); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions.to(F32)[..., None] * freqs)


def apply_mrope(x, positions, theta, sections):
    """M-RoPE (Qwen2-VL): positions (3, B, S) = (t, h, w) ids; the D/2
    frequency slots are split into ``sections`` groups, each rotated by its
    own position stream."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    sec = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])
    pos = positions[sec].movedim(0, -1).to(F32)         # (B, S, D/2)
    return _rotate(x, pos * freqs)


def _rope(cfg: ArchConfig, x, positions):
    if cfg.rope_type is None:
        return x
    if cfg.rope_type == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


# --------------------------------------------------------------------------
# attention (GQA)
# --------------------------------------------------------------------------
def init_attention(cfg: ArchConfig, gen, dtype, device, lead=()):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    p = dict(wq=_dense(gen, (d, h * hd), dtype, device, lead=lead),
             wk=_dense(gen, (d, hkv * hd), dtype, device, lead=lead),
             wv=_dense(gen, (d, hkv * hd), dtype, device, lead=lead),
             wo=_dense(gen, (h * hd, d), dtype, device, lead=lead))
    if cfg.qkv_bias:
        for name, n in (("bq", h * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            p[name] = torch.zeros((*lead, n), dtype=dtype, device=device)
    return p


def _chunked_causal_attention(q, k, v):
    """Online-softmax causal attention over KV chunks with (m, l, acc)
    carried for all query positions — the plain route.
    q: (B, T, H, D); k/v: (B, S, Hkv, D); returns (B, T, H, D)."""
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    chunk_k = min(ATTN_CHUNK_K, s)
    qs = (q.float() * scale).to(q.dtype).float()
    rows = torch.arange(t, device=q.device)
    m = torch.full((b, h, t), -1e30, dtype=F32, device=q.device)
    l = torch.zeros((b, h, t), dtype=F32, device=q.device)
    acc = torch.zeros((b, h, t, d), dtype=F32, device=q.device)
    for koff in range(0, s, chunk_k):
        kblk = k[:, koff:koff + chunk_k]
        vblk = v[:, koff:koff + chunk_k]
        n = kblk.shape[1]
        if n < chunk_k:                 # zero-padded tail chunk, as in JAX
            pad = (0, 0, 0, 0, 0, chunk_k - n)
            kblk, vblk = F.pad(kblk, pad), F.pad(vblk, pad)
        logit = torch.einsum("bqhd,bkhd->bhqk", qs,
                             kblk.repeat_interleave(g, dim=2).float())
        cols = koff + torch.arange(chunk_k, device=q.device)
        mask = (rows[:, None] >= cols[None, :]) & (cols < s)[None, :]
        logit = torch.where(mask, logit, torch.tensor(-1e30, dtype=F32,
                                                      device=q.device))
        m_new = torch.maximum(m, logit.amax(dim=-1))
        p = torch.exp(logit - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vblk.dtype).float(),
            vblk.repeat_interleave(g, dim=2).float())
        m = m_new
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / l[..., None]).to(q.dtype)              # (B, H, T, D)
    return out.transpose(1, 2)                          # (B, T, H, D)


def grad_wanted(*tensors):
    """A gradient is being taken through these tensors: grad is enabled and
    one of them requires it (serving calls run with grad enabled on
    tensors that require none)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _refuse_grad(kernel, *ops):
    """Raise when a kernel without a backward would run under grad on an
    operand that requires grad: its output would have no ``grad_fn``, and
    the weights behind the operands would silently get no gradient."""
    if grad_wanted(*ops):
        raise RuntimeError(
            f"{kernel} has no backward: under grad pass use_kernels=False "
            "(the plain route, which the training step takes), or run the "
            "kernel route under torch.no_grad()")


def attention_qkv(cfg: ArchConfig, p, x, positions):
    """The projections of sequence-form attention, RoPE applied:
    q (B, S, H, D), k and v (B, S, Hkv, D) — the operands of K7."""
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _rope(cfg, ctx_split_heads(q, cfg.n_heads, hd), positions)
    k = _rope(cfg, ctx_split_heads(k, cfg.n_kv_heads, hd), positions)
    return q, k, ctx_split_heads(v, cfg.n_kv_heads, hd)


def attention_seq(cfg: ArchConfig, p, x, positions, use_kernels=True):
    """Sequence-form attention. positions: (B,S) or (3,B,S) for mrope.
    Returns (out, (k, v)) — k, v the cache rows."""
    b, s, _ = x.shape
    q, k, v = attention_qkv(cfg, p, x, positions)
    if use_kernels and x.is_cuda:
        _refuse_grad("K7 (flash_attention)", q, k, v)
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2)).transpose(1, 2)
    else:
        o = ctx_by_heads(_chunked_causal_attention, q, k, v)
    return ctx_model_last(o.reshape(b, s, -1)) @ p["wo"], (k, v)


def _cache_logits(q, ck, pos, row0):
    """The masked logits (B, H, 1, S') of q (B, 1, H, D) against the cache
    rows ck (B, S', Hkv, D), global rows row0.. (rows past pos masked):
    all the rows in :func:`_cache_attention`, one shard's in
    ``sharding.ctx_seq_split``."""
    g = q.shape[2] // ck.shape[2]
    logit = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                         ck.repeat_interleave(g, dim=2).float())
    logit = logit / math.sqrt(q.shape[3])
    rows = row0 + torch.arange(ck.shape[1], device=q.device)
    return torch.where(rows[None, None, None, :] <= pos, logit,
                       torch.tensor(-1e30, dtype=F32, device=q.device))


def _cache_weighted(logit, cv, m):
    """Against the global max m (B, H, 1, 1): the sum of exp(logit − m)
    (B, H, 1, 1) and the exp-weighted values (B, H, 1, D) of one shard's
    rows."""
    g = logit.shape[1] // cv.shape[2]
    w = torch.exp(logit - m)
    return w.sum(dim=-1, keepdim=True), torch.einsum(
        "bhqk,bkhd->bhqd", w, cv.repeat_interleave(g, dim=2).float())


def _cache_attention(q, ck, cv, pos):
    """One query row per sequence, q (B, 1, H, D), over the cache rows
    0..pos of ck, cv (B, S_max, Hkv, D): (B, 1, H, D)."""
    g = q.shape[2] // ck.shape[2]
    w = torch.softmax(_cache_logits(q, ck, pos, 0), dim=-1)
    vv = cv.repeat_interleave(g, dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(vv.dtype), vv)


def attention_step(cfg: ArchConfig, p, x, positions, cache_kv, pos):
    """Decode-form attention: x (B,1,d); cache_kv = (k,v) with shape
    (B, S_max, Hkv, D); pos = current write index (0-based).  Writes the
    new row into the cache tensors in place (the JAX function returns
    updated copies) and returns (out, cache_kv)."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    q, k, v = attention_qkv(cfg, p, x, positions)
    ck, cv = cache_kv
    ctx_write_row(ck, pos, k[:, 0])
    ctx_write_row(cv, pos, v[:, 0])
    split = ctx_seq_split(_cache_logits, _cache_weighted, q, ck, cv, pos)
    if split is None:
        o = ctx_by_heads(_cache_attention, q, ck, cv, pos)
    else:                        # the cache's rows split over a mesh axis
        l, acc = split
        o = (acc / l).transpose(1, 2).to(cv.dtype)
    return o.reshape(b, 1, h * hd) @ p["wo"], (ck, cv)


# --------------------------------------------------------------------------
# FFN: swiglu / geglu / gelu
# --------------------------------------------------------------------------
def init_mlp(cfg: ArchConfig, gen, dtype, device, lead=()):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "gelu":
        return dict(w_up=_dense(gen, (d, f), dtype, device, lead=lead),
                    w_down=_dense(gen, (f, d), dtype, device, lead=lead))
    return dict(w_gate=_dense(gen, (d, f), dtype, device, lead=lead),
                w_up=_dense(gen, (d, f), dtype, device, lead=lead),
                w_down=_dense(gen, (f, d), dtype, device, lead=lead))


def mlp(cfg: ArchConfig, p, x):
    if cfg.act == "gelu":
        return gelu(x @ p["w_up"]) @ p["w_down"]
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    act = F.silu(g) if cfg.act == "swiglu" else gelu(g)
    return (act * u) @ p["w_down"]


def init_moe(cfg: ArchConfig, gen, dtype, device, lead=()):
    d, m = cfg.d_model, cfg.moe
    e, f = m.n_experts, m.d_ff_expert
    return dict(router=_dense(gen, (d, e), dtype, device, 0.02, lead),
                w_gate=_dense(gen, (e, d, f), dtype, device, lead=lead),
                w_up=_dense(gen, (e, d, f), dtype, device, lead=lead),
                w_down=_dense(gen, (e, f, d), dtype, device, lead=lead))


def moe_route(cfg: ArchConfig, logits, groups: int = 1):
    """The router's decisions from its float32 logits (T, E), the T tokens
    split into ``groups`` groups of consecutive tokens: (probs, gate
    (T, k) renormalised, experts (T·k,) token-major, keep (T·k,), slot
    (T·k,), cap).  Within each group, copy i of the token-major list goes
    to slot expert · cap + rank, its rank the count of the group's earlier
    copies routed to the same expert; a copy of rank cap or more is
    dropped (keep False, slot E · cap).  ``cap`` is one group's
    capacity."""
    m = cfg.moe
    t, e, k = logits.shape[0], m.n_experts, m.top_k
    tl = t // groups
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[:, :k], ids[:, :k]                 # (T, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = ids.reshape(groups, tl * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    pos_sorted = (torch.arange(tl * k, device=logits.device)
                  - torch.searchsorted(sorted_e, sorted_e))
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    cap = max(int(math.ceil(tl * k / e * m.capacity_factor)), 1)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, e * cap)
    return (probs, gate, flat_e.reshape(t * k), keep.reshape(t * k),
            slot.reshape(t * k), cap)


def _moe_dispatch(cfg, tl, xf, logits):
    """Route and scatter one data shard's tokens xf (T, d), ``tl`` tokens
    a group: (buf (G, E, cap, d), probs (T, E), the combine weights keep ·
    gate (T·k,), the rows of the groups' flat buffers the copies went to
    (T·k,), the kept copies per expert (E,)).  Every dropped copy goes to
    its group's overflow row E · cap, which is discarded; the kept slots
    are unique, so the scatter is a copy."""
    m = cfg.moe
    t, d = xf.shape
    k, e = m.top_k, m.n_experts
    g = t // tl
    probs, gate, flat_e, keep, slot, cap = moe_route(cfg, logits, g)
    if g > 1:                          # group j's rows start at j (E·cap+1)
        slot = slot + (torch.arange(g, device=xf.device)
                       * (e * cap + 1)).repeat_interleave(tl * k)
    buf = xf.new_zeros((g * (e * cap + 1), d)).index_copy_(
        0, slot, xf.repeat_interleave(k, dim=0))
    buf = buf.view(g, e * cap + 1, d)[:, :-1].reshape(g, e, cap, d)
    counts = torch.zeros(e, dtype=F32, device=xf.device).index_add_(
        0, flat_e, keep.float())
    return buf, probs, keep * gate.reshape(t * k), slot, counts


def _moe_combine(cfg, y, weight, slot):
    """Gather every copy's expert output from its group's rows of y (G, E,
    cap, d), weight it and sum each token's k copies: (T, d)."""
    g, e, cap, d = y.shape
    yflat = torch.cat([y.reshape(g, e * cap, d), y.new_zeros((g, 1, d))],
                      dim=1).reshape(g * (e * cap + 1), d)
    back = yflat[slot] * weight.to(y.dtype)[:, None]
    return back.view(-1, cfg.moe.top_k, d).sum(dim=1)


def moe(cfg: ArchConfig, p, x):
    """Group-local, sort-based, capacity-limited top-k dispatch (JAX
    ``layers.moe``).

    The tokens are split into ``ctx_groups()`` groups of consecutive
    tokens, the data-parallel shards of the mesh context (one group
    without a context, or when the groups do not divide T, as in JAX);
    ranking, capacity and scatter are within each group.  Ties in the
    router probabilities go to the lower expert index, as ``lax.top_k``
    breaks them (a stable descending sort); each expert's tokens are
    ranked in token order (a stable argsort); slots past the capacity
    ``cap`` are dropped.  The expert products are batched matmuls over
    the experts.  On a mesh the dispatch and the combine run on each data
    shard's local tokens (``sharding.data_local``, the JAX layer's vmap
    over groups), and the expert-parallel reshard is an explicit
    redistribute (``ctx_constrain``) where the JAX layer constrains.
    Returns (out, {"moe_lb", "moe_z"})."""
    m = cfg.moe
    b, s, d = x.shape
    t, k, e = b * s, m.top_k, m.n_experts
    grp = ctx_groups()
    if t % grp:
        grp = 1
    dp = "dp" if grp > 1 else None
    xf = x.reshape(t, d)
    logits = (xf @ p["router"]).float()                 # (T, E)
    buf, probs, weight, slot, counts = data_local(
        lambda xl, ll: _moe_dispatch(cfg, t // grp, xl, ll),
        [(dp, None, None, None), (dp, None), (dp,), (dp,), "partial"],
        [(dp, None), (dp, None)], xf, logits)
    buf = ctx_constrain(buf, dp, None, None, None)
    # the expert-parallel reshard (the JAX layer's all-to-all)
    espec_in = (dp, "model" if m.shard == "expert" else None, None, None)
    buf = ctx_constrain(buf, *espec_in)
    # the expert products' layout on (E, G·cap, f): the JAX layer's
    # (dp, model, ., .) on (G, E, cap, f) for expert shards, f on 'model'
    # for ffn shards
    espec_f = ("model", dp, None) if m.shard == "expert" \
        else (None, dp, "model")
    g_, cap = buf.shape[0], buf.shape[2]
    h = buf.transpose(0, 1).reshape(e, g_ * cap, d)    # (E, G·cap, d)
    g_out = ctx_constrain(torch.bmm(h, p["w_gate"]), *espec_f)
    u_out = ctx_constrain(torch.bmm(h, p["w_up"]), *espec_f)
    act = F.silu(g_out) if cfg.act == "swiglu" else gelu(g_out)
    y = torch.bmm(act * u_out, p["w_down"])             # (E, G·cap, d)
    y = y.reshape(e, g_, cap, d).transpose(0, 1)        # (G, E, cap, d)
    y = ctx_constrain(y, *espec_in)
    # back to data-local before the combine gather
    y = ctx_constrain(y, dp, None, None, None)
    out = data_local(lambda yl, wl, sl: _moe_combine(cfg, yl, wl, sl),
                     [(dp, None)], [(dp, None, None, None), (dp,), (dp,)],
                     y, weight, slot)
    out = out.view(b, s, d)
    # ---- aux losses (Switch load balance + router z-loss) ----------------
    me = probs.mean(dim=0)
    ce = counts / max(t * k, 1)
    lb = e * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return out, dict(moe_lb=lb, moe_z=z)


# --------------------------------------------------------------------------
# Mamba (selective SSM, chunked scan)
# --------------------------------------------------------------------------
def init_mamba(cfg: ArchConfig, gen, dtype, device, lead=()):
    d = cfg.d_model
    m = cfg.mamba or MambaCfg()
    di = m.expand * d
    dtr = m.dt_rank or -(-d // 16)
    u = torch.empty((*lead, di), dtype=F32, device=device).uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen)
    a_log = torch.log(torch.arange(1, m.d_state + 1, dtype=F32,
                                   device=device)).expand(*lead, di, -1)
    return dict(
        in_proj=_dense(gen, (d, 2 * di), dtype, device, lead=lead),
        conv_w=_dense(gen, (m.d_conv, di), dtype, device, 0.5, lead),
        conv_b=torch.zeros((*lead, di), dtype=dtype, device=device),
        x_proj=_dense(gen, (di, dtr + 2 * m.d_state), dtype, device,
                      lead=lead),
        dt_proj=_dense(gen, (dtr, di), dtype, device, lead=lead),
        dt_bias=torch.log(torch.expm1(torch.exp(u))).to(dtype),
        a_log=a_log.to(dtype).contiguous(),
        d_skip=torch.ones((*lead, di), dtype=dtype, device=device),
        out_proj=_dense(gen, (di, d), dtype, device, lead=lead))


def _conv_silu(p, xin):
    """The causal depthwise convolution along time, then SiLU."""
    s, kw = xin.shape[1], p["conv_w"].shape[0]
    xpad = F.pad(xin, (0, 0, kw - 1, 0))
    return F.silu(sum(xpad[:, i:i + s] * p["conv_w"][i] for i in range(kw))
                  + p["conv_b"])


def _ssm_inputs(p, xc, n):
    """dt (softplus of its projection), B and C from the convolved x, and
    A = −exp(a_log).  ``F.softplus`` returns x above its threshold of 20,
    where ``jax.nn.softplus`` computes log1p(exp(x)): they differ there by
    under 2e-9."""
    dtr = p["dt_proj"].shape[0]
    dt, bmat, cmat = torch.split(xc @ p["x_proj"], [dtr, n, n], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
    return dt, bmat, cmat, -torch.exp(p["a_log"].float())


def mamba_seq(cfg: ArchConfig, p, x, chunk=MAMBA_CHUNK, return_state=False):
    """Sequence form. x: (B, S, d).  The selective scan runs chunk by chunk
    (time padded to a multiple of ``chunk`` with dt = 0, so padded steps
    are the identity), the state carried across chunks; one chunk's
    (B, L, DI, N) float32 tensors are the largest the layer holds.  On a
    mesh the d_inner dim of x, z, the convolved x and each chunk's scan
    operands is pinned to 'model' (``ctx_constrain``), as in JAX.
    Returns out, or (out, (conv_buf (B, d_conv − 1, DI), h (B, DI, N)))
    with ``return_state``."""
    m = cfg.mamba or MambaCfg()
    b, s, _ = x.shape
    n = m.d_state
    xin, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xin = ctx_constrain(xin, "dp", None, "model")   # d_inner on 'model'
    z = ctx_constrain(z, "dp", None, "model")       # the gate, held across
    xc = ctx_constrain(_conv_silu(p, xin), "dp", None, "model")
    dt, bmat, cmat, a = _ssm_inputs(p, xc, n)
    di = xc.shape[-1]
    sp = -(-s // chunk) * chunk
    dt_, b_, c_, xc_ = (F.pad(v, (0, 0, 0, sp - s))
                        for v in (dt, bmat, cmat, xc))
    h = None
    ys = []
    for c0 in range(0, sp, chunk):
        dtc, bc, cc, xcc = (v[:, c0:c0 + chunk] for v in (dt_, b_, c_, xc_))
        abar = torch.exp(dtc.float()[..., None] * a)            # (B,L,DI,N)
        bx = (dtc * xcc).float()[..., None] * bc.float()[:, :, None, :]
        abar = ctx_constrain(abar, "dp", None, "model", None)
        bx = ctx_constrain(bx, "dp", None, "model", None)
        if h is None:                         # (B, DI, N) float32 zeros
            h = torch.zeros_like(bx[:, 0])
        # elementwise over (B, DI, N): on a mesh each shard's own states
        hs = ctx_local(_ssm_scan_chunk, 0, abar, bx, h)
        del abar, bx
        ys.append(torch.einsum("blin,bln->bli", hs, cc.float()))
        h = hs[:, -1].clone()
        del hs
    y = torch.cat(ys, dim=1)[:, :s]
    y = (y + xc.float() * p["d_skip"].float()).to(x.dtype)
    out = (y * F.silu(z)) @ p["out_proj"]
    if return_state:
        kw = p["conv_w"].shape[0]
        conv_buf = F.pad(xin, (0, 0, kw - 1, 0))[:, s:s + kw - 1]
        return out, (conv_buf.to(x.dtype).contiguous(), h)
    return out


def mamba_step(cfg: ArchConfig, p, x, state):
    """Decode form. x: (B, 1, d); state = (conv_buf (B, d_conv − 1, DI),
    h (B, DI, N)).  Returns (out (B, 1, d), new state)."""
    m = cfg.mamba or MambaCfg()
    conv_buf, h = state
    xin, z = (x[:, 0] @ p["in_proj"]).chunk(2, dim=-1)
    window = torch.cat([conv_buf, xin[:, None, :]], dim=1)     # (B, kw, DI)
    xc = F.silu(torch.einsum("bki,ki->bi", window, p["conv_w"])
                + p["conv_b"])
    dt, bvec, cvec, a = _ssm_inputs(p, xc, m.d_state)
    abar = torch.exp(dt.float()[..., None] * a)                 # (B, DI, N)
    bx = (dt * xc).float()[..., None] * bvec.float()[:, None, :]
    h = abar * h + bx
    y = torch.einsum("bin,bn->bi", h, cvec.float())
    y = (y + xc.float() * p["d_skip"].float()).to(x.dtype)
    return ((y * F.silu(z)) @ p["out_proj"])[:, None, :], (window[:, 1:], h)


# --------------------------------------------------------------------------
# RWKV6 (Finch): time-mix with data-dependent decay + channel-mix
# --------------------------------------------------------------------------
def init_rwkv(cfg: ArchConfig, gen, dtype, device, lead=()):
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    nh = d // hs
    lora = 32 if d >= 512 else 8

    def full(val):
        return torch.full((*lead, d), val, dtype=dtype, device=device)

    def dense(shape, scale=None):
        return _dense(gen, shape, dtype, device, scale=scale, lead=lead)

    return dict(
        mix_r=full(0.5), mix_k=full(0.5), mix_v=full(0.5), mix_w=full(0.5),
        mix_g=full(0.5),
        wr=dense((d, d)), wk=dense((d, d)), wv=dense((d, d)),
        wg=dense((d, d)), wo=dense((d, d)),
        # data-dependent decay lora: w = exp(-exp(wbase + tanh(x@w1)@w2))
        w_base=full(-2.0),
        w1=dense((d, lora), 0.01), w2=dense((lora, d), 0.01),
        u=dense((nh, hs), 0.5),                         # bonus
        ln_x=full(1.0), ln_cm=full(1.0),                # channel-mix norm
        cmix_k=full(0.5), cmix_r=full(0.5),
        ck=dense((d, cfg.d_ff)), cv=dense((cfg.d_ff, d)), cr=dense((d, d)),
    )


def _rwkv_mix(x, x_prev, mu):
    return x + (x_prev - x) * mu


def _shift(x):
    """x_{t-1} along the sequence, zero at t = 0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _decay_local(xw, w_base, w1, w2):
    return torch.exp(-torch.exp((w_base + torch.tanh(xw @ w1) @ w2)
                                .float()))


def _decay(p, xw):
    """The data-dependent decay exp(−exp(w_base + tanh(xw w1) w2)).  On a
    mesh each shard computes its own columns from its rows of xw (the
    low-rank product is replicated, w2's columns split over 'model'),
    in one local step: ``DTensor`` cannot fold the gradient its own
    layout would give the first product."""
    # rows split over the data axes where they divide (a batch of 1 does
    # not: DTensor's local step cannot place an uneven split)
    lead = ("dp" if xw.shape[0] % ctx_groups() == 0 else None,) \
        + (None,) * (xw.ndim - 2)
    return data_local(_decay_local, [lead + ("model",)],
                      [lead + (None,), ("model",), (None, None),
                       (None, "model")], xw, p["w_base"], p["w1"], p["w2"])


def rwkv_wkv_inputs(cfg: ArchConfig, p, x):
    """The WKV operands of sequence-form time-mix, each (B, S, nh, hs)
    float32 — r, k, v, the decay w — with the bonus u (nh, hs) float32
    and the gate g (B, S, d).  The operands of K8."""
    b, s, d = x.shape
    hs = cfg.rwkv_head_size
    nh = d // hs
    xprev = _shift(x)
    r = _rwkv_mix(x, xprev, p["mix_r"]) @ p["wr"]
    k = _rwkv_mix(x, xprev, p["mix_k"]) @ p["wk"]
    v = _rwkv_mix(x, xprev, p["mix_v"]) @ p["wv"]
    g = F.silu(_rwkv_mix(x, xprev, p["mix_g"]) @ p["wg"])
    w = _decay(p, _rwkv_mix(x, xprev, p["mix_w"]))
    heads = [a.float().reshape(b, s, nh, hs) for a in (r, k, v, w)]
    return (*heads, p["u"].float(), g)


def rwkv_time_mix_seq(cfg: ArchConfig, p, x, return_state=False,
                      use_kernels=True):
    """WKV recurrence over time. x: (B,S,d).  Returns (out, state) with
    state = (x[:, -1], S_final) when ``return_state``, else None."""
    b, s, d = x.shape
    rh, kh, vh, wh, u, g = rwkv_wkv_inputs(cfg, p, x)
    fn = wkv if use_kernels and x.is_cuda else wkv_scan
    if fn is wkv:
        _refuse_grad("K8 (wkv)", rh, kh, vh, wh, u)
    # per head: on a mesh each shard's local heads
    y, st_fin = ctx_local(fn, [0, 0], *(a.transpose(1, 2)
                                        for a in (rh, kh, vh, wh)), u)
    y = y.transpose(1, 2).reshape(b, s, d)
    y = rms_norm(y.to(x.dtype), p["ln_x"], cfg.norm_eps)
    out = (y * g) @ p["wo"]
    if return_state:
        return out, (x[:, -1].clone(), st_fin)   # a copy: a view keeps x alive
    return out, None


def _wkv_step(rt, kt, vt, wt, u, st):
    """One WKV step of every head: r, k, v, w (B, nh, hs), u (nh, hs), the
    state (B, nh, hs, hs).  Returns (y (B, nh, hs), the new state)."""
    kv = kt[..., :, None] * vt[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rt, st + u[..., None] * kv)
    return y, wt[..., None] * st + kv


def rwkv_time_mix_step(cfg: ArchConfig, p, x, state):
    """Decode form. state = (x_prev (B,d), S (B,nh,hs,hs))."""
    b, _, d = x.shape
    hs = cfg.rwkv_head_size
    nh = d // hs
    xprev, st = state
    xt = x[:, 0]
    r = _rwkv_mix(xt, xprev, p["mix_r"]) @ p["wr"]
    k = _rwkv_mix(xt, xprev, p["mix_k"]) @ p["wk"]
    v = _rwkv_mix(xt, xprev, p["mix_v"]) @ p["wv"]
    g = F.silu(_rwkv_mix(xt, xprev, p["mix_g"]) @ p["wg"])
    wt = _decay(p, _rwkv_mix(xt, xprev, p["mix_w"])).reshape(b, nh, hs)
    rt, kt, vt = (a.reshape(b, nh, hs).float() for a in (r, k, v))
    y, st = ctx_local(_wkv_step, [0, 5], rt, kt, vt, wt, p["u"].float(), st)
    y = rms_norm(y.reshape(b, d).to(x.dtype), p["ln_x"], cfg.norm_eps)
    return ((y * g) @ p["wo"])[:, None, :], (xt, st)


def rwkv_channel_mix(cfg: ArchConfig, p, x, x_prev=None):
    """x: (B,S,d) (sequence) or (B,d) with explicit x_prev (step)."""
    xprev = _shift(x) if x.ndim == 3 else x_prev
    k = torch.square(torch.relu(_rwkv_mix(x, xprev, p["cmix_k"]) @ p["ck"]))
    r = torch.sigmoid(_rwkv_mix(x, xprev, p["cmix_r"]) @ p["cr"])
    # on a mesh r is whole over 'model' and k @ cv a partial sum over it:
    # sum it first (DTensor would split the product's rows instead, and
    # then cannot fold the gradient into cr's product)
    return r * ctx_gather_model(k @ p["cv"])
