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
from ..kernels.wkv.ops import wkv, wkv_plain

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
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _rope(cfg, q.reshape(b, s, cfg.n_heads, hd), positions)
    k = _rope(cfg, k.reshape(b, s, cfg.n_kv_heads, hd), positions)
    return q, k, v.reshape(b, s, cfg.n_kv_heads, hd)


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
        o = _chunked_causal_attention(q, k, v)
    return o.reshape(b, s, -1) @ p["wo"], (k, v)


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
    ck[:, pos] = k[:, 0].to(ck.dtype)
    cv[:, pos] = v[:, 0].to(cv.dtype)
    g = h // hkv
    s_max = ck.shape[1]
    kk = ck.repeat_interleave(g, dim=2)
    vv = cv.repeat_interleave(g, dim=2)
    logit = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float())
    logit = logit / math.sqrt(hd)
    valid = torch.arange(s_max, device=x.device)[None, None, None, :] <= pos
    logit = torch.where(valid, logit, torch.tensor(-1e30, dtype=F32,
                                                   device=x.device))
    w = torch.softmax(logit, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w.to(vv.dtype), vv)
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


def moe_route(cfg: ArchConfig, logits):
    """The router's decisions from its float32 logits (T, E): (probs,
    gate (T, k) renormalised, experts (T·k,) token-major, keep (T·k,),
    slot (T·k,), cap).  Copy i of the token-major list goes to slot
    expert · cap + rank, its rank the count of earlier copies routed to
    the same expert; a copy of rank cap or more is dropped (keep False,
    slot E · cap)."""
    m = cfg.moe
    t, e, k = logits.shape[0], m.n_experts, m.top_k
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[:, :k], ids[:, :k]                 # (T, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = ids.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos_sorted = (torch.arange(t * k, device=logits.device)
                  - torch.searchsorted(sorted_e, sorted_e))
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    cap = max(int(math.ceil(t * k / e * m.capacity_factor)), 1)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, e * cap)
    return probs, gate, flat_e, keep, slot, cap


def moe(cfg: ArchConfig, p, x):
    """Sort-based, capacity-limited top-k dispatch (JAX ``layers.moe``).

    The JAX layer splits the tokens into ``ctx_groups()`` groups, the
    data-parallel shards of its mesh context, and ranks, caps and scatters
    within each.  On one device that count is 1, and the port has no mesh
    context: all T tokens are one group.  Ties in the router
    probabilities go to the lower expert index, as ``lax.top_k`` breaks
    them (a stable descending sort); each expert's tokens are ranked in
    token order (a stable argsort); slots past the capacity ``cap`` are
    dropped.  The expert products are plain batched matmuls.
    Returns (out, {"moe_lb", "moe_z"})."""
    m = cfg.moe
    b, s, d = x.shape
    t, k, e = b * s, m.top_k, m.n_experts
    xf = x.reshape(t, d)
    logits = (xf @ p["router"]).float()                 # (T, E)
    probs, gate, flat_e, keep, slot, cap = moe_route(cfg, logits)
    # ---- dispatch: unique kept slots; every dropped copy goes to the
    # overflow row e·cap, which is discarded ------------------------------
    buf = x.new_zeros((e * cap + 1, d)).index_copy_(
        0, slot, xf.repeat_interleave(k, dim=0))
    buf = buf[:-1].view(e, cap, d)
    g_ = torch.bmm(buf, p["w_gate"])
    u_ = torch.bmm(buf, p["w_up"])
    act = F.silu(g_) if cfg.act == "swiglu" else gelu(g_)
    y = torch.bmm(act * u_, p["w_down"])                # (E, cap, d)
    # ---- combine ---------------------------------------------------------
    yflat = torch.cat([y.reshape(e * cap, d), y.new_zeros((1, d))])
    back = yflat[slot] * (keep * gate.reshape(t * k)).to(y.dtype)[:, None]
    out = back.view(t, k, d).sum(dim=1).view(b, s, d)
    # ---- aux losses (Switch load balance + router z-loss) ----------------
    me = probs.mean(dim=0)
    ce = torch.zeros(e, dtype=F32, device=x.device).index_add_(
        0, flat_e, keep.float()) / max(t * k, 1)
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


def _ssm_scan_chunk(a, bx, h0):
    """h_t = a_t · h_{t-1} + bx_t along axis 1 (time) from h_{-1} = h0;
    a / bx (B, L, DI, N), h0 (B, DI, N).  Returns the states h (B, L, DI,
    N).  The JAX function reaches the same states by an associative scan
    and also returns the running product of a, which ``mamba_seq`` does
    not use; here a loop over the chunk's steps, one fused multiply-add
    each, written into the states' tensor; under grad (``out=`` has no
    backward) the steps are stacked instead."""
    if grad_wanted(a, bx, h0):
        hs, h = [], h0
        for i in range(a.shape[1]):
            h = torch.addcmul(bx[:, i], a[:, i], h)
            hs.append(h)
        return torch.stack(hs, dim=1)
    hs = torch.empty_like(bx)
    h = h0
    for i in range(a.shape[1]):
        h = torch.addcmul(bx[:, i], a[:, i], h, out=hs[:, i])
    return hs


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
    (B, L, DI, N) float32 tensors are the largest the layer holds.
    Returns out, or (out, (conv_buf (B, d_conv − 1, DI), h (B, DI, N)))
    with ``return_state``."""
    m = cfg.mamba or MambaCfg()
    b, s, _ = x.shape
    n = m.d_state
    xin, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xc = _conv_silu(p, xin)
    dt, bmat, cmat, a = _ssm_inputs(p, xc, n)
    di = xc.shape[-1]
    sp = -(-s // chunk) * chunk
    dt_, b_, c_, xc_ = (F.pad(v, (0, 0, 0, sp - s))
                        for v in (dt, bmat, cmat, xc))
    h = torch.zeros((b, di, n), dtype=F32, device=x.device)
    ys = []
    for c0 in range(0, sp, chunk):
        dtc, bc, cc, xcc = (v[:, c0:c0 + chunk] for v in (dt_, b_, c_, xc_))
        abar = torch.exp(dtc.float()[..., None] * a)            # (B,L,DI,N)
        bx = (dtc * xcc).float()[..., None] * bc.float()[:, :, None, :]
        hs = _ssm_scan_chunk(abar, bx, h)
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


def _decay(p, xw):
    return torch.exp(-torch.exp((p["w_base"] + torch.tanh(xw @ p["w1"])
                                 @ p["w2"]).float()))


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
    fn = wkv if use_kernels and x.is_cuda else wkv_plain
    if fn is wkv:
        _refuse_grad("K8 (wkv)", rh, kh, vh, wh, u)
    y, st_fin = fn(*(a.transpose(1, 2) for a in (rh, kh, vh, wh)), u)
    y = y.transpose(1, 2).reshape(b, s, d)
    y = rms_norm(y.to(x.dtype), p["ln_x"], cfg.norm_eps)
    out = (y * g) @ p["wo"]
    if return_state:
        return out, (x[:, -1].clone(), st_fin)   # a copy: a view keeps x alive
    return out, None


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
    u = p["u"].float()
    kv = kt[..., :, None] * vt[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rt, st + u[..., None] * kv)
    st = wt[..., None] * st + kv
    y = rms_norm(y.reshape(b, d).to(x.dtype), p["ln_x"], cfg.norm_eps)
    return ((y * g) @ p["wo"])[:, None, :], (xt, st)


def rwkv_channel_mix(cfg: ArchConfig, p, x, x_prev=None):
    """x: (B,S,d) (sequence) or (B,d) with explicit x_prev (step)."""
    xprev = _shift(x) if x.ndim == 3 else x_prev
    k = torch.square(torch.relu(_rwkv_mix(x, xprev, p["cmix_k"]) @ p["ck"]))
    r = torch.sigmoid(_rwkv_mix(x, xprev, p["cmix_r"]) @ p["cr"])
    return r * (k @ p["cv"])
