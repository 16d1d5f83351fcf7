"""Plain PyTorch version of the flash-attention kernel: the counterpart of
``src/repro/kernels/flashattn/ref.py`` (``attention_ref``)."""
from __future__ import annotations

import math

import torch


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B, Hq, T, D), k/v (B, Hkv, S, D), Hq % Hkv == 0 → (B, Hq, T, D) in
    q's dtype.  ``attention_ref``'s function with the kernels' rounding:
    logits in float32 times 1/sqrt(D), the causal mask with the (S − T)
    offset, p = exp(logits − row max) in float32, l the sum of the
    unrounded p, then p rounded to v's dtype for the float32 product with
    v, divided by l.  For float32 inputs it is ``attention_ref``; in
    bfloat16 it rounds p as the Pallas kernel and K7 do."""
    t, d = q.shape[2], q.shape[3]
    g = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vv = v.repeat_interleave(g, dim=1)
    logits = torch.einsum("bhtd,bhsd->bhts", q.float(), kf) * (
        1.0 / math.sqrt(d))
    if causal:
        s = kf.shape[2]
        rows = torch.arange(t, device=q.device)[:, None] + (s - t)
        mask = rows >= torch.arange(s, device=q.device)[None, :]
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhts,bhsd->bhtd", p.to(v.dtype).float(), vv.float())
    return (out / l).to(q.dtype)
