"""Plain PyTorch version of the WKV kernel: the counterpart of
``src/repro/kernels/wkv/ref.py`` (``wkv_ref``), over any leading dims::

    y_t = r_t · (S_{t-1} + (u ⊙ k_t) v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
"""
from __future__ import annotations

import torch


def wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor):
    """r/k/v/w (..., T, hs), u broadcastable to (..., hs).  A loop over T in
    float32 from the zero state.  Returns (y (..., T, hs), s_final (...,
    hs, hs))."""
    *lead, t, hs = r.shape
    s = torch.zeros((*lead, hs, hs), dtype=torch.float32, device=r.device)
    uu = u.float().expand(*lead, hs)[..., :, None]
    ys = []
    for i in range(t):
        rt, kt, vt, wt = (a[..., i, :].float() for a in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("...k,...kv->...v", rt, s + uu * kv))
        s = wt[..., :, None] * s + kv
    y = (torch.stack(ys, dim=-2) if ys else
         torch.zeros((*lead, 0, hs), dtype=torch.float32, device=r.device))
    return y, s
