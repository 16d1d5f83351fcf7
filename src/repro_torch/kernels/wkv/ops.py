"""WKV wrapper: K8 ``wkv`` (``csrc/wkv.cu``).

On a CUDA tensor it launches the kernel (or raises); on a CPU tensor it
runs the plain version of :mod:`.ref`.  Every launch adds one to
``wkv.launches``.  It returns y and the final state — the function the
oracle ``wkv_ref`` returns; the Pallas kernel drops the state, which is
why the JAX layer can take it only without ``return_state``.  The operands
may be strided views (the model hands it its (B, T, H, hs) projections
transposed to (B, H, T, hs), read in place), and T is not padded.
"""
from __future__ import annotations

import torch

from ...roofline import kernel_cost as kc
from .. import _build
from .ref import wkv_plain

__all__ = ["wkv", "wkv_plain"]

HEAD_SIZES = (8, 16, 32, 64)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor):
    """r/k/v/w (B, H, T, hs), w the per-step decay (already exp'd); u
    (H, hs) or (B, H, hs).  Returns (y, s_final): y float32 (B, H, T, hs),
    a view of a (B, T, H, hs) buffer; s_final (B, H, hs, hs) float32.
    Replaces ``repro.kernels.wkv.ops.wkv_padded`` (and returns the state
    ``wkv_ref`` returns)."""
    if r.ndim != 4 or not r.shape == k.shape == v.shape == w.shape:
        raise ValueError(f"need r, k, v, w of one shape (B, H, T, hs), got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} and {tuple(w.shape)}")
    if r.device.type == "cpu":
        return wkv_plain(r, k, v, w, u)
    ops = (r, k, v, w)
    if any(a.dtype != torch.float32 for a in ops):
        raise TypeError("wkv takes float32 r, k, v, w")
    if not all(a.device == r.device for a in (*ops, u)):
        raise ValueError("wkv: every operand must lie on one CUDA device")
    if r.stride(-1) != 1 or any(a.stride() != r.stride() for a in ops):
        raise ValueError("wkv: hs must be contiguous and r, k, v, w must "
                         "share their strides")
    b, nh, t, hs = r.shape
    if hs not in HEAD_SIZES:
        raise ValueError(f"wkv takes hs in {HEAD_SIZES}, got {hs}")
    u3 = u.float().contiguous().expand(b, nh, hs)
    y = torch.empty((b, t, nh, hs), dtype=torch.float32,
                    device=r.device).transpose(1, 2)
    s = torch.empty((b, nh, hs, hs), dtype=torch.float32, device=r.device)
    if y.numel():
        with _build.on_device(r):
            _build.launch("hylu_wkv_f32", *map(_build.ptr, (*ops, u3, y, s)),
                          b, nh, t, hs, *r.stride()[:3], *u3.stride()[:2],
                          *y.stride()[:3], _build.stream_of(r),
                          work=lambda: kc.as_work(4, kc.wkv(b, nh, t, hs,
                                                            u.numel())))
        wkv.launches += 1
    elif s.numel():
        s.zero_()
    return y, s


wkv.launches = 0
