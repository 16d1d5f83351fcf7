"""Flash-attention wrapper: K7 ``flash_attention`` (``csrc/flash_attn.cu``).

On a CUDA tensor it launches the kernel (or raises); on a CPU tensor it
runs the plain version of :mod:`.ref`.  Every launch adds one to
``flash_attention.launches``.  The operands may be strided views — the
model hands it its (B, T, H, D) projections transposed to (B, H, T, D),
and the kernel reads them in place — and nothing is padded: ragged tiles
are masked in the kernel.  bfloat16 runs on the tensor cores (wgmma, with
q, k and v loaded by TMA, which needs 16-byte aligned bases and strides);
float32 runs in exact float32 FMA.
"""
from __future__ import annotations

import torch

from ...roofline import kernel_cost as kc
from .. import _build
from .ref import attention_plain

__all__ = ["flash_attention", "attention_plain"]

HEAD_DIMS = (16, 32, 64, 128, 256)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention of q (B, Hq, T, D) over k, v (B, Hkv, S, D); query head h
    reads KV head h // (Hq // Hkv).  Returns (B, Hq, T, D) in q's dtype, a
    view of a (B, T, Hq, D) buffer.  Causal attention needs T == S: the
    Pallas kernel masks ``row >= col`` with no offset and its oracle with
    the (S − T) offset, which agree only there.  Replaces
    ``repro.kernels.flashattn.kernel.flash_attention``."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or k.shape[1] == 0 or q.shape[1] % k.shape[1] \
            or k.shape[2] == 0:
        raise ValueError(f"need q (B, Hq, T, D) and k, v (B, Hkv, S, D) "
                         f"with Hq % Hkv == 0 and S > 0, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if causal and t != s:
        raise ValueError(f"causal attention needs T == S, got {t} and {s}")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal)
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 "
                        f"operands of one dtype, got {q.dtype}, {k.dtype} "
                        f"and {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes D in {HEAD_DIMS}, got {d}")
    if not (q.device == k.device == v.device and q.device.type == "cuda"):
        raise ValueError("flash_attention: every operand must lie on one "
                         "CUDA device")
    if q.stride(3) != 1 or k.stride(3) != 1 or k.stride() != v.stride():
        raise ValueError("flash_attention: D must be contiguous and k, v "
                         "must share their strides")
    if q.dtype == torch.bfloat16:
        _check_tma(q, k, v)
    out = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    o = out.transpose(1, 2)
    if out.numel():
        with _build.on_device(q):
            _build.launch(f"hylu_flash_attn_{_SUFFIX[q.dtype]}",
                          _build.ptr(q), _build.ptr(k), _build.ptr(v),
                          _build.ptr(out), b, hq, hkv, t, s, d, int(causal),
                          1.0 / d ** 0.5, *q.stride()[:3], *k.stride()[:3],
                          *o.stride()[:3], _build.stream_of(q),
                          work=lambda: kc.as_work(
                              q.element_size(),
                              kc.flash(b, hq, hkv, t, s, d, q.element_size(),
                                       causal),
                              tensor_cores=q.dtype == torch.bfloat16))
        flash_attention.launches += 1
    return o


def _check_tma(*ops) -> None:
    """What the bfloat16 kernel's TMA loads take: 16-byte aligned base
    pointers, and the stride of every dimension longer than 1 a positive
    multiple of 8 elements (16 bytes)."""
    for a in ops:
        if a.data_ptr() % 16 or any(
                n > 1 and (st <= 0 or st % 8)
                for n, st in zip(a.shape[:3], a.stride()[:3])):
            raise ValueError(f"flash_attention (bfloat16): operands must "
                             f"start 16-byte aligned with strides that are "
                             f"positive multiples of 8 elements, got "
                             f"strides {a.stride()} at offset "
                             f"{a.data_ptr() % 16} bytes")


flash_attention.launches = 0
