"""Gradient compression with error feedback: the counterpart of
``src/repro/optim/compression.py``.

The JAX hook compresses the gradients before the optimizer (the quantized
form is what would cross a pod link); on one device it reduces to
quantize + dequantize with error feedback, which is what this module
computes: ``bf16`` rounds each gradient (plus its carried error) to
bfloat16, ``int8`` to 127 levels of its largest magnitude, and the error
state carries what the rounding lost into the next step.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import tree as tr

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"          # none | bf16 | int8
    error_feedback: bool = True


def init_error_state(params, cfg: CompressionConfig):
    if cfg.kind == "none" or not cfg.error_feedback:
        return None
    return tr.map_leaves(
        lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)


def _quant_int8(g):
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_grads(cfg: CompressionConfig, grads, err_state):
    """Returns (compressed-then-decompressed grads, new error state)."""
    if cfg.kind == "none":
        return grads, err_state

    def one(g, e):
        g32 = g.to(F32) + (e if e is not None else 0.0)
        if cfg.kind == "bf16":
            gq = g32.to(torch.bfloat16).to(F32)
        elif cfg.kind == "int8":
            q, scale = _quant_int8(g32)
            gq = q.to(F32) * scale
        else:
            raise ValueError(cfg.kind)
        new_e = (g32 - gq) if cfg.error_feedback else None
        return gq.to(g.dtype), new_e

    flat_g = tr.leaves(grads)
    flat_e = ([None] * len(flat_g) if err_state is None
              else tr.leaves(err_state))
    out = [one(g, e) for g, e in zip(flat_g, flat_e)]
    new_g = tr.unflatten(grads, [o[0] for o in out])
    if err_state is None:
        return new_g, None
    return new_g, tr.unflatten(err_state, [o[1] for o in out])
