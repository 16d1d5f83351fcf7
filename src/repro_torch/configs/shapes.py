"""Input-shape suites and the input specs of each (arch, shape) cell: the
counterpart of ``src/repro/configs/shapes.py``.

  train_4k      seq_len=4096    global_batch=256   → train_step
  prefill_32k   seq_len=32768   global_batch=32    → prefill_step
  decode_32k    seq_len=32768   global_batch=128   → decode_step (1 new token
                                                     against a 32k KV cache)
  long_500k     seq_len=524288  global_batch=1     → decode_step; only for
                sub-quadratic archs (ssm/hybrid)

``[audio]``/``[vlm]`` archs take precomputed frame/patch embeddings.  The
JAX package's stand-ins are ``jax.ShapeDtypeStruct``s; here each is a
``(shape, dtype)`` pair of a tuple and a torch dtype, as
``models.transformer.cache_specs`` returns them.  Nothing is allocated.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def cell_applicable(arch: ArchConfig, shape: ShapeCfg) -> tuple[bool, str]:
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, ("skipped: pure full-attention arch; long_500k needs "
                       "sub-quadratic attention (DESIGN.md §Arch-applicability)")
    return True, ""


def input_specs(arch: ArchConfig, shape: ShapeCfg,
                dtype=torch.bfloat16) -> dict:
    """(shape, dtype) stand-ins for every model input (no allocation)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        specs = dict(tokens=((b, s), i32))
        if shape.kind == "train":
            specs["labels"] = ((b, s), i32)
        if arch.embeddings_input:
            specs["embeds"] = ((b, s, arch.d_model), dtype)
        if arch.rope_type == "mrope":
            specs["positions"] = ((3, b, s), i32)
        return specs
    # decode: one new token against a cache of length seq_len
    from ..models.transformer import cache_specs
    specs = dict(
        tokens=((b, 1), i32),
        pos=((), i32),
        cache=cache_specs(arch, b, s, dtype=dtype),
    )
    if arch.embeddings_input:
        specs["embeds"] = ((b, 1, arch.d_model), dtype)
    if arch.rope_type == "mrope":
        specs["positions"] = ((3, b, 1), i32)
    return specs
