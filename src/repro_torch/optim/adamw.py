"""AdamW with global-norm clipping and a warmup + cosine schedule: the
counterpart of ``src/repro/optim/adamw.py``.

State mirrors the param tree: ``m`` and ``v`` in float32 whatever the
params' dtype, and an int32 step.  Each update runs in float32 and is
rounded to the param's dtype once.  ``torch.optim.AdamW`` is not this
function: on bfloat16 params it keeps bf16 moments and rounds twice a
step.  The leaves are walked in the reference's order (``repro_torch.tree``:
dict keys sorted), so the global norm sums them in the JAX order.

Where the JAX function returns new trees (and its caller donates the old
ones), :func:`apply_updates` updates the params and the state's tensors in
place and returns them: at full width a second copy of params, ``m`` and
``v`` would not fit beside the first.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .. import tree as tr

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32, shape ()
    m: dict
    v: dict


def init_state(params) -> AdamWState:
    leaves = tr.leaves(params)
    dev = leaves[0].device if leaves else None
    zero = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tr.map_leaves(zero, params),
                      v=tr.map_leaves(zero, params))


def lr_schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (a tensor), in float32."""
    step = step.to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree):
    """sqrt of the float32 sum of squares over every leaf, the leaves
    summed in the reference's order."""
    total = 0
    for leaf in tr.leaves(tree):
        total = total + torch.sum(leaf.to(F32) ** 2)
    return torch.sqrt(torch.as_tensor(total, dtype=F32))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState):
    """One AdamW step: (params, state, metrics), params and state updated
    in place.  metrics: ``grad_norm`` (before clipping) and ``lr``."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    sf = step.to(F32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=F32, device=sf.device), sf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=F32, device=sf.device), sf)
    flat_p = tr.leaves(params)
    flat_g = tr.leaves(grads)
    flat_m = tr.leaves(state.m)
    flat_v = tr.leaves(state.v)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and state differ in structure")
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        g = g.to(F32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        p32 = p.to(F32)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
        del p32, delta
    state.step.copy_(step)
    return params, state, dict(grad_norm=gnorm, lr=lr)
