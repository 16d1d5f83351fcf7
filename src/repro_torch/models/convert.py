"""Carry the JAX package's model weights across.

``params_from_numpy`` turns the JAX params tree, as numpy arrays
(``jax.tree.map(np.asarray, params)`` of ``repro.models.transformer
.init_params``), into the port's tree: the same dicts and lists with each
leaf a tensor of the same shape and values.  Both trees lay weights out
(in, out) with leaves stacked (n_periods, ...), so this is a copy, never
a transpose; it works for every family of the registry (attention, MoE:
router and (E, d, f) expert stacks; Mamba: projections, conv, dt and
``a_log``; RWKV6).  bfloat16 leaves (numpy's ``ml_dtypes.bfloat16``) come
across bit for bit.  The training state carries across the same way:
``opt_state_from_numpy`` turns the JAX ``AdamWState`` (as numpy) into the
port's, and a compression error state, a tree of the params' layout, goes
through ``params_from_numpy``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.options import resolve_device


def _tensor(a, dev, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=dev, dtype=dtype or t.dtype)


def params_from_numpy(tree, device="cuda", dtype=None):
    """The port's params tree from the JAX one as numpy arrays, on
    ``device`` (leaves cast to ``dtype`` when one is given)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return _tensor(node, dev, dtype)

    return conv(tree)


def opt_state_from_numpy(state, device="cuda"):
    """The port's ``optim.adamw.AdamWState`` from the JAX one whose leaves
    are numpy arrays (``jax.tree.map(np.asarray, opt_state)``): the int32
    step and the float32 moment trees, on ``device``."""
    from ..optim.adamw import AdamWState

    step, m, v = state
    return AdamWState(step=params_from_numpy(step, device),
                      m=params_from_numpy(m, device),
                      v=params_from_numpy(v, device))
