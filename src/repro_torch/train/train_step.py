"""The loss and the training step: the counterpart of
``src/repro/train/train_step.py``.

``loss_fn`` is next-token cross-entropy (``ce_loss_chunked``) plus the MoE
aux terms.  The forward takes the plain route, ``use_kernels=False``: K7 and
K8 have no backward (the kernel route under grad raises), and the JAX
``forward`` never reaches its Pallas kernels either.  ``constrain``, as
in the JAX step, pins the residual stream's layout on a mesh
(``models.sharding.activation_constrainer``); it is None on one device.
"""
from __future__ import annotations

import torch

from .. import tree as tr
from ..configs.base import ArchConfig
from ..models import transformer as T
from ..optim import adamw
from ..optim.compression import CompressionConfig, compress_grads

F32 = torch.float32

MOE_LB_COEF = 0.01
MOE_Z_COEF = 1e-3


def _long(x):
    return None if x is None else x.long()


def loss_fn(cfg: ArchConfig, params, batch, seq_chunk=512, constrain=None):
    """(total loss, metrics): metrics hold ``ce`` and, for MoE configs, the
    summed ``moe_lb`` and ``moe_z`` before their coefficients."""
    hidden, aux, _ = T.forward(
        cfg, params,
        tokens=_long(batch.get("tokens")),
        embeds=batch.get("embeds"),
        positions=_long(batch.get("positions")),
        use_kernels=False,
        constrain=constrain,
    )
    loss = T.ce_loss_chunked(cfg, params, hidden, batch["labels"],
                             seq_chunk=seq_chunk)
    total = loss
    if "moe_lb" in aux:
        total = total + MOE_LB_COEF * aux["moe_lb"] / cfg.n_layers
        total = total + MOE_Z_COEF * aux["moe_z"] / cfg.n_layers
    return total, dict(ce=loss, **aux)


def value_and_grad(cfg: ArchConfig, params, batch, seq_chunk=512,
                   constrain=None):
    """(loss, metrics, grads): the gradient of ``loss_fn`` with respect to
    every leaf of ``params`` (zeros for a leaf the loss does not reach, as
    ``jax.value_and_grad`` gives them), each in its leaf's dtype."""
    flat = tr.leaves(params)
    with torch.enable_grad():
        req = [p.detach().requires_grad_(True) for p in flat]
        loss, metrics = loss_fn(cfg, tr.unflatten(params, req), batch,
                                seq_chunk, constrain)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tr.unflatten(params, grads)


def _split(x, microbatch, i):
    """Microbatch i of one batch array: rows of the batch axis, which is the
    second axis of a (3, B, S) positions array (the JAX step's test: three
    dims with a leading 3)."""
    if x.ndim == 3 and x.shape[0] == 3:
        return x.reshape(3, microbatch, -1, *x.shape[2:])[:, i]
    return x.reshape(microbatch, -1, *x.shape[1:])[i]


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    comp_cfg: CompressionConfig | None = None,
                    microbatch: int = 1, seq_chunk: int = 512,
                    constrain=None):
    """Returns step(params, opt_state, err_state, batch) ->
    (params, opt_state, err_state, metrics).  The params and the optimizer
    state are updated in place (the JAX step returns new trees and the
    trainer donates the old).  With ``microbatch`` > 1 the batch is split
    in that many parts run one after the other, their gradients summed in
    float32 and divided by ``microbatch``; the loss is the parts' mean and
    the other metrics are the last part's."""
    comp_cfg = comp_cfg or CompressionConfig()

    def step(params, opt_state, err_state, batch):
        if microbatch > 1:
            g_acc = [torch.zeros(p.shape, dtype=F32, device=p.device)
                     for p in tr.leaves(params)]
            lsum = 0.0
            for i in range(microbatch):
                mb = {k: _split(v, microbatch, i) for k, v in batch.items()}
                l, metrics, g = value_and_grad(cfg, params, mb, seq_chunk,
                                               constrain)
                for a, gi in zip(g_acc, tr.leaves(g)):
                    a.add_(gi)
                del g
                lsum = lsum + l
            g = tr.unflatten(params, [a / microbatch for a in g_acc])
            del g_acc
            loss = lsum / microbatch
        else:
            loss, metrics, g = value_and_grad(cfg, params, batch, seq_chunk,
                                              constrain)

        g, err_state = compress_grads(comp_cfg, g, err_state)
        params, opt_state, opt_m = adamw.apply_updates(
            opt_cfg, params, g, opt_state)
        metrics = dict(loss=loss, **metrics, **opt_m)
        return params, opt_state, err_state, metrics

    return step
