"""The models' time recurrences as single operators: Mamba's chunk scan and
the RWKV6 WKV loop of the plain route.

On real tensors the layers call the plain functions here directly (the
chunk scan, ``kernels.wkv.ref.wkv_plain``).  A dry run traces full-size
cells on fake tensors, where every ATen op costs a few hundred µs to
dispatch, and a loop over 4,096–32,768 time steps in each of dozens of
layers would take hours; so on fake tensors the layers call the same
functions registered as custom operators (``torch.library``), one op
each forward and backward, with a fake implementation that gives only
the outputs' shapes.  The forward operators' real implementations are
the plain functions, and their gradient on real tensors recomputes the
forward under autograd, so there they give the plain functions' values
and gradients bit for bit (``tests/test_torch_roofline.py``); the
backward operators exist for fake tensors alone.  ``roofline.op_cost``
counts their work by formula (``RECURRENCE_FLOPS``).
"""
import torch
from torch._subclasses.fake_tensor import FakeTensor

from ..kernels.wkv.ref import wkv_plain


def ssm_scan_plain(a, bx, h0):
    """h_t = a_t · h_{t-1} + bx_t along axis 1 (time) from h_{-1} = h0;
    a / bx (B, L, DI, N), h0 (B, DI, N).  Returns the states h (B, L, DI,
    N).  The JAX function reaches the same states by an associative scan
    and also returns the running product of a, which ``mamba_seq`` does
    not use; here a loop over the chunk's steps, one fused multiply-add
    each, written into the states' tensor; under grad (``out=`` has no
    backward) the steps are stacked instead."""
    from .layers import grad_wanted

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


def _recomputed_grads(fn, inputs, grads_out):
    """The gradients of ``fn``'s outputs against its tensor inputs,
    ``grads_out`` flowing back (None for an output that gets none):
    ``fn`` recomputed under autograd."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in inputs]
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads_out) if g is not None]
        grads = torch.autograd.grad([o for o, _ in pairs], xs,
                                    [g for _, g in pairs], allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for x, g in zip(xs, grads))


# ---------------------------------------------------------------- Mamba
@torch.library.custom_op("repro_torch::ssm_scan", mutates_args=())
def ssm_scan_op(a: torch.Tensor, bx: torch.Tensor,
                h0: torch.Tensor) -> torch.Tensor:
    return ssm_scan_plain(a, bx, h0)


@ssm_scan_op.register_fake
def _(a, bx, h0):
    return torch.empty_like(bx)


def _fake_only(name):
    raise NotImplementedError(
        f"{name} runs on fake tensors only; on real tensors the gradient "
        "recomputes the plain function under autograd")


@torch.library.custom_op("repro_torch::ssm_scan_backward", mutates_args=())
def ssm_scan_backward_op(a: torch.Tensor, bx: torch.Tensor,
                         h0: torch.Tensor, grad: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    _fake_only("ssm_scan_backward")


@ssm_scan_backward_op.register_fake
def _(a, bx, h0, grad):
    return torch.empty_like(a), torch.empty_like(bx), torch.empty_like(h0)


def _ssm_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _ssm_backward(ctx, grad):
    if _fake(grad):
        return ssm_scan_backward_op(*ctx.saved_tensors, grad)
    return _recomputed_grads(ssm_scan_plain, ctx.saved_tensors, (grad,))


ssm_scan_op.register_autograd(_ssm_backward, setup_context=_ssm_setup)


# ---------------------------------------------------------------- RWKV6
@torch.library.custom_op("repro_torch::wkv_scan", mutates_args=())
def wkv_scan_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    y, s = wkv_plain(r, k, v, w, u)
    return y, s


@wkv_scan_op.register_fake
def _(r, k, v, w, u):
    *lead, t, hs = r.shape
    return (r.new_empty((*lead, t, hs), dtype=torch.float32),
            r.new_empty((*lead, hs, hs), dtype=torch.float32))


@torch.library.custom_op("repro_torch::wkv_scan_backward", mutates_args=())
def wkv_scan_backward_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         w: torch.Tensor, u: torch.Tensor,
                         gy: torch.Tensor, gs: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor, torch.Tensor]:
    _fake_only("wkv_scan_backward")


@wkv_scan_backward_op.register_fake
def _(r, k, v, w, u, gy, gs):
    return tuple(torch.empty_like(x) for x in (r, k, v, w, u))


def _wkv_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _wkv_backward(ctx, gy, gs):
    saved = ctx.saved_tensors
    if not _fake(saved[0]):
        return _recomputed_grads(wkv_plain, saved, (gy, gs))
    r = saved[0]
    if gy is None:
        gy = r.new_zeros(r.shape, dtype=torch.float32)
    if gs is None:
        gs = r.new_zeros((*r.shape[:-2], r.shape[-1], r.shape[-1]),
                         dtype=torch.float32)
    return wkv_scan_backward_op(*saved, gy, gs)


wkv_scan_op.register_autograd(_wkv_backward, setup_context=_wkv_setup)


# ---------------------------------------------------------------- entry
def _fake(*tensors) -> bool:
    return any(isinstance(t, FakeTensor) for t in tensors)


def ssm_scan(a, bx, h0):
    """:func:`ssm_scan_plain`, as one operator on fake tensors."""
    if _fake(a, bx, h0):
        return ssm_scan_op(a, bx, h0)
    return ssm_scan_plain(a, bx, h0)


def wkv_scan(r, k, v, w, u):
    """``wkv_plain``, as one operator on fake tensors."""
    if _fake(r, k, v, w, u):
        return wkv_scan_op(r, k, v, w, u)
    return wkv_plain(r, k, v, w, u)
