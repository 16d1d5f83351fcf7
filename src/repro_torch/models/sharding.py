"""Sharding policy: the partition spec of every param, cache and input leaf
on a mesh, and the mesh context the layers read: the counterpart of
``src/repro/models/sharding.py``.

Scheme (Megatron-style TP on 'model', DP over 'data' (+'pod'), optional
FSDP over 'data' for the archs with ``cfg.fsdp``):

  embeddings / lm_head (V, d)      → vocab on 'model'
  attn  wq/wk/wv (d, H·hd)         → heads on 'model'; wo (H·hd, d) the same
  mlp   up/gate (d, f) ↔ down      → f on 'model'
  moe   experts (E, d, f)          → E on 'model' (shard="expert") or f on
                                     'model' (shard="ffn", grok's E=8<16)
  mamba d_inner dims               → 'model'
  rwkv  head dims                  → 'model'
  norms, routers, mixes            → replicated
  FSDP  (cfg.fsdp)                 → the d_model dim also on 'data'

Caches: batch on the data axes when divisible, else the sequence dim on
'data'; kv-heads / state on 'model'.

A spec is a tuple with one entry per tensor dim: an axis name, None
(replicated) or a tuple of names (the dim split over several mesh axes,
the first the major one) — the entries of the JAX ``PartitionSpec``, so
the two compare as tuples.  The spec functions read only the mesh's axis
names and sizes (:func:`mesh_axes`): a ``torch.distributed``
``DeviceMesh`` or anything with the JAX mesh's ``shape`` / ``axis_names``.
:func:`placements` turns a spec into ``DTensor`` placements on a
``DeviceMesh``.

The mesh context (:func:`set_mesh_context`) lets the layers pin the
layouts of their intermediates without threading the mesh through every
call, as the JAX context does: :func:`ctx_constrain` redistributes a
``DTensor`` to a spec, :func:`ctx_groups` is the MoE layer's number of
data-parallel groups, and :func:`data_local` runs a function on each data
shard's local tensors.  Without a mesh context each is the identity (one
group), so on one device nothing changes.
"""
from __future__ import annotations

import contextlib

import torch

from ..configs.base import ArchConfig


def mesh_axes(mesh) -> dict:
    """{axis name: size} in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # torch DeviceMesh
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


def data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))


def _dp(mesh):
    """The data axes as one spec entry: a name alone for one axis, as the
    JAX ``PartitionSpec`` normalises a 1-tuple."""
    daxes = data_axes(mesh)
    return daxes[0] if len(daxes) == 1 else daxes


def _data_size(mesh) -> int:
    axes = mesh_axes(mesh)
    size = 1
    for a in data_axes(mesh):
        size *= axes[a]
    return size


def placements(spec, mesh) -> tuple:
    """The ``DTensor`` placements of ``spec`` on a ``DeviceMesh``: on each
    mesh dim, ``Shard(d)`` for the tensor dim d whose entry names it,
    ``Replicate()`` where no entry does."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dim = next((d for d, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


# --------------------------------------------------------------------------
# the mesh context
# --------------------------------------------------------------------------
_CTX = {"mesh": None}


def set_mesh_context(mesh):
    """Set (or with None clear) the mesh the layers constrain to."""
    _CTX["mesh"] = mesh


@contextlib.contextmanager
def mesh_context(mesh):
    """:func:`set_mesh_context` for the duration of a ``with`` block.  On a
    ``DeviceMesh`` the plain tensors a step makes inside the block
    (positions, masks, constants: the same on every rank) meet the
    ``DTensor`` operands as replicated ones (``implicit_replication``)."""
    prev = _CTX["mesh"]
    _CTX["mesh"] = mesh
    try:
        if hasattr(mesh, "mesh_dim_names"):
            from torch.distributed.tensor.experimental import \
                implicit_replication

            with implicit_replication():
                yield mesh
        else:
            yield mesh
    finally:
        _CTX["mesh"] = prev


def ctx_groups() -> int:
    """Number of data-parallel groups in the mesh context (1 without one).
    The MoE dispatch ranks and caps within each group."""
    mesh = _CTX["mesh"]
    return 1 if mesh is None else _data_size(mesh)


def _dtensor_mesh(x):
    """The context's mesh when it is a ``DeviceMesh`` and ``x`` a
    ``DTensor`` on it, else None."""
    mesh = _CTX["mesh"]
    if mesh is None or not hasattr(mesh, "mesh_dim_names"):
        return None
    from torch.distributed.tensor import DTensor

    return mesh if isinstance(x, DTensor) else None


def _model_index(mesh):
    names = mesh.mesh_dim_names
    return names.index("model") if "model" in names else None


def _model_offset(mesh, n: int) -> int:
    """First global index of this rank's shard of a dim of n split over
    'model' (``torch.chunk``'s ceiling split)."""
    m = mesh_axes(mesh)["model"]
    return mesh.get_local_rank("model") * -(-n // m)


def _on_model(x, mesh, dim):
    """``x`` with its placement on the mesh's 'model' dim set to
    ``Shard(dim)`` (``Replicate()`` for None)."""
    from torch.distributed.tensor import Replicate, Shard

    i = _model_index(mesh)
    if i is None:
        return x
    want = list(x.placements)
    want[i] = Replicate() if dim is None else Shard(dim)
    want = tuple(want)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def _model_partial(placements, mesh, reduce_op="sum"):
    """``placements`` with 'model' as a partial ``reduce_op``."""
    from torch.distributed.tensor import Partial

    out = list(placements)
    out[_model_index(mesh)] = Partial(reduce_op)
    return out


def _expand(mesh, dims):
    daxes = _dp(mesh)
    return tuple(daxes if d == "dp" else d for d in dims)


# --------------------------------------------------------------------------
# explicit layouts: where DTensor has no rule for what the model meets
# (each listed in docs/PORT.md); the identity off a mesh
# --------------------------------------------------------------------------
def ctx_constrain(x, *dims):
    """``x`` redistributed to the spec ``dims``, where "dp" stands for the
    data axes; the identity without a mesh context or for a plain
    tensor."""
    mesh = _dtensor_mesh(x)
    if mesh is None:
        return x
    want = placements(_expand(mesh, dims), mesh)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def ctx_gather_model(x):
    """``x`` replicated over 'model', its other placements kept: the
    all-gather Megatron-SP puts before a tensor-parallel block (GSPMD
    inserts it; ``DTensor`` has no rule for a matmul of the
    sequence-sharded residual).  The identity off a mesh."""
    mesh = _dtensor_mesh(x)
    return x if mesh is None else _on_model(x, mesh, None)


def ctx_gather_data(sub: dict) -> dict:
    """A sub-layer's weights with their 'data' split (FSDP, ``cfg.fsdp``)
    gathered: the all-gather FSDP makes before a layer runs (its gradient
    is the reduce-scatter back to the shards).  ``DTensor`` would
    otherwise contract over the data-split d_model and gather the
    activations' batch instead.  The identity off a mesh or without a
    data split."""
    if _CTX["mesh"] is None:
        return sub

    def gather(w):
        mesh = _dtensor_mesh(w)
        if mesh is None:
            return w
        from torch.distributed.tensor import Replicate, Shard

        daxes = data_axes(mesh)
        want = tuple(Replicate() if n in daxes and isinstance(p, Shard)
                     else p for n, p in zip(mesh.mesh_dim_names,
                                            w.placements))
        return w if want == tuple(w.placements) else w.redistribute(mesh,
                                                                    want)

    return {k: ctx_gather_data(v) if isinstance(v, dict) else gather(v)
            for k, v in sub.items()}


def ctx_like(y, x):
    """``y`` redistributed to ``x``'s layout: a sub-layer's output (a
    partial sum over 'model' after its row-parallel product) before it is
    added to the residual stream x.  Done explicitly, the reduce-scatter
    is part of the autograd graph, so that the gradient that flows back
    into the product is replicated over 'model' (``DTensor`` cannot fold
    a sequence-sharded gradient into a product).  The identity off a
    mesh."""
    if _dtensor_mesh(y) is None or _dtensor_mesh(x) is None \
            or tuple(y.placements) == tuple(x.placements):
        return y
    return y.redistribute(x.device_mesh, x.placements)


def ctx_embed(table, tokens):
    """``table[tokens]``; on a mesh as ``F.embedding``, whose ``DTensor``
    rule looks rows up in a vocab-sharded table shard by shard, then
    summed over 'model' at once (indexing would gather the whole table;
    the masked partial sum the rule leaves is not carried further)."""
    mesh = _dtensor_mesh(table)
    if mesh is None:
        return table[tokens]
    import torch.nn.functional as F

    return _on_model(F.embedding(tokens, table), mesh, None)


def ctx_split_heads(x, n: int, hd: int):
    """x (B, S, n·hd) as (B, S, n, hd).  On a mesh whose 'model' axis does
    not divide the n heads (``DTensor`` cannot split a sharded dim
    unevenly; GSPMD pads it), x is first redistributed over 'model' so
    that the split is local: sequence-sharded where 'model' divides S
    (query heads), else replicated (key / value heads, and a decode
    step's one position)."""
    mesh = _dtensor_mesh(x)
    if mesh is not None:
        msize = mesh_axes(mesh).get("model", 1)
        if n % msize:
            x = _on_model(x, mesh, 1 if x.shape[1] % msize == 0 and
                          x.shape[1] > 1 else None)
    return x.reshape(*x.shape[:2], n, hd)


def ctx_model_last(x):
    """``x`` (B, S, F) split over 'model' on its last dim where it was
    split on its sequence dim (attention output of query heads that
    'model' does not divide, ``ctx_split_heads``): the all-to-all before
    the row-parallel output projection, whose rows 'model' splits.
    ``DTensor`` cannot fold the sequence-sharded rows into the product.
    The identity otherwise."""
    mesh = _dtensor_mesh(x)
    i = None if mesh is None else _model_index(mesh)
    if i is None:
        return x
    from torch.distributed.tensor import Shard

    if x.placements[i] != Shard(1):
        return x
    return _on_model(x, mesh, x.ndim - 1)


def ctx_by_heads(fn, q, k, v, *rest):
    """``fn(q, k, v, *rest)`` for attention over q (B, T, H, D) and k, v
    (B, S, Hkv, D).  Where q is split by heads over 'model', it runs on
    each shard's local heads (``local_map``): ``DTensor`` cannot
    redistribute the strided shard that a product's fold of the sharded
    batch and heads makes.  Key and value heads that are not split with
    q's are first repeated to q's heads and split as q's are (a local
    slice).  Otherwise, and off a mesh, ``fn`` runs as it is."""
    mesh = _dtensor_mesh(q)
    i = None if mesh is None else _model_index(mesh)
    if i is None:
        return fn(q, k, v, *rest)
    from torch.distributed.tensor import Shard

    if q.placements[i] != Shard(2):
        return fn(q, k, v, *rest)
    if k.placements[i] != Shard(2):
        g = q.shape[2] // k.shape[2]
        k, v = (_on_model(a.repeat_interleave(g, dim=2), mesh, 2)
                for a in (k, v))
    return _local_map(lambda *a: fn(*a, *rest), [q.placements],
                      [q.placements, k.placements, v.placements],
                      mesh)(q, k, v)


def ctx_seq_split(logits, weighted, q, k, v, *rest):
    """Attention of q (B, 1, H, D) over the cache k, v (B, S, Hkv, D)
    whose rows S are split over 'model' (the sequence-parallel cache of
    ``cache_spec_tree``): each shard's ``logits(q, k, *rest, row0=...)``
    (B, H, 1, S_local) over its own rows, their max reduced over 'model'
    (a partial max), then ``weighted(logits, v, m)``'s exponent sums and
    weighted values, summed over 'model' (partial sums) by ``DTensor``.
    Returns (sums, weighted values), or None when the cache is not split
    so (the caller's own form applies)."""
    mesh = _dtensor_mesh(k)
    i = None if mesh is None else _model_index(mesh)
    if i is None:
        return None
    from torch.distributed.tensor import Shard

    if k.placements[i] != Shard(1):
        return None
    q = ctx_gather_model(q)
    row0 = _model_offset(mesh, k.shape[1])
    rep = list(q.placements)
    by_rows = list(rep)
    by_rows[i] = Shard(3)

    def stage1(a, b):
        lg = logits(a, b, *rest, row0=row0)
        return lg, lg.amax(dim=-1, keepdim=True)

    lg, m = _local_map(stage1, [by_rows, _model_partial(rep, mesh, "max")],
                       [rep, k.placements], mesh)(q, k)
    m = m.redistribute(mesh, rep)
    l, acc = _local_map(weighted, [_model_partial(rep, mesh)] * 2,
                        [by_rows, v.placements, rep], mesh)(lg, v, m)
    return l.redistribute(mesh, rep), acc.redistribute(mesh, rep)


def ctx_write_row(cache, pos: int, row):
    """``cache[:, pos] = row`` in place, for a cache (B, S, ...) and a row
    (B, ...).  Where 'model' splits the cache's rows S (the
    sequence-parallel cache), only the shard that holds row ``pos``
    writes it, into its local rows: ``DTensor`` would gather the whole
    cache to write one row, and into the gathered copy."""
    mesh = _dtensor_mesh(cache)
    i = None if mesh is None else _model_index(mesh)
    if i is not None:
        from torch.distributed.tensor import Replicate, Shard
    if i is None or cache.placements[i] != Shard(1):
        cache[:, pos] = row.to(cache.dtype)
        return
    row0 = _model_offset(mesh, cache.shape[1])
    local = cache.to_local()
    want = [Replicate() if p == Shard(1) else
            (Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1 else p)
            for p in cache.placements]
    if row0 <= pos < row0 + local.shape[1]:
        local[:, pos - row0] = row.redistribute(mesh, want).to_local().to(
            local.dtype)


def ctx_take_last(x, idx):
    """``x[..., idx]`` row by row (``torch.gather`` on the last dim).  On
    a mesh whose 'model' axis splits x's last dim (vocab-parallel
    logits), each shard takes the entries its range holds, zero
    elsewhere, and the sum over 'model' is left to ``DTensor`` (a partial
    sum): Megatron's vocab-parallel cross-entropy.  ``DTensor``'s own
    gather rule cannot reduce this case."""
    mesh = _dtensor_mesh(x)
    i = None if mesh is None else _model_index(mesh)
    if i is not None:
        from torch.distributed.tensor import Replicate, Shard
    if i is None or x.placements[i] != Shard(x.ndim - 1):
        return _gather_last(x, idx)
    lo = _model_offset(mesh, x.shape[-1])
    lead = [Replicate() if p == Shard(x.ndim - 1) else p
            for p in x.placements]

    def local(xl, il):
        rel = il - lo
        ok = (rel >= 0) & (rel < xl.shape[-1])
        got = _gather_last(xl, rel.clamp(0, xl.shape[-1] - 1))
        return got * ok

    return _local_map(local, [_model_partial(lead, mesh)],
                      [x.placements, lead], mesh, True)(x, idx)


def _gather_last(x, idx):
    return torch.gather(x, -1, idx[..., None])[..., 0]


# --------------------------------------------------------------------------
# local steps (local_map)
# --------------------------------------------------------------------------
def data_local(fn, out_dims, in_dims, *args):
    """``fn(*args)`` on each data shard's local tensors: the counterpart of
    the JAX layer's ``vmap`` over data-local groups.  ``in_dims`` gives
    each argument's spec (None for an argument that is no tensor) and
    ``out_dims`` each output's, where "partial" marks an output that holds
    each data shard's part of a sum; the arguments are redistributed to
    their specs first.  Without a mesh context, or on plain tensors, it is
    ``fn(*args)``."""
    mesh = next((m for m in map(_dtensor_mesh, args) if m is not None), None)
    if mesh is None:
        return fn(*args)

    def pl(dims):
        if dims is None:
            return None
        if dims == "partial":
            from torch.distributed.tensor import Partial, Replicate

            daxes = data_axes(mesh)
            return tuple(Partial() if n in daxes else Replicate()
                         for n in mesh.mesh_dim_names)
        return placements(_expand(mesh, dims), mesh)

    return _local_map(fn, [pl(d) for d in out_dims],
                      [pl(d) for d in in_dims], mesh, True)(*args)


def ctx_local(fn, out_like, *args):
    """``fn(*args)`` on each shard's local tensors, the arguments taken in
    the layouts they have and output j placed as argument ``out_like[j]``
    (an int for one output): for a computation that is local to each
    shard, such as a recurrence over the heads split over 'model'.  The
    identity wrapper off a mesh."""
    mesh = next((m for m in map(_dtensor_mesh, args) if m is not None), None)
    if mesh is None:
        return fn(*args)
    ins = [getattr(a, "placements", None) for a in args]
    outs = [ins[out_like]] if isinstance(out_like, int) \
        else [ins[i] for i in out_like]
    return _local_map(fn, outs, ins, mesh)(*args)


def _local_map(fn, outs, ins, mesh, redistribute=False):
    """``local_map`` of ``fn`` with out placements ``outs`` (one list per
    output) and in placements ``ins`` (None for a non-tensor).  An input
    replicated over a mesh dim on which some output differs from rank to
    rank (sharded or partial there) gets a partial gradient on that dim:
    each rank's backward sums only its own part."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    differs = [any(not isinstance(o[i], Replicate) for o in outs)
               for i in range(mesh.ndim)]
    grads = [None if p is None else
             [Partial() if isinstance(pi, Replicate) and differs[i] else pi
              for i, pi in enumerate(p)] for p in ins]
    return local_map(fn, out_placements=_outs(outs), in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=redistribute)


def _outs(placements: list):
    """``local_map``'s out_placements: a tuple of one list per output, or
    the one output's list."""
    outs = tuple(list(p) for p in placements)
    return outs if len(outs) > 1 else outs[0]


# --------------------------------------------------------------------------
# spec trees
# --------------------------------------------------------------------------
def batch_spec(mesh) -> tuple:
    return (_dp(mesh),)


def _is_leaf(x) -> bool:
    """A tensor, or a ``(shape, dtype)`` stand-in (``configs.shapes``)."""
    if hasattr(x, "shape"):
        return True
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], tuple) and not isinstance(x[1], tuple))


def shape_of(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x[0])


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples whose
    leaves are tensors or ``(shape, dtype)`` stand-ins, keeping its
    structure; path entries are dict keys and list / tuple indices."""
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    raise TypeError(f"not a tree node: {type(tree)}")


def zip_map(fn, tree, *others):
    """``fn(leaf, *matching nodes of others)`` over the leaves of ``tree``;
    each other tree has ``tree``'s structure above its leaves."""
    if _is_leaf(tree):
        return fn(tree, *others)
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    return type(tree)(zip_map(fn, v, *(o[i] for o in others))
                      for i, v in enumerate(tree))


def param_specs(cfg: ArchConfig, params_shapes) -> dict:
    """The spec of every leaf of the params tree (tensors, fake tensors or
    ``(shape, dtype)`` stand-ins), in its structure."""
    moe_shard = cfg.moe.shard if cfg.moe else "expert"

    def rule(path, leaf):
        nd = len(shape_of(leaf))
        lead = (None,) if "blocks" in path else ()   # stacked period axis

        def spec(*tail):
            full = lead + tail
            if len(full) != nd:
                raise ValueError(f"{'/'.join(path)}: rank {nd}, spec {full}")
            return full

        name = path[-1]
        if name in ("embed", "lm_head"):
            return ("model", None)
        if nd - len(lead) == 1:                    # biases / norms / mixes
            if name in ("bq", "bk", "bv", "conv_b", "dt_bias", "d_skip"):
                return spec("model")
            return spec(None)
        dsh = "data" if cfg.fsdp else None
        if name in ("wq", "wk", "wv"):
            return spec(dsh, "model")
        if name == "wo":
            return spec("model", dsh)
        if name in ("w_gate", "w_up"):
            if nd - len(lead) == 3:                # MoE experts (E, d, f)
                return spec("model", dsh, None) if moe_shard == "expert" \
                    else spec(None, dsh, "model")
            return spec(dsh, "model")
        if name == "w_down":
            if nd - len(lead) == 3:                # (E, f, d)
                return spec("model", None, dsh) if moe_shard == "expert" \
                    else spec(None, "model", dsh)
            return spec("model", dsh)
        rules = {                                  # mamba, then rwkv
            "router": (None, None), "in_proj": (dsh, "model"),
            "conv_w": (None, "model"), "x_proj": ("model", None),
            "dt_proj": (None, "model"), "a_log": ("model", None),
            "out_proj": ("model", dsh), "wr": (dsh, "model"),
            "wg": (dsh, "model"), "w1": (None, None), "w2": (None, "model"),
            "u": ("model", None), "ck": (dsh, "model"), "cv": ("model", dsh),
            "cr": (dsh, None)}
        if name in rules:
            return spec(*rules[name])
        return spec(*([None] * (nd - len(lead))))

    return map_with_path(rule, params_shapes)


def cache_spec_tree(cfg: ArchConfig, cache_shapes, mesh) -> list:
    """Specs for the decode cache (leaves lead with n_periods)."""
    daxes = _dp(mesh)
    dsize = _data_size(mesh)
    msize = mesh_axes(mesh).get("model", 1)

    def rule(path, leaf):
        shape = shape_of(leaf)
        batch_ok = shape[1] % dsize == 0
        bspec = daxes if batch_ok else None
        nd = len(shape)
        if nd == 5 and shape[3] == cfg.n_kv_heads:      # attn kv cache
            if cfg.n_kv_heads % msize == 0:
                return (None, bspec, None if batch_ok else "data", "model",
                        None)
            # kv heads that do not divide the model axis: the sequence
            # dim on 'model' instead
            if shape[2] % msize == 0:
                return (None, bspec, "model", None, None)
            return (None, bspec, None, None, None)
        if nd == 5:                                     # rwkv state
            return (None, bspec, "model", None, None)
        if nd == 4 and cfg.mamba and shape[2] != (cfg.mamba.d_conv - 1):
            return (None, bspec, "model", None)         # mamba h (np,B,di,n)
        if nd == 4:                                     # mamba conv
            return (None, bspec, None, "model")
        if nd == 3:                                     # rwkv xprev
            return (None, bspec, None)
        return (None,) * nd

    return map_with_path(rule, cache_shapes)


def activation_constrainer(mesh):
    """Residual-stream constraint for Megatron-SP: (B, S, d) lives batch-
    sharded over the data axes and sequence-sharded over 'model' at block
    boundaries."""
    dims = (_dp(mesh), "model", None)

    def constrain(x):
        if x.ndim != 3:
            return x
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            return x
        want = placements(dims, mesh)
        return x if tuple(x.placements) == want else \
            x.redistribute(mesh, want)

    return constrain


def zero_specs(pspecs, pshapes, mesh):
    """ZeRO-style optimizer-state sharding: the param spec with its first
    still-replicated, divisible dim also on 'data'."""
    dsize = mesh_axes(mesh).get("data", 1)

    def rule(shape_leaf, spec):
        shape = shape_of(shape_leaf)
        dims = list(spec) + [None] * (len(shape) - len(spec))
        named = [d for e in dims for d in (e if isinstance(e, tuple)
                                           else (e,))]
        if "data" in named:
            return spec
        for i, (d, n) in enumerate(zip(dims, shape)):
            if d is None and n % dsize == 0 and n >= dsize:
                dims[i] = "data"
                return tuple(dims)
        return spec

    return zip_map(rule, pshapes, pspecs)


def input_spec_tree(cfg: ArchConfig, specs: dict, mesh) -> dict:
    """Specs of the step's inputs (``configs.shapes.input_specs``)."""
    daxes = _dp(mesh)
    dsize = _data_size(mesh)
    out = {}
    for k, v in specs.items():
        if k == "cache":
            out[k] = cache_spec_tree(cfg, v, mesh)
            continue
        shape = shape_of(v)
        if k == "pos":
            out[k] = ()
        elif k == "positions":                 # (3, B, S)
            out[k] = (None, daxes if shape[1] % dsize == 0 else None, None)
        elif k == "embeds":
            out[k] = (daxes if shape[0] % dsize == 0 else None, None, None)
        else:                                  # tokens / labels (B, S)
            out[k] = (daxes if shape[0] % dsize == 0 else None, None)
    return out
