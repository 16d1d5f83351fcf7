"""Per-device cost of a program, counted as it runs: the counterpart of
``src/repro/roofline/hlo_cost.py``.

The JAX module parses the compiled per-device HLO.  Eager PyTorch has no
such module, so :class:`OpCost` counts the program of one device as it
runs: a ``TorchDispatchMode`` that lets ``DTensor`` handle its own
dispatch (it returns ``NotImplemented`` for a call on ``DTensor``s) and so
sees what ``DTensor`` runs below it, the local shards' ATen ops and the
functional collectives it issues.  Per call it counts:

* FLOPs by dtype: a matmul or convolution 2·|out|·K, as
  ``torch.utils.flop_counter`` reckons it; each elementwise op of
  ``hlo_cost.ELEMENTWISE`` once per output element (an ATen op that is
  several HLO ops, such as ``addcmul`` or ``silu``, as many times);
  a reduction once per input element, as ``hlo_cost`` counts ``reduce``;
* bytes: operands plus outputs of each op that moves data (views and
  metadata move none).  Eager PyTorch does not fuse, so every
  intermediate is written and read again: this is an upper bound on what
  XLA's count over fused HLO would be for the same program;
* collective bytes by kind (all-reduce, all-gather, reduce-scatter,
  all-to-all, permute): the operand bytes, as ``hlo_cost`` counts them;
* hand-written kernels: they dispatch no ATen op, so every launch through
  ``kernels._build.launch`` reports its work from a formula of
  ``roofline.kernel_cost``; a launch without one goes into ``uncounted``
  by entry name and counts as nothing else;
* the least traffic of the call (:meth:`OpCost.min_bytes`, real tensors
  only): every storage that existed when the count began read once, as
  far as its views were read, every such storage written once, as far as
  in-place ops wrote into it, and the call's results written once.  The
  intermediates, which eager PyTorch writes and reads again, move nothing
  in it: this is the traffic of a program that fused the whole call (its
  weights, caches, inputs and results each moved once), a lower bound
  beside the eager count's upper one;
* the peak of live local bytes the program allocated beyond what existed
  when the count began (outputs of non-view ops, freed when their tensor
  is collected): what an eager rank allocates, tensors held by reference
  cycles counted until Python's own collections free them, as in an
  eager run.  On the card ``torch.cuda.max_memory_allocated`` is the
  better reading.

``DTensor``'s sharding propagation runs each new op once on fake tensors
of the global shapes to learn its output's shape; those runs are not the
program's and are not counted (the count pauses inside the propagator's
``_propagate_tensor_meta_non_cached``, and skips fake tensors of another
``FakeTensorMode`` than the program's).
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

#: HLO elementwise opcodes (``hlo_cost.ELEMENTWISE``) as ATen ops: the
#: number of such HLO ops one output element of the ATen op takes
ELEMENTWISE = {
    "add": 1, "sub": 1, "rsub": 1, "mul": 1, "div": 1, "maximum": 1,
    "minimum": 1, "abs": 1, "neg": 1, "exp": 1, "log": 1, "tanh": 1,
    "rsqrt": 1, "sqrt": 1, "pow": 1, "floor": 1, "ceil": 1, "sign": 1,
    "cos": 1, "sin": 1, "sigmoid": 1, "expm1": 1, "log1p": 1, "atan2": 1,
    "remainder": 1, "erf": 1, "reciprocal": 1, "square": 1, "clamp": 2,
    "clamp_min": 1, "clamp_max": 1, "addcmul": 2, "addcdiv": 2, "lerp": 3,
    "silu": 2, "relu": 1, "softplus": 3, "gelu": 8, "mean": 1,
    "_softmax": 3, "_log_softmax": 3, "logsumexp": 0,
}
#: reductions (``hlo_cost``'s ``reduce``): HLO ops per input element
REDUCTIONS = {"sum": 1, "mean": 1, "amax": 1, "amin": 1, "max": 1,
              "min": 1, "prod": 1, "logsumexp": 4, "_softmax": 2,
              "_log_softmax": 2, "var": 3, "cumsum": 1}
COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
}
#: the models' time recurrences, one operator each on fake tensors
#: (``models.recurrence``): the operations of their plain loops, per
#: state element of Mamba's scan (a multiply-add; its gradient twice
#: that) and per step and head of the WKV (7 hs^2, the plain form's;
#: its gradient twice that)
RECURRENCE_FLOPS = {
    "ssm_scan": lambda ins: 2.0 * ins[1].numel(),
    "ssm_scan_backward": lambda ins: 4.0 * ins[1].numel(),
    "wkv_scan": lambda ins: 7.0 * ins[0].numel() * ins[0].shape[-1],
    "wkv_scan_backward": lambda ins: 14.0 * ins[0].numel()
    * ins[0].shape[-1],
}
#: gathers move their output and read as much of the source, plus indices
GATHERS = {"index", "index_select", "gather", "take", "embedding"}
#: scatters read and write the updated region and read the update and
#: indices (``hlo_cost``'s 3 × update), whatever the target's size
SCATTERS = {"index_put", "index_copy", "index_add", "scatter",
            "scatter_add", "scatter_reduce", "index_fill", "masked_fill",
            "copy", "slice_scatter", "select_scatter", "fill", "zero"}
#: ops that move no data
_FREE = {"view", "_unsafe_view", "as_strided", "expand", "t", "transpose",
         "permute", "slice", "select", "unsqueeze", "squeeze", "alias",
         "detach", "lift_fresh", "empty", "empty_strided", "empty_like",
         "split", "split_with_sizes", "unbind", "chunk", "diagonal",
         "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
         "is_same_size", "_reshape_alias", "wait_tensor", "unfold",
         "narrow", "_to_copy_noop", "set_", "resize_", "new_empty",
         "new_empty_strided", "_local_scalar_dense"}


def _propagator():
    """``DTensor``'s ShardingPropagator class, or None."""
    try:
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
    except ImportError:
        return None
    return ShardingPropagator


#: the propagator's method that runs an op on fake global-shape tensors
_META = "_propagate_tensor_meta_non_cached"


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


#: views of more contiguous runs than this are counted by their own bytes
_MAX_RUNS = 4096


def _storage_key(t):
    return (t.device.type, t.device.index, t.untyped_storage().data_ptr())


def _runs(t):
    """The element intervals [start, end) of its storage that ``t``
    covers, or None when they are not a few contiguous runs."""
    if t.numel() == 0:
        return []
    off = t.storage_offset()
    dims = sorted((st, sz) for sz, st in zip(t.shape, t.stride())
                  if sz > 1 and st > 0)
    run, i = 1, 0
    while i < len(dims) and dims[i][0] == run:
        run *= dims[i][1]
        i += 1
    starts, n = [off], 1
    for st, sz in dims[i:]:
        n *= sz
        if n > _MAX_RUNS:
            return None
        starts = [s + j * st for s in starts for j in range(sz)]
    return [(s, s + run) for s in starts]


class _Touched:
    """The bytes of each storage that views touched: the union of their
    runs, plus the bytes of views of many runs, at most the storage's
    size."""

    def __init__(self):
        self.runs = collections.defaultdict(list)
        self.loose = collections.defaultdict(int)
        self.size = {}

    def add(self, key, t):
        r = _runs(t)
        if r is None:
            self.loose[key] += _nbytes(t)
        else:
            self.runs[key].extend((a * t.element_size(), b * t.element_size())
                                  for a, b in r)
        self.size[key] = t.untyped_storage().nbytes()

    def add_bytes(self, key, t, nbytes):
        """``nbytes`` of ``t``'s storage, wherever they lie in it."""
        self.loose[key] += nbytes
        self.size[key] = t.untyped_storage().nbytes()

    def total(self) -> int:
        out = 0
        for key, size in self.size.items():
            got, end = self.loose[key], -1
            for a, b in sorted(self.runs[key]):
                got += max(0, b - max(a, end))
                end = max(end, b)
            out += min(got, size)
        return out


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


class OpCost(TorchDispatchMode):
    """Count what runs inside ``with OpCost(fake_mode) as c:``.  Pass the
    ``FakeTensorMode`` of the program's fake tensors when it runs on fake
    tensors (the dry run), None on real ones."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = collections.defaultdict(float)      # by dtype name
        self.bytes = 0.0
        self.coll_by_kind = collections.defaultdict(float)
        self.kernels = {}           # entry -> {launches, flops, bytes}
        self.uncounted = collections.Counter()
        self.n_ops = 0
        self.by_op = {}             # ATen op -> [calls, FLOPs, bytes]
        self.live = self.peak_live = 0
        self.paused = 0
        self._prev = self._prev_meta = None
        # the least traffic (real tensors): storages made in the count,
        # and what the call read from / wrote into the others
        self._made = set()
        self._read, self._written = _Touched(), _Touched()
        from torch.distributed.tensor import DTensor

        self._dtensor = DTensor

    # ---------------------------------------------------------- totals
    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))

    @property
    def coll_bytes(self) -> float:
        return float(sum(self.coll_by_kind.values()))

    def min_bytes(self, result=None) -> int:
        """The call's least traffic: what it read from and wrote into the
        storages that existed before it, each byte once, plus the tensors
        of ``result`` (the call's return value) that it made, once."""
        out = _Touched()
        for t in _tensors(result):
            key = _storage_key(t)
            if key in self._made:
                out.add(key, t)
        return self._read.total() + self._written.total() + out.total()

    def record(self) -> dict:
        return {"flops_by_dtype": dict(self.flops),
                "flops": self.total_flops, "bytes": self.bytes,
                "coll_bytes": self.coll_bytes,
                "coll_by_kind": dict(self.coll_by_kind),
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "uncounted": dict(self.uncounted), "n_ops": self.n_ops,
                "by_op": {k: list(v) for k, v in self.by_op.items()},
                "peak_live_bytes": self.peak_live}

    # ---------------------------------------------------------- kernels
    def kernel(self, name: str, work) -> None:
        """One launch of entry ``name``; ``work`` returns its
        ({dtype name: FLOPs}, bytes), or is None (no formula)."""
        if work is None:
            self.uncounted[name] += 1
            return
        flops, nbytes = work()
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["launches"] += 1
        for dt, f in flops.items():
            self.flops[dt] += f
            k["flops"] += f
        k["bytes"] += nbytes
        self.bytes += nbytes

    def __enter__(self):
        from ..kernels import _build

        self._prev = _build.launch_observer
        _build.launch_observer = self.kernel
        prop = _propagator()
        if prop is not None and hasattr(prop, _META):
            meta = self._prev_meta = getattr(prop, _META)

            def paused(*args, **kwargs):
                self.paused += 1
                try:
                    return meta(*args, **kwargs)
                finally:
                    self.paused -= 1

            setattr(prop, _META, paused)
        return super().__enter__()

    def __exit__(self, *exc):
        from ..kernels import _build

        _build.launch_observer = self._prev
        if self._prev_meta is not None:
            setattr(_propagator(), _META, self._prev_meta)
            self._prev_meta = None
        return super().__exit__(*exc)

    # ---------------------------------------------------------- ATen ops
    def _foreign(self, tensors) -> bool:
        return any(isinstance(t, FakeTensor) and t.fake_mode
                   is not self.fake_mode for t in tensors)

    def _free(self, nbytes):
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        if self.paused or self._foreign(ins):
            return out
        self._count(func, args, kwargs, ins, out)
        return out

    def _touch(self, func, args, kwargs, ins, outs, name, ns):
        """The least traffic's bookkeeping of one op on real tensors."""
        if ns != "prim" and name not in _FREE and not func.is_view:
            schema = func._schema.arguments
            written = [args[i] if i < len(args) else kwargs.get(a.name)
                       for i, a in enumerate(schema)
                       if a.alias_info is not None and a.alias_info.is_write]
            written = [t for t in written if isinstance(t, torch.Tensor)]
            for t in written:
                if _storage_key(t) not in self._made:
                    self._written.add(_storage_key(t), t)
            for j, t in enumerate(ins):
                key = _storage_key(t)
                if key in self._made or any(t is w for w in written):
                    continue
                if j == 0 and name.rstrip("_") in GATHERS:
                    # a gather reads the source's rows it takes
                    self._read.add_bytes(key, t, sum(map(_nbytes, outs)))
                else:
                    self._read.add(key, t)
        if not any(r.alias_info is not None for r in func._schema.returns):
            self._made.update(_storage_key(t) for t in outs)

    def _count(self, func, args, kwargs, ins, out):
        from torch.utils.flop_counter import flop_registry

        name = func._overloadpacket.__name__
        ns = func.namespace
        outs = list(_tensors(out))
        self.n_ops += 1
        if self.fake_mode is None:
            self._touch(func, args, kwargs, ins, outs, name, ns)
        if ns == "_c10d_functional":
            kind = COLLECTIVES.get(name)
            if kind is not None:
                self.coll_by_kind[kind] += sum(map(_nbytes, ins))
            return
        if ns == "prim" or name in _FREE or func.is_view:
            return
        base = name.rstrip("_")
        dt = dtype_name((ins or outs)[0].dtype) if (ins or outs) else "none"
        packet = func._overloadpacket
        if ns == "repro_torch":
            f = RECURRENCE_FLOPS[name](ins)
        elif packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
        else:
            f = float(ELEMENTWISE.get(base, 0) * (outs[0].numel() if outs
                                                  else 0)
                      + REDUCTIONS.get(base, 0) * (ins[0].numel() if ins
                                                   else 0))
        if f:
            self.flops[dt] += f
            self.by_op.setdefault(name, [0, 0.0, 0.0])[1] += f
        if base in GATHERS:
            nbytes = 2 * sum(map(_nbytes, outs)) + sum(
                _nbytes(t) for t in ins[1:] if not t.is_floating_point())
        elif base in SCATTERS and func._schema.returns and \
                func._schema.returns[0].alias_info is not None:
            # in place on a target: 3 x the update (the last tensor
            # argument, or the target for a fill) and the indices
            upd = ins[-1] if len(ins) > 1 else ins[0]
            nbytes = 3 * _nbytes(upd) + sum(
                _nbytes(t) for t in ins[1:-1] if not t.is_floating_point())
        else:
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.bytes += nbytes
        rec = self.by_op.setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[2] += nbytes
        aliased = any(r.alias_info is not None for r in func._schema.returns)
        if not aliased:
            for t in outs:
                nb = _nbytes(t)
                self.live += nb
                weakref.finalize(t, self._free, nb)
            self.peak_live = max(self.peak_live, self.live)
