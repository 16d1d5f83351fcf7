"""Dry run on the production meshes: trace every (arch × shape × mesh) cell
per device, without allocating, and read its memory, FLOPs and collective
bytes.  The counterpart of ``src/repro/launch/dryrun.py``.

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
        [--out artifacts/dryrun]

The JAX module lowers and compiles each cell on 512 forced host devices
and parses the compiled per-device HLO.  Here one process is rank 0 of a
fake process group of 256 or 512 ranks (``launch.mesh``), and per cell:

  - params, optimizer state, inputs and caches are ``DTensor``s whose
    local shards are fake tensors (``FakeTensorMode``: shapes, no
    storage) of rank 0's shard, laid out by ``models.sharding``'s specs
    (ZeRO ``zero_specs`` on AdamW's m and v);
  - the port's own train step (with ``activation_constrainer``), prefill
    step or decode step runs once under the mesh context and under
    ``roofline.op_cost``, which counts the local ops and the collectives
    ``DTensor`` issues;
  - the record holds the JAX record's keys where their meaning carries
    over (``flops_per_device``, ``bytes_per_device``,
    ``coll_bytes_per_device``, ``coll_by_kind``, the three terms at the
    H100's rates, ``bottleneck``, ``model_flops``, ``useful_ratio``,
    ``mem_args_gib``), ``peak_live_gib`` (the peak of live local bytes
    the step allocated beyond its arguments: what an eager rank
    allocates; XLA's ``mem_temp_gib`` is its buffer assignment, another
    quantity) and ``t_trace_s`` in place of lower and compile times.

Rank 0 holds the largest shard of an uneven split (``DTensor``'s
``Shard`` gives it the ceiling, as GSPMD pads), so its bytes are the JAX
per-device ones.  No kernel is launched: fake tensors take the plain
route.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..configs import registry
from ..configs.shapes import SHAPES, cell_applicable, input_specs
from ..models import sharding as Sh
from ..models import transformer as T
from ..optim import adamw
from ..roofline import analysis as RA
from ..roofline.op_cost import OpCost
from ..serve.serve_step import make_decode_step, make_prefill_step
from ..train.train_step import make_train_step
from .mesh import make_production_mesh

MESH_NAMES = {False: "pod16x16", True: "pod2x16x16"}


def local_shape(shape, spec, mesh) -> tuple:
    """Rank 0's shard of a tensor of ``shape`` laid out by ``spec``: each
    dim divided, ceiling first, by every mesh axis the spec puts on it."""
    axes = Sh.mesh_axes(mesh)
    out = list(shape)
    for d, e in enumerate(spec):
        for name in (e if isinstance(e, tuple) else (e,)):
            if name is not None:
                out[d] = -(-out[d] // axes[name])
    return tuple(out)


def fake_dtensor(shape, dtype, spec, mesh):
    """A ``DTensor`` of global ``shape`` whose local shard is a tensor of
    rank 0's shape, made in the ambient ``FakeTensorMode`` (no storage, no
    scatter)."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    local = torch.empty(local_shape(shape, spec, mesh), dtype=dtype)
    return DTensor.from_local(local, mesh, Sh.placements(spec, mesh),
                              shape=torch.Size(shape), stride=tuple(stride),
                              run_check=False)


def _as_dtensors(tree, specs, mesh, dtype=None):
    """Fake ``DTensor``s of a tree of tensors or ``(shape, dtype)`` stand-ins
    laid out by its spec tree (``dtype`` overrides each leaf's)."""
    def make(leaf, spec):
        dt = dtype or (leaf.dtype if hasattr(leaf, "dtype") else leaf[1])
        return fake_dtensor(Sh.shape_of(leaf), dt, spec, mesh)

    return Sh.zip_map(make, tree, specs)


def local_bytes(tree) -> int:
    """Bytes of the local shards of a tree's ``DTensor`` leaves."""
    from torch.distributed.tensor import DTensor

    total = 0

    def add(leaf, *_):
        nonlocal total
        if isinstance(leaf, DTensor):
            loc = leaf.to_local()
            total += loc.numel() * loc.element_size()
        return leaf

    Sh.zip_map(add, tree)
    return total


def params_shape_tree(cfg, dtype=torch.bfloat16):
    """The params as fake tensors on the CPU (shapes and dtypes; nothing
    allocated).  Call inside a ``FakeTensorMode``."""
    return T.init_params(cfg, seed=0, dtype=dtype, device="cpu")


def trace_cell(cfg, shape, mesh, mesh_name, seq_chunk=512):
    """Run one cell's step once on fake ``DTensor``s under ``op_cost``:
    (record, OpCost)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as fm, Sh.mesh_context(mesh):
        pshapes = params_shape_tree(cfg)
        pspecs = Sh.param_specs(cfg, pshapes)
        params = _as_dtensors(pshapes, pspecs, mesh)
        specs = input_specs(cfg, shape)
        ispecs = Sh.input_spec_tree(cfg, specs, mesh)
        inputs = _as_dtensors(specs, ispecs, mesh)
        args_bytes = local_bytes(params) + local_bytes(inputs)
        cost = OpCost(fm)
        t0 = time.perf_counter()
        if shape.kind == "train":
            zspecs = Sh.zero_specs(pspecs, pshapes, mesh)
            m = _as_dtensors(pshapes, zspecs, mesh, torch.float32)
            v = _as_dtensors(pshapes, zspecs, mesh, torch.float32)
            opt = adamw.AdamWState(
                step=fake_dtensor((), torch.int32, (), mesh), m=m, v=v)
            args_bytes += local_bytes([opt.step, m, v])
            step = make_train_step(cfg, adamw.AdamWConfig(),
                                   seq_chunk=seq_chunk,
                                   constrain=Sh.activation_constrainer(mesh))
            with cost:
                step(params, opt, None, inputs)
        elif shape.kind == "prefill":
            prefill = make_prefill_step(cfg)
            with cost, torch.no_grad():
                prefill(params, **inputs)
        else:
            decode = make_decode_step(cfg)
            kw = {k: inputs[k] for k in ("embeds", "positions")
                  if k in inputs}
            with cost, torch.no_grad():
                decode(params, inputs["tokens"], inputs["cache"],
                       shape.seq_len - 1, **kw)
        t_trace = time.perf_counter() - t0
    n_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
    chips = mesh.size()
    rec = RA.compute(cfg, shape.name, shape.kind, mesh_name, chips, cost,
                     n_tokens).to_dict()
    rec.update(t_trace_s=t_trace, mem_args_gib=args_bytes / 2**30,
               peak_live_gib=cost.peak_live / 2**30, n_ops=cost.n_ops,
               status="ok")
    return rec, cost


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--seq-chunk", type=int, default=512)
    args = ap.parse_args(argv)

    archs = list(registry.ARCHS) if args.arch == "all" \
        else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    results = []
    t_all = time.perf_counter()
    for multi in meshes:
        mesh = make_production_mesh(multi_pod=multi)
        mesh_name = MESH_NAMES[multi]
        for an in archs:
            cfg = registry.get(an)
            for sn in shapes:
                shape = SHAPES[sn]
                ok, why = cell_applicable(cfg, shape)
                tag = f"{cfg.name} × {shape.name} × {mesh_name}"
                if not ok:
                    print(f"[skip] {tag}: {why}", flush=True)
                    results.append(dict(arch=cfg.name, shape=sn,
                                        mesh=mesh_name, status="skipped",
                                        reason=why))
                    continue
                try:
                    rec, _ = trace_cell(cfg, shape, mesh, mesh_name,
                                        seq_chunk=args.seq_chunk)
                    results.append(rec)
                    print(f"[ok]   {tag}: trace={rec['t_trace_s']:.1f}s "
                          f"args={rec['mem_args_gib']:.2f}GiB "
                          f"live={rec['peak_live_gib']:.2f}GiB "
                          f"flops/dev={rec['flops_per_device']:.3e} "
                          f"coll/dev={rec['coll_bytes_per_device']:.3e} "
                          f"bottleneck={rec['bottleneck']}", flush=True)
                except Exception as e:          # a cell's failure is data
                    traceback.print_exc()
                    results.append(dict(arch=cfg.name, shape=sn,
                                        mesh=mesh_name, status="error",
                                        error=str(e)[:500]))
                    print(f"[FAIL] {tag}: {e}", flush=True)
    out_path = os.path.join(
        args.out, "dryrun_" + "_".join("multi" if m else "single"
                                       for m in meshes) + ".json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r.get("status") == "ok")
    n_skip = sum(1 for r in results if r.get("status") == "skipped")
    n_err = len(results) - n_ok - n_skip
    print(f"\nDRYRUN: {n_ok} ok, {n_skip} skipped (documented), {n_err} "
          f"errors in {time.perf_counter() - t_all:.1f} s → {out_path}")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
