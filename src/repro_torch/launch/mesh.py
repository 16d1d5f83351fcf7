"""Meshes: the training / dry-run meshes and the devices of the batched
solver's split of the system batch K.  The counterpart of
``src/repro/launch/mesh.py``.

* ``make_production_mesh`` / ``make_host_mesh`` return a
  ``torch.distributed`` ``DeviceMesh`` with the JAX meshes' shapes and
  axis names.  A mesh of more ranks than there are devices (the 16 × 16
  and 2 × 16 × 16 production meshes on one host) runs on PyTorch's fake
  process group, which ranks 0 joins alone and whose collectives move no
  data: :func:`ensure_virtual_cpu_devices` (the JAX helper forces XLA's
  host device count) sets it up, so that callers never touch
  ``torch.distributed`` themselves.
* ``make_solver_mesh`` returns the first N CUDA devices: the batched
  solver's split is a list of devices, one per shard of K
  (``HyluOptions.mesh``, ``core/batched.py``); on the CPU and on one card
  such a list may name one device several times.

Nothing here runs at import time.
"""
from __future__ import annotations

#: the name of the axis the batched solver splits: the systems of a batch
BATCH_AXIS = "systems"


def _dist():
    import torch.distributed as dist

    return dist


def ensure_virtual_cpu_devices(n: int) -> int:
    """A world of ``n`` ranks for a mesh on one host: this process becomes
    rank 0 of a fake process group of ``n`` ranks
    (``torch.testing._internal.distributed.fake_pg``; its collectives
    return at once and move nothing, so one process traces the program of
    one rank of a large mesh), unless a group of ``n`` exists.  A fake
    group of another size is replaced; a real one raises: a smaller world
    is never left in place.  Returns ``n``."""
    dist = _dist()
    n = int(n)
    if dist.is_initialized():
        size, backend = dist.get_world_size(), dist.get_backend()
        if size == n:
            return n
        if backend != "fake":
            raise RuntimeError(
                f"need a world of {n} ranks but a {backend} process group "
                f"of {size} is initialized; run the dry run in a process of "
                "its own")
        dist.destroy_process_group()
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed import fake_pg

    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0,
                            world_size=n)
    return n


def _device_mesh(shape, axes):
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    dist = _dist()
    backend = dist.get_backend()
    dev = "cuda" if backend == "nccl" and torch.cuda.is_available() \
        else "cpu"
    return init_device_mesh(dev, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16 × 16 = 256 ranks ("data", "model"); multi-pod 2 × 16 × 16 = 512
    ("pod", "data", "model"), on a fake group of that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    ensure_virtual_cpu_devices(n)
    return _device_mesh(shape, axes)


def make_host_mesh(model: int = 1):
    """("data", "model") mesh over every rank of the initialized process
    group (a fake group of one without one), ``model`` of them on
    'model'."""
    dist = _dist()
    if not dist.is_initialized():
        ensure_virtual_cpu_devices(1)
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not split into model={model}")
    return _device_mesh((n // model, model), ("data", "model"))


def make_solver_mesh(n_devices: int | None = None) -> list:
    """The first ``n_devices`` CUDA devices (every visible one for None),
    the devices ``HyluOptions.mesh`` splits K over; an int there routes
    through this helper.  Raises when fewer devices are visible."""
    import torch

    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = visible if n_devices is None else int(n_devices)
    if not 1 <= n <= visible:
        raise ValueError(
            f"make_solver_mesh: asked for {n} devices but {visible} are "
            "visible — on one card or the CPU, name a device several "
            "times instead (HyluOptions(mesh=['cuda:0', 'cuda:0']) or "
            "mesh=N with device='cpu')")
    return [torch.device("cuda", i) for i in range(n)]
