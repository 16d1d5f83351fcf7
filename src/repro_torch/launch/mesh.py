"""The devices of the batched solver's split of the system batch K.

Adapted from ``src/repro/launch/mesh.py``, whose ``make_solver_mesh``
(:52–72) builds a 1-D jax Mesh over the system-batch axis.  PyTorch has
no mesh: the split is a list of devices, one per shard of K
(``HyluOptions.mesh``, ``core/batched.py``), and ``make_solver_mesh``
returns the first N CUDA devices.  The JAX module's other helpers
(``make_production_mesh``, ``make_host_mesh``,
``ensure_virtual_cpu_devices``) set up XLA meshes for training and its
virtual CPU devices; they have no counterpart (ROADMAP.md): on the CPU and
on one card a mesh may name one device several times instead.
"""
from __future__ import annotations

#: the name of the axis the batched solver splits: the systems of a batch
BATCH_AXIS = "systems"


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
