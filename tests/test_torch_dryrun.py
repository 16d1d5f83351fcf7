"""The port's dry runs (``repro_torch.launch.dryrun``,
``repro_torch.launch.solver_dryrun``) and production meshes, on the CPU.

* One dry-run cell, reduced phi3 train and decode on a 4 × 4 mesh, against
  the JAX ``lower_cell`` (a subprocess with 16 forced host devices): equal
  per-device argument bytes, FLOPs per device within 0.8–1.25× of the
  JAX count.
* A full-size cell is traced without allocating: the process's resident
  memory grows by less than 1 GiB (a real allocation of its shards would
  take several).
* The cells skipped are ``cell_applicable``'s, as in JAX.
* The solver share on the CPU (the JAX dry run's unrefined float32
  program): its backward error within n eps32 and x within 4 cond eps32
  of ``spsolve`` (an unrefined float32 solve of these systems cannot come
  within 1e-4: measured 6.3e-3 of max |x|, condition up to 4.5e4), no
  collective.
* The mesh helpers: the production meshes' shapes and names on the fake
  group, and no smaller world left in place.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import scipy.sparse.linalg as spla  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import solver_dryrun as SD  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX_CELLS = """
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
from repro.configs import registry
from repro.configs.shapes import ShapeCfg
from repro.launch.dryrun import lower_cell
from repro.launch.mesh import compat_make_mesh
mesh = compat_make_mesh((4, 4), ("data", "model"))
cfg = registry.get("phi3-medium-14b").reduced()
out = {}
for kind in ("train", "decode"):
    rec = lower_cell(cfg, ShapeCfg("smoke", 64, 8, kind), mesh, "mesh4x4",
                     seq_chunk=32)
    out[kind] = dict(flops=rec["flops_per_device"],
                     args=rec["mem_args_gib"] * 2**30)
print("CELLS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake16():
    """Rank 0 of a fake group of 16 and its 4 x 4 mesh; the group is torn
    down after the module's tests."""
    import torch.distributed as dist

    M.ensure_virtual_cpu_devices(16)
    yield M.make_host_mesh(model=4)
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_CELLS], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    line = next((ln for ln in r.stdout.splitlines()
                 if ln.startswith("CELLS ")), None)
    assert line is not None, r.stderr[-3000:]
    return json.loads(line[len("CELLS "):])


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_cell_matches_jax_lower_cell(kind, fake16, jax_cells):
    cfg = treg.get("phi3-medium-14b").reduced()
    rec, cost = D.trace_cell(cfg, tshapes.ShapeCfg("smoke", 64, 8, kind),
                             fake16, "mesh4x4", seq_chunk=32)
    ref = jax_cells[kind]
    ratio = rec["flops_per_device"] / ref["flops"]
    print(f"{kind}: port/JAX FLOPs per device {ratio:.4f}")
    assert rec["status"] == "ok" and rec["chips"] == 16
    assert round(rec["mem_args_gib"] * 2**30) == round(ref["args"])
    assert 0.8 <= ratio <= 1.25, ratio
    assert rec["coll_bytes_per_device"] > 0 and not cost.uncounted
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["peak_live_gib"] > 0 and rec["t_trace_s"] > 0


@pytest.mark.parametrize("name", ["jamba-1.5-large-398b", "rwkv6-1.6b"])
def test_batch_of_one_decode_cell(name, fake16):
    """long_500k's decode has a batch of one, which the data axes do not
    divide: the cache and the RWKV decay stay whole over 'data', and the
    residual keeps its layout across the MoE and Mamba layers."""
    rec, cost = D.trace_cell(treg.get(name).reduced(),
                             tshapes.ShapeCfg("long", 512, 1, "decode"),
                             fake16, "mesh4x4")
    assert rec["status"] == "ok" and rec["flops_per_device"] > 0
    assert not cost.uncounted


def _rss():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def test_full_size_cell_allocates_nothing():
    """gemma-7b x decode_32k on the 16 x 16 mesh: about 1 GiB of real
    shards a rank (params and the 32k cache) if anything were allocated;
    the fake trace keeps the resident memory within 1 GiB of its start."""
    import torch.distributed as dist

    peak, stop = [_rss()], threading.Event()

    def sample():
        while not stop.is_set():
            peak[0] = max(peak[0], _rss())
            time.sleep(0.01)

    t = threading.Thread(target=sample)
    start = _rss()
    t.start()
    try:
        mesh = M.make_production_mesh()
        rec, _ = D.trace_cell(treg.get("gemma-7b"),
                              tshapes.SHAPES["decode_32k"], mesh, "pod16x16")
    finally:
        stop.set()
        t.join(timeout=10)
        if dist.is_initialized():
            dist.destroy_process_group()
    assert rec["status"] == "ok"
    assert rec["mem_args_gib"] > 1.0, rec["mem_args_gib"]
    assert peak[0] - start < 2**30, (peak[0] - start) / 2**30


def test_skipped_cells_are_jax_cell_applicable(tmp_path):
    for name in jreg.ARCHS:
        for sname in jshapes.SHAPES:
            assert tshapes.cell_applicable(
                treg.get(name), tshapes.SHAPES[sname]) == \
                jshapes.cell_applicable(jreg.get(name),
                                        jshapes.SHAPES[sname])
    import torch.distributed as dist

    try:
        assert D.main(["--arch", "phi3-medium-14b", "--shape", "long_500k",
                       "--mesh", "single", "--out", str(tmp_path)]) == 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    rec, = json.loads((tmp_path / "dryrun_single.json").read_text())
    assert rec["status"] == "skipped"
    assert rec["reason"] == jshapes.cell_applicable(
        jreg.get("phi3-medium-14b"), jshapes.SHAPES["long_500k"])[1]


def test_solver_share_on_the_cpu():
    """One device's share of 4,096 systems over 256 (K = 16), the JAX
    dry run's program: a float32 factor and one unrefined float32 solve.
    Its backward error is float32's (under n eps = 4.8e-5, normwise); its
    forward error is that times the condition, about 1e4 (infinity norm)
    here: measured 6.3e-3 of max |x|, so it is held to 4 cond eps of
    ``spsolve``, not to 1e-4.  No collective: the share is the whole
    program of one device."""
    rec, x, (a, values, b), cost = SD.share(device="cpu")
    assert rec["k_per_device"] == 16 and rec["chips"] == 256
    assert rec["coll_bytes_per_device"] == 0 and not cost.coll_by_kind
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert x.shape == (16, 800) and np.isfinite(x).all()
    eps = np.finfo(np.float32).eps
    for k in range(16):
        ak = a.copy()
        ak.data = values[k]
        xr = spla.spsolve(ak.tocsc(), b[k])
        r = ak @ x[k].astype(np.float64) - b[k]
        norm_a = abs(ak).sum(axis=1).max()
        assert np.abs(r).max() <= 800 * eps * (norm_a * np.abs(x[k]).max()
                                               + np.abs(b[k]).max())
        if k < 2:             # the condition of two systems, densely
            cond = np.linalg.cond(ak.toarray(), np.inf)
            assert np.abs(x[k] - xr).max() <= 4 * cond * eps \
                * np.abs(xr).max()
    assert rec["useful_flops_per_system"] > 0


def test_production_meshes_on_the_fake_group():
    import torch.distributed as dist

    try:
        m = M.make_production_mesh()
        assert m.mesh_dim_names == ("data", "model")
        assert tuple(m.shape) == (16, 16) and dist.get_world_size() == 256
        m = M.make_production_mesh(multi_pod=True)
        assert m.mesh_dim_names == ("pod", "data", "model")
        assert tuple(m.shape) == (2, 16, 16)
        assert M.ensure_virtual_cpu_devices(512) == 512
        h = M.make_host_mesh(model=16)
        assert tuple(h.shape) == (32, 16)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_a_real_group_of_another_size_is_not_replaced():
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="gloo process group of 1"):
            M.ensure_virtual_cpu_devices(4)
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
