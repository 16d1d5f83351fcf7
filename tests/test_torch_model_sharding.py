"""The port's parallelism layer (``repro_torch.models.sharding``,
``repro_torch.launch.mesh``) against the JAX package, on the CPU.

* The spec functions (``param_specs``, ``cache_spec_tree``,
  ``input_spec_tree``, ``zero_specs``) equal the JAX package's entry by
  entry for every registry arch, on ``jax.sharding.AbstractMesh``
  stand-ins of 16 × 16, 2 × 16 × 16 and 4 × 4 (no devices needed).
* The MoE layer under a 4-group mesh context equals the JAX ``moe`` with
  its context set to a 4-device mesh (a subprocess with 4 forced host
  devices) within 1e-5 in float32, on tokens whose capacity drops differ
  from one group's.
* Four gloo ranks (spawned processes) run a sharded prefill, decode step
  and train step of reduced phi3 and qwen3-moe on a 2 × 2 mesh, and
  phi3's prefill and decode step on a 1 × 4 mesh (kv heads that 'model'
  does not divide: the sequence-parallel cache and the heads repeated for
  the query split), each held to the unsharded port within 1e-5 in
  float32.  The 2 × 2 outputs, gathered, are also held within 1e-5 to
  the JAX package's own sharded prefill, decode step and train step on a
  2 × 2 mesh of 4 forced host devices (a subprocess), from the same
  weights and tokens: the reference for what both ports of the layers
  share (the G-group MoE routing, the explicit layouts).
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.models import sharding as JSh  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import tree as tr  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import sharding as Sh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(jreg.ARCHS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x4": ((4, 4), ("data", "model"))}
TOL = 1e-5


def _jax_flat(tree):
    """(path, leaf) of a JAX pytree whose leaves are PartitionSpecs or
    ShapeDtypeStructs, with paths as the port's tuples of strings."""
    import jax
    from jax.sharding import PartitionSpec as P

    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        key = tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)
        out.append((key, leaf))
    return out


def _port_flat(tree, path=()):
    """(path, spec) of a port spec tree: dicts, lists and tuples of specs
    (tuples of entries)."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _port_flat(v, path + (k,))]
    if isinstance(tree, list) or (isinstance(tree, tuple) and tree
                                  and isinstance(tree[0], (tuple, list))):
        return [x for i, v in enumerate(tree)
                for x in _port_flat(v, path + (str(i),))]
    return [(path, tree)]


def _same(jflat, pflat):
    jflat, pflat = sorted(jflat, key=lambda x: x[0]), sorted(
        pflat, key=lambda x: x[0])
    assert [p for p, _ in jflat] == [p for p, _ in pflat]
    for (path, js), (_, ps) in zip(jflat, pflat):
        assert tuple(js) == tuple(ps), (path, js, ps)


@pytest.fixture(scope="module")
def port_param_shapes():
    """The port's params of every arch at full size, as fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    out = {}
    with FakeTensorMode():
        for name in ARCHS:
            out[name] = T.init_params(treg.get(name), dtype=torch.bfloat16,
                                      device="cpu")
    return out


@pytest.fixture(scope="module")
def jax_param_shapes():
    import jax
    import jax.numpy as jnp

    return {name: jax.eval_shape(
        lambda k, c=jreg.get(name): JT.init_params(c, k, dtype=jnp.bfloat16),
        jax.random.PRNGKey(0)) for name in ARCHS}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_spec_trees_match_jax(name, mesh_name, port_param_shapes,
                              jax_param_shapes):
    """param_specs, zero_specs and, for every shape suite,
    input_spec_tree (the cache's cache_spec_tree among them), entry by
    entry."""
    mesh = AbstractMesh(*MESHES[mesh_name])
    jcfg, tcfg = jreg.get(name), treg.get(name)
    jps = JSh.param_specs(jcfg, jax_param_shapes[name])
    tps = Sh.param_specs(tcfg, port_param_shapes[name])
    _same(_jax_flat(jps), _port_flat(tps))
    _same(_jax_flat(JSh.zero_specs(jps, jax_param_shapes[name], mesh)),
          _port_flat(Sh.zero_specs(tps, port_param_shapes[name], mesh)))
    for sname in jshapes.SHAPES:
        jin = JSh.input_spec_tree(
            jcfg, jshapes.input_specs(jcfg, jshapes.SHAPES[sname]), mesh)
        tin = Sh.input_spec_tree(
            tcfg, tshapes.input_specs(tcfg, tshapes.SHAPES[sname]), mesh)
        assert sorted(jin) == sorted(tin)
        for key in jin:
            _same(_jax_flat(jin[key]), _port_flat(tin[key])
                  if key == "cache" else [((), tin[key])])


def test_placements_follow_the_spec():
    """A spec's DTensor placements: Shard(d) on each mesh dim the spec's
    entry d names (both dims of a tuple entry), Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert Sh.placements((("pod", "data"), None, "model"), Mesh()) == (
        Shard(0), Shard(0), Shard(2))
    assert Sh.placements((None, "data"), Mesh()) == (
        Replicate(), Shard(1), Replicate())
    assert Sh.placements((), Mesh()) == (Replicate(),) * 3


def test_context_is_the_identity_off_a_mesh():
    """Without a mesh context: one group, and every constraint returns
    its tensor."""
    x = torch.randn(2, 3, 4)
    assert Sh.ctx_groups() == 1
    assert Sh.ctx_constrain(x, "dp", None, "model") is x
    assert Sh.ctx_gather_model(x) is x
    with Sh.mesh_context(AbstractMesh((4, 2), ("data", "model"))):
        assert Sh.ctx_groups() == 4
        assert Sh.ctx_constrain(x, "dp", None, "model") is x
    assert Sh.ctx_groups() == 1


# ---------------------------------------------------------------- MoE groups
_JAX_MOE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp, dataclasses
from repro.configs import registry
from repro.launch.mesh import compat_make_mesh
from repro.models import layers as JL, sharding as JSh
d = np.load(sys.argv[1])
cfg = registry.get("qwen3-moe-30b-a3b").reduced()
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, capacity_factor=float(d["cf"])))
p = {k: jnp.asarray(d[k]) for k in ("router", "w_gate", "w_up", "w_down")}
JSh.set_mesh_context(compat_make_mesh((4, 1), ("data", "model")))
out, aux = JL.moe(cfg, p, jnp.asarray(d["x"]))
np.savez(sys.argv[2], out=np.asarray(out), lb=np.asarray(aux["moe_lb"]),
         z=np.asarray(aux["moe_z"]))
"""


def _moe_case(seed=5, cf=0.5):
    import dataclasses

    cfg = dataclasses.replace(
        treg.get("qwen3-moe-30b-a3b").reduced(),
        moe=dataclasses.replace(treg.get("qwen3-moe-30b-a3b").reduced().moe,
                                capacity_factor=cf))
    rng = np.random.default_rng(seed)
    d, m = cfg.d_model, cfg.moe
    p = {"router": rng.normal(size=(d, m.n_experts)) * 0.5,
         "w_gate": rng.normal(size=(m.n_experts, d, m.d_ff_expert)) * 0.1,
         "w_up": rng.normal(size=(m.n_experts, d, m.d_ff_expert)) * 0.1,
         "w_down": rng.normal(size=(m.n_experts, m.d_ff_expert, d)) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    # the first half of the tokens lean to expert 0, the second half to
    # expert 3: one group over all T drops copies that four groups keep
    x = rng.normal(size=(4, 8, d)).astype(np.float32)
    x[:2] += 2.0 * p["router"][:, 0] / np.linalg.norm(p["router"][:, 0])
    x[2:] += 2.0 * p["router"][:, 3] / np.linalg.norm(p["router"][:, 3])
    return cfg, p, x.astype(np.float32)


class _FourGroups:
    """A mesh stand-in of 4 data groups (the context reads only its axes)."""
    axis_names = ("data", "model")
    shape = {"data": 4, "model": 1}


def test_moe_four_groups_match_jax(tmp_path):
    cfg, p, x = _moe_case()
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    with Sh.mesh_context(_FourGroups()):
        out, aux = L.moe(cfg, tp, torch.from_numpy(x))
    one, _ = L.moe(cfg, tp, torch.from_numpy(x))
    logits = (torch.from_numpy(x).reshape(-1, cfg.d_model)
              @ tp["router"]).float()
    keep4 = L.moe_route(cfg, logits, 4)[3]
    keep1 = L.moe_route(cfg, logits, 1)[3]
    assert not torch.equal(keep4, keep1), "the drops must differ"
    assert not torch.allclose(out, one, atol=TOL)
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, x=x, cf=cfg.moe.capacity_factor, **p)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_MOE, str(src), str(dst)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = np.load(dst)
    np.testing.assert_allclose(out.numpy(), ref["out"], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux["moe_lb"]), float(ref["lb"]),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux["moe_z"]), float(ref["z"]),
                               atol=TOL, rtol=TOL)


# ---------------------------------------------------------------- gloo ranks
_RANK = r"""
import json, sys
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
from repro_torch import tree as tr
from repro_torch.configs import registry
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import sharding as Sh, transformer as T
from repro_torch.optim import adamw
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import make_train_step

res, arrays = {}, {}
B, S, SMAX = 4, 16, 20


def shard(tree, specs):
    return Sh.zip_map(lambda t, sp: distribute_tensor(
        t, mesh, Sh.placements(sp, mesh)), tree, specs)


def full(tree):
    return [t.full_tensor() if hasattr(t, "full_tensor") else t
            for t in tr.leaves(tree)]


def diff(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


# 2 x 2: both archs, every step; 1 x 4 (kv heads that 'model' does not
# divide: the sequence-parallel cache): phi3's prefill and decode
for model, names in ((2, ("phi3-medium-14b", "qwen3-moe-30b-a3b")),
                     (4, ("phi3-medium-14b",))):
    mesh = make_host_mesh(model=model)
    tag = f"{4 // model}x{model} "
    for name in names:
        cfg = registry.get(name).reduced()
        params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (B, S + 1)))
        pspecs = Sh.param_specs(cfg, params)
        sp = shard(params, pspecs)
        tok = distribute_tensor(tokens[:, :S], mesh,
                                Sh.placements(Sh.batch_spec(mesh) + (None,),
                                              mesh))
        prefill = make_prefill_step(cfg, s_max=SMAX, use_kernels=False)
        decode = make_decode_step(cfg)
        with torch.no_grad():
            with Sh.mesh_context(mesh):     # the unsharded port, G groups
                ref_logits, ref_cache = prefill(params, tokens=tokens[:, :S])
                got_logits, _ = prefill(sp, tokens=tok)
                res[tag + name + " prefill"] = diff([got_logits.full_tensor()],
                                              [ref_logits])
                cspecs = Sh.cache_spec_tree(cfg, ref_cache, mesh)
                scache = shard([tuple(c.clone() for c in leaf)
                                for leaf in ref_cache], cspecs)
                nxt = tokens[:, S:S + 1]
                snxt = distribute_tensor(nxt, mesh, Sh.placements(
                    Sh.batch_spec(mesh) + (None,), mesh))
                ref_d, ref_c = decode(params, nxt, ref_cache, S)
                got_d, got_c = decode(sp, snxt, scache, S)
                res[tag + name + " decode"] = diff(
                    [got_d.full_tensor()] + full(got_c),
                    [ref_d] + tr.leaves(ref_c))
        if model == 4:
            continue
        arrays[name + "|prefill"] = got_logits.full_tensor().numpy()
        arrays[name + "|decode"] = got_d.full_tensor().numpy()
        for i, c in enumerate(full(got_c)):
            arrays[f"{name}|cache{i}"] = c.numpy()
        # one train step from the same params and state
        batch = {"tokens": tokens[:, :S].int(), "labels": tokens[:, 1:].int()}
        sbatch = {k: distribute_tensor(v, mesh, Sh.placements(
            Sh.batch_spec(mesh) + (None,), mesh)) for k, v in batch.items()}
        zspecs = Sh.zero_specs(pspecs, params, mesh)
        ref_p = tr.map_leaves(torch.clone, params)
        ref_o = adamw.init_state(ref_p)
        sopt = adamw.AdamWState(
            step=distribute_tensor(torch.zeros((), dtype=torch.int32), mesh,
                                   Sh.placements((), mesh)),
            m=shard(adamw.init_state(params).m, zspecs),
            v=shard(adamw.init_state(params).v, zspecs))
        opt_cfg = adamw.AdamWConfig(lr=1e-3)
        with Sh.mesh_context(mesh):
            ref_step = make_train_step(cfg, opt_cfg, seq_chunk=8)
            rp, ro, _, rm = ref_step(ref_p, ref_o, None, batch)
            step = make_train_step(cfg, opt_cfg, seq_chunk=8,
                                   constrain=Sh.activation_constrainer(mesh))
            gp, go, _, gm = step(sp, sopt, None, sbatch)
        loss = gm["loss"]
        loss = loss.full_tensor() if hasattr(loss, "full_tensor") else loss
        res[tag + name + " train loss"] = abs(float(loss)
                                              - float(rm["loss"]))
        res[tag + name + " train m"] = diff(full(go.m), tr.leaves(ro.m))
        res[tag + name + " train v"] = diff(full(go.v), tr.leaves(ro.v))
        res[tag + name + " train params"] = diff(full(gp), tr.leaves(rp))
        arrays[name + "|loss"] = np.asarray(float(loss))
        for part, tree in (("params", gp), ("m", go.m), ("v", go.v)):
            for i, a in enumerate(full(tree)):
                arrays[f"{name}|{part}{i}"] = a.detach().numpy()
if rank == 0:
    with open(out, "w") as f:
        json.dump(res, f)
    np.savez(out + ".npz", **arrays)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_JAX_SHARDED = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.launch.mesh import compat_make_mesh
from repro.models import sharding as JSh, transformer as JT
from repro.optim import adamw
from repro.serve.serve_step import make_decode_step, make_prefill_step
from repro.train.train_step import make_train_step
d = np.load(sys.argv[1])
B, S, SMAX = 4, 16, 20
mesh = compat_make_mesh((2, 2), ("data", "model"))
JSh.set_mesh_context(mesh)
ns = lambda spec: jax.tree.map(lambda s: NamedSharding(mesh, s), spec,
                               is_leaf=lambda x: isinstance(x, P))
out = {}
for name in ("phi3-medium-14b", "qwen3-moe-30b-a3b"):
    cfg = registry.get(name).reduced()
    shapes = jax.eval_shape(lambda k: JT.init_params(
        cfg, k, dtype=jnp.float32), jax.random.PRNGKey(0))
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in kp) for kp, _ in flat]
    assert paths == list(d[name + "|paths"]), "leaf order"
    params = jax.tree.unflatten(treedef, [jnp.asarray(d[f"{name}|w{i}"])
                                          for i in range(len(flat))])
    pspecs = JSh.param_specs(cfg, params)
    params = jax.device_put(params, ns(pspecs))
    rows = NamedSharding(mesh, P(*JSh.batch_spec(mesh), None))
    tokens = d[name + "|tokens"]
    logits, cache = jax.jit(make_prefill_step(cfg, s_max=SMAX))(
        params, tokens=jax.device_put(tokens[:, :S], rows))
    cache = jax.device_put(cache, ns(JSh.cache_spec_tree(cfg, cache, mesh)))
    dec = make_decode_step(cfg)
    lg, cache = jax.jit(lambda p, t, c: dec(p, t, c, S))(
        params, jax.device_put(tokens[:, S:S + 1], rows), cache)
    out[name + "|prefill"] = logits
    out[name + "|decode"] = lg
    for i, c in enumerate(jax.tree.leaves(cache)):
        out[f"{name}|cache{i}"] = c
    batch = {"tokens": jax.device_put(tokens[:, :S].astype(np.int32), rows),
             "labels": jax.device_put(tokens[:, 1:].astype(np.int32), rows)}
    zspecs = JSh.zero_specs(pspecs, params, mesh)
    opt = jax.device_put(adamw.init_state(params),
                         ns(adamw.AdamWState(step=P(), m=zspecs, v=zspecs)))
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3), seq_chunk=8,
                           constrain=JSh.activation_constrainer(mesh))
    gp, go, _, gm = jax.jit(lambda p, o, b: step(p, o, None, b))(
        params, opt, batch)
    out[name + "|loss"] = gm["loss"]
    for part, tree in (("params", gp), ("m", go.m), ("v", go.v)):
        for i, a in enumerate(jax.tree.leaves(tree)):
            out[f"{name}|{part}{i}"] = a
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def gloo_and_jax(tmp_path_factory):
    """The four gloo ranks' results (and their gathered 2 × 2 outputs),
    and the JAX package's sharded run on the same weights and tokens, the
    two run side by side."""
    tmp = tmp_path_factory.mktemp("gloo")
    out, src, dst = tmp / "res.json", tmp / "in.npz", tmp / "jax.npz"
    inputs = {}
    for name in ("phi3-medium-14b", "qwen3-moe-30b-a3b"):
        # the ranks' own weights and tokens (the same seeds)
        cfg = treg.get(name).reduced()
        flat = tr.flatten_with_paths(T.init_params(
            cfg, seed=0, dtype=torch.float32, device="cpu"))
        inputs[name + "|paths"] = np.array([p for p, _ in flat])
        for i, (_, w) in enumerate(flat):
            inputs[f"{name}|w{i}"] = w.numpy()
        inputs[name + "|tokens"] = np.random.default_rng(1).integers(
            0, cfg.vocab, (4, 17))
    np.savez(src, **inputs)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SHARDED, str(src), str(dst)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_RANK), str(r), port,
         str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    errs = []
    for p in procs + [jax_proc]:
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        errs.append((p.returncode, err[-3000:]))
    return errs, out, dst


def test_four_gloo_ranks_match_the_unsharded_port(gloo_and_jax):
    errs, out, _ = gloo_and_jax
    assert all(rc == 0 for rc, _ in errs[:4]), errs[:4]
    res = json.loads(out.read_text())
    assert len(res) == 14, res      # 2 x 2: 2 archs x 6; 1 x 4: 2
    for key, val in res.items():
        assert val <= TOL, (key, val, res)


def test_four_gloo_ranks_match_jax_sharded(gloo_and_jax):
    """The 2 × 2 prefill logits, decode logits and cache, train loss and
    the params, m and v after the step, gathered from the gloo ranks,
    against the JAX package's sharded run."""
    errs, out, dst = gloo_and_jax
    assert all(rc == 0 for rc, _ in errs), errs
    got, ref = np.load(str(out) + ".npz"), np.load(dst)
    assert sorted(got.files) == sorted(ref.files)
    assert len(got.files) > 2 * 6
    worst = {}
    for key in got.files:
        assert got[key].shape == ref[key].shape, key
        worst[key] = float(np.abs(got[key] - ref[key]).max())
    assert max(worst.values()) <= TOL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:8]
