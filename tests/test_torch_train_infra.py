"""The port's training infrastructure against the JAX package, on the CPU:
the input-shape suites (``configs/shapes.py``), the token pipeline (batches
bit-equal), the checkpointer (the JAX tests' roundtrip, GC and uncommitted
cases, a bfloat16 leaf, and float32 checkpoints that either package writes
and the other restores, with equal values), the Trainer (a resumed run's
identical loss stream, the loss falling over 40 reduced steps, a NaN batch
rolled back, SIGTERM's final checkpoint) and the launcher CLI."""
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402,E501
from repro.configs import registry as jreg  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch import tree as tr  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import (opt_state_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes: the suite runs six
    workers on a few cores, where idle-spinning thread pools slow them
    all."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ shapes
def _spec_tree(specs, torch_side):
    """{key: (shape, dtype name)} with the decode cache flattened."""
    out = {}
    for k, v in specs.items():
        if k == "cache":
            for i, leaves in enumerate(v):
                for j, leaf in enumerate(leaves):
                    out[f"cache/{i}/{j}"] = _one(leaf, torch_side)
        else:
            out[k] = _one(v, torch_side)
    return out


def _one(spec, torch_side):
    if torch_side:
        shape, dt = spec
        return tuple(shape), str(dt).replace("torch.", "")
    return tuple(spec.shape), str(np.dtype(spec.dtype))


@pytest.mark.parametrize("shape", sorted(jshapes.SHAPES))
def test_input_specs_and_applicability_match_jax(shape):
    assert tshapes.SHAPES[shape] == tshapes.ShapeCfg(
        **vars(jshapes.SHAPES[shape]))
    for name in sorted(jreg.ARCHS):
        ja, ta = jreg.get(name), treg.get(name)
        js, ts = jshapes.SHAPES[shape], tshapes.SHAPES[shape]
        assert tshapes.cell_applicable(ta, ts) == \
            jshapes.cell_applicable(ja, js)
        for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                         (jnp.float32, torch.float32)):
            ref = _spec_tree(jshapes.input_specs(ja, js, jdt), False)
            got = _spec_tree(tshapes.input_specs(ta, ts, tdt), True)
            assert list(got) == list(ref), name
            assert got == ref, name


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_batches_bit_equal_to_jax(seed):
    a = jdata.SyntheticLM(vocab=997, seq_len=33, global_batch=3, seed=seed)
    b = tdata.SyntheticLM(vocab=997, seq_len=33, global_batch=3, seed=seed)
    for step in (0, 1, 17, 123456):
        ra, rb = a.batch(step), b.batch(step)
        assert sorted(ra) == sorted(rb)
        for k in ra:
            assert ra[k].dtype == rb[k].dtype == np.int32
            np.testing.assert_array_equal(rb[k], ra[k])


def test_memmap_corpus_and_batches_bit_equal_to_jax(tmp_path):
    pa, pb = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jdata.write_synthetic_corpus(pa, 20_000, vocab=300, seed=4)
    tdata.write_synthetic_corpus(pb, 20_000, vocab=300, seed=4)
    assert open(pa, "rb").read() == open(pb, "rb").read()
    a = jdata.MemmapDataset(pa, vocab=300, seq_len=40, global_batch=5, seed=2)
    b = tdata.MemmapDataset(pb, vocab=300, seq_len=40, global_batch=5, seed=2)
    assert a.n_windows == b.n_windows
    for step in (0, 3, 99):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b.batch(step)[k],
                                          a.batch(step)[k])
    np.testing.assert_array_equal(b.batch(0)["tokens"][:, 1:],
                                  b.batch(0)["labels"][:, :-1])


# ------------------------------------------------------------ checkpointer
def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    tree = dict(a=torch.arange(12.0).reshape(3, 4),
                b=dict(c=torch.ones((5,), dtype=torch.int32)))
    ck.save(3, tree)
    ck.save(7, tr.map_leaves(lambda x: x * 2, tree))
    assert ck.committed_steps() == [3, 7]
    restored = ck.restore(7, tree)
    torch.testing.assert_close(restored["a"], tree["a"] * 2)
    assert restored["b"]["c"].dtype == torch.int32


def test_checkpoint_gc_keeps_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    t = dict(x=torch.zeros(3))
    for s in (1, 2, 3, 4):
        ck.save(s, t)
    assert ck.committed_steps() == [3, 4]


def test_checkpoint_uncommitted_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3, async_save=False)
    ck.save(5, dict(x=torch.zeros(3)))
    os.makedirs(tmp_path / "step_000000009/arrays")  # a crash mid-save
    assert ck.latest_step() == 5


def test_checkpoint_async_save_snapshots_values(tmp_path):
    """The device-to-host copy is taken at ``save``: a leaf updated in
    place while the thread writes is saved as it was."""
    ck = Checkpointer(str(tmp_path), keep=3)
    t = dict(w=torch.ones(1000))
    ck.save(1, t)
    t["w"].add_(5.0)
    ck.wait()
    torch.testing.assert_close(ck.restore(1, t)["w"], torch.ones(1000))


def test_checkpoint_bf16_roundtrip(tmp_path):
    """A bfloat16 leaf restores bit for bit (the reference's own restore
    raises on the file it writes for such a leaf); the file is the one the
    JAX package writes, a 2-byte void array, and the port also reads the
    JAX package's."""
    w = torch.randn(7, 9).to(torch.bfloat16)
    tree = dict(params=dict(w=w, b=torch.zeros(3)))
    ck = Checkpointer(str(tmp_path / "t"), async_save=False)
    ck.save(1, tree)
    got = ck.restore(1, tree)["params"]["w"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), w.view(torch.int16))
    jck = JCheckpointer(str(tmp_path / "j"), async_save=False)
    jw = jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)
    jck.save(1, dict(params=dict(w=jw, b=jnp.zeros(3))))
    a = np.load(tmp_path / "j" / "step_000000001" / "arrays" / "1.npy")
    b = np.load(tmp_path / "t" / "step_000000001" / "arrays" / "1.npy")
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    got = Checkpointer(str(tmp_path / "j")).restore(1, tree)["params"]["w"]
    assert torch.equal(got.view(torch.int16), w.view(torch.int16))


def _train_state(seed):
    cfg = jreg.get("qwen3-moe-30b-a3b").reduced()
    params = JT.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    st = JA.init_state(params)
    st = JA.AdamWState(jnp.asarray(7, jnp.int32),
                       jax.tree.map(lambda x: x + 0.5, st.m),
                       jax.tree.map(lambda x: x + 0.25, st.v))
    return dict(params=params, opt=st)


def _as_port(jstate):
    nps = jax.tree.map(np.asarray, jstate)
    return dict(params=params_from_numpy(nps["params"], device="cpu"),
                opt=opt_state_from_numpy(nps["opt"], device="cpu"))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jstate = _train_state(1)
    JCheckpointer(str(tmp_path), async_save=False).save(4, jstate)
    like = _as_port(_train_state(2))
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 4
    got = ck.restore(4, like)
    assert int(got["opt"].step) == 7 and got["opt"].step.dtype == torch.int32
    ref = tr.flatten_with_paths(_as_port(jstate))
    for (p, a), (q, b) in zip(ref, tr.flatten_with_paths(got)):
        assert p == q and torch.equal(a, b), p


def test_port_checkpoint_restores_in_jax(tmp_path):
    state = _as_port(_train_state(1))
    Checkpointer(str(tmp_path), async_save=False).save(6, state)
    like = _train_state(2)
    got = JCheckpointer(str(tmp_path)).restore(6, like)
    ref = jax.tree.map(np.asarray, _train_state(1))
    assert int(got["opt"].step) == 7
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(b), a)
    paths = [p for p, _ in tr.flatten_with_paths(state)]
    assert "opt/.step" in paths and "params/blocks/0/attn/wq" in paths
    assert any(p.startswith("opt/.m/blocks/0/ffn/") for p in paths)


# ----------------------------------------------------------------- trainer
def _trainer(cfg, ckdir, data, total=30, ckpt_every=10, seed=0, **kw):
    params = T.init_params(cfg, seed=seed, dtype=torch.float32, device="cpu")
    return Trainer(TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                                 ckpt_dir=str(ckdir), log_every=1000,
                                 seq_chunk=16), cfg, params, data,
                   device="cpu", **kw)


def test_trainer_resume_identical_stream(tmp_path):
    """A 30-step run and 20 steps + resume + 10 steps give the same losses
    bit for bit (the JAX test holds 1e-4)."""
    cfg = treg.get("gemma-7b").reduced()
    data = tdata.SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=2,
                             seed=5)
    log1 = _trainer(cfg, tmp_path / "a", data).run()
    t2 = _trainer(cfg, tmp_path / "b", data)
    t2.run(n_steps=20)
    t2.ckpt.wait()
    t3 = _trainer(cfg, tmp_path / "b", data)
    assert t3.maybe_resume() == 20
    log3 = t3.run()
    assert [r["step"] for r in log3] == list(range(21, 31))
    assert [r["loss"] for r in log1][-10:] == [r["loss"] for r in log3]


def test_trainer_loss_decreases(tmp_path):
    cfg = treg.get("phi3-medium-14b").reduced()
    data = tdata.SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=4,
                             seed=1)
    tr_ = _trainer(cfg, tmp_path, data, total=40, ckpt_every=10**9,
                   opt_cfg=TA.AdamWConfig(lr=3e-3, warmup_steps=5,
                                          total_steps=40))
    log = tr_.run()
    first = np.mean([r["loss"] for r in log[:5]])
    last = np.mean([r["loss"] for r in log[-5:]])
    assert last < first - 0.2, (first, last)


class _Embeds:
    """musicgen's embeddings-fed batches; ``bad`` steps carry a NaN, and
    ``kill_at`` sends SIGTERM to this process when that step is drawn."""

    def __init__(self, cfg, bad=(), kill_at=None):
        self.cfg, self.bad, self.kill_at = cfg, set(bad), kill_at
        self.drawn = []

    def batch(self, step):
        self.drawn.append(step)
        rng = np.random.default_rng(step)
        emb = (rng.normal(size=(2, 16, self.cfg.d_model)) * 0.02)
        if step in self.bad:
            emb[0, 3, 5] = np.nan
        if step == self.kill_at:
            os.kill(os.getpid(), signal.SIGTERM)
        return dict(embeds=emb.astype(np.float32),
                    labels=rng.integers(0, self.cfg.vocab, (2, 16))
                    .astype(np.int32))


def test_trainer_rolls_back_a_nan_batch(tmp_path):
    """A NaN batch right after a checkpoint: the step's loss is NaN, the
    trainer restores that checkpoint (params and optimizer state) and
    skips the batch; the run then equals one that never drew it."""
    cfg = treg.get("musicgen-medium").reduced()
    bad = _trainer(cfg, tmp_path / "a", _Embeds(cfg, bad=(4,)), total=7,
                   ckpt_every=2)
    log = bad.run()
    assert bad.dataset.drawn == [0, 1, 2, 3, 4, 5, 6]
    assert [r["step"] for r in log] == [1, 2, 3, 4, 6, 7]
    assert all(np.isfinite(r["loss"]) for r in log)
    assert all(torch.isfinite(p).all() for p in tr.leaves(bad.params))

    ok = _trainer(cfg, tmp_path / "b", _Embeds(cfg), total=4, ckpt_every=2)
    ok.run()
    ok.step = 5
    ok.run(n_steps=2)
    assert [r["loss"] for r in ok.metrics_log] == [r["loss"] for r in log]
    assert int(bad.opt_state.step) == int(ok.opt_state.step) == 6


def test_trainer_sigterm_writes_a_final_checkpoint(tmp_path):
    cfg = treg.get("musicgen-medium").reduced()
    t = _trainer(cfg, tmp_path, _Embeds(cfg, kill_at=2), total=10,
                 ckpt_every=100)
    t.install_signal_handler()
    try:
        log = t.run()
    finally:
        t.remove_signal_handler()
    assert signal.getsignal(signal.SIGTERM) is not None
    assert [r["step"] for r in log] == [1, 2, 3]
    assert t.ckpt.committed_steps() == [3]
    back = t.ckpt.restore(3, dict(params=t.params, opt=t.opt_state))
    for a, b in zip(tr.leaves(back), tr.leaves(dict(params=t.params,
                                                    opt=t.opt_state))):
        assert torch.equal(a, b)


def test_launch_train_resumes(tmp_path, capsys):
    from repro_torch.launch import train as launch

    base = ["--arch", "rwkv6-1.6b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "24", "--ckpt-dir", str(tmp_path),
            "--compress", "int8"]
    first, second = {}, {}
    assert launch.main(base + ["--steps", "4", "--ckpt-every", "2"],
                       out=first) == 0
    os.remove(tmp_path / "step_000000004" / "COMMIT")  # a crash at step 4
    assert launch.main(base + ["--steps", "4", "--ckpt-every", "5",
                               "--resume"], out=second) == 0
    assert second["resumed"] == 2
    assert [r["step"] for r in second["log"]] == [3, 4]
    assert all(np.isfinite(r["loss"]) for r in first["log"])
    # the error state is not in the checkpoint (as in the reference), so
    # the resumed steps differ from the first run's by its feedback only
    np.testing.assert_allclose([r["loss"] for r in second["log"]],
                               [r["loss"] for r in first["log"][2:]],
                               rtol=1e-3)
    assert "resumed from step 2" in capsys.readouterr().out


def test_launch_train_cuts_depth(tmp_path):
    """``--layers N`` trains the arch's first N layers at full width."""
    from repro_torch.launch import train as launch

    out = {}
    assert launch.main(["--arch", "phi3-medium-14b", "--reduced",
                        "--layers", "1", "--device", "cpu", "--batch", "2",
                        "--seq", "16", "--steps", "1", "--ckpt-dir",
                        str(tmp_path), "--ckpt-every", "5"], out=out) == 0
    full = treg.get("phi3-medium-14b").reduced()
    cfg = out["trainer"].arch
    assert (cfg.n_layers, cfg.d_model) == (1, full.d_model) != (
        full.n_layers, full.d_model)
    assert np.isfinite(out["log"][0]["loss"])
