"""Package rules of the port: no JAX, no ``repro``, the card unless the CPU
is asked for, and options it does not run raise instead of computing
something else (every option runs today)."""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core import (CSR, HyluOptions, analyze,  # noqa: E402
                              torch_repeated_engine)
from repro_torch.core.options import check_supported  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_import_pulls_in_neither_jax_nor_repro():
    """In a fresh interpreter (conftest imports jax into this one), every
    module of the port imports without jax or any repro module."""
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'repro.'))\n"
        "             or m == 'repro')\n"
        "print(bad)\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._lib is None, 'import built or loaded the kernels'\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(_modules()) >= 20


def test_parallelism_and_roofline_modules_are_ported():
    """Every module of the JAX package's parallelism layer, dry runs and
    roofline has its counterpart, walked by the no-jax import above."""
    for name in ("models.sharding", "launch.mesh", "launch.dryrun",
                 "launch.solver_dryrun", "roofline.op_cost",
                 "roofline.kernel_cost", "roofline.analysis",
                 "roofline.report"):
        assert "repro_torch." + name in _modules(), name


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_repro_import_in_the_sources():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def _tiny():
    import numpy as np

    indptr = np.array([0, 2, 4, 6])
    indices = np.array([0, 1, 0, 1, 1, 2])
    return CSR(3, indptr, indices, np.array([4.0, 1.0, 1.0, 4.0, 1.0, 4.0]))


def test_default_device_raises_without_cuda():
    """Asking for the card on a machine without one raises: the port never
    quietly runs on the CPU.  The solver services resolve their device when
    they are built, so a missing card is not hidden behind typed per-request
    failures."""
    from repro_torch.serve.async_server import AsyncSolverServer
    from repro_torch.serve.solver_service import SolverService

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    an = analyze(_tiny())                        # host analysis needs no card
    with pytest.raises(RuntimeError, match="cuda"):
        torch_repeated_engine(an)
    with pytest.raises(RuntimeError, match="cuda"):
        SolverService()
    with pytest.raises(RuntimeError, match="cuda"):
        AsyncSolverServer()
    cpu = HyluOptions(device="cpu")
    assert SolverService(opts=cpu, cache_dir=None).device.type == "cpu"
    assert AsyncSolverServer(SolverService(opts=cpu, cache_dir=None))


@pytest.mark.parametrize("kw", [dict(factor_dtype="bfloat16")])
def test_unported_options_raise(kw):
    """bfloat16 factors on the card were the last option to port: the
    check that raises for unported options accepts them now, on the card
    and on the CPU, and still refuses an unknown engine."""
    for dev in ("cuda", "cpu"):
        assert check_supported(HyluOptions(**kw), torch.device(dev)) is None
    with pytest.raises(ValueError, match="engine"):
        check_supported(HyluOptions(engine="jax", **kw),
                        torch.device("cuda"))


@pytest.mark.parametrize("kw", [dict(use_kernels=False),
                                dict(factor_schedule="unrolled"),
                                dict(donate=True)])
def test_ported_options_build_an_engine(kw):
    """The level-scheduled route, the unrolled schedule and buffer
    donation are ported: the options build an engine that runs them."""
    an = analyze(_tiny(), HyluOptions(device="cpu", **kw))
    eng = torch_repeated_engine(an)
    assert eng.use_kernels == kw.get("use_kernels", True)
    assert eng.schedule == kw.get("factor_schedule", "bucketed")


def test_bfloat16_on_cuda_raises():
    """bfloat16 factors and the split of K no longer raise: an engine
    builds with factor_dtype="bfloat16" and mesh=2 on the CPU, and a
    batched factorization runs in two bfloat16 shards."""
    from repro_torch.core import factor_batched

    a = _tiny()
    an = analyze(a, HyluOptions(device="cpu", factor_dtype="bfloat16",
                                mesh=2))
    eng = torch_repeated_engine(an)
    assert eng.factor_dtype == torch.bfloat16
    bst = factor_batched(an, a, a.data[None].repeat(3, axis=0))
    assert bst.k == 3 and bst.k_pad == 4 and len(bst.shards) == 2
    assert all(p.vals.dtype == torch.bfloat16 for p in bst.shards)


def test_build_is_lazy_and_hashes_the_sources():
    """Importing the kernels builds nothing; the build key covers every
    CUDA source, and a missing nvcc is an error, not a fallback."""
    names = [p.name for p in _build.sources()]
    assert names == ["bmm.cu", "flash_attn.cu", "gemm_update.cu",
                     "panel_lu.cu", "suprow.cu", "trsm.cu", "wkv.cu"]
    assert _build.source_hash() == _build.source_hash()
    for fn in _build.SIGNATURES:
        assert fn.startswith("hylu_")
    if not any(os.path.isfile(os.path.join(d, "nvcc")) for d in
               os.environ.get("PATH", "").split(os.pathsep)) \
            and not os.path.isfile("/usr/local/cuda/bin/nvcc") \
            and not os.environ.get("CUDA_HOME"):
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.nvcc_path()


def test_shared_division_header_is_in_the_build_key(tmp_path, monkeypatch):
    """K3, K5's node kernel and K6 take their divisions from one header,
    which no source copies, and an edit to it changes the build key."""
    import shutil

    assert [p.name for p in _build.headers()] == ["div_fast.cuh"]
    for name in ("trsm.cu", "gemm_update.cu", "suprow.cu"):
        text = (_build.CSRC / name).read_text()
        assert '#include "div_fast.cuh"' in text
        assert "div_fast(double a" not in text and "true_div(T a" not in text
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.source_hash()
    with open(csrc / "div_fast.cuh", "a") as f:
        f.write("\n")
    assert _build.source_hash() != before


def test_port_test_modules_define_each_top_level_name_once():
    """A second top-level ``def`` of a name in one test module silently
    replaces the first for every test above it (a K5 card-test helper
    once took the name of K2's and failed K2's 174 card tests)."""
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    twice = []
    for name in sorted(os.listdir(tests_dir)):
        if not (name.startswith("test_torch_") and name.endswith(".py")):
            continue
        with open(os.path.join(tests_dir, name)) as f:
            tree = ast.parse(f.read())
        seen = set()
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                if node.name in seen:
                    twice.append(f"{name}: {node.name}")
                seen.add(node.name)
    assert not twice, twice


@pytest.mark.parametrize("sub", ["configs", "models", "serve",
                                 "kernels.flashattn", "kernels.wkv", "core",
                                 "launch", "optim", "train", "data",
                                 "checkpoint"])
def test_serving_subpackages_import_without_jax(sub):
    """The serving slice's subpackages, imported alone in a fresh
    interpreter, pull in neither jax nor repro."""
    mods = [m for m in _modules() if m.startswith(f"repro_torch.{sub}")]
    assert len(mods) >= 2
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m == 'repro'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_model_entry_points_default_to_the_card():
    """``init_params`` and ``init_cache`` run on the card unless the CPU is
    asked for: without one they raise."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = registry.get("phi3-medium-14b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_cache(cfg, 1, 4)
    assert T.init_params(cfg, device="cpu")["embed"].device.type == "cpu"


def test_training_entry_points_default_to_the_card(tmp_path):
    """The Trainer, ``launch.train.main`` and ``examples/train_lm_torch.py``
    run on the card unless the CPU is asked for: without one they raise."""
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as launch
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import Trainer, TrainerConfig

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = registry.get("phi3-medium-14b").reduced()
    params = T.init_params(cfg, device="cpu")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=8, global_batch=2)
    tcfg = TrainerConfig(ckpt_dir=str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(tcfg, cfg, params, data)
    assert Trainer(tcfg, cfg, params, data, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        launch.main(["--arch", "phi3-medium-14b", "--reduced", "--steps", "1",
                     "--ckpt-dir", str(tmp_path / "ck2")])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "train_lm_torch.py"),
         "--steps", "1", "--ckpt-dir", str(tmp_path / "ck3")],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and "cuda" in out.stderr
