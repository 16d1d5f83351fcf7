"""Package rules of the port: no JAX, no ``repro``, the card unless the CPU
is asked for, and options it does not run raise instead of computing
something else."""
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
    quietly runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    an = analyze(_tiny())                        # host analysis needs no card
    with pytest.raises(RuntimeError, match="cuda"):
        torch_repeated_engine(an)


@pytest.mark.parametrize("kw", [dict(donate=True)])
def test_unported_options_raise(kw):
    an = analyze(_tiny(), HyluOptions(device="cpu", **kw))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_repeated_engine(an)


@pytest.mark.parametrize("kw", [dict(use_kernels=False),
                                dict(factor_schedule="unrolled")])
def test_ported_options_build_an_engine(kw):
    """The level-scheduled route and the unrolled schedule are ported: the
    options build an engine that runs them."""
    an = analyze(_tiny(), HyluOptions(device="cpu", **kw))
    eng = torch_repeated_engine(an)
    assert eng.use_kernels == kw.get("use_kernels", True)
    assert eng.schedule == kw.get("factor_schedule", "bucketed")


def test_bfloat16_on_cuda_raises():
    with pytest.raises(NotImplementedError, match="bfloat16"):
        check_supported(HyluOptions(factor_dtype="bfloat16"),
                        torch.device("cuda"))


def test_build_is_lazy_and_hashes_the_sources():
    """Importing the kernels builds nothing; the build key covers every
    CUDA source, and a missing nvcc is an error, not a fallback."""
    names = [p.name for p in _build.sources()]
    assert names == ["bmm.cu", "gemm_update.cu", "panel_lu.cu", "suprow.cu",
                     "trsm.cu"]
    assert _build.source_hash() == _build.source_hash()
    for fn in _build.SIGNATURES:
        assert fn.startswith("hylu_")
    if not any(os.path.isfile(os.path.join(d, "nvcc")) for d in
               os.environ.get("PATH", "").split(os.pathsep)) \
            and not os.path.isfile("/usr/local/cuda/bin/nvcc") \
            and not os.environ.get("CUDA_HOME"):
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.nvcc_path()
