"""Build and load the port's CUDA kernels (nvcc by hand + ctypes).

The sources are ``src/repro_torch/csrc/*.cu``: each exports plain C entry
points that take device pointers, sizes and a CUDA stream, launch one
kernel and return ``cudaGetLastError()``.  They are compiled for Hopper
(``sm_90a``) into one shared library at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -shared -Xcompiler -fPIC -o build/repro_torch/libhylu_kernels.so \\
         src/repro_torch/csrc/*.cu

(one ``nvcc -c`` per source, started together, then one link).  The
library lands in ``<repo>/build/repro_torch/`` (``$REPRO_TORCH_BUILD_DIR``
overrides it) beside a stamp holding the sources' hash; it is rebuilt when
the hash changes.  Nothing here runs at import time: this module is
imported on machines without nvcc or a card, where only the plain PyTorch
versions of the kernels run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
LIB_NAME = "libhylu_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_PANEL = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_RIGHT = [_P, _P, _P, _I, _I, _I, _I, _P]
_LEFT = [_P, _P, _P, _I, _I, _I, _P]
_BMM = [_P, _P, _P, _I, _I, _I, _I, _P]
_GEMM_UPDATE = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
_SUPROW = [_P, _P, _P, _P, _I, _I, _I, _P]
SIGNATURES = {
    **{f"hylu_panel_lu_{s}": _PANEL for s in ("f64", "f32")},
    **{f"hylu_trsm_right_{s}": _RIGHT for s in ("f64", "f32")},
    **{f"hylu_trsm_left_unit_lower_{s}": _LEFT for s in ("f64", "f32")},
    **{f"hylu_trsm_left_upper_{s}": _LEFT for s in ("f64", "f32")},
    **{f"hylu_bmm_{s}": _BMM for s in ("f64", "f32")},
    **{f"hylu_gemm_update_{s}": _GEMM_UPDATE for s in ("f64", "f32")},
    **{f"hylu_suprow_{s}": _SUPROW for s in ("f64", "f32")},
}

_lock = threading.Lock()
_lib = None
#: seconds the last nvcc build of this process took and its ptxas report
#: (zero and empty while the library on disk was up to date)
last_build = {"seconds": 0.0, "log": ""}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the checkout root is 3 levels up
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from src/repro_torch/csrc")


def build(force: bool = False) -> Path:
    """Compile the sources into the shared library unless an up-to-date one
    exists; returns its path.  Concurrent builders each compile in their
    own temporary directory and install with an atomic rename."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib, stamp = out_dir / LIB_NAME, out_dir / (LIB_NAME + ".sha256")
    digest = source_hash()
    if (not force and lib.exists() and stamp.exists()
            and stamp.read_text() == digest):
        return lib
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *objs, "-o", tmp_lib], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp_lib, lib)
    stamp.write_text(digest)
    (out_dir / "build.log").write_text(log)
    last_build.update(seconds=time.perf_counter() - t0, log=log)
    return lib


def library():
    """The loaded kernel library (built on first call), with ``argtypes``
    set on every entry point: ``c_void_p`` for pointers and the stream, so
    no 64-bit address is cut to 32 bits."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.hylu_error_string.argtypes = [ctypes.c_int]
            lib.hylu_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call one C entry point and raise if the launch was refused."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.hylu_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


# ---------------------------------------------------------------- wrappers
def suffix(t) -> str:
    """Entry-point suffix of a tensor's dtype; raises for other dtypes."""
    import torch

    if t.dtype == torch.float64:
        return "f64"
    if t.dtype == torch.float32:
        return "f32"
    raise TypeError(f"the CUDA kernels take float64 or float32, got "
                    f"{t.dtype}")


def check_cuda(name: str, *tensors) -> None:
    """Every tensor on one CUDA device, contiguous, and of one dtype."""
    dev, dt = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: every operand must lie on one CUDA "
                             f"device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.dtype != dt:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dt}")


def stream_of(t):
    """The current CUDA stream of the tensor's device, as a c_void_p."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())
