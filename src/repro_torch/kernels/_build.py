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
overrides it) beside a stamp holding the hash of the sources and of the
headers they include (``csrc/*.cuh``); it is rebuilt when the hash
changes.  Nothing here runs at import time: this module is imported on
machines without nvcc or a card, where only the plain PyTorch versions of
the kernels run.
"""
from __future__ import annotations

import contextlib
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
_L, _F = ctypes.c_longlong, ctypes.c_float
_PANEL = [_P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_NODE_PANEL = [_P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_BATCHED_PANEL = [_P] * 6 + [_I] * 4 + [_P]
_BUCKET_PANEL = [_P, _L] + [_P] * 5 + [_I] * 7 + [_P]
_RIGHT = [_P, _P, _P, _I, _I, _I, _I, _L, _L, _P]
_LEFT = [_P, _P, _P, _I, _I, _I, _P]
# the wide right solve also takes its device-memory scratch (or null), and
# so does the bfloat16 wide left solve, for its float32 sums
_RIGHT_WIDE = _RIGHT[:-1] + [_P, _P]
_LEFT_WIDE_BF16 = _LEFT[:-1] + [_P, _P]
_BMM = [_P, _P, _P, _I, _I, _I, _I, _P]
_GEMM_UPDATE = [_P, _L, _L] * 4 + [_I, _I, _I, _I, _P]
_NODE_EDGES = [_P, _L, _L, _I, _I, _I, _P, _P, _I, _I, _P, _P, _I, _I, _P]
_NODE_EDGES_WIDE = _NODE_EDGES[:-1] + [_I, _P]
_SUPROW = [_P, _P, _P, _P, _I, _I, _I, _P]
_SUPROW_GROUPED = [_P, _I, _I, _I, _I, _P]
_FLASH = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, *[_L] * 9, _P]
_WKV = [_P] * 7 + [_I] * 4 + [_L] * 8 + [_P]
# K1-K5 in float64, float32 and bfloat16; K6 and K8 in float64 / float32
# or float32; K7 in float32 and bfloat16
_FACTOR_DTYPES = ("f64", "f32", "bf16")
SIGNATURES = {
    **{f"hylu_panel_lu_{s}": _PANEL for s in _FACTOR_DTYPES},
    **{f"hylu_node_panel_lu_{s}": _NODE_PANEL for s in _FACTOR_DTYPES},
    **{f"hylu_panel_lu_batched_{s}": _BATCHED_PANEL for s in _FACTOR_DTYPES},
    **{f"hylu_bucket_panel_lu_{s}": _BUCKET_PANEL for s in _FACTOR_DTYPES},
    **{f"hylu_trsm_right_{s}": _RIGHT for s in _FACTOR_DTYPES},
    **{f"hylu_trsm_left_unit_lower_{s}": _LEFT for s in _FACTOR_DTYPES},
    **{f"hylu_trsm_left_upper_{s}": _LEFT for s in _FACTOR_DTYPES},
    **{f"hylu_trsm_right_wide_{s}": _RIGHT_WIDE for s in _FACTOR_DTYPES},
    **{f"hylu_trsm_left_{n}_wide_{s}": _LEFT
       for n in ("unit_lower", "upper") for s in ("f64", "f32")},
    **{f"hylu_trsm_left_{n}_wide_bf16": _LEFT_WIDE_BF16
       for n in ("unit_lower", "upper")},
    **{f"hylu_bmm_{s}": _BMM for s in _FACTOR_DTYPES},
    **{f"hylu_gemm_update_{s}": _GEMM_UPDATE for s in _FACTOR_DTYPES},
    **{f"hylu_node_edges_{s}": _NODE_EDGES for s in _FACTOR_DTYPES},
    **{f"hylu_node_edges_wide_{s}": _NODE_EDGES_WIDE
       for s in _FACTOR_DTYPES},
    **{f"hylu_suprow_{s}": _SUPROW for s in ("f64", "f32")},
    **{f"hylu_suprow_grouped_{s}": _SUPROW_GROUPED for s in ("f64", "f32")},
    **{f"hylu_flash_attn_{s}": _FLASH for s in ("f32", "bf16")},
    "hylu_wkv_f32": _WKV,
}

_CURRENT = contextlib.nullcontext()
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


def headers() -> list:
    """The headers the sources include (each compiled only through them)."""
    return sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
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
            lib.hylu_panel_lu_scratch.argtypes = [_I] * 5
            lib.hylu_panel_lu_scratch.restype = ctypes.c_longlong
            lib.hylu_trsm_right_wide_scratch.argtypes = [_I] * 4
            lib.hylu_trsm_right_wide_scratch.restype = ctypes.c_longlong
            lib.hylu_trsm_left_wide_scratch.argtypes = [_I] * 3
            lib.hylu_trsm_left_wide_scratch.restype = ctypes.c_longlong
            lib.hylu_suprow_warps.argtypes = [_I, _I]
            lib.hylu_suprow_warps.restype = ctypes.c_int
            lib.hylu_error_string.argtypes = [ctypes.c_int]
            lib.hylu_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


#: called as ``launch_observer(name, work)`` at every launch while set
#: (``roofline.op_cost.OpCost`` sets it)
launch_observer = None


def launch(name: str, *args, work=None) -> None:
    """Call one C entry point and raise if the launch was refused.
    ``work`` is a function that returns the launch's ({dtype name:
    operations}, bytes) (``roofline.kernel_cost``), called only for the
    launch observer; a launch without one is reported as uncounted."""
    if launch_observer is not None:
        launch_observer(name, work)
    lib = _lib if _lib is not None else library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.hylu_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


# ---------------------------------------------------------------- wrappers
def suffix(t) -> str:
    """Entry-point suffix of a tensor's dtype; raises for other dtypes (an
    entry point that lacks the suffix's instance is missing from the
    library and raises when it is looked up)."""
    import torch

    name = {torch.float64: "f64", torch.float32: "f32",
            torch.bfloat16: "bf16"}.get(t.dtype)
    if name is None:
        raise TypeError(f"the CUDA kernels take bfloat16, float64 or "
                        f"float32, got {t.dtype}")
    return name


def check_cuda(name: str, *tensors) -> None:
    """Every tensor on one CUDA device, contiguous, and of one dtype."""
    first = tensors[0]
    dev, dt = first.get_device(), first.dtype
    for t in tensors:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"{name}: every operand must lie on one CUDA "
                             f"device, got {t.device} and {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.dtype != dt:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dt}")


def row_strides(name: str, t) -> tuple:
    """(batch stride, row stride) of a (B, R, C) view whose rows are dense,
    for an entry point that takes a view by its strides (the strides of a
    dimension of size 1 are arbitrary, so they are normalised)."""
    nb, r, c = t.shape
    if c > 1 and t.stride(2) != 1:
        raise ValueError(f"{name}: rows must be dense, got strides "
                         f"{tuple(t.stride())}")
    return (t.stride(0) if nb > 1 else 0), (t.stride(1) if r > 1 else c)


def stream_of(t):
    """The current CUDA stream of the tensor's device, as a c_void_p (the
    raw handle: ``torch.cuda.current_stream`` builds a Python object on
    every call, several microseconds per launch)."""
    import torch

    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(t.device.index))


def on_device(t):
    """A context that makes the tensor's device current: a no-op when it
    already is (``torch.cuda.device`` costs microseconds per launch)."""
    import torch

    if t.device.index == torch.cuda.current_device():
        return _CURRENT
    return torch.cuda.device(t.device)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())
