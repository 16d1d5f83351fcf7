"""Solver options, device resolution, and pattern fingerprints.

Adapted from ``src/repro/core/options.py``.  The option schema and the
fingerprints are the same as the JAX package's, with these changes:

* ``device`` (default ``"cuda"``) says where an entry point runs: on the
  card unless the caller asks for ``"cpu"``, and a missing card raises
  instead of falling back to the CPU (:func:`resolve_device`);
* ``mesh`` splits the batched path's system batch K over devices, as the
  JAX package shards it over a 1-D mesh: ``None`` (no split), an int N
  (the first N CUDA devices, ``repro_torch.launch.mesh.make_solver_mesh``;
  with ``device="cpu"`` N shards on the CPU) or a sequence of devices,
  repeats allowed (``["cuda:0", "cuda:0"]`` splits K in two on one card,
  as the JAX package's virtual CPU devices do) (:func:`resolve_mesh`).
  As in the JAX package it is runtime-only: never in a fingerprint;
* ``use_pallas`` becomes ``use_kernels`` (default ``True``) in the same
  position of ``PLAN_OPTION_FIELDS``, so ``plan_options_key`` and
  ``plan_fingerprint`` hash exactly as the JAX package's do with
  ``use_pallas=True`` — an analysis written by either package is
  recognised by the other;
* ``engine`` is ``"torch"`` (the default) or ``"ref"``, and
  ``refine_dtype="auto"`` always means float64 (PyTorch has no x64 switch).

An option the port does not run would raise ``NotImplementedError``
(:func:`check_supported`); every option of the schema runs today.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


@dataclasses.dataclass
class HyluOptions:
    """Solver options — every knob of the analyze/factor/solve pipeline.
    Field meanings are those of the JAX package (docs/API.md), apart from
    ``device``/``mesh``/``use_kernels``/``engine`` (module docstring).
    The serving and plan-cache knobs (``deadline_ms``, ``retry_max``,
    ``retry_perturb_boost``, ``cache_root``) and ``mesh`` are
    runtime-only, as in the JAX package: they never enter a
    fingerprint."""
    force_mode: str | None = None          # rowrow | hybrid | supernodal
    orderings: tuple = ("min_degree", "nested_dissection", "natural")
    relax: int = 8
    max_super: int = 128
    amalg_fill_tol: float = 0.0
    perturb_eps: float | None = None       # None → 1e-8 scaled by
                                           # sqrt(eps(factor_dtype)/eps(f64))
    refine_max_iter: int = 3
    refine_tol: float | None = None        # None → 1e-12 scaled by
                                           # eps(refine_dtype)/eps(f64)
    factor_dtype: str = "float64"          # float64 | float32 | bfloat16
    refine_dtype: str = "auto"             # auto → float64
    fp64_fallback: bool = True
    deadline_ms: float | None = None       # async server: default
                                           # per-request latency budget
    retry_max: int = 1                     # serving ladder: perturbed
                                           # re-factor retries before
                                           # quarantine
    retry_perturb_boost: float = 1e4       # perturb_eps multiplier per
                                           # retry attempt
    bulk_min_width: int = 8
    engine: str = "torch"
    use_kernels: bool = True               # hand-written CUDA kernels on the
                                           # card (plain PyTorch on the CPU)
    factor_schedule: str = "bucketed"
    device: str = "cuda"                   # "cuda" | "cuda:N" | "cpu"
    donate: bool = False                   # the T-step pipeline reuses
                                           # its factor buffers (runtime
                                           # only, never in a fingerprint)
    cache_root: str | None = None          # plan-cache root; None →
                                           # $HYLU_CACHE_ROOT or
                                           # <repo>/checkpoints
    mesh: object = None                    # None | int | devices: the
                                           # split of K (runtime only)


# Options that change the analysis artifact or the engine built from it —
# the option half of a plan fingerprint.  Same order as the JAX package's.
PLAN_OPTION_FIELDS = ("force_mode", "orderings", "relax", "max_super",
                      "amalg_fill_tol", "perturb_eps", "bulk_min_width",
                      "factor_schedule", "use_kernels", "factor_dtype")


_DTYPE_EPS = {
    "float64": 2.220446049250313e-16,
    "float32": 1.1920928955078125e-07,
    "bfloat16": 0.0078125,
}


def dtype_name(dtype) -> str:
    """Canonical name ("float64"/"float32"/"bfloat16") of a dtype given as a
    string, a numpy dtype or a torch dtype."""
    if isinstance(dtype, str):
        name = dtype
    elif str(dtype).startswith("torch."):
        name = str(dtype)[len("torch."):]
    else:
        name = np.dtype(dtype).name
    if name not in _DTYPE_EPS:
        raise ValueError(f"unsupported factor/refine dtype {name!r}: "
                         f"expected one of {sorted(_DTYPE_EPS)}")
    return name


def resolve_perturb_eps(opts: HyluOptions | None, dtype=None) -> float:
    """An explicit ``opts.perturb_eps`` verbatim, else ``1e-8`` scaled by
    ``sqrt(eps(dtype)/eps(float64))`` — exactly ``1e-8`` for float64."""
    opts = opts or HyluOptions()
    if opts.perturb_eps is not None:
        return float(opts.perturb_eps)
    name = dtype_name(opts.factor_dtype if dtype is None else dtype)
    return 1e-8 * (_DTYPE_EPS[name] / _DTYPE_EPS["float64"]) ** 0.5


def resolve_refine_tol(opts: HyluOptions | None, dtype=None) -> float:
    """An explicit ``opts.refine_tol`` verbatim, else ``1e-12`` scaled by
    ``eps(dtype)/eps(float64)`` of the dtype the residual is computed in."""
    opts = opts or HyluOptions()
    if opts.refine_tol is not None:
        return float(opts.refine_tol)
    name = dtype_name(opts.factor_dtype if dtype is None else dtype)
    return 1e-12 * (_DTYPE_EPS[name] / _DTYPE_EPS["float64"])


def resolve_retry_perturb(opts: HyluOptions | None, attempt: int,
                          dtype=None) -> float:
    """The pivot-perturbation threshold of retry ``attempt`` (1-based) of
    the serving ladder: :func:`resolve_perturb_eps` times
    ``retry_perturb_boost ** attempt``.  As an explicit ``perturb_eps`` it
    lands in a fingerprint of its own, so retries never touch the healthy
    traffic's plans and engines."""
    opts = opts or HyluOptions()
    if attempt < 1:
        raise ValueError(f"retry attempt is 1-based, got {attempt}")
    return (resolve_perturb_eps(opts, dtype)
            * float(opts.retry_perturb_boost) ** attempt)


def resolve_dtype_names(opts: HyluOptions | None) -> tuple:
    """(factor, refine) dtype names; ``refine_dtype="auto"`` → float64."""
    opts = opts or HyluOptions()
    r = opts.refine_dtype
    if r in (None, "auto"):
        r = "float64"
    return dtype_name(opts.factor_dtype), dtype_name(r)


def resolve_device(device):
    """The torch device an entry point runs on.  A CUDA device is required
    to exist: when the card was asked for and is missing this raises — the
    port never quietly runs on the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: expected 'cuda', "
                         "'cuda:N' or 'cpu'")
    return dev


def resolve_mesh(opts: HyluOptions | None) -> tuple | None:
    """``opts.mesh`` → the devices of the split of K, one per shard (a
    tuple of torch devices, repeats allowed), or None for no split (the
    counterpart of ``_resolve_mesh``, ``src/repro/core/options.py:
    255–280``).  An int N takes the first N CUDA devices
    (``make_solver_mesh``, which raises when fewer are visible), or N
    shards on the CPU when ``opts.device`` is the CPU; a sequence names
    its devices, each resolved by :func:`resolve_device`, all of one
    type."""
    import torch

    opts = opts or HyluOptions()
    mesh = opts.mesh
    if mesh is None:
        return None
    if isinstance(mesh, (int, np.integer)) and not isinstance(mesh, bool):
        n = int(mesh)
        if torch.device(opts.device).type == "cpu":
            if n < 1:
                raise ValueError(f"mesh: need at least one shard, got {n}")
            return (torch.device("cpu"),) * n
        from ..launch.mesh import make_solver_mesh
        return tuple(make_solver_mesh(n))
    if not isinstance(mesh, (list, tuple)):
        raise TypeError(f"mesh must be None, an int device count, or a "
                        f"sequence of devices — got {type(mesh).__name__}")
    devs = tuple(resolve_device(d) for d in mesh)
    if not devs:
        raise ValueError("mesh: an empty sequence of devices")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"mesh: every shard on one device type, got "
                         f"{[str(d) for d in devs]}")
    return devs


def check_supported(opts: HyluOptions, device) -> None:
    """Raise for options the port does not run on ``device``, instead of
    computing something else: the place where an option that is not
    ported yet raises ``NotImplementedError`` (ROADMAP.md).  Every option
    of the schema runs today, bfloat16 factors on the card among them, so
    only an unknown engine raises (``ValueError``)."""
    if opts.engine not in ("torch", "ref"):
        raise ValueError(f"repro_torch runs engine='torch' or 'ref', got "
                         f"{opts.engine!r}")


def plan_options_key(opts: HyluOptions | None) -> tuple:
    """Hashable tuple of the plan/engine-affecting option fields (see
    ``PLAN_OPTION_FIELDS``); ``perturb_eps`` enters resolved."""
    opts = opts or HyluOptions()
    out = []
    for name in PLAN_OPTION_FIELDS:
        if name == "perturb_eps":
            out.append(resolve_perturb_eps(opts))
            continue
        v = getattr(opts, name)
        out.append(tuple(v) if isinstance(v, (list, tuple)) else v)
    return tuple(out)


def _pattern_parts(a_or_pattern) -> tuple:
    if hasattr(a_or_pattern, "indptr"):
        return (int(a_or_pattern.n), a_or_pattern.indptr,
                a_or_pattern.indices)
    indptr, indices = a_or_pattern
    indptr = np.asarray(indptr)
    return len(indptr) - 1, indptr, indices


def pattern_key(a_or_pattern) -> str:
    """sha256 over (n, indptr, indices): the sparsity pattern alone."""
    n, indptr, indices = _pattern_parts(a_or_pattern)
    h = hashlib.sha256(b"hylu-pattern-v1")
    h.update(int(n).to_bytes(8, "little"))
    h.update(np.ascontiguousarray(indptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(indices, dtype=np.int64).tobytes())
    return h.hexdigest()


def plan_fingerprint(a_or_pattern, opts: HyluOptions | None = None,
                     pkey: str | None = None) -> str:
    """sha256 over the pattern key plus ``plan_options_key(opts)``."""
    h = hashlib.sha256(b"hylu-plan-v1")
    h.update((pattern_key(a_or_pattern) if pkey is None else pkey).encode())
    h.update(repr(plan_options_key(opts)).encode())
    return h.hexdigest()
