"""Internal baselines (the paper's comparison structure, §4).

Adapted from ``src/repro/core/baseline.py``: three solver configurations
on the same engine, with the JAX package's defaults, so that each preset's
``plan_fingerprint`` is the JAX preset's (with ``use_kernels`` standing
for ``use_pallas``, ``core/options.py``):

  pardiso_like  — supernodal-only (aggressive amalgamation, supernodes of
                  up to 256 rows; level-3 BLAS everywhere) — the MKL
                  PARDISO / SuperLU design point.
  klu_like      — row-row only (no supernodes) — the KLU/NICSLU design
                  point.
  hylu          — hybrid kernels + smart selection (the paper).

Keyword arguments (``device``, ``use_kernels``, ``factor_dtype``, ...)
pass through to :class:`HyluOptions`.
"""
from __future__ import annotations

from .options import HyluOptions


def hylu_options(**kw) -> HyluOptions:
    return HyluOptions(force_mode=None, **kw)


def pardiso_like_options(**kw) -> HyluOptions:
    kw.setdefault("relax", 32)
    kw.setdefault("max_super", 256)
    return HyluOptions(force_mode="supernodal", **kw)


def klu_like_options(**kw) -> HyluOptions:
    return HyluOptions(force_mode="rowrow", **kw)


BASELINES = {
    "hylu": hylu_options,
    "pardiso_like": pardiso_like_options,
    "klu_like": klu_like_options,
}
