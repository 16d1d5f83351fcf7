"""Content-addressed plan cache: Analysis artifacts by pattern fingerprint.

Adapted from ``src/repro/core/plan_cache.py``.  The host analysis is a
per-pattern tax that the serving regime should pay once per pattern, not
once per process:

* ``PlanCache`` — an LRU map ``plan_fingerprint → Analysis``.  A cached
  analysis carries its ``engine_cache``, so a warm hit also reuses every
  engine already built for it (keyed by dtype, kernel route, schedule and
  device, so the CPU and card views of one plan never share an engine).
* disk persistence — ``save_analysis`` / ``load_analysis`` write and read
  the analysis as one versioned ``.npz`` under
  ``<cache root>/plan_cache/<fingerprint>.npz``.  The file is the JAX
  package's, array for array and key for key (``options_key`` is the
  ``repr`` of ``plan_options_key``, equal to the JAX key under
  ``use_pallas=True``), so each package loads the other's artifacts.  A
  fresh process loads the artifact and skips the host analysis; the
  engines are rebuilt from the plan at first use.

Unknown versions, fingerprint or option mismatches and unreadable files
raise ``PlanCacheFormatError`` (a ``ValueError``); the cache treats such a
file as a miss and re-analyzes.  Decoding is
:func:`~repro_torch.core.convert.analysis_from_arrays`.

The fingerprint addresses the *pattern*, not the values: a warm hit reuses
the matching and scaling of the values that first populated the entry, as
``solve_sequence`` does.  Callers whose values drift far should
``invalidate()`` the pattern.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import zipfile
from collections import OrderedDict

import numpy as np

from .analysis import Analysis, analyze
from .convert import FORMAT_VERSION, PlanCacheFormatError, analysis_from_arrays
from .matrix import CSR
from .options import HyluOptions, plan_fingerprint, plan_options_key

__all__ = ["FORMAT_VERSION", "DEFAULT_CACHE_DIR", "PlanCacheFormatError",
           "default_cache_root", "resolve_cache_dir", "save_analysis",
           "load_analysis", "PlanCache"]

# Sentinel: resolved to <cache root>/plan_cache when a PlanCache is built
# (not at import), so $HYLU_CACHE_ROOT set after import still wins.
DEFAULT_CACHE_DIR = "auto"


def default_cache_root() -> str:
    """``$HYLU_CACHE_ROOT`` when set, else ``<repo>/checkpoints`` when the
    package runs from a source checkout (the JAX package's location, never
    the CWD), else ``~/.cache/hylu``."""
    env = os.environ.get("HYLU_CACHE_ROOT")
    if env:
        return env
    # src/repro_torch/core/plan_cache.py -> the repo root is 4 levels up
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    if os.path.exists(os.path.join(repo, "pyproject.toml")):
        return os.path.join(repo, "checkpoints")
    return os.path.join(os.path.expanduser("~"), ".cache", "hylu")


def resolve_cache_dir(directory: str | None,
                      cache_root: str | None = None) -> str | None:
    """The ``DEFAULT_CACHE_DIR`` sentinel becomes ``<root>/plan_cache``
    with ``root`` = ``cache_root`` or :func:`default_cache_root`; explicit
    paths and None pass through."""
    if directory != DEFAULT_CACHE_DIR:
        return directory
    return os.path.join(cache_root or default_cache_root(), "plan_cache")


def _jsonable(v):
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    return v


def _cat(arrs, dtype=np.int64):
    """Concatenate possibly-empty ragged pieces with a stable dtype."""
    arrs = [np.asarray(a, dtype=dtype) for a in arrs]
    return np.concatenate(arrs) if arrs else np.empty(0, dtype=dtype)


def _ptr(lengths):
    out = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=out[1:])
    return out


def save_analysis(an: Analysis, path: str) -> str:
    """Write one Analysis to a versioned ``.npz`` (atomic).  Everything
    value-independent about the pattern is kept; the engines are not."""
    plan, sym, match = an.plan, an.sym, an.match
    nodes = plan.nodes
    meta = {
        "format_version": FORMAT_VERSION,
        "fingerprint": an.fingerprint,
        "pattern_key": an.pattern_key,
        "options_key": repr(plan_options_key(an.opts)),
        "n": int(an.n),
        "ordering_name": an.ordering_name,
        "match_structurally_singular": bool(match.structurally_singular),
        "choice": {"mode": an.choice.mode, "relax": int(an.choice.relax),
                   "max_super": int(an.choice.max_super),
                   "reason": an.choice.reason,
                   "stats": _jsonable(an.choice.stats)},
        "sym": {"flops": float(sym.flops), "nnz_l": int(sym.nnz_l)},
        "plan": {"total_slots": int(plan.total_slots), "mode": plan.mode,
                 "useful_flops": float(plan.useful_flops),
                 "padded_flops": float(plan.padded_flops),
                 "n_bulk_levels": int(plan.n_bulk_levels)},
        "timings": _jsonable(an.timings),
    }
    edge_lists = [nd.edges for nd in nodes]
    all_edges = [e for edges in edge_lists for e in edges]
    arrays = dict(
        match_col_of_row=match.col_of_row,
        match_row_scale=match.row_scale,
        match_col_scale=match.col_scale,
        q=an.q, p=an.p,
        src_map=an.src_map, scale_map=an.scale_map,
        m_indptr=an.m_pattern[0], m_indices=an.m_pattern[1],
        sym_parent=sym.parent,
        sym_lrow_ptr=sym.lrow_ptr, sym_lrow_idx=sym.lrow_idx,
        sym_lcol_ptr=sym.lcol_ptr, sym_lcol_idx=sym.lcol_idx,
        sym_cc=sym.cc, sym_row_flops=sym.row_flops,
        sym_snode_of=sym.snode_of,
        sym_snode_start=sym.snode_start, sym_snode_end=sym.snode_end,
        plan_panel_offset=plan.panel_offset,
        plan_a_scatter=plan.a_scatter,
        plan_row_perm_slots=plan.row_perm_slots,
        node_r0=np.array([nd.r0 for nd in nodes], dtype=np.int64),
        node_r1=np.array([nd.r1 for nd in nodes], dtype=np.int64),
        node_level=np.array([nd.level for nd in nodes], dtype=np.int64),
        node_lsize=np.array([nd.lsize for nd in nodes], dtype=np.int64),
        node_usize=np.array([nd.usize for nd in nodes], dtype=np.int64),
        node_pat_ptr=_ptr([len(nd.pattern) for nd in nodes]),
        node_pat=_cat([nd.pattern for nd in nodes]),
        edge_ptr=_ptr([len(edges) for edges in edge_lists]),
        edge_src=np.array([e.src for e in all_edges], dtype=np.int64),
        edge_cm_ptr=_ptr([len(e.col_map) for e in all_edges]),
        edge_cm=_cat([e.col_map for e in all_edges]),
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, meta=json.dumps(meta), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_analysis(path: str, opts: HyluOptions | None = None,
                  expected_fingerprint: str | None = None) -> Analysis:
    """Read an Analysis back.  ``opts`` becomes its options and must agree
    with the artifact on every plan-affecting field;
    ``expected_fingerprint`` also pins its content address.  Raises
    ``PlanCacheFormatError`` when the artifact cannot be trusted."""
    t0 = time.perf_counter()
    try:
        with np.load(path, allow_pickle=False) as z:
            an = analysis_from_arrays(
                z, z["meta"], opts or HyluOptions(),
                expected_fingerprint=expected_fingerprint)
    except PlanCacheFormatError as e:
        raise PlanCacheFormatError(f"{path}: {e}") from e
    except (OSError, KeyError, ValueError, EOFError,
            zipfile.BadZipFile) as e:
        raise PlanCacheFormatError(
            f"unreadable plan artifact {path}: {e}") from e
    load_s = time.perf_counter() - t0
    an.timings = {"load": load_s, "total": load_s, **an.timings}
    return an


@dataclasses.dataclass
class PlanCache:
    """LRU plan cache with optional disk persistence.

    capacity   — most analyses kept in memory (least recently used, and
                 their engines, evicted beyond it)
    directory  — persistence root (``<directory>/<fingerprint>.npz``);
                 None disables disk; the default ``"auto"`` resolves to
                 ``<cache root>/plan_cache`` (:func:`resolve_cache_dir`)
    cache_root — overrides the resolved root (``HyluOptions.cache_root``);
                 ignored when ``directory`` is explicit

    ``stats``: ``hits`` (memory), ``disk_hits`` (loaded: the analysis was
    skipped), ``misses`` (= ``analyze_calls``: a full host analysis ran),
    ``saves``, ``evictions``, and the summed ``analyze_s`` / ``load_s``."""
    capacity: int = 32
    directory: str | None = DEFAULT_CACHE_DIR
    cache_root: str | None = None

    def __post_init__(self):
        self.directory = resolve_cache_dir(self.directory, self.cache_root)
        self._entries: OrderedDict[str, Analysis] = OrderedDict()
        self.stats = dict(hits=0, misses=0, disk_hits=0, saves=0,
                          evictions=0, analyze_calls=0,
                          analyze_s=0.0, load_s=0.0)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, fingerprint: str) -> bool:
        return fingerprint in self._entries

    def fingerprints(self):
        return list(self._entries)

    def path_for(self, fingerprint: str) -> str | None:
        if self.directory is None:
            return None
        return os.path.join(self.directory, f"{fingerprint}.npz")

    def fingerprint(self, a_or_pattern, opts: HyluOptions | None = None) -> str:
        return plan_fingerprint(a_or_pattern, opts)

    def get_or_analyze(self, a: CSR, opts: HyluOptions | None = None,
                       fingerprint: str | None = None) -> Analysis:
        """The Analysis of ``a``'s pattern under ``opts``: from memory,
        from the artifact store, or by running ``analyze`` (persisted when
        a directory is set).  Warm hits ignore ``a``'s values.
        ``fingerprint`` passes an already computed ``plan_fingerprint(a,
        opts)``, so hot callers skip hashing the pattern again."""
        opts = opts or HyluOptions()
        fp = fingerprint or plan_fingerprint(a, opts)
        an = self._entries.get(fp)
        if an is not None:
            self._entries.move_to_end(fp)
            self.stats["hits"] += 1
            return self._with_opts(an, opts)
        path = self.path_for(fp)
        if path is not None and os.path.exists(path):
            try:
                t0 = time.perf_counter()
                an = load_analysis(path, opts=opts, expected_fingerprint=fp)
                self.stats["load_s"] += time.perf_counter() - t0
                self.stats["disk_hits"] += 1
            except PlanCacheFormatError:
                an = None                     # untrusted artifact: re-analyze
        if an is None:
            t0 = time.perf_counter()
            an = analyze(a, opts)
            self.stats["analyze_s"] += time.perf_counter() - t0
            self.stats["misses"] += 1
            self.stats["analyze_calls"] += 1
            if path is not None:
                save_analysis(an, path)
                self.stats["saves"] += 1
        self._insert(fp, an)
        return an

    def put(self, an: Analysis) -> str:
        """Insert an Analysis built elsewhere (persisted when a directory
        is set) and return its fingerprint."""
        if not an.fingerprint:
            raise ValueError("analysis has no fingerprint: cannot "
                             "content-address it")
        path = self.path_for(an.fingerprint)
        if path is not None and not os.path.exists(path):
            save_analysis(an, path)
            self.stats["saves"] += 1
        self._insert(an.fingerprint, an)
        return an.fingerprint

    def invalidate(self, fingerprint: str, disk: bool = False) -> None:
        """Drop one entry; ``disk=True`` also removes its artifact."""
        self._entries.pop(fingerprint, None)
        path = self.path_for(fingerprint)
        if disk and path is not None and os.path.exists(path):
            os.remove(path)

    def clear(self) -> None:
        self._entries.clear()

    @staticmethod
    def _with_opts(an: Analysis, opts: HyluOptions) -> Analysis:
        """A hit honours the caller's runtime-only options (device,
        engine, refinement caps: the fields the fingerprint leaves out).
        When they differ it returns a shallow view with ``opts`` rebound
        and the same plan arrays and ``engine_cache``, as the disk-hit
        path loads under the caller's options."""
        if an.opts == opts:
            return an
        return dataclasses.replace(an, opts=opts)

    def _insert(self, fp: str, an: Analysis) -> None:
        self._entries[fp] = an
        self._entries.move_to_end(fp)
        while len(self._entries) > max(int(self.capacity), 1):
            self._entries.popitem(last=False)
            self.stats["evictions"] += 1
