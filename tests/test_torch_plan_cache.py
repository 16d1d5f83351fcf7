"""The port's plan cache: the contracts of ``tests/test_plan_cache.py`` on
``repro_torch.core.plan_cache``, and artifacts that cross between the two
packages in both directions.

On the CPU the port's engine sums in a fixed order, so a reloaded plan
solves bit-identically, as the JAX suite asserts.  Across the packages
the two engines sum in different orders (batched GEMMs, scatter-adds), so
solutions are held to 1e-10 with equal pivots and perturbation counts.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import HyluOptions as JaxOptions  # noqa: E402
from repro.core import analyze as jax_analyze  # noqa: E402
from repro.core.api import (factor_batched as jax_factor_batched,  # noqa: E402
                            solve_batched as jax_solve_batched)
from repro.core.plan_cache import (load_analysis as jax_load,  # noqa: E402
                                   save_analysis as jax_save)
from repro_torch.core import (CSR, HyluOptions, analyze,  # noqa: E402
                              factor_batched, solve_batched)
from repro_torch.core.api import pattern_key, plan_fingerprint  # noqa: E402
from repro_torch.core.plan_cache import (  # noqa: E402
    DEFAULT_CACHE_DIR, FORMAT_VERSION, PlanCache, PlanCacheFormatError,
    default_cache_root, load_analysis, resolve_cache_dir, save_analysis)

from tests.helpers import scenario_system  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-10


def _cpu(**kw):
    return HyluOptions(device="cpu", **kw)


def _case(name="circuit", n=32, seed=0, k=3):
    aj, _, _, _ = scenario_system(name, n=n, seed=seed)
    a = CSR(aj.n, aj.indptr, aj.indices, aj.data)
    rng = np.random.default_rng(seed + 7)
    vb = a.data[None, :] * rng.uniform(0.9, 1.1, (k, a.nnz))
    bb = rng.normal(size=(k, a.n))
    return a, vb, bb


def _solve(an, a, vb, bb):
    bst = factor_batched(an, a, vb)
    x, info = solve_batched(bst, bb)
    return bst, x, info


# ------------------------------------------------------------- fingerprints
def test_fingerprint_is_content_addressed_and_ignores_runtime_knobs():
    a, _, _ = _case()
    base = plan_fingerprint(a, _cpu())
    assert pattern_key(a) == pattern_key((a.indptr, a.indices))
    assert plan_fingerprint(CSR(a.n, a.indptr, a.indices, 2 * a.data),
                            _cpu()) == base
    b, _, _ = _case("banded")
    assert plan_fingerprint(b, _cpu()) != base
    distinct = [_cpu(force_mode="hybrid"), _cpu(relax=2),
                _cpu(perturb_eps=1e-6), _cpu(use_kernels=False),
                _cpu(factor_schedule="unrolled"), _cpu(amalg_fill_tol=0.3)]
    fps = {plan_fingerprint(a, o) for o in distinct}
    assert len(fps | {base}) == len(distinct) + 1
    for o in (HyluOptions(), _cpu(engine="ref"), _cpu(refine_max_iter=9),
              _cpu(retry_max=5, retry_perturb_boost=10.0, deadline_ms=3.0),
              _cpu(cache_root="/elsewhere")):
        assert plan_fingerprint(a, o) == base, o


# ----------------------------------------------------------- cache semantics
def test_memory_hit_returns_same_analysis_and_skips_analyze(tmp_path):
    a, _, _ = _case()
    cache = PlanCache(directory=str(tmp_path))
    an = cache.get_or_analyze(a, _cpu())
    assert cache.stats["misses"] == 1 and cache.stats["analyze_calls"] == 1
    assert cache.get_or_analyze(a, _cpu()) is an
    assert cache.stats["hits"] == 1 and cache.stats["analyze_calls"] == 1


def test_memory_hit_honors_callers_runtime_options(tmp_path):
    """A hit comes back bound to the caller's runtime options, sharing the
    plan arrays and the engine cache; the CPU and card views key their
    engines apart."""
    a, vb, bb = _case()
    cache = PlanCache(directory=str(tmp_path))
    an = cache.get_or_analyze(a, _cpu())
    _solve(an, a, vb, bb)
    o2 = _cpu(refine_tol=1e-3, refine_max_iter=0, engine="ref")
    an2 = cache.get_or_analyze(a, o2)
    assert cache.stats["hits"] == 1 and cache.stats["analyze_calls"] == 1
    assert an2.opts is o2 and an.opts.refine_tol is None
    assert an2.fingerprint == an.fingerprint
    assert an2.plan is an.plan
    assert an2.engine_cache is an.engine_cache
    an3 = cache.get_or_analyze(a, HyluOptions())           # the card's view
    assert an3.engine_cache is an.engine_cache
    assert all(key[-1] == "cpu" for key in an.engine_cache)


def test_corrupt_artifact_falls_back_to_analyze(tmp_path):
    a, _, _ = _case()
    cache = PlanCache(directory=str(tmp_path))
    fp = cache.fingerprint(a, _cpu())
    with open(cache.path_for(fp), "wb") as f:
        f.write(b"PK\x03\x04 truncated garbage")
    with pytest.raises(PlanCacheFormatError):
        load_analysis(cache.path_for(fp))
    an = cache.get_or_analyze(a, _cpu())
    assert an.fingerprint == fp
    assert cache.stats["analyze_calls"] == 1 and cache.stats["disk_hits"] == 0


def test_distinct_options_are_distinct_entries(tmp_path):
    a, _, _ = _case()
    cache = PlanCache(directory=str(tmp_path))
    an_r = cache.get_or_analyze(a, _cpu(force_mode="rowrow"))
    an_h = cache.get_or_analyze(a, _cpu(force_mode="hybrid"))
    assert an_r is not an_h and an_r.fingerprint != an_h.fingerprint
    assert len(cache) == 2 and cache.stats["analyze_calls"] == 2


def test_lru_eviction():
    cache = PlanCache(capacity=2, directory=None)
    mats = [_case(name, n=30)[0] for name in ("circuit", "banded",
                                              "denseish")]
    fps = [cache.get_or_analyze(a, _cpu()).fingerprint for a in mats]
    assert len(cache) == 2 and cache.stats["evictions"] == 1
    assert fps[0] not in cache and fps[1] in cache and fps[2] in cache
    cache.get_or_analyze(mats[1], _cpu())        # refresh [1]
    cache.get_or_analyze(mats[0], _cpu())        # re-analyze [0], evict [2]
    assert fps[2] not in cache and fps[1] in cache
    assert cache.stats["saves"] == 0 and cache.path_for("beef") is None


def test_invalidate(tmp_path):
    a, _, _ = _case()
    cache = PlanCache(directory=str(tmp_path))
    fp = cache.get_or_analyze(a, _cpu()).fingerprint
    cache.invalidate(fp, disk=True)
    assert fp not in cache and not os.path.exists(cache.path_for(fp))
    cache.get_or_analyze(a, _cpu())
    assert cache.stats["analyze_calls"] == 2


def test_put_persists_and_serves_a_fresh_cache(tmp_path):
    a, _, _ = _case()
    an = analyze(a, _cpu())
    cache = PlanCache(directory=str(tmp_path))
    assert cache.put(an) == an.fingerprint
    assert cache.stats["saves"] == 1 and cache.get_or_analyze(a, _cpu()) is an
    fresh = PlanCache(directory=str(tmp_path))
    fresh.get_or_analyze(a, _cpu())
    assert fresh.stats["disk_hits"] == 1 and fresh.stats["analyze_calls"] == 0


# ---------------------------------------------------------- disk persistence
@pytest.mark.parametrize("name", ["circuit", "banded", "denseish"])
def test_disk_round_trip_bit_identical_solve(tmp_path, name):
    a, vb, bb = _case(name, n=30, k=3)
    opts = _cpu()
    cache = PlanCache(directory=str(tmp_path))
    an = cache.get_or_analyze(a, opts)
    _, x0, info0 = _solve(an, a, vb, bb)
    fresh = PlanCache(directory=str(tmp_path))
    an2 = fresh.get_or_analyze(a, opts)
    assert fresh.stats["disk_hits"] == 1 and fresh.stats["analyze_calls"] == 0
    assert "load" in an2.timings and "matching" not in an2.timings
    for f in ("p", "q", "src_map", "scale_map"):
        np.testing.assert_array_equal(getattr(an2, f), getattr(an, f))
    np.testing.assert_array_equal(an2.plan.a_scatter, an.plan.a_scatter)
    assert an2.choice.mode == an.choice.mode
    _, x1, info1 = _solve(an2, a, vb, bb)
    assert np.abs(x1 - x0).max() == 0.0
    assert np.abs(info1["residual"] - info0["residual"]).max() == 0.0


def test_version_and_fingerprint_guards(tmp_path):
    a, _, _ = _case()
    opts = _cpu()
    an = analyze(a, opts)
    path = save_analysis(an, str(tmp_path / "art.npz"))
    with pytest.raises(PlanCacheFormatError, match="does not match"):
        load_analysis(path, opts=opts, expected_fingerprint="0" * 64)
    with pytest.raises(PlanCacheFormatError, match="plan options"):
        load_analysis(path, opts=_cpu(force_mode="hybrid"))
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"][()]))
        arrays = {name: z[name] for name in z.files if name != "meta"}
    meta["format_version"] = FORMAT_VERSION + 1
    bad_path = str(tmp_path / f"{an.fingerprint}.npz")
    np.savez_compressed(bad_path, meta=json.dumps(meta), **arrays)
    with pytest.raises(PlanCacheFormatError, match="format version"):
        load_analysis(bad_path, opts=opts)
    assert issubclass(PlanCacheFormatError, ValueError)
    cache = PlanCache(directory=str(tmp_path))
    assert cache.get_or_analyze(a, opts).fingerprint == an.fingerprint
    assert cache.stats["analyze_calls"] == 1 and cache.stats["disk_hits"] == 0


_SUBPROCESS_CODE = """
import numpy as np
from repro_torch.core import CSR, HyluOptions, factor_batched, solve_batched
from repro_torch.core.plan_cache import PlanCache
z = np.load({inputs!r})
a = CSR(int(z["n"]), z["indptr"], z["indices"], z["data"])
cache = PlanCache(directory={cache_dir!r})
an = cache.get_or_analyze(a, HyluOptions(device="cpu"))
assert cache.stats["disk_hits"] == 1, cache.stats
assert cache.stats["analyze_calls"] == 0, cache.stats
x, _ = solve_batched(factor_batched(an, a, z["vb"]), z["bb"])
print("XHASH", x.tobytes().hex())
"""


def test_persistence_round_trip_subprocess(tmp_path):
    """Save here, reload and solve in a fresh interpreter (no JAX there):
    the analysis is skipped and the solution is byte-for-byte the same."""
    a, vb, bb = _case("circuit", n=32, k=3)
    cache = PlanCache(directory=str(tmp_path / "pc"))
    _, x0, _ = _solve(cache.get_or_analyze(a, _cpu()), a, vb, bb)
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, n=a.n, indptr=a.indptr, indices=a.indices,
             data=a.data, vb=vb, bb=bb)
    code = _SUBPROCESS_CODE.format(inputs=inputs,
                                   cache_dir=str(tmp_path / "pc"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    xhash = [ln for ln in r.stdout.splitlines()
             if ln.startswith("XHASH")][0].split()[1]
    assert xhash == x0.tobytes().hex()


# ------------------------------------------------ artifacts across packages
def _jax_side(name, n, seed):
    aj, _, _, _ = scenario_system(name, n=n, seed=seed)
    a = CSR(aj.n, aj.indptr, aj.indices, aj.data)
    rng = np.random.default_rng(seed + 3)
    vb = a.data[None, :] * rng.uniform(0.9, 1.1, (3, a.nnz))
    bb = rng.normal(size=(3, a.n))
    return aj, a, vb, bb


def _held_across(an_t, an_j, aj, a, vb, bb):
    """Both packages solve the same plan: 1e-10, equal pivots and counts."""
    bst, x_t, info_t = _solve(an_t, a, vb, bb)
    bst_j = jax_factor_batched(an_j, aj, vb)
    x_j, info_j = jax_solve_batched(bst_j, bb)
    x_j = np.asarray(x_j)
    assert np.abs(x_t - x_j).max() / np.abs(x_j).max() <= TOL
    assert max(info_t["residual"].max(),
               np.asarray(info_j["residual"]).max()) <= TOL
    np.testing.assert_array_equal(bst.inode_perm.numpy(),
                                  np.asarray(bst_j.inode_perm)[:bst_j.k])
    np.testing.assert_array_equal(bst.n_perturb, np.asarray(bst_j.n_perturb))


@pytest.mark.parametrize("name", ["circuit", "denseish"])
def test_port_artifact_loads_in_the_jax_package(tmp_path, name):
    aj, a, vb, bb = _jax_side(name, 28, 1)
    an_t = analyze(a, _cpu())
    path = save_analysis(an_t, str(tmp_path / f"{an_t.fingerprint}.npz"))
    an_j = jax_load(path, opts=JaxOptions(engine="jax", use_pallas=True),
                    expected_fingerprint=an_t.fingerprint)
    assert an_j.fingerprint == an_t.fingerprint
    np.testing.assert_array_equal(an_j.p, an_t.p)
    _held_across(an_t, an_j, aj, a, vb, bb)


@pytest.mark.parametrize("name", ["circuit", "denseish"])
def test_jax_artifact_loads_in_the_port(tmp_path, name):
    aj, a, vb, bb = _jax_side(name, 28, 2)
    an_j = jax_analyze(aj, JaxOptions(engine="jax", use_pallas=True))
    path = jax_save(an_j, str(tmp_path / f"{an_j.fingerprint}.npz"))
    cache = PlanCache(directory=str(tmp_path))
    an_t = cache.get_or_analyze(a, _cpu())
    assert cache.stats["disk_hits"] == 1 and cache.stats["analyze_calls"] == 0
    assert an_t.fingerprint == an_j.fingerprint
    assert os.path.basename(path) == f"{an_t.fingerprint}.npz"
    _held_across(an_t, an_j, aj, a, vb, bb)


# --------------------------------------------------------- cache-root rules
def test_cache_dir_resolution(tmp_path, monkeypatch):
    assert resolve_cache_dir(None) is None
    assert resolve_cache_dir("some/dir") == "some/dir"
    monkeypatch.setenv("HYLU_CACHE_ROOT", str(tmp_path / "env"))
    assert resolve_cache_dir(DEFAULT_CACHE_DIR,
                             cache_root=str(tmp_path / "o")) == \
        str(tmp_path / "o" / "plan_cache")
    assert resolve_cache_dir(DEFAULT_CACHE_DIR) == \
        str(tmp_path / "env" / "plan_cache")
    monkeypatch.delenv("HYLU_CACHE_ROOT")
    monkeypatch.chdir(tmp_path)
    root = default_cache_root()
    assert os.path.isabs(root) and str(tmp_path) not in root
    assert root == os.path.join(ROOT, "checkpoints")   # the JAX package's


def test_plan_cache_honors_cache_root(tmp_path):
    cache = PlanCache(directory=DEFAULT_CACHE_DIR,
                      cache_root=str(tmp_path / "store"))
    assert cache.directory == str(tmp_path / "store" / "plan_cache")
    a, _, _ = _case("circuit", n=30, seed=1)
    cache.get_or_analyze(a, _cpu())
    assert os.listdir(cache.directory)
