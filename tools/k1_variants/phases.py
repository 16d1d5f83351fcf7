"""Cycles by phase of K1's in-place kernel on the panel buckets of one
bucketed refactor.

    python3 tools/k1_variants/phases.py       # from the checkout root, one card

Builds a copy of ``src/repro_torch/csrc/panel_lu.cu`` with ``clock64()``
marks (thread 0 of every block, summed over the blocks by atomics into a
``__device__`` array that an added entry point reads back) into its own
library under ``artifacts/var/``, runs the 97 buckets one bucketed refactor
of fem2d_10k at K = 32 hands K1, one padded row count at a time, and prints
the mean cycles a block spends per phase: descriptor and geometry loads,
issuing the staging copies, waiting for them, the pivot loop, the prefix
write and the column rule with the window write."""
import ctypes, json, os, subprocess, sys
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.kernels.panel import ops as panel_ops
from repro_torch.core import HyluOptions, analyze, torch_repeated_engine
from repro_torch.matrices import fem2d, to_csr

src = open("src/repro_torch/csrc/panel_lu.cu").read()
NP = 7
def rep(s, old, new, count=1):
    assert s.count(old) >= count, old
    return s.replace(old, new, count)
s = src
s = rep(s, "namespace {\nnamespace node {\n", "namespace {\nnamespace node {\n__device__ unsigned long long prof[8][8];\n")
s = rep(s, "  const int nb = nreal;                        // real block columns\n",
        "  const int nb = nreal;                        // real block columns\n  const long long _t1 = clock64();\n")
s = rep(s, "panel_lu_window_kernel(const Args<T> a) {\n  extern __shared__ __align__(16) unsigned char smem_raw[];\n",
        "panel_lu_window_kernel(const Args<T> a) {\n  extern __shared__ __align__(16) unsigned char smem_raw[];\n  const long long _t0 = clock64(); long long _t2 = 0, _t3 = 0, _t4 = 0, _t5 = 0;\n")
i = s.index('asm volatile("cp.async.commit_group;\\n" ::: "memory");\n  {\n    const int w0')
j = s.index('asm volatile("cp.async.commit_group;\\n" ::: "memory");', i + 10)
s = s[:j] + '_t2 = clock64(); ' + s[j:]
s = rep(s, "    group_sync<NWF>();\n    // the warp's best", "    group_sync<NWF>();\n    _t3 = clock64();\n    // the warp's best")
k = s.index('  asm volatile("cp.async.wait_group 0;\\n" ::: "memory");\n  __syncthreads();\n  if (has) rowmap')
s = s[:k] + '  _t4 = clock64();\n' + s[k:]
s = rep(s, "  if (!lead) return;\n  // the deferred", "  _t5 = clock64();\n  if (!lead) return;\n  // the deferred")
s = rep(s, "  if (tid == 0) a.nper[b] = nper;\n}",
        "  if (tid == 0) a.nper[b] = nper;\n  if (tid == 0 && BUCKET) {\n    const long long _t6 = clock64();\n    const int q = NWF == 1 ? 0 : NWF == 4 ? 1 : 2;\n"
        "    atomicAdd(&prof[q][0], (unsigned long long)(_t1 - _t0)); atomicAdd(&prof[q][1], (unsigned long long)(_t2 - _t1));\n"
        "    atomicAdd(&prof[q][2], (unsigned long long)(_t3 - _t2)); atomicAdd(&prof[q][3], (unsigned long long)(_t4 - _t3));\n"
        "    atomicAdd(&prof[q][4], (unsigned long long)(_t5 - _t4)); atomicAdd(&prof[q][5], (unsigned long long)(_t6 - _t5));\n"
        "    atomicAdd(&prof[q][6], 1ULL);\n  }\n}")
s += '\nextern "C" int probe_read(void* out) { return (int)cudaMemcpyFromSymbol(out, node::prof, sizeof(node::prof)); }\n'
s += 'extern "C" int probe_reset() { static unsigned long long z[64] = {0}; return (int)cudaMemcpyToSymbol(node::prof, z, sizeof(z)); }\n'
d = "artifacts/var/phases"
os.makedirs(d, exist_ok=True)
open(f"{d}/p.cu", "w").write(s)
out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", f"{d}/lib.so", f"{d}/p.cu"], capture_output=True, text=True)
assert out.returncode == 0, out.stdout + out.stderr
lib = ctypes.CDLL(f"{d}/lib.so")
for sfx in ("f64", "f32"):
    fn = getattr(lib, f"hylu_bucket_panel_lu_{sfx}")
    fn.argtypes = _build.SIGNATURES[f"hylu_bucket_panel_lu_{sfx}"]
    fn.restype = ctypes.c_int
lib.hylu_panel_lu_scratch.argtypes = [ctypes.c_int] * 5
lib.hylu_panel_lu_scratch.restype = ctypes.c_longlong
lib.probe_read.argtypes = [ctypes.c_void_p]

def launch(vals, lay, eps):
    k, ldv = vals.shape
    b = lay.desc.shape[0]
    perm = torch.empty((k * b, lay.nr), dtype=torch.int32, device=vals.device)
    nper = torch.empty((k * b,), dtype=torch.int32, device=vals.device)
    per = lib.hylu_panel_lu_scratch(lay.nr, lay.wu, lay.wt - lay.wu, 1, vals.element_size())
    scratch = torch.empty(k * b * per, dtype=vals.dtype, device=vals.device) if per else None
    sfx = "f64" if vals.dtype == torch.float64 else "f32"
    rc = getattr(lib, f"hylu_bucket_panel_lu_{sfx}")(
        _build.ptr(vals), ldv, _build.ptr(lay.desc), _build.ptr(perm), _build.ptr(nper),
        _build.ptr(eps), None if scratch is None else _build.ptr(scratch), k, b, lay.nr, lay.wu,
        lay.wt - lay.wu, lay.zero_slot, lay.one_slot, _build.stream_of(vals))
    assert rc == 0, rc

A = to_csr(fem2d(100, 100, seed=930))
eng = torch_repeated_engine(analyze(A, HyluOptions()))
rng = np.random.default_rng(2026)
a_dev = torch.from_numpy(A.data[None] * rng.uniform(0.8, 1.2, (32, A.nnz))).cuda()
calls = []
orig = eng._panel_lu_bucket
def spy(v, lay, e):
    calls.append((cs.Compact(torch, np, v, lay), e.clone()))
    return orig(v, lay, e)
eng._panel_lu_bucket = spy
eng.refactor_batched(a_dev)
del eng._panel_lu_bucket
torch.cuda.synchronize()
for dt in (torch.float64, torch.float32):
    for nrp in sorted({c.lay.nr for c, _ in calls}):
        sel = [(c, e) for c, e in calls if c.lay.nr == nrp]
        bufs = [(c.base.to(dt, copy=True), c.lay, panel_ops._eps_in(e, 32, c.base.to(dt))) for c, e in sel]
        for v, l, e in bufs:            # warm
            launch(v.clone(), l, e)
        torch.cuda.synchronize()
        lib.probe_reset()
        for v, l, e in bufs:
            launch(v, l, e)
        torch.cuda.synchronize()
        arr = (ctypes.c_ulonglong * 64)()
        assert lib.probe_read(ctypes.cast(arr, ctypes.c_void_p)) == 0
        a = np.array(arr[:]).reshape(8, 8)
        q = 0 if nrp <= 8 else 1 if nrp <= 64 else 2
        n = a[q, 6]
        names = ["desc+geometry", "staging issue", "stage wait", "pivot loop", "prefix out", "column rule+window out"]
        print(json.dumps({"dtype": str(dt)[6:], "nrp": nrp, "blocks": int(n),
                          "cycles_per_block": {nm: round(a[q, i] / n) for i, nm in enumerate(names)},
                          "avg_nreal": float(np.mean([c.lay.desc[:, 1].float().mean().item() for c, _ in sel]))}), flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm", "--format=csv,noheader"], capture_output=True, text=True).stdout)
