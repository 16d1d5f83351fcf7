"""K1 design variants on the panel buckets of one bucketed refactor.

    python3 tools/k1_variants/compare.py      # from the checkout root, one card

Records what one bucketed refactor of fem2d_10k at K = 32 hands K1 (the 97
buckets, ``chip_smoke.Compact``), builds each variant of
``src/repro_torch/csrc/panel_lu.cu`` (the package's source with the text
edits below) into its own library under ``artifacts/var/``, holds every
variant to the plain version on every bucket, and prints each variant's
device ms summed over the buckets of each padded row count (and all), by
CUDA-graph replay from the recorded values, in two rounds (variants in
order, then reversed).  Variants: the package's kernel; no early stop
before padded steps; a lone pivot warp staging its window alone; two
warps a block for a lone pivot warp; the update without its per-width
specializations."""
import ctypes, json, os, subprocess, sys, time
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.kernels.panel import ops as panel_ops
from repro_torch.core import HyluOptions, analyze, torch_repeated_engine
from repro_torch.matrices import fem2d, to_csr

VARIANTS = {
    "base": [],
    "noskip": [("const bool inert = BUCKET &&", "const bool inert = false &&")],
    "stage1": [("constexpr int NWS = BUCKET ? NWB : NWF;", "constexpr int NWS = NWF;")],
    "warps2": [("return nwf > 4 ? nwf : 4;", "return nwf > 4 ? nwf : nwf == 1 ? 2 : 4;")],
    "nosw": [("""        switch (nch) {
          case 1: update_chunks<T, 1, kRows>(R, lq, urow, j, lane, ww); break;
          case 2: update_chunks<T, 2, kRows>(R, lq, urow, j, lane, ww); break;
          case 3: update_chunks<T, 3, kRows>(R, lq, urow, j, lane, ww); break;
          default: update_chunks<T, kRowRegs, kRows>(R, lq, urow, j, lane, ww);
        }""", """        update_chunks<T, kRowRegs, kRows>(R, lq, urow, j, lane, ww);""")],
}
src = open("src/repro_torch/csrc/panel_lu.cu").read()
nvcc = _build.nvcc_path()
procs = []
for name, edits in VARIANTS.items():
    s = src
    for o, n in edits:
        assert o in s, (name, o)
        s = s.replace(o, n)
    d = f"artifacts/var/{name}"
    os.makedirs(d, exist_ok=True)
    open(f"{d}/p.cu", "w").write(s)
    procs.append((name, d, subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", f"{d}/lib.so", f"{d}/p.cu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
libs = {}
for name, d, p in procs:
    out, _ = p.communicate()
    assert p.returncode == 0, out
    regs = [ln.strip()[-60:] for ln in out.splitlines() if "registers" in ln]
    lib = ctypes.CDLL(f"{d}/lib.so")
    for sfx in ("f64", "f32"):
        fn = getattr(lib, f"hylu_bucket_panel_lu_{sfx}")
        fn.argtypes = _build.SIGNATURES[f"hylu_bucket_panel_lu_{sfx}"]
        fn.restype = ctypes.c_int
    lib.hylu_panel_lu_scratch.argtypes = [ctypes.c_int] * 5
    lib.hylu_panel_lu_scratch.restype = ctypes.c_longlong
    libs[name] = lib
    print(json.dumps({"variant": name, "ptxas_bucket": [x.split("window_kernelI")[1][:14] + x.split(":")[-1][:30] for x in cs.ptxas_of(out, "ELb1EEEvNS0_4Args") if "registers" in x]}), flush=True)

def launch(lib, vals, lay, eps):
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
    return perm, nper

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
res = {}
for dt in (torch.float64, torch.float32):
    dname = str(dt)[6:]
    bases = [c.base.to(dt) for c, _ in calls]
    works = [torch.empty_like(b) for b in bases]
    es = [panel_ops._eps_in(e, b.shape[0], b) for (_, e), b in zip(calls, bases)]
    for name, lib in libs.items():
        for (c, _), b, e in zip(calls, bases, es):
            g, r = b.clone(), b.clone()
            gp, gn = launch(lib, g, c.lay, e)
            rp, rn = panel_ops.panel_lu_bucket_plain(r, c.lay, e)
            torch.cuda.synchronize()
            assert torch.equal(gp, rp) and torch.equal(gn, rn), name
            assert torch.allclose(g[:, c.real], r[:, c.real], rtol=cs.TOL[dname], atol=cs.TOL[dname]), name
    classes = sorted({c.lay.nr for c, _ in calls})
    order = list(libs) + list(libs)[::-1]
    tab = {}
    for rnd, name in enumerate(order):
        lib = libs[name]
        for nrp in classes + ["all"]:
            sel = [i for i, (c, _) in enumerate(calls) if nrp == "all" or c.lay.nr == nrp]
            def restore(sel=sel):
                for i in sel:
                    works[i].copy_(bases[i])
            fns = [lambda i=i: launch(lib, works[i], calls[i][0].lay, es[i]) for i in sel]
            ms = cs.fresh_graph_ms(torch, fns, restore)
            tab.setdefault(name, {}).setdefault(str(nrp), []).append(ms)
    res[dname] = tab
    print(json.dumps({dname: tab}), flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout)
