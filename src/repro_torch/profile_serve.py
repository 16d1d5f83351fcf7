"""Where the time of one prefill and one decode step goes on the card.

    python -m repro_torch.profile_serve

For phi3-medium-14b and rwkv6-1.6b at full width and depth in bfloat16
(weights from ``init_params(seed=0)``), 4 requests of 2,048 random prompt
tokens (numpy seed 0), after one warm-up prefill:

1. times one prefill (``make_prefill_step``, kernels on) and one decode
   step (``make_decode_step``) by the host clock around work that ends in
   a synchronize, three times each;
2. profiles one prefill and one decode step under ``torch.profiler`` (CPU
   and CUDA activity): the device time by kernel name, the number of
   kernels the device ran, and the device busy share — summed kernel time
   over the unprofiled wall time (the share over the profiled wall time is
   printed beside it).

Prints one JSON line per model with the card's name and power limit.
Needs a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import time

MODELS = ("phi3-medium-14b", "rwkv6-1.6b")
BATCH, PROMPT, NEW, REPEATS = 4, 2048, 16, 3


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _profile(torch, fn, wall):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled = time.perf_counter() - t0
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_s = sum(_dev_us(e) for e in kern) * 1e-6
    top = sorted(kern, key=_dev_us, reverse=True)[:12]
    return {"profiled_s": profiled, "device_kernel_s": device_s,
            "device_kernels_run": sum(e.count for e in kern),
            "device_busy_share": device_s / wall if device_s else None,
            "device_busy_share_profiled": (device_s / profiled
                                           if device_s else None),
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "device_ms": _dev_us(e) * 1e-3} for e in top]}


def main() -> int:
    import numpy as np
    import torch

    from . import kernels
    from .configs import registry
    from .models import transformer as T
    from .serve.serve_step import make_decode_step, make_prefill_step

    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    for name in MODELS:
        cfg = registry.get(name)
        params = T.init_params(cfg, seed=0, dtype=torch.bfloat16)
        prompt = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (BATCH, PROMPT))).cuda()
        prefill = make_prefill_step(cfg, s_max=PROMPT + NEW)
        decode = make_decode_step(cfg)
        _, cache = prefill(params, tokens=prompt)           # warm-up
        tok = torch.zeros((BATCH, 1), dtype=torch.long, device="cuda")

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        def one_prefill():
            prefill(params, tokens=prompt)

        def one_step():
            decode(params, tok, cache, PROMPT)

        kernels.reset_launch_counts()
        prefill_s = [timed(one_prefill) for _ in range(REPEATS)]
        per_prefill = {k: v // REPEATS for k, v in
                       kernels.launch_counts().items() if v}
        step_s = [timed(one_step) for _ in range(REPEATS)]
        out = {"model": name, "smi": smi, "batch": BATCH, "prompt": PROMPT,
               "dtype": "bfloat16", "prefill_s": prefill_s,
               "decode_step_s": step_s, "launches_per_prefill": per_prefill,
               "prefill_profile": _profile(torch, one_prefill,
                                           min(prefill_s)),
               "decode_profile": _profile(torch, one_step, min(step_s))}
        print(json.dumps(out), flush=True)
        del params, cache
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
