#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each printing one JSON line:

1. device   the card's name and power limit (nvidia-smi);
2. build    nvcc builds the kernel library from ``src/repro_torch/csrc``;
3. analyze  host analysis of fem2d_10k (the corpus's FEM entry: a 100x100
            5-point stencil with a diagonal jitter, seed 930; n = 10,000);
4. kernels  every CUDA kernel of the main path against its plain PyTorch
            version on the card, in float64 and float32 (K1-K5 also in
            bfloat16, records named ``..._bf16``: equal pivots and
            counts; entry by entry, the panel LUs bit-equal, the others
            within two bf16 ulps of each entry (BF16_ULPS); ``solve_triangular`` takes no bfloat16 on
            CUDA, so K3's bf16 records have no library time), on the operands
            fem2d_10k's factor program hands it (largest panel bucket,
            which K1 reads and writes in place in the value buffer,
            largest narrow-level node, largest sup-sup edge bucket) and on
            an nr = 128 block of the finished factors, with its time, the
            plain version's, a library call's where one computes the same
            function, and the card's lower bound; each panel LU also on its
            panels with the rows shuffled, where pivoting must move rows;
            K5's node step (``node_edges_inplace``: a node's whole edge
            loop in one launch, in place) at the unrolled program's node
            with the most edge work, the node with the most edges and the
            width-1 node with the most edges, each from its input buffer,
            beside the parent route (per edge a gather, K3 + the per-edge
            K5 ``gemm_update``, a write-back); the per-edge K5 (C - A.B)
            and K6 (sup-row TRSV + GEMV) are held the same way at the
            largest sup-sup and sup-row edge of the unrolled schedule, on
            the operands its program hands that edge; K6 also over every
            sup-row edge at K = 32 (340 edges in 31 (k, m) groups, the
            operands the unrolled program hands each), in one grouped
            launch (``suprow_update_grouped``) and in one launch per
            group, held to the plain version and timed by CUDA-graph
            replay beside the library route (``solve_triangular`` +
            ``baddbmm`` per group), the plain route and the summed bound,
            and with zero divisors and NaNs in U and past it, where NaN
            and inf positions must match; K6 at k = 128, m = 300; K1 and
            K2 also on panels with an exactly zero pivot under a zero
            threshold, where NaN and inf positions must match; K4 (and
            ``torch.bmm``) also per launch by CUDA-graph replay, on 2,048
            products of its bucket's shape, and summed over all 516
            sup-sup buckets of the bucketed schedule (in bfloat16 per
            launch at the table's shape); K3 beside
            ``torch.linalg.solve_triangular`` per launch by CUDA-graph
            replay at the table's shapes (bfloat16 too, alone), the right
            solve summed over the
            516 sup-sup buckets (U a strided view of the source rows, as
            the engine passes it) and both left solves over the 502 node
            blocks of the node-block apply, each held to its plain version
            on every bucket and block; then panel_extra: a spy on the
            engine records what one unrolled refactor of one system hands
            K2 (502 node panels), and what one bucketed refactor at
            K = 32 hands K2 (32 narrow-level launches) and K1 (97 buckets,
            in place), with each panel's layout (K2's are strided views of
            the value buffer); every K2 and K1 call, replayed at that
            layout (K1's from restored values), is held to its plain
            version in float64 and float32 (K1 also: no other slot
            written), and their device times summed over each refactor
            by CUDA-graph replay are printed beside the summed bound, the
            sums of the design before (for K1 the engine's former gather,
            kernel and scatter) and, as a scale, library LU, triangular
            solve and gather on the same panels; K1's bucket census; every
            K5 node step of one unrolled refactor replayed in order, held
            to its plain version in float64 and float32 and summed by
            graph replay, beside the parent route's refactor (host
            seconds, its K3 and per-edge K5 device sums);
5. main     the batched repeated-solve path through its entry points at
            K = 32: ``solve_sequence`` for T = 3 float64 steps, then one
            ``factor_batched`` + ``solve_batched`` step in float64 and one
            with float32 factors refined in float64; residuals, agreement
            with scipy's ``spsolve`` and the launch counts are checked
            (one K1 launch per panel bucket), and the device kernels of
            one bucketed refactor counted with and without the in-place
            K1 (torch.profiler); the T-step ``solve_sequence`` runs the
            double-buffered pipeline (pinned staging, a copy stream);
5b. pipeline  the pipeline on the main phase's analysis, values and
            right-hand sides: T = 3 without and with donation, then T = 6
            with donation, each after a reset of the peak memory
            statistics: the donating stream within 1e-10 of the other
            with equal counts and masks, its peak no higher, T = 3 -> 6
            growing by less than one factor buffer; the seconds per step
            beside T sequential ``factor_batched`` + ``solve_batched``;
6. width1   circuit_like(2000, seed 3), K = 8: the scanned width-1 tail;
6b. autodiff  ``make_sparse_solve`` on fem2d_10k, one right-hand side:
            x, b's and A's values' gradients of sum(W x) by ``backward()``
            against ``spsolve(A, b)``, y = ``spsolve(Aᵀ, W)`` and
            -y[rows] x[cols] (1e-10), K1-K4 launched in the forward,
            forward and backward ms;
7. baselines  the paper's §4 comparison at fem2d_10k, K = 32, the main
            phase's values and right-hand sides: the ``hylu`` (the main
            phase's analysis), ``pardiso_like`` (supernodal only, relax
            32, supernodes up to 256 rows: its 150-row root runs K2's
            wide path, its 150-row node block K3's wide left solves)
            and ``klu_like`` (row-row only) presets through
            ``factor_batched`` + ``solve_batched``, once (launches per
            wrapper counted) and PRESET_REPEATS more times (median and range of
            the ms and systems/s): plan census, residuals, ``spsolve`` on
            systems 0 and 31; the host-loop solve
            (``_solve_batched_hostloop``) on hylu's and klu_like's factors
            (one refinement) beside the fused one (x within 1e-10, equal
            refinement counts and failure masks); ``pardiso_like`` on a
            200-row system with a 140-row supernode, the wide paths
            fem2d_10k does not reach (K1's, K3's wide right solve),
            also under the unrolled schedule (K5's wide node step,
            ``node_edges_wide``: against ``spsolve`` and the bucketed
            factors), with that node step's kernel record, and in
            bfloat16 factors (K3's wide bfloat16 solves, each launched,
            no per-edge K5; x against ``spsolve``);
            and the wide paths' kernel records, float64: K2 on the root's
            32 panels and at 256 and 300 rows, K1 on buckets padded to 256
            and 512 rows, K3's wide right solve at k = 140, 256 and 600
            and its wide left solves at k = 150 (each one launch, by a
            spy on the launches, timed also by CUDA-graph replay), each
            held to its plain version beside the library's
            ``solve_triangular`` (K3) and the bound; and K3's wide
            bfloat16 solves at the same shapes (records ``..._wide_bf16``,
            one launch each, within BF16_ULPS of the plain version);
8. scalar   the one-system lifecycle ``factor`` -> ``refactor`` (new
            values) -> ``solve`` on fem2d_10k under the bucketed and the
            unrolled schedule in float64, and bucketed with float32
            factors: residuals, ``spsolve``, unrolled against bucketed
            (pivots, perturbation counts, factors), the launches of one
            unrolled refactor against the plan's counts (one K5 node step
            per node with edges or width 1, K2 per node with nr > 1, no
            per-edge K3 or K5) and the device kernels of one refactor of
            each schedule (torch.profiler);
9. plain    one batched step at K = 32 with ``use_kernels=False`` (plain
            factor program, level-scheduled substitution): residuals, no
            kernel launched, and its times beside the kernel route's;
9b. bf16    bfloat16 factors at fem2d_10k, K = 32: ``factor_batched`` +
            ``solve_batched`` with ``factor_dtype="bfloat16"`` beside the
            float64 step (every x within 1e-10 of ``spsolve``, all-clear
            ``refine_failed``, ``n_fp64_fallback``, ms, peak memory,
            factor storage; the bf16 entry points launched, counted by a
            spy on ``_build.launch``, and none of the per-edge K5), then
            the one-system unrolled
            lifecycle in bfloat16 (times, launches, every node step of
            one refactor held to its plain version; its host refinement
            reported as it ends, there being no fallback on that path);
            the batched and the one-system bf16 factors also held to the
            CPU's plain bf16 route on the same values (equal pivots);
9c. mesh    the split of K: ``mesh=["cuda:0", "cuda:0"]`` and ``mesh=1``
            against the unsplit step (x within 1e-10, equal pivots and
            counts), timed in turns with it; K = 31 on two shards; a
            donating T = 3 pipeline on the split;
10. serving_solver  solver serving at the same sizes: the analyses of
            fem2d_10k and the circuit are put into a ``PlanCache`` on a
            temporary directory, and a fresh ``SolverService`` on it
            (batch 8, one retry) serves a mixed, fault-laced stream of 56
            requests (32 healthy fem2d_10k, four of them with two
            right-hand sides; 16 healthy circuit; NaN / inf values, NaN
            and wrong-shape right-hand sides and a singular system on
            fem2d_10k; a singular, an ill-conditioned and a tiny-deadline
            system on the circuit) twice: by ``solve_batch`` and through
            an ``AsyncSolverServer`` (``faultinject.run_stream``).  No
            request lost, every status inside its kind's expectation,
            healthy solutions within 1e-10 of scipy's ``spsolve``, both
            plans loaded from disk and only the ladder's retries
            analyzed, K1-K4 launched; requests/s, p50 / p99 latency, the
            dispatches' factor and solve ms, the retries' analysis
            seconds and the peak memory printed;
11. model_kernels  per serving model, K7 (flash attention) on the q/k/v of
            phi3-medium-14b's first and last attention layers and K8 (WKV)
            on the r/k/v/w of rwkv6-1.6b's first and last time-mix layers
            (timed on the first; K8 also with layer 0's decays replaced by
            draws from [1e-6, 0.05] and by 1.0, and summed over one
            prefill's 24 launches by CUDA-graph replay), at the serving
            shape (4 requests of 2,048 tokens), each against its plain
            version in bfloat16 and float32 (K7) or float32 (K8), also at a
            ragged T and (K7) without the causal mask, with its time, the
            plain version's, the library call's (K7) and the bound; K7 in
            bfloat16 also at gemma-7b's attention shape (D = 256), random
            q/k/v, beside SDPA;
12. transformer  the serving path of each model at full width and depth
            in bfloat16 through its entry points (``init_params`` on the
            card, ``greedy_generate``): 4 requests of 2,048 random prompt
            tokens, 16 new tokens each; prefill and decode times, peak
            memory, K7 / K8 launches (one per layer per prefill, none in
            decode), finite logits; decode against the teacher-forced
            forward and the kernel route against ``use_kernels=False`` in
            float32 at full width and 2 layers (2e-3); the two routes'
            bfloat16 logits and greedy tokens at full depth, printed; for
            rwkv6 the two routes also in float32 at full width and 8
            layers (2e-3).
            The peak memory is that of the serving calls alone.

9d. repairs  C1: bfloat16 factors with ``use_kernels=False`` on the card
            (no bfloat16 ``solve_triangular`` there: ``trsm_plain``), the
            bucketed schedule at K = 32 through ``factor_batched`` +
            ``solve_batched`` against ``spsolve``, both schedules held to
            the CPU's plain bfloat16 route; C3: two one-system bfloat16
            applies on the card bit-identical to each other and to the
            CPU's (the level substitution's ordered row passes);
13. moe_serving  qwen3-moe-30b-a3b at full width and depth (48 layers,
            128 experts top-8, about 30.5 B parameters) in bfloat16 after
            the earlier models are freed: ``greedy_generate`` on 4
            requests of 2,048 tokens, 16 new, prefill and decode times,
            peak memory, MoE's share of the prefill's device time, the
            device busy share, K7 on layer 0 held to its plain version and
            launched once per layer per prefill; decode ≡ forward in
            float32 at 2 layers, at capacity_factor 8.0 (printed) and held
            at E / k, where no copy can be dropped;
14. jamba_reduced  jamba-1.5-large at ``.reduced()`` end to end in float32
            (attention, Mamba, MoE sub-layers): K7 on its attention layers,
            kernel vs plain route and decode ≡ forward within 2e-3;
15. mamba_layer  one Mamba layer at jamba's full width (DI 16,384) over
            4 x 2,048 tokens: ``mamba_seq`` and 16 ``mamba_step`` calls
            timed in float32 and bfloat16, the steps within 2e-3 of the
            sequence form over the extended sequence in float32.
16. train_musicgen  musicgen-medium at full width and depth (48 layers, d
            1,536) trained in float32 through ``repro_torch.launch.train
            .main``: B = 4, T = 1,024, seq_chunk 512, 4 steps (finite
            losses, every param leaf moved, no K7 / K8 launch; step ms,
            tokens/s, peak memory), then phase 19's roofline of one more
            step on its trainer; then, at full width and
            TRAIN_RESUME_LAYERS (4) layers (``--layers``), 4 steps with
            checkpoints at
            steps 2 and 4 into a temporary directory, step 4's COMMIT
            removed (a crash before it) and a second ``main(...,
            "--resume")`` running steps 3-4 from step 2: the resumed
            losses equal to the first run's within 1e-5 relative;
            checkpoint and restore seconds;
17. train_rwkv  rwkv6-1.6b at full width (d 2,048) and 4 layers
            (TRAIN_RWKV_LAYERS, ``--layers``) in float32 through
            ``main``: B = 2,
            T = 512, 2 steps (its
            plain WKV loop under autograd): finite losses, params moved,
            no K7 / K8 launch; step ms, peak memory;
18. train_held  two ``train_step`` calls each of musicgen-medium and of
            rwkv6-1.6b at full width and 2 layers in float32, B = 2, T =
            256, on the card and on the CPU from the same params,
            optimizer state and batches, no K7 / K8 launch: the first
            step's loss within 1e-5 relative, the second's (taken at the
            first step's params) within 1e-4; after the first step m and
            v within 1e-4 of each leaf's largest entry, params: at least
            99.9% of the entries within 1e-3 of lr and every entry within
            0.5 lr (an entry whose gradient is noise near Adam's eps moves
            by a sizeable part of lr: measured 0.057 lr on musicgen, 0.220
            lr on rwkv6; the max printed); then ``forward(use_kernels=
            True)`` under grad on the card raises (K7, K8 have no
            backward) and launches nothing.
19. roofline  inside the phases that already hold the models (no model
            loaded again): phi3-medium-14b's prefill (4 x 2,048, K7) and
            one decode step, rwkv6-1.6b's prefill (K8) and one
            musicgen-medium float32 training step, each run once under
            ``repro_torch.roofline.op_cost`` (FLOPs by dtype and bytes of
            the ATen ops, the kernels' work by ``roofline.kernel_cost``):
            two bounds at the card's peaks beside the phase's own timed
            call, the eager one (the eager program's own traffic) and
            the least-traffic one (arguments read, results written
            once), each over measured, the device busy share in a
            torch.profiler window of one more call, the kernel launches;
            fails on a launch without a formula, on either bound over
            measured above 1.05, or on no K7 / K8 launch in its prefill;
            the
            records again in one ``roofline_table`` line;
20. solver_share  ``launch/solver_dryrun.py``'s per-device share on the
            card (after serving_solver): n = 800, K = 16 (4,096 systems
            over 256 devices), float32 factor and one unrefined solve,
            under ``op_cost``, in the analysis's mode (row-row) and in
            supernodal mode, which launches K1-K4; each x within 4 cond
            eps32 of ``spsolve`` (condition up to about 4.5e4), its
            backward error within n eps32, and within twice that of the
            same share's CPU plain route; its record;
21. dryrun  one full-size dry-run cell on the host, qwen3-moe-30b-a3b x
            decode_32k x pod16x16 (expert sharding, the MoE groups), as
            rank 0 of a fake process group of 256: its record and trace
            seconds.

Then one ``{"kernels": [...]}`` line (each record's ``launches_by_path``
counts the batched, pipeline, autodiff, baselines, scalar, mesh,
solver-serving and solver-share phases, or the models' serving calls and
their roofline calls (K7's also
qwen3-moe's and reduced jamba's ``greedy_generate``); a bfloat16 record
its entry point's launches in the bf16 phase), the nvidia-smi
line, and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero; it also exits non-zero, printing no result, without a CUDA
device or outside a checkout of the repository.
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
K_MAIN, T_STEPS, K_WIDTH1 = 32, 3, 8
PRESET_REPEATS = 1                  # timed passes of each §4 preset (3
#                                     before the MoE / Mamba phases came)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float64": 67e12,    # fp64 (tensor core) peak, data sheet
              "float32": 67e12,    # fp32 outside the tensor cores
              "bfloat16": 989e12}  # bf16 dense tensor cores
TOL = {"float64": 1e-10, "float32": 1e-4}
# K5 and K6 are also held to 1e-12 relative to the plain version's largest
# magnitude in float64
REL_TOL_F64 = {"gemm_update": 1e-12, "suprow_update": 1e-12,
               "suprow_update_grouped": 1e-12}
SUPROW_LARGE = (128, 300)           # K6's large shape (k, m), K rows
# the bfloat16 instances of K1-K5 (no bfloat16 K6: it has no engine path):
# kernel record -> its entry point, and the needles of its ptxas lines.
# Held to the plain version entry by entry (bf16_err): the panel LUs round
# where the plain versions do, in their order, so their finite values must
# be bit-equal; the solves, products and node steps sum in float32 in
# another order, so each finite entry is held within BF16_ULPS bf16 ulps of
# its own magnitude plus bf16's smallest normal, and a product also within
# the float32 summation bound of the two orders, 2 k 2^-24 (|A| |B|).
BF16_ULPS = 2
BF16_TINY = 2.0 ** -126
CPU_SYSTEMS = 2           # bf16 phase: value sets also factored on the CPU
# A whole bfloat16 factorization on the card against the CPU's plain route:
# the kernels sum in float32 in another order than the CPU's plain ops, so
# a rare bf16 rounding lands on the other side and later steps carry that
# ulp on (into small entries, where it is many of their ulps).  Pivots and
# counts must be equal, at most this share of the entries may differ at
# all, and none by more than BF16_ULPS ulps of the system's largest value.
BF16_DIFFER_SHARE = 1e-4
BF16_ENTRY = {"panel_lu_bucketed": "hylu_bucket_panel_lu_bf16",
              "panel_lu": "hylu_node_panel_lu_bf16",
              "trsm_right": "hylu_trsm_right_bf16",
              "trsm_left_unit_lower": "hylu_trsm_left_unit_lower_bf16",
              "trsm_left_upper": "hylu_trsm_left_upper_bf16",
              "bmm": "hylu_bmm_bf16",
              "gemm_update": "hylu_gemm_update_bf16",
              "node_edges": "hylu_node_edges_bf16"}
BF16_PTXAS = {"panel_lu_bucketed": ("panel_lu_window_kernel", "bf16r"),
              "panel_lu": ("panel_lu_window_kernel", "bf16r"),
              "trsm_right": ("trsm_right_kernel", "nv_bfloat16"),
              "trsm_left_unit_lower": ("trsm_left_kernel", "nv_bfloat16Lb0"),
              "trsm_left_upper": ("trsm_left_kernel", "nv_bfloat16Lb1"),
              "bmm": ("bmm_kernel", "bfloat16"),
              "gemm_update": ("gemm_update_kernel", "bfloat16"),
              "node_edges": ("node_edges_kernel", "bfloat16")}
TOL_LEFT = {"float64": 1e-10, "float32": 1e-3}
# the serving phases: two models at full width and depth, 4 requests of
# 2,048 prompt tokens and 16 new tokens each, weights and prompts from SEED
SERVING_MODELS = ("phi3-medium-14b", "rwkv6-1.6b")
BATCH, PROMPT, NEW_TOKENS, SEED = 4, 2048, 16, 0
# MoE serving at full width and depth (one 80 GB card holds its 61 GB of
# bf16 weights), its float32 decode check's prompt, and jamba's reduced
# prompt
MOE_MODEL, DECODE_CHECK_TOKENS, JAMBA_PROMPT = "qwen3-moe-30b-a3b", 32, 256
RAGGED_T = 2000                     # a multiple of none of K7's row tiles
# the training phases: musicgen-medium at full width and depth, (B, T,
# steps); rwkv6-1.6b likewise; the held models at full width and 2 layers,
# (B, T), on the card against the CPU
TRAIN_MUSICGEN, TRAIN_MUSICGEN_SHAPE = "musicgen-medium", (4, 1024, 4)
ROOFLINE_LIMIT = 1.05     # bound / measured above this: a count is wrong
TRAIN_RESUME_LAYERS = 4   # the checkpoint / resume check's depth (full
#                           width; the timed steps keep all 48 layers)
TRAIN_RWKV_SHAPE, TRAIN_HELD_SHAPE = (2, 512, 2), (2, 256)
TRAIN_RWKV_LAYERS = 4     # train_rwkv's depth (full width)
F32_ROUTE_LAYERS = 4      # rwkv6's float32 kernel-vs-plain route check's
#                           depth (full width)
# the held models and the kernel each one's refused route names
TRAIN_HELD = (("musicgen-medium", "K7"), ("rwkv6-1.6b", "K8"))
# K7 against its plain version, (rtol, atol): float32 at the 2e-5 of
# tests/test_kernels.py; bfloat16 inside its 3e-2, at 1e-2 relative (about
# one to two bf16 ulps of the output) plus 2e-3 for p rounded after another row
# maximum, since the plain version rounds p to bf16 as the kernel does
TOL_MODEL = {"bfloat16": (1e-2, 2e-3), "float32": (2e-5, 2e-5)}
TOL_WKV, TOL_DECODE = 2e-4, 2e-3    # K8 (y and state); decode ≡ forward
WKV_TINY_DECAY = (1e-6, 0.05)       # K8 also held at decays drawn from here
# the serving_solver phase: healthy requests on (fem2d_10k, circuit) and
# the faults injected on each pattern (ill_conditioned stays off fem2d_10k:
# every retry is a new fingerprint and so a full host analysis)
SERVING_HEALTHY = (32, 16)    # healthy fem2d_10k / circuit requests
SERVING_FAULTS = {"fem": ("nan_values", "inf_values", "nan_rhs",
                          "wrong_shape_rhs", "singular_values"),
                  "cir": ("singular_values", "ill_conditioned",
                          "tiny_deadline")}


# ``repro_torch.roofline.kernel_cost``, imported by ``main`` once the
# package is on the path: the work formulas the bound column and the
# port's roofline share
kc = None


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bench_ms(torch, fn, min_ms=50.0):
    """Mean time of one call by CUDA events over back-to-back calls that
    fill ``min_ms``, after a warm-up call: the least of three such windows
    (a call bound by the host's launch cost spreads by some 20% between
    windows)."""
    fn()
    torch.cuda.synchronize()
    reps, times = 1, []
    while len(times) < 3:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        el = t0.elapsed_time(t1)
        if not times and el < min_ms and reps < 4096:
            reps *= 4
        else:
            times.append(el / reps)
    return min(times)


def graph_ms(torch, calls, reps=5):
    """Device time of one pass of ``calls`` (thunks launched back to back),
    by CUDA events around replays of a CUDA graph that captured the pass:
    the host's cost of each launch is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for fn in calls:
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    del g
    torch.cuda.empty_cache()
    return t0.elapsed_time(t1) / reps


def lib_graph_ms(torch, calls):
    """``graph_ms`` of library calls, or None for calls that a CUDA graph
    cannot capture (their loop time is reported instead)."""
    try:
        return graph_ms(torch, calls)
    except RuntimeError:
        torch.cuda.synchronize()
        return None


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    global kc
    from repro_torch.roofline import kernel_cost as kc
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device -------------------------------------------------------
    t = time.perf_counter()
    smi = smi_line()
    emit({"phase": "device", "smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32,
          "seconds": time.perf_counter() - t})

    # ---- 2. build --------------------------------------------------------
    from repro_torch.kernels import _build

    t = time.perf_counter()
    lib_path = _build.build(force=True)
    _build.library()
    ptxas = [ln.strip() for ln in _build.last_build["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "library": os.path.relpath(lib_path, ROOT),
          "nvcc_s": _build.last_build["seconds"],
          "seconds": time.perf_counter() - t, "ptxas": ptxas})

    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import (HyluOptions, analyze, factor_batched,
                                  solve_batched, solve_sequence,
                                  torch_repeated_engine)
    from repro_torch.matrices import circuit_like, fem2d, to_csr

    # the wrappers each path launches (suprow_update has no engine caller,
    # as in the JAX package)
    batched_path = ("panel_lu_bucket_inplace", "panel_lu", "trsm_batched",
                    "trsm_left_unit_lower_batched", "trsm_left_upper_batched",
                    "gemm_batched")

    # ---- 3. analyze ------------------------------------------------------
    t = time.perf_counter()
    a_sp = fem2d(100, 100, seed=930)
    A = to_csr(a_sp)
    opts64 = HyluOptions()                       # device="cuda", kernels on
    an64 = analyze(A, opts64)
    analyze_s = time.perf_counter() - t
    eng64 = torch_repeated_engine(an64)
    sched = eng64.sched
    emit({"phase": "analyze", "matrix": "fem2d_10k", "n": A.n, "nnz": A.nnz,
          "mode": an64.choice.mode, "analyze_s": analyze_s,
          "host_timings": an64.timings, "level_steps": len(sched.steps),
          "panel_buckets": sum(len(s.panels) for s in sched.steps),
          "narrow_nodes": sum(len(s.seq) for s in sched.steps),
          "edge_buckets": sum(len(s.edges) for s in sched.steps),
          "supsup_buckets": sum(1 for s in sched.steps for e in s.edges
                                if e.k > 1),
          "scan_chunks": len(sched.scan_chunks),
          "block_nodes": len(eng64._blocks),
          "seconds": time.perf_counter() - t})

    # the same plan under the other schedule and route (matching and
    # ordering reused)
    t = time.perf_counter()
    an_u = analyze(A, HyluOptions(factor_schedule="unrolled"), reuse=an64)
    eng_u = torch_repeated_engine(an_u)
    emit({"phase": "analyze_reuse", "unrolled_s": time.perf_counter() - t})

    rng = np.random.default_rng(2026)
    vals0 = A.data[None] * rng.uniform(0.8, 1.2, (K_MAIN, A.nnz))
    records = kernel_phase(torch, np, kernels, eng64, vals0, eng_u)

    # ---- 5. main path ----------------------------------------------------
    t = time.perf_counter()
    seq_rng = np.random.default_rng(7)
    values = A.data[None, None] * seq_rng.uniform(0.8, 1.2,
                                                  (T_STEPS, K_MAIN, A.nnz))
    b = np.random.default_rng(8).normal(size=(K_MAIN, A.n))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    xs, info_seq = solve_sequence(A, values, b, opts64)
    t_seq = time.perf_counter() - t
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = factor_batched(an64, A, values[0])
    t_factor = time.perf_counter() - t0
    t0 = time.perf_counter()
    x64, info64 = solve_batched(bst, b)
    t_solve = time.perf_counter() - t0
    an32 = analyze(A, HyluOptions(factor_dtype="float32"), reuse=an64)
    torch_repeated_engine(an32)                  # build it outside the timing
    t0 = time.perf_counter()
    bst32 = factor_batched(an32, A, values[0])
    t_factor32 = time.perf_counter() - t0
    t0 = time.perf_counter()
    x32, info32 = solve_batched(bst32, b)
    t_solve32 = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # launches of one refactor and of one substitution (outside the counts
    # of the main path above)
    b_dev = torch.from_numpy(b).to(eng64.device)
    kernels.reset_launch_counts()
    f = eng64.refactor_batched(bst.values_dev)
    per_refactor = kernels.launch_counts()
    kernels.reset_launch_counts()
    eng64.apply_batched(f.vals, f.inode_perm, b_dev)
    per_apply = kernels.launch_counts()
    # everything the device runs in one bucketed refactor (torch.profiler),
    # and with K1's bucket phase as the engine ran it before the in-place
    # kernel (gather, threshold repeat, parent kernel, scatter)
    from repro_torch.kernels.panel import ops as panel_ops

    n_buckets = sum(len(s_.panels) for s_ in sched.steps)
    dk = {"in_place": device_kernels(
        torch, lambda: eng64.refactor_batched(bst.values_dev))}
    eng64._panel_lu_bucket = lambda v_, l_, e_: parent_bucket(panel_ops, v_,
                                                              l_, e_)
    try:
        dk["parent_bucket_phase"] = device_kernels(
            torch, lambda: eng64.refactor_batched(bst.values_dev))
    finally:
        del eng64._panel_lu_bucket
    dk["panel_buckets"] = n_buckets
    dk["fewer_per_bucket"] = (dk["parent_bucket_phase"]
                              - dk["in_place"]) / n_buckets

    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    scipy_err = []
    for k in (0, K_MAIN - 1):
        ak = sp.csr_matrix((values[0, k], A.indices, A.indptr),
                           shape=(A.n, A.n)).tocsc()
        xr = spla.spsolve(ak, b[k])
        scipy_err.append(float(np.abs(x64[k] - xr).max() / np.abs(xr).max()))
    mixed_err = float(np.abs(x32 - x64).max() / np.abs(x64).max())
    seq_vs_step = float(np.abs(xs[0] - x64).max() / np.abs(x64).max())
    main = {"phase": "main", "matrix": "fem2d_10k", "k": K_MAIN,
            "steps": T_STEPS, "analyze_s": analyze_s,
            "solve_sequence_s": t_seq,
            "factor_batched_ms": t_factor * 1e3,
            "solve_batched_ms": t_solve * 1e3,
            "systems_per_s": K_MAIN / (t_factor + t_solve),
            "factor_batched_f32_ms": t_factor32 * 1e3,
            "solve_batched_f32_ms": t_solve32 * 1e3,
            "max_residual_seq": float(info_seq["residual"].max()),
            "max_residual_f64": float(info64["residual"].max()),
            "max_residual_f32": float(info32["residual"].max()),
            "refine_iters_seq": info_seq["n_refine"],
            "refine_iters_f64": info64["n_refine"],
            "refine_iters_f32": info32["n_refine"],
            "n_fp64_fallback": info32["n_fp64_fallback"],
            "n_perturb": int(info64["n_perturb"].sum()),
            "scipy_rel_err": scipy_err, "mixed_vs_f64_rel_err": mixed_err,
            "sequence_step0_vs_step_rel_err": seq_vs_step,
            "launches": counts, "launches_per_refactor": per_refactor,
            "device_kernels_per_refactor": dk,
            "launches_per_apply": per_apply, "max_memory_allocated": peak,
            "seconds": time.perf_counter() - t}
    emit(main)
    check(np.isfinite(xs).all() and xs.shape == (T_STEPS, K_MAIN, A.n),
          "sequence solutions are finite and (T, K, n)")
    for key in ("max_residual_seq", "max_residual_f64", "max_residual_f32"):
        check(main[key] <= 1e-10, f"{key} = {main[key]} > 1e-10")
    check(max(scipy_err) <= 1e-10, f"scipy disagreement {scipy_err}")
    check(mixed_err <= 1e-10, f"mixed vs f64 {mixed_err}")
    for name in batched_path:
        check(counts[name] > 0,
              f"kernel {name} was not launched on the main path")
    check(per_refactor["panel_lu_bucket_inplace"] == n_buckets
          and per_refactor["panel_lu_batched"] == 0,
          f"K1 launches per bucketed refactor {per_refactor} != one per "
          f"panel bucket ({n_buckets})")

    pipeline_counts = pipeline_phase(torch, np, kernels, A, an64, values, b,
                                     xs, info_seq)

    # ---- 6. width-1 path -------------------------------------------------
    t = time.perf_counter()
    C = to_csr(circuit_like(2000, seed=3))
    crng = np.random.default_rng(11)
    cvals = C.data[None] * crng.uniform(0.8, 1.2, (K_WIDTH1, C.nnz))
    cb = crng.normal(size=(K_WIDTH1, C.n))
    kernels.reset_launch_counts()
    anc = analyze(C, opts64)
    n_chunks = len(torch_repeated_engine(anc).sched.scan_chunks)
    xc, infoc = solve_batched(factor_batched(anc, C, cvals), cb)
    emit({"phase": "width1", "matrix": "circuit_like(2000, seed=3)",
          "mode": anc.choice.mode, "k": K_WIDTH1, "scan_chunks": n_chunks,
          "max_residual": float(infoc["residual"].max()),
          "launches": kernels.launch_counts(),
          "seconds": time.perf_counter() - t})
    check(n_chunks > 0, "circuit schedule has no scan chunks")
    check(np.isfinite(xc).all() and infoc["residual"].max() <= 1e-10,
          f"width-1 residual {infoc['residual'].max()}")

    autodiff_counts = autodiff_phase(torch, np, kernels, A, an64)
    baseline_counts, wide = baselines_phase(torch, np, kernels, A, an64,
                                            values[0], b)
    records.extend(wide)
    scalar_counts = scalar_phase(torch, np, kernels, A, an64, an_u, an32)
    plain_phase(torch, np, kernels, A, an64, bst, values[0], b, t_factor,
                t_solve)
    bf16_counts, bf16_entries = bf16_phase(torch, np, kernels, A, an64,
                                           values[0], b)
    mesh_counts = mesh_phase(torch, np, kernels, A, an64, values[0], b, bst,
                             x64, xs, values)
    repairs_phase(torch, np, kernels, A, an64, values[0], b)
    serving_counts = serving_solver_phase(torch, np, kernels, A, an64, C, anc)
    share_counts = solver_share_phase(torch, np, kernels)

    for rec in records:
        w = rec.pop("wrapper")
        if rec.get("dtype") == "bfloat16":
            # the bfloat16 instance's own launches on the bfloat16 path
            # (its wrapper also counts the float64 fallback's)
            rec["launches_by_path"] = {
                **rec.get("launches_by_path", {}),
                "bf16": bf16_entries.get(rec["entry"], 0)}
            rec["wrapper_launches_bf16_phase"] = bf16_counts[w]
        else:
            rec["launches_by_path"] = {"batched": counts[w],
                                       "pipeline": pipeline_counts[w],
                                       "autodiff": autodiff_counts[w],
                                       "baselines": baseline_counts[w],
                                       "scalar": scalar_counts[w],
                                       "mesh": mesh_counts[w],
                                       "serving": serving_counts[w],
                                       "solver_share": share_counts[w]}
        rec["launches"] = sum(rec["launches_by_path"].values())
    # the solver phases' device state goes before the models (qwen3-moe's
    # 61 GB of weights need the card to themselves)
    del bst, bst32, f, b_dev, eng64, eng_u
    for an in (an64, an_u, an32, anc):
        an.engine_cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    # from here, segments grow in place: a small tensor left in a freed
    # model's segment no longer pins the segment (the 18 GiB expert stacks
    # need contiguous room)
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    emit({"phase": "free_solver",
          "memory_allocated": torch.cuda.memory_allocated(),
          "memory_reserved": torch.cuda.memory_reserved()})
    from repro_torch.configs import registry

    for name in SERVING_MODELS:
        rec = serving_phase(torch, np, kernels, registry.get(name))
        for path, c in (("serving", serving_counts),
                        ("solver_share", share_counts),
                        ("baselines", baseline_counts),
                        ("pipeline", pipeline_counts),
                        ("autodiff", autodiff_counts),
                        ("mesh", mesh_counts)):
            rec["launches_by_path"][path] = c[rec["name"]]
        records.append(rec)
    flash_rec = next(r for r in records if r["name"] == "flash_attention")
    for path, phase in ((MOE_MODEL, moe_serving_phase),
                        ("jamba_reduced", jamba_reduced_phase)):
        n, _ = phase(torch, np, kernels)
        flash_rec["launches_by_path"][path] = n
        flash_rec["launches"] += n
    mamba_layer_phase(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    roof = [r_ for rec in records for r_ in rec.pop("roofline", [])]
    roof.append(train_musicgen_phase(torch, np))
    train_rwkv_phase(torch, np)
    train_held_phase(torch, np)
    dryrun_phase(torch)
    emit({"phase": "roofline_table", "records": roof})
    emit({"kernels": records})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def bf16_phase(torch, np, kernels, A, an64, values0, b):
    """Phase 9b: bfloat16 factors at fem2d_10k, K = 32, full size.
    ``factor_batched`` + ``solve_batched`` with ``factor_dtype="bfloat16"``
    (bucketed) beside the same step in float64: every x within 1e-10 of
    scipy's ``spsolve`` (the float64 refinement, then the float64 fallback
    for the systems it leaves above tolerance) with an all-clear
    ``refine_failed``; factor and solve ms (the solve split into the
    fallback's ``fallback_time`` and the rest, the bfloat16 applies; every
    engine built before the timings), peak memory, factor storage,
    ``n_fp64_fallback``.  The bfloat16 factors themselves are held to the
    CPU's plain bfloat16 route (the same analysis, ``device="cpu"``) on the
    first CPU_SYSTEMS value sets: equal pivots and perturbation counts,
    the values by :func:`held_to_cpu`.  Then the one-system lifecycle in
    bfloat16 under the unrolled schedule (``factor`` -> ``refactor`` ->
    ``solve``): its times and launches, every K5 node step of one more
    refactor held to ``node_edges_plain`` on the same input
    (:func:`bf16_err`), and its factors held to the CPU's plain lifecycle
    on the same matrices (equal pivots and counts, values by
    :func:`held_to_cpu`, the same ``refine_failed``); the host refinement
    ends where it ends (no float64 fallback on that path, in either
    package), so x is reported beside the CPU's, not held.  The wrappers count launches
    whatever the dtype and the fallback launches float64 kernels through
    them, so a spy on ``_build.launch`` also counts launches by entry
    point.  Returns the phase's (wrapper counts, entry-point counts)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    import dataclasses

    from repro_torch.core import (CSR, analyze, factor, factor_batched,
                                  refactor, solve, solve_batched,
                                  torch_repeated_engine)
    from repro_torch.core.options import resolve_refine_tol
    from repro_torch.kernels import _build
    from repro_torch.kernels.supsup import ops as supsup_ops

    t_all = time.perf_counter()
    K = values0.shape[0]
    an_bf = analyze(A, dataclasses.replace(an64.opts,
                                           factor_dtype="bfloat16"),
                    reuse=an64)
    an_bu = analyze(A, dataclasses.replace(an_bf.opts,
                                           factor_schedule="unrolled"),
                    reuse=an64)
    for an in (an64, an_bf, an_bu):
        torch_repeated_engine(an)              # built outside the timings
    # the float64 fallback's engine on the bfloat16 analysis, too
    torch_repeated_engine(an_bf, dtype="float64", refine_dtype="float64")
    entries, orig = {}, _build.launch

    def spy(name, *args, **kwargs):
        entries[name] = entries.get(name, 0) + 1
        return orig(name, *args, **kwargs)

    def mats(vals):
        return [sp.csr_matrix((v, A.indices, A.indptr),
                              shape=(A.n, A.n)).tocsc() for v in vals]

    xr = np.stack([spla.spsolve(m, b[k]) for k, m in
                   enumerate(mats(values0))])
    total = dict.fromkeys(kernels.launch_counts(), 0)
    runs = {}
    for label, an in (("float64", an64), ("bfloat16", an_bf)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        entries.clear()
        _build.launch = spy
        try:
            t0 = time.perf_counter()
            bst = factor_batched(an, A, values0)
            t_f = time.perf_counter() - t0
            factor_entries = dict(entries)
            t0 = time.perf_counter()
            x, info = solve_batched(bst, b)
            t_s = time.perf_counter() - t0
        finally:
            _build.launch = orig
        counts = kernels.launch_counts()
        if label == "bfloat16":
            for w, c in counts.items():
                total[w] += c
        fb_s = info.get("fallback_time", 0.0)
        runs[label] = {
            "factor_batched_ms": t_f * 1e3, "solve_batched_ms": t_s * 1e3,
            "fallback_ms": fb_s * 1e3,
            "solve_without_fallback_ms": (t_s - fb_s) * 1e3,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "factor_storage_bytes": bst.vals.numel() * bst.vals.element_size(),
            "factor_dtype": info["factor_dtype"],
            "n_fp64_fallback": info["n_fp64_fallback"],
            "escalation": info["escalation"],
            "n_refine": info["n_refine"],
            "n_perturb": int(bst.n_perturb.sum()),
            "max_residual": float(info["residual"].max()),
            "refine_failed": int(info["refine_failed"].sum()),
            "scipy_rel_err": float(np.abs(x - xr).max() / np.abs(xr).max()),
            "launches": {w: c for w, c in counts.items() if c},
            "entry_points_factor": factor_entries,
            "entry_points": dict(entries)}
        if label == "bfloat16":
            bst_bf = bst
    batched_entries = dict(runs["bfloat16"]["entry_points"])
    # the bfloat16 factors against the CPU's plain route on the same values
    t0 = time.perf_counter()
    f_cpu = torch_repeated_engine(an_bf, device="cpu").refactor_batched(
        torch.from_numpy(values0[:CPU_SYSTEMS]))
    e_, u_, d_, o_ = bf16_err(torch, bst_bf.vals[:CPU_SYSTEMS].cpu(),
                              f_cpu.vals)
    vs_cpu = {"systems": CPU_SYSTEMS,
              "held": held_to_cpu(torch, bst_bf.vals[:CPU_SYSTEMS].cpu(),
                                  f_cpu.vals, d_),
              "same_pivots": bool(torch.equal(
                  bst_bf.inode_perm[:CPU_SYSTEMS].cpu(), f_cpu.inode_perm)),
              "same_n_perturb": bool(np.array_equal(
                  bst_bf.n_perturb[:CPU_SYSTEMS],
                  f_cpu.n_perturb.numpy())),
              "max_abs_err": e_, "max_ulps_of_entry": u_,
              "entries_differing": d_, "entries_over_limit": o_,
              "entries": int(f_cpu.vals.numel()),
              "cpu_s": time.perf_counter() - t0}
    runs["bfloat16"]["vs_cpu_plain"] = vs_cpu
    del bst_bf, f_cpu

    # the one-system lifecycle, unrolled, in bfloat16
    rng = np.random.default_rng(9)
    v1, v2 = (A.data * rng.uniform(0.8, 1.2, A.nnz) for _ in range(2))
    A1 = CSR(A.n, A.indptr, A.indices, v1)
    A2 = CSR(A.n, A.indptr, A.indices, v2)
    bs = rng.normal(size=A.n)
    xr1 = spla.spsolve(mats([v2])[0], bs)
    nodes = an_bu.plan.nodes
    n_steps = sum(1 for nd in nodes if nd.edges or nd.nr == 1)
    n_wide = sum(1 for nd in nodes if nd.nr > 1)
    torch.cuda.synchronize()
    entries.clear()
    _build.launch = spy
    try:
        t0 = time.perf_counter()
        st = factor(an_bu, A1)
        t_f = time.perf_counter() - t0
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        st = refactor(st, A2)
        t_r = time.perf_counter() - t0
        per_refactor = kernels.launch_counts()
        t0 = time.perf_counter()
        x1, info1 = solve(st, bs)
        t_s = time.perf_counter() - t0
    finally:
        _build.launch = orig
    for w, c in kernels.launch_counts().items():
        total[w] += c
    for name, c in entries.items():
        batched_entries[name] = batched_entries.get(name, 0) + c
    # every node step of one more refactor against its plain version, on
    # the input the program hands it
    worst, steps_held = [0.0, 0.0, 0], [0]
    orig_ns = supsup_ops.node_edges_inplace

    def held_step(vals, table, step, eps, nper, n_edges=None):
        v0, n0 = vals.clone(), nper.clone()
        orig_ns(vals, table, step, eps, nper, n_edges)
        supsup_ops.node_edges_plain(v0, table, step, eps, n0, n_edges)
        lo, hi = step.off, step.off + step.nr * step.w
        e_, u_, d_, o_ = bf16_err(torch, vals[:, lo:hi], v0[:, lo:hi])
        check(torch.equal(nper, n0) and o_ == 0,
              f"bf16: node step at slot {lo}: {o_} entries over "
              f"{BF16_ULPS} ulps of their own from its plain version (max "
              f"{e_}, {u_} ulps) or other perturbations")
        worst[0], worst[1] = max(worst[0], e_), max(worst[1], u_)
        worst[2] += d_
        steps_held[0] += 1

    held_step.launches = 0
    eng_u = torch_repeated_engine(an_bu)
    supsup_ops.node_edges_inplace = held_step
    try:
        eng_u.refactor(torch.from_numpy(v2).to(eng_u.device))
    finally:
        supsup_ops.node_edges_inplace = orig_ns
    torch.cuda.synchronize()
    tf = st.torch_factors
    tol = resolve_refine_tol(an_bu.opts, "float64")
    # the same lifecycle on the CPU's plain route
    t0 = time.perf_counter()
    an_bc = analyze(A, dataclasses.replace(an_bu.opts, device="cpu"),
                    reuse=an64)
    st_c = refactor(factor(an_bc, A1), A2)
    x_c, info_c = solve(st_c, bs)
    tc = st_c.torch_factors
    e_, u_, d_, o_ = bf16_err(torch, tf.vals.cpu(), tc.vals)
    lc_cpu = {"held": held_to_cpu(torch, tf.vals.cpu()[None],
                                  tc.vals[None], d_),
              "same_pivots": bool(torch.equal(tf.inode_perm.cpu(),
                                              tc.inode_perm)),
              "same_n_perturb": info1["n_perturb"] == info_c["n_perturb"],
              "max_abs_err": e_, "max_ulps_of_entry": u_,
              "entries_differing": d_, "entries_over_limit": o_,
              "x_rel_err": float(np.abs(x1 - x_c).max()
                                 / np.abs(x_c).max()),
              "cpu_residual": info_c["residual"],
              "cpu_n_refine": info_c["n_refine"],
              "cpu_refine_failed": info_c["refine_failed"],
              "cpu_s": time.perf_counter() - t0}
    scalar = {"factor_ms": t_f * 1e3, "refactor_ms": t_r * 1e3,
              "solve_ms": t_s * 1e3, "residual": info1["residual"],
              "n_refine": info1["n_refine"],
              "n_perturb": info1["n_perturb"],
              "refine_failed": info1["refine_failed"],
              "scipy_rel_err": float(np.abs(x1 - xr1).max()
                                     / np.abs(xr1).max()),
              "launches_per_refactor": {w: c for w, c in
                                        per_refactor.items() if c},
              "node_steps_held": steps_held[0],
              "node_steps_max_abs_err": worst[0],
              "node_steps_max_ulps_of_entry": worst[1],
              "node_steps_entries_differing": worst[2],
              "vs_cpu_plain": lc_cpu}
    rec = {"phase": "bf16", "matrix": "fem2d_10k", "k": K, "runs": runs,
           "scalar_unrolled": scalar, "entry_points": batched_entries,
           "factor_storage_ratio":
               runs["bfloat16"]["factor_storage_bytes"]
               / runs["float64"]["factor_storage_bytes"],
           "seconds": time.perf_counter() - t_all}
    emit(rec)
    r = runs["bfloat16"]
    check(r["factor_dtype"] == "bfloat16", "bf16: factor dtype")
    for label, run in runs.items():
        check(run["scipy_rel_err"] <= 1e-10 and run["max_residual"] <= 1e-10
              and run["refine_failed"] == 0,
              f"bf16 phase {label}: x off spsolve by {run['scipy_rel_err']},"
              f" residual {run['max_residual']}, {run['refine_failed']} "
              "failed")
    check(vs_cpu["same_pivots"] and vs_cpu["same_n_perturb"]
          and vs_cpu["held"],
          f"bf16: batched factors differ from the CPU's plain route: "
          f"{vs_cpu}")
    # x itself is not held: the refinement does not converge on either
    # device, so x carries no digits to compare (the bits of one bf16
    # apply are held in the repairs phase)
    check(lc_cpu["same_pivots"] and lc_cpu["same_n_perturb"]
          and lc_cpu["held"]
          and lc_cpu["cpu_refine_failed"] == info1["refine_failed"],
          f"bf16 unrolled: the lifecycle differs from the CPU's plain "
          f"route: {lc_cpu}")
    for name in ("hylu_bucket_panel_lu_bf16", "hylu_node_panel_lu_bf16",
                 "hylu_trsm_right_bf16", "hylu_bmm_bf16"):
        check(r["entry_points_factor"].get(name, 0) > 0,
              f"bf16: {name} was not launched by factor_batched")
    for name in ("hylu_trsm_left_unit_lower_bf16",
                 "hylu_trsm_left_upper_bf16", "hylu_node_edges_bf16"):
        check(batched_entries.get(name, 0) > 0,
              f"bf16: {name} was not launched on the bfloat16 path")
    for w in ("panel_lu_bucket_inplace", "panel_lu", "trsm_batched",
              "trsm_left_unit_lower_batched", "trsm_left_upper_batched",
              "gemm_batched", "node_edges_inplace"):
        check(total[w] > 0, f"bf16: wrapper {w} was not launched")
    per_edge = [n for n in batched_entries
                if n.startswith("hylu_gemm_update_")]
    check(not per_edge, f"bf16: the per-edge K5 ran on the bfloat16 path: "
                        f"{per_edge}")
    check(scalar["launches_per_refactor"].get("node_edges_inplace", 0)
          == n_steps and scalar["launches_per_refactor"].get("panel_lu", 0)
          == n_wide, f"bf16 unrolled refactor: launches "
                     f"{scalar['launches_per_refactor']} != {n_steps} node "
                     f"steps, {n_wide} K2")
    check(steps_held[0] == n_steps, f"bf16: {steps_held[0]} node steps "
                                    f"held of {n_steps}")
    check(bool(torch.isfinite(tf.vals.float()).all())
          and bool(np.isfinite(x1).all()), "bf16 unrolled: non-finite")
    check(info1["refine_failed"] == (info1["residual"] > tol),
          "bf16 unrolled: refine_failed disagrees with the residual")
    return total, batched_entries


def mesh_phase(torch, np, kernels, A, an64, values0, b, bst64, x64, xs,
               values):
    """Phase 9c: the split of K on the card at fem2d_10k, K = 32:
    ``HyluOptions(mesh=["cuda:0", "cuda:0"])`` (two shards of 16 on one
    card, one engine) and ``mesh=1`` against the unsplit main step (x
    within 1e-10, equal pivots, perturbation and refinement counts), timed
    in turns with the unsplit step (unsplit, split, split, unsplit; the
    shards' factors and refinement iterations are queued together, but on
    one card they share one stream, so no gain is expected: the ratio is
    printed beside PR 25's, when each shard ran to its end before the
    next began); K = 31 on the two shards (the second padded with system
    0); one donating
    T = 3 pipeline (``solve_sequence``'s ``_run_pipeline``) on the split
    against the main phase's ``solve_sequence``.  Returns the launch
    counts of the split runs."""
    import dataclasses

    from repro_torch.core import (analyze, factor_batched, solve_batched,
                                  torch_repeated_engine)
    from repro_torch.core.batched import _run_pipeline

    t_all = time.perf_counter()
    K = values0.shape[0]
    two = ["cuda:0", "cuda:0"]
    an2 = analyze(A, dataclasses.replace(an64.opts, mesh=two), reuse=an64)
    an1 = analyze(A, dataclasses.replace(an64.opts, mesh=1), reuse=an64)
    for an in (an2, an1):
        torch_repeated_engine(an, device="cuda:0")   # outside the timings
    total = dict.fromkeys(kernels.launch_counts(), 0)

    def run(an, vals, bb, count):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        bst = factor_batched(an, A, vals)
        t1 = time.perf_counter()
        x, info = solve_batched(bst, bb)
        t2 = time.perf_counter()
        if count:
            for w, c in kernels.launch_counts().items():
                total[w] += c
        return bst, x, info, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    def held(label, bst, x, info, k):
        inode = bst.inode_perm
        err = float(np.abs(x - x64[:k]).max() / np.abs(x64[:k]).max())
        ok = {"x_rel_err": err,
              "same_pivots": bool(torch.equal(inode, bst64.inode_perm[:k])),
              "same_n_perturb": bool(np.array_equal(bst.n_perturb,
                                                    bst64.n_perturb[:k])),
              "shards": [p.k for p in bst.shards], "k_pad": bst.k_pad,
              "max_residual": float(info["residual"].max())}
        check(err <= 1e-10 and ok["same_pivots"] and ok["same_n_perturb"]
              and ok["max_residual"] <= 1e-10,
              f"mesh {label}: {ok}")
        return ok

    times = {"unsplit": [], "mesh_cuda0_x2": []}
    res, infos = {}, {}
    for label, an in (("unsplit", an64), ("mesh_cuda0_x2", an2),
                      ("mesh_cuda0_x2", an2), ("unsplit", an64)):
        bst, x, info, tf, ts = run(an, values0, b, label != "unsplit")
        times[label].append({"factor_ms": tf, "solve_ms": ts})
        infos[label] = info
        if label != "unsplit":
            res[label] = held(label, bst, x, info, K)
    check(bool(np.array_equal(infos["unsplit"]["n_refine_per_system"],
                              infos["mesh_cuda0_x2"]["n_refine_per_system"])),
          "mesh: refinement counts differ")
    bst, x, info, tf, ts = run(an1, values0, b, True)
    res["mesh_1"] = held("1", bst, x, info, K)
    times["mesh_1"] = [{"factor_ms": tf, "solve_ms": ts}]
    bst, x, info, tf, ts = run(an2, values0[:K - 1], b[:K - 1], True)
    res["mesh_cuda0_x2_k31"] = held("K = 31", bst, x, info, K - 1)
    check(res["mesh_cuda0_x2_k31"]["shards"] == [K // 2, K // 2],
          f"mesh: K = 31 shards {res['mesh_cuda0_x2_k31']['shards']}")
    an2d = dataclasses.replace(an2, opts=dataclasses.replace(an2.opts,
                                                             donate=True))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    xs2, info_s = _run_pipeline(an2d, (A.indptr, A.indices), values, b)
    t_pipe = time.perf_counter() - t0
    for w, c in kernels.launch_counts().items():
        total[w] += c
    err_seq = float(np.abs(xs2 - xs).max() / np.abs(xs).max())

    def med(label, key):
        return _median([t[key] for t in times[label]])

    rec = {"phase": "mesh", "matrix": "fem2d_10k", "k": K, "mesh": two,
           "runs": res, "times_ms": times,
           "split_over_unsplit": {
               key: med("mesh_cuda0_x2", key) / med("unsplit", key)
               for key in ("factor_ms", "solve_ms")},
           "split_over_unsplit_shards_one_after_the_other": {
               "factor_ms": 2.21, "solve_ms": 2.12,
               "source": "PERF.md, PR 25 review round"},
           "engines": len(an2.engine_cache),
           "pipeline_t3_donate": {"x_vs_solve_sequence_rel_err": err_seq,
                                  "s": t_pipe, "donate": info_s["donate"],
                                  "max_residual": float(
                                      info_s["residual"].max())},
           "launches": {w: c for w, c in total.items() if c},
           "seconds": time.perf_counter() - t_all}
    emit(rec)
    check(rec["engines"] == 1, "mesh: shards on one card share one engine")
    check(err_seq <= 1e-10 and info_s["donate"]
          and rec["pipeline_t3_donate"]["max_residual"] <= 1e-10,
          f"mesh pipeline: {rec['pipeline_t3_donate']}")
    for w in ("panel_lu_bucket_inplace", "panel_lu", "trsm_batched",
              "gemm_batched", "trsm_left_unit_lower_batched",
              "trsm_left_upper_batched"):
        check(total[w] > 0, f"mesh: kernel {w} was not launched")
    return total


def pipeline_phase(torch, np, kernels, A, an64, values, b, xs, info_seq):
    """Phase 5b: the T-step ``solve_sequence`` pipeline on fem2d_10k at
    K = 32 (the main phase's analysis, values and right-hand sides): T = 3
    without and with donation, then T = 6 with donation (three more
    steps of new values), each after a reset of the peak memory
    statistics, beside T = 3 sequential ``factor_batched`` +
    ``solve_batched`` calls before and after the streams (the host's
    launch cost drifts within a process).  The donating stream must give the answers of
    the stream without donation (1e-10, ``index_add_`` is atomic on the
    card) with equal counts and masks, peak no higher, and grow by less
    than one factor buffer from T = 3 to T = 6.  Returns the phase's
    launch counts."""
    import dataclasses

    from repro_torch.core import factor_batched, solve_batched
    from repro_torch.core.batched import _run_pipeline

    t_all = time.perf_counter()
    pattern = (A.indptr, A.indices)
    an_d = dataclasses.replace(an64, opts=dataclasses.replace(an64.opts,
                                                              donate=True))
    rng = np.random.default_rng(17)
    values6 = np.concatenate([values, A.data[None, None] * rng.uniform(
        0.8, 1.2, (3,) + values.shape[1:])])
    total = dict.fromkeys(kernels.launch_counts(), 0)

    def sequential():                   # T factor_batched + solve_batched
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(values.shape[0]):
            solve_batched(factor_batched(an64, A, values[t]), b)
        return (time.perf_counter() - t0) / values.shape[0]

    seq_s = [sequential()]              # before and after the streams
    runs = {}
    for label, an, vals in (("t3", an64, values), ("t3_donate", an_d, values),
                            ("t6_donate", an_d, values6)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        x, info = _run_pipeline(an, pattern, vals, b)
        sec = time.perf_counter() - t0
        for w, c in kernels.launch_counts().items():
            total[w] += c
        runs[label] = (x, info, sec, torch.cuda.max_memory_allocated())
    seq_s.append(sequential())
    (x3, i3, s3, p3), (xd, idn, sd, pd), (x6, i6, s6, p6) = (
        runs[k] for k in ("t3", "t3_donate", "t6_donate"))
    factor_bytes = values.shape[1] * int(an64.plan.total_slots) * 8
    err_d = float(np.abs(xd - x3).max() / np.abs(x3).max())
    err_main = float(np.abs(x3 - xs).max() / np.abs(xs).max())
    err_6 = float(np.abs(x6[:3] - xd).max() / np.abs(xd).max())
    same = {key: bool(np.array_equal(idn[key], i3[key])) for key in
            ("n_refine_per_system", "refine_failed", "refine_stalled",
             "n_perturb")}
    rec = {"phase": "pipeline", "matrix": "fem2d_10k",
           "k": int(values.shape[1]),
           "donating_vs_plain_rel_err": err_d,
           "plain_vs_solve_sequence_rel_err": err_main,
           "t6_first3_vs_t3_rel_err": err_6,
           "n_refine": {"t3": i3["n_refine"], "t3_donate": idn["n_refine"],
                        "t6_donate": i6["n_refine"]},
           "equal_counts_and_masks": same,
           "max_residual": max(float(r[1]["residual"].max())
                               for r in runs.values()),
           "peak_bytes": {"t3": p3, "t3_donate": pd, "t6_donate": p6},
           "factor_buffer_bytes": factor_bytes,
           "s_per_step": {"t3": s3 / 3, "t3_donate": sd / 3,
                          "t6_donate": s6 / 6,
                          "sequential_factor_solve_before_after": seq_s},
           "pipeline_s_reported": {k: r[1]["timings"]["pipeline"]
                                   for k, r in runs.items()},
           "donate": {k: r[1]["donate"] for k, r in runs.items()},
           "launches": {w: c for w, c in total.items() if c},
           "seconds": time.perf_counter() - t_all}
    emit(rec)
    check(x3.shape == xs.shape and x6.shape[0] == 6,
          "pipeline: solutions of (T, K, n)")
    check(rec["max_residual"] <= 1e-10,
          f"pipeline: residual {rec['max_residual']} > 1e-10")
    check(err_d <= 1e-10, f"pipeline: donating vs plain stream {err_d}")
    check(err_main <= 1e-10, f"pipeline: vs solve_sequence {err_main}")
    check(err_6 <= 1e-10, f"pipeline: T = 6's first steps vs T = 3 {err_6}")
    check(idn["n_refine"] == i3["n_refine"] and all(same.values()),
          f"pipeline: donating counts or masks differ: {same}")
    check(not i3["donate"] and idn["donate"] and i6["donate"],
          "pipeline: donate flags")
    check(pd <= p3, f"pipeline: donating peak {pd} > plain peak {p3}")
    check(p6 - pd < factor_bytes, f"pipeline: T = 3 -> 6 grew by "
                                  f"{p6 - pd} B >= one factor buffer "
                                  f"({factor_bytes} B)")
    for w in ("panel_lu_bucket_inplace", "panel_lu", "trsm_batched",
              "gemm_batched", "trsm_left_unit_lower_batched",
              "trsm_left_upper_batched"):
        check(total[w] > 0, f"pipeline: kernel {w} was not launched")
    return total


def autodiff_phase(torch, np, kernels, A, an64):
    """Phase 6b: the differentiable solve (``make_sparse_solve``) at
    fem2d_10k, the whole matrix: x of one right-hand side and the
    gradients of sum(W x) with respect to b and A's values by
    ``backward()``, held to scipy alone: x to ``spsolve(A, b)``, b's
    gradient to y = ``spsolve(Aᵀ, W)``, the values' to −y[rows] x[cols]
    (each relative to its largest magnitude, 1e-10).  The forward must
    launch K1–K4 (the bucketed one-system refactor); forward and backward
    ms after a warm-up call.  Returns the phase's launch counts."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from repro_torch.core import make_sparse_solve, torch_repeated_engine

    t_all = time.perf_counter()
    rng = np.random.default_rng(41)
    b, W = rng.normal(size=A.n), rng.normal(size=A.n)
    solve = make_sparse_solve(an64)
    dev = torch_repeated_engine(an64).device
    w_dev = torch.from_numpy(W).to(dev)

    def run():
        a_t = torch.tensor(A.data, device=dev, requires_grad=True)
        b_t = torch.tensor(b, device=dev, requires_grad=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = solve(a_t, b_t)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fwd = kernels.launch_counts()
        (w_dev * x).sum().backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return x, a_t.grad, b_t.grad, fwd, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    run()                                        # warm-up (uploads)
    kernels.reset_launch_counts()
    x, a_grad, b_grad, fwd, fwd_ms, bwd_ms = run()
    total = kernels.launch_counts()
    a = sp.csr_matrix((A.data, A.indices, A.indptr), shape=(A.n, A.n))
    x_ref = spla.spsolve(a.tocsc(), b)
    y = spla.spsolve(a.T.tocsc(), W)
    rows = np.repeat(np.arange(A.n), np.diff(A.indptr))
    a_ref = -y[rows] * x_ref[A.indices]

    def rel(got, ref):
        return float(np.abs(got.detach().cpu().numpy() - ref).max()
                     / np.abs(ref).max())

    rec = {"phase": "autodiff", "matrix": "fem2d_10k", "n": A.n,
           "nnz": A.nnz, "x_rel_err": rel(x, x_ref),
           "b_grad_rel_err": rel(b_grad, y),
           "a_grad_rel_err": rel(a_grad, a_ref),
           "forward_ms": fwd_ms, "backward_ms": bwd_ms,
           "forward_launches": {w: c for w, c in fwd.items() if c},
           "backward_launches": {w: total[w] - fwd[w] for w in total
                                 if total[w] - fwd[w]},
           "seconds": time.perf_counter() - t_all}
    emit(rec)
    for key in ("x_rel_err", "b_grad_rel_err", "a_grad_rel_err"):
        check(rec[key] <= 1e-10, f"autodiff: {key} = {rec[key]} > 1e-10")
    for w in ("panel_lu_bucket_inplace", "panel_lu", "trsm_batched",
              "gemm_batched"):
        check(fwd[w] > 0, f"autodiff: the forward launched no {w}")
    return total


def unrolled_operands(torch, np, eng_u, a_dev, pred):
    """The operands the unrolled program hands its largest edge (by
    nr * k * m, the product's work) among those with ``pred(target nr,
    source nr)``: the gathered target columns x (1, nr, k+m) and the source
    rows src (1, k, k+m), taken from the program stopped just before that
    edge.  Also returns k and the largest k and m of all those edges."""
    plan = eng_u.plan
    nodes, offs = plan.nodes, plan.panel_offset
    shapes = {(t, j): (nd.nr, nodes[e.src].nr,
                       len(e.col_map) - nodes[e.src].nr)
              for t, nd in enumerate(nodes) for j, e in enumerate(nd.edges)
              if pred(nd.nr, nodes[e.src].nr)}
    t, j = max(shapes, key=lambda tj: np.prod(shapes[tj]))
    nd = nodes[t]
    e = nd.edges[j]
    snd = nodes[e.src]
    vals, _ = eng_u.refactor_batched(a_dev, stop=(t, j))
    off, soff = int(offs[nd.nid]), int(offs[snd.nid])
    panel = vals[:, off:off + nd.nr * nd.width].view(1, nd.nr, nd.width)
    cm = torch.from_numpy(e.col_map.astype(np.int64)).to(vals.device)
    x = panel[:, :, cm].contiguous()
    src = vals[:, soff:soff + snd.nr * snd.width].view(
        1, snd.nr, snd.width)[:, :, snd.lsize:].contiguous()
    return x, src, snd.nr, {"edges": len(shapes),
                            "max_k": max(v[1] for v in shapes.values()),
                            "max_m": max(v[2] for v in shapes.values())}


def suprow_operands(torch, eng_u, a_dev):
    """The operands the unrolled program hands every sup-row edge (a target
    of one row, a source of k > 1 rows) at K systems, ``{(k, m): (x (n K,
    k+m), src (n K, k, k+m))}``, the rows edge by edge, K systems each.
    One refactor of ``a_dev`` (K, nnz) runs with a spy on the node step:
    before the step of a node with sup-row edges, for each such edge j it
    runs the node's first j edges (``n_edges=j``, as ``refactor_batched(
    stop=(t, j))`` does), gathers the edge's columns of the panel and its
    source rows (as ``unrolled_operands``) and puts the panel back."""
    from repro_torch.kernels.supsup import ops as supsup_ops

    nodes = eng_u.plan.nodes
    want = {}
    for t, nd in enumerate(nodes):
        js = [j for j, e in enumerate(nd.edges)
              if nd.nr == 1 and nodes[e.src].nr > 1]
        if js:
            want[eng_u._nodes[t][1].off] = js
    found, orig = {}, supsup_ops.node_edges_inplace

    def spy(vals, table, step, eps, nper, n_edges=None):
        if n_edges is None and step.off in want:
            lo, hi = step.off, step.off + step.w
            panel, scratch = vals[:, lo:hi].clone(), torch.zeros_like(nper)
            for j in want[step.off]:
                orig(vals, table, step, eps, scratch, j)
                soff, k, sw, slsize, cm = table.edges[step.e0 + j]
                src = vals[:, soff:soff + k * sw].view(-1, k, sw)
                found.setdefault((k, len(cm) - k), []).append(
                    (vals[:, lo + cm], src[:, :, slsize:].clone()))
                vals[:, lo:hi] = panel
        return orig(vals, table, step, eps, nper, n_edges)

    spy.launches = 0        # the wrapper counts through the module's name
    supsup_ops.node_edges_inplace = spy
    try:
        eng_u.refactor_batched(a_dev)
    finally:
        supsup_ops.node_edges_inplace = orig
    check(sum(map(len, found.values())) == sum(map(len, want.values())),
          "suprow_operands: a sup-row edge was not gathered")
    return {km: (torch.cat([x for x, _ in v]), torch.cat([s for _, s in v]))
            for km, v in sorted(found.items())}


def suprow_library(torch, x, src, k):
    """K6's function in two library calls: ``solve_triangular`` and
    ``baddbmm`` (the chip run's yardstick; the port never calls them)."""
    y = torch.linalg.solve_triangular(src[:, :, :k], x[:, None, :k],
                                      upper=True, left=False)
    return y[:, 0], torch.baddbmm(x[:, None, k:], y, src[:, :, k:],
                                  alpha=-1)[:, 0]


def _flat(pairs):
    return tuple(t for p in pairs for t in p)


def _held_nonfinite(torch, got, ref, tol, what):
    """NaN and inf positions equal, infinities of one sign, finite values
    within tol; returns (NaN, inf, finite) counts of ref and the error."""
    nan = inf = fin = 0
    err = 0.0
    for g, r in zip(got, ref):
        check(torch.equal(torch.isnan(g), torch.isnan(r))
              and torch.equal(torch.isinf(g), torch.isinf(r))
              and torch.equal(g[torch.isinf(g)], r[torch.isinf(r)]),
              f"{what}: NaN or inf positions differ")
        f = torch.isfinite(r)
        if f.any():
            err = max(err, float((g[f] - r[f]).abs().max()))
            check(bool(torch.allclose(g[f], r[f], rtol=tol, atol=tol)),
                  f"{what}: finite values differ by {err}")
        nan += int(torch.isnan(r).sum())
        inf += int(torch.isinf(r).sum())
        fin += int(f.sum())
    return nan, inf, fin, err


def suprow_extra(torch, suprow_ops, groups, K):
    """K6 over every sup-row edge of the unrolled program at K systems
    (``suprow_operands``), in float64 and float32: the per-group launches
    held to the plain version as the grouped one is in the kernels loop;
    device times of one pass by CUDA-graph replay (20 passes a graph) of
    the grouped launch, the per-group launches, the library route
    (``suprow_library`` per group) and the plain route, beside the summed
    bound; then the non-finite case: exact zeros on U's diagonal (one
    meeting a zero dividend, one whose infinite quotient meets a zero of
    U), a NaN in U's upper triangle and one in the rows past it, each in
    its own row, held to the plain version's NaN and inf positions, its
    infinities and its finite values, through both entry points."""
    rows = sum(x.shape[0] for x, _ in groups.values())
    out = {"edges_systems": K, "edges_groups": len(groups),
           "edges_rows": rows, "edges_edges": rows // K,
           "edges_per_group": {f"{k},{m}": x.shape[0] // K
                               for (k, m), (x, _) in groups.items()}}
    reps = 20
    for dt in (torch.float64, torch.float32):
        dname = str(dt).replace("torch.", "")
        sfx = "" if dt == torch.float64 else "_f32"
        tol = TOL[dname]
        gs = [(x.to(dt).contiguous(), s.to(dt).contiguous(), k)
              for (k, _), (x, s) in groups.items()]
        ref = _flat(suprow_ops.suprow_update_grouped_plain(gs))
        one = _flat([suprow_ops.suprow_update(*g) for g in gs])
        torch.cuda.synchronize()
        err = max(float((g - r).abs().max()) for g, r in zip(one, ref))
        check(all(bool(torch.allclose(g, r, rtol=tol, atol=tol))
                  for g, r in zip(one, ref)),
              f"suprow_update per group {dname}: max |kernel - plain| = "
              f"{err}")
        if dname == "float64":
            rel = err / max(float(r.abs().max()) for r in ref)
            check(rel <= REL_TOL_F64["suprow_update"],
                  f"suprow_update per group: relative error {rel}")
            out["groups_max_rel_err"] = rel
        tab = suprow_ops.suprow_groups(gs)
        grouped = [lambda: suprow_ops.suprow_update_grouped(tab)]
        per = [lambda g=g: suprow_ops.suprow_update(*g) for g in gs]
        lib = [lambda g=g: suprow_library(torch, *g) for g in gs]
        plain = [lambda: suprow_ops.suprow_update_grouped_plain(gs)]
        lib_ms, plain_ms = (lib_graph_ms(torch, fns * reps)
                            for fns in (lib, plain))
        bound = sum(max(fl / PEAK_FLOPS[dname], nb / HBM_BYTES_PER_S)
                    for fl, nb in (kc.suprow_work({km: v}, dt.itemsize)
                                   for km, v in groups.items())) * 1e3
        out.update({
            "groups_max_abs_err" + sfx: err,
            "edges_bound_ms" + sfx: bound,
            "edges_grouped_device_ms" + sfx: graph_ms(torch,
                                                      grouped * reps) / reps,
            "edges_groups_device_ms" + sfx: graph_ms(torch, per * reps) / reps,
            "edges_library_device_ms" + sfx: (
                None if lib_ms is None else lib_ms / reps),
            "edges_plain_device_ms" + sfx: (
                None if plain_ms is None else plain_ms / reps)})
        # the non-finite case, on copies of three groups
        z = [(x.clone(), s.clone(), k) for x, s, k in gs]
        a = max(range(len(z)), key=lambda i: z[i][2])           # largest k
        b = max(range(len(z)), key=lambda i: z[i][0].shape[0])  # most rows
        (xa, sa, ka), (xb, sb, kb) = z[a], z[b]
        j = ka // 2
        sa[0, j, j] = 0.0                          # x_j / 0 = +-inf ...
        sa[0, j, j + 1] = 0.0                      # ... meets a zero of U
        xa[1, 0] = 0.0
        sa[1, 0, 0] = 0.0                          # 0 / 0
        sb[2, 0, 1] = float("nan")                 # U's upper triangle
        sb[3, 1, kb + 4] = float("nan")            # the rows past it
        zr = _flat(suprow_ops.suprow_update_grouped_plain(z))
        for label, got in (
                ("grouped", _flat(suprow_ops.suprow_update_grouped(z))),
                ("per group", _flat([suprow_ops.suprow_update(*g)
                                     for g in z]))):
            torch.cuda.synchronize()
            nan, inf, fin, e_ = _held_nonfinite(
                torch, got, zr, tol, f"suprow {label} {dname} (zero "
                                     "divisors, NaN in U and past it)")
        check(nan > 0 and inf > 0, f"suprow {dname}: the non-finite case "
                                   f"gave {nan} NaN and {inf} inf")
        out.update({"nonfinite_nan" + sfx: nan, "nonfinite_inf" + sfx: inf,
                    "nonfinite_finite" + sfx: fin,
                    "nonfinite_max_abs_err" + sfx: e_})
        del gs, ref, one, tab, grouped, per, lib, plain, z, zr
        torch.cuda.empty_cache()
    torch._C._cuda_clearCublasWorkspaces()
    return out


def suprow_large(torch, suprow_ops, dev):
    """K6 at one large shape, ``SUPROW_LARGE`` (k, m) with K_MAIN rows of
    random operands (U dominant: its strict upper part scaled by 1/sqrt(k)
    over 3 I), per call in float64 and float32: held to the plain version,
    the time per call through the wrapper and by CUDA-graph replay of 20
    calls, the plain version's and the library route's, and the bound."""
    k, m = SUPROW_LARGE
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    x = torch.randn(K_MAIN, k + m, generator=gen, dtype=torch.float64,
                    device=dev)
    src = torch.randn(K_MAIN, k, k + m, generator=gen, dtype=torch.float64,
                      device=dev)
    src[:, :, :k] = (torch.triu(src[:, :, :k], 1) / k ** 0.5
                     + 3 * torch.eye(k, dtype=torch.float64, device=dev))
    out = {"large_shape": f"x ({K_MAIN}, {k} + {m}) src ({K_MAIN}, {k}, "
                          f"{k} + {m})"}
    for dt in (torch.float64, torch.float32):
        dname = str(dt).replace("torch.", "")
        sfx = "" if dt == torch.float64 else "_f32"
        xd, sd = x.to(dt), src.to(dt)
        got = suprow_ops.suprow_update(xd, sd, k)
        ref = suprow_ops.suprow_update_plain(xd, sd, k)
        torch.cuda.synchronize()
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        check(all(bool(torch.allclose(g, r, rtol=TOL[dname],
                                      atol=TOL[dname]))
                  for g, r in zip(got, ref)),
              f"suprow_update large {dname}: max |kernel - plain| = {err}")
        flops, nbytes = kc.suprow_work({(k, m): (xd, sd)}, dt.itemsize)
        run = [lambda: suprow_ops.suprow_update(xd, sd, k)] * 20
        out.update({
            "large_max_abs_err" + sfx: err,
            "large_ms" + sfx: bench_ms(torch, run[0]),
            "large_device_ms" + sfx: graph_ms(torch, run) / len(run),
            "large_plain_ms" + sfx: bench_ms(
                torch, lambda: suprow_ops.suprow_update_plain(xd, sd, k)),
            "large_library_ms" + sfx: bench_ms(
                torch, lambda: suprow_library(torch, xd, sd, k)),
            "large_bound_ms" + sfx: max(flops / PEAK_FLOPS[dname],
                                        nbytes / HBM_BYTES_PER_S) * 1e3})
    torch._C._cuda_clearCublasWorkspaces()
    return out


def node_bound_ms(np, plan, t, dname):
    flops, nbytes = kc.node_work(plan, t, 8 if dname == "float64" else 4)
    return max(flops / PEAK_FLOPS[dname], nbytes / HBM_BYTES_PER_S) * 1e3


def parent_node_step(torch, eng, t, vals, eps, nper, record=None):
    """Node t's edge loop and width-1 perturbation as the engine ran them
    before the node kernel (the parent route): ``node_edges_plain`` with
    its sup-sup update (nr > 1, k > 1) bound to the wrapper
    ``supsup_update``, K3's right solve then ``gemm_update``; the other
    edges run as the plain version runs them.  ``record(x, src, k)`` sees
    the operands of every sup-sup edge."""
    from repro_torch.kernels.supsup import ops as supsup_ops
    from repro_torch.kernels.supsup import ref as supsup_ref

    def kernel_update(x, src, k):
        if record is not None:
            record(x, src, k)
        return supsup_ops.supsup_update(x, src, k)

    plain_update = supsup_ref.supsup_update_plain
    supsup_ref.supsup_update_plain = kernel_update
    try:
        supsup_ref.node_edges_plain(vals, eng._edges, eng._nodes[t][1], eps,
                                    nper)
    finally:
        supsup_ref.supsup_update_plain = plain_update


def bf16_err(torch, got, ref, exact=False, bound=None):
    """Entry by entry over ref's finite entries: (max |got - ref|, the
    largest |got - ref| in bf16 ulps of its own entry, the entries that
    differ, the entries over the limit).  The limit is 0 when ``exact``,
    else BF16_ULPS ulps of the entry plus BF16_TINY plus ``bound`` (a
    float32 summation bound, broadcast) where given.  Over-limit is inf
    when the NaN or inf positions or the infinities differ."""
    g, r = got.float(), ref.float()
    if not (torch.equal(torch.isnan(g), torch.isnan(r))
            and torch.equal(torch.isinf(g), torch.isinf(r))
            and torch.equal(g[torch.isinf(g)], r[torch.isinf(r)])):
        return float("inf"), float("inf"), -1, float("inf")
    fin = torch.isfinite(r)
    if not fin.any():
        return 0.0, 0.0, 0, 0
    err = (g - r).abs()
    ulp = torch.exp2(torch.floor(torch.log2(
        r.abs().clamp(min=BF16_TINY))) - 7)
    if exact:
        lim = torch.zeros_like(err)
    else:
        lim = BF16_ULPS * ulp + BF16_TINY
        if bound is not None:
            lim = lim + bound
    e, u = err[fin], ulp[fin]
    return (float(e.max()), float((e / u).max()), int((e > 0).sum()),
            int((e > lim[fin]).sum()))


def held_to_cpu(torch, got, ref, n_diff):
    """A card's bfloat16 factors (K, slots) against the CPU's plain route's
    (BF16_DIFFER_SHARE): equal NaN and inf positions, at most that share of
    the entries different, none by more than BF16_ULPS ulps of its
    system's largest finite magnitude."""
    g, r = got.float(), ref.float()
    if not (torch.equal(torch.isnan(g), torch.isnan(r))
            and torch.equal(torch.isinf(g), torch.isinf(r))):
        return False
    fin = torch.isfinite(r)
    big = torch.where(fin, r.abs(), torch.zeros_like(r)).amax(dim=1,
                                                              keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(big.clamp(min=BF16_TINY))) - 7)
    err = torch.where(fin, (g - r).abs(), torch.zeros_like(r))
    return bool(n_diff <= BF16_DIFFER_SHARE * r.numel()
                and (err <= BF16_ULPS * ulp).all())


def sum_bound(torch, a, b):
    """The float32 summation bound of a (.., nr, k) @ (.., k, m) summed in
    two orders: 2 k 2^-24 (|a| |b|)."""
    return (2.0 * a.shape[-1] * 2.0 ** -24
            * torch.matmul(a.float().abs(), b.float().abs()))


def bf16_library(torch, lib):
    """(lib, None), or (None, why) when the library call takes no bfloat16
    on the card (``torch.linalg.solve_triangular``)."""
    if lib is None:
        return None, None
    try:
        lib()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, f"the library call takes no bfloat16 on CUDA: {e}"
    return lib, None


def kernel_phase(torch, np, kernels, eng, vals0, eng_u):
    """Phase 4: each kernel against its plain version on the card, in
    float64 and float32, and K1-K5 in bfloat16 (records named ..._bf16,
    held entry by entry by :func:`bf16_err`, pivots and counts equal)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.panel import ops as panel_ops
    from repro_torch.kernels.suprow import ops as suprow_ops
    from repro_torch.kernels.supsup import ops as supsup_ops
    from repro_torch.kernels.trisolve import ops as trisolve_ops

    t = time.perf_counter()
    dev = eng.device
    sched, plan = eng.sched, eng.plan
    K = vals0.shape[0]
    a_dev = torch.from_numpy(vals0).to(dev)
    nodes = plan.nodes
    steps = list(enumerate(sched.steps))
    st1, pb = max(((i, p) for i, s in steps for p in s.panels),
                  key=lambda ip: ip[1].gather.size)
    st2, seq_t = max(((i, int(t_)) for i, s in steps for t_ in s.seq),
                     key=lambda it: nodes[it[1]].nr * nodes[it[1]].width)
    nd = nodes[seq_t]
    st3, eb = max(((i, e) for i, s in steps for e in s.edges if e.k > 1),
                  key=lambda ie: (len(ie[1].srcs) * ie[1].nr * ie[1].k
                                  * (ie[1].k + ie[1].m)))
    blk_node = max(eng._blocks, key=lambda b_: b_[1])
    nrb, bslots = blk_node[1], blk_node[-1]

    # Each kernel's operands are what the factor program hands it: the
    # value buffer (sentinel slots included) and the per-system thresholds
    # just before the phase of the level step that runs the case.
    # K1 reads its bucket in the value buffer: the slots of the largest
    # bucket, copied out with the layout that reads them (``Compact``)
    vals, eps1 = eng.refactor_batched(a_dev, stop=(st1, "panels"))
    B, nr, wt = pb.gather.shape
    C1 = Compact(torch, np, vals, next(
        lay for p_, (lay, _) in zip(sched.steps[st1].panels,
                                    eng._steps[st1][1]) if p_ is pb))
    vals, eps2 = eng.refactor_batched(a_dev, stop=(st2, "seq"))
    off = int(plan.panel_offset[seq_t])
    P2 = vals[:, off:off + nd.nr * nd.width].reshape(K, nd.nr, nd.width)
    P2 = P2.contiguous()
    vals, _ = eng.refactor_batched(a_dev, stop=(st3, "edges"))
    sidx = torch.from_numpy(eb.src_idx.astype(np.int64)).to(dev)
    xidx = torch.from_numpy(eb.x_idx.astype(np.int64)).to(dev)
    S = vals[:, sidx]
    E = S.shape[1]
    U = S[..., :eb.k].reshape(K * E, eb.k, eb.k).contiguous()
    Us = S[..., eb.k:].reshape(K * E, eb.k, eb.m).contiguous()
    X = vals[:, xidx].reshape(K * E, eb.nr, eb.k).contiguous()
    # the substitution reads the finished factors
    f = eng.refactor_batched(a_dev)
    BLK = f.vals[:, bslots].contiguous()
    RHS = torch.from_numpy(np.random.default_rng(5).normal(
        size=(K, nrb, 1))).to(dev)
    LTS = trisolve_ops.trsm_batched(U, X)
    del vals, S, f
    # K5 and K6 on the unrolled program of system 0, which launches them one
    # system at a time: its largest sup-sup edge (nr, k > 1) and its largest
    # sup-row edge (nr = 1, k > 1)
    X5, S5, k5, edges5 = unrolled_operands(
        torch, np, eng_u, a_dev[:1], lambda nr_, k_: nr_ > 1 and k_ > 1)
    LTS5 = trisolve_ops.trsm_batched(S5[..., :k5].contiguous(),
                                     X5[..., :k5].contiguous())
    X6, S6, k6, edges6 = unrolled_operands(
        torch, np, eng_u, a_dev[:1], lambda nr_, k_: nr_ == 1 and k_ > 1)
    X6 = X6[:, 0]
    nr5, m5, m6 = X5.shape[1], X5.shape[2] - k5, X6.shape[1] - k6
    # K6 over every sup-row edge of the unrolled program at K systems, one
    # group per (k, m)
    G6 = suprow_operands(torch, eng_u, a_dev)
    n6 = sum(x_.shape[0] for x_, _ in G6.values()) // K
    # K5's node step on system 0 of the unrolled program (which runs one
    # system), in place, at the node with the most edge work (operations),
    # the node with the most edges and the width-1 node with the most edges
    # (at fem2d_10k the first two are one node); the record's own numbers
    # are those of the first
    plan_u = eng_u.plan
    unodes = plan_u.nodes
    node_ts = {
        "most_work": max(range(len(unodes)),
                         key=lambda t_: kc.node_work(plan_u, t_, 8)[0]),
        "most_edges": max(range(len(unodes)),
                          key=lambda t_: len(unodes[t_].edges)),
        "width1_most_edges": max(
            (t_ for t_, nd_ in enumerate(unodes) if nd_.nr == 1),
            key=lambda t_: len(unodes[t_].edges))}
    node_base = {t_: eng_u.refactor_batched(a_dev[:1], stop=(t_, 0))
                 for t_ in set(node_ts.values())}
    t_n = node_ts["most_work"]
    _, step_n = eng_u._nodes[t_n]
    lo_n, hi_n = step_n.off, step_n.off + step_n.nr * step_n.w
    # The stencil's diagonal blocks may need no row swap at all, so each
    # panel LU is also held to its plain version on the same panels with
    # their rows shuffled: partial pivoting then has to move rows.
    shuf_rng = np.random.default_rng(6)

    def shuffled(P):
        rows = np.argsort(shuf_rng.random(P.shape[:2]), axis=1)
        idx = torch.from_numpy(rows).to(dev)[..., None].expand(P.shape)
        return torch.gather(P, 1, idx).contiguous()

    P2s = shuffled(P2)
    C1s = shuffle_members(torch, np, C1, shuf_rng)
    torch.cuda.synchronize()

    def sz(dt):
        return torch.finfo(dt).bits // 8

    # name, wrapper counted on the main path, replaces, source, args,
    # kernel call, plain call, library call, (flops, bytes) of the work,
    # tolerance table, for a panel LU the (kernel, plain) calls on the
    # row-shuffled panels, and for K1 (in place) the copy that restores its
    # operands before each call, timed alone and taken off its times
    bf16_bounds = {}          # bfloat16 products: their summation bounds

    def cases(dt):
        c = lambda t_: t_.to(dt).contiguous()          # noqa: E731
        p2, u, x, us, lts, blk, rhs = map(c, (P2, U, X, Us, LTS, BLK, RHS))
        p2s = c(P2s)
        b1, b1s = c(C1.base), c(C1s)
        w1k, w1p = torch.empty_like(b1), torch.empty_like(b1)

        def k1(fn, work, base):
            def run():
                work.copy_(base)
                perm, nper = fn(work, C1.lay, e1)
                return work[:, :C1.zero], perm, nper   # sentinels aside
            return run
        x5c, x5a, s5u, s5b = (c(X5[..., k5:]), c(LTS5), c(S5[..., :k5]),
                              c(S5[..., k5:]))
        if dt == torch.bfloat16:
            bf16_bounds.update(
                bmm=lambda: sum_bound(torch, lts, us),
                gemm_update=lambda: sum_bound(torch, x5a, s5b))
        x6, s6 = c(X6), c(S6)
        x6k = x6[:, None, :k6].contiguous()
        g6 = [(c(x_), c(s_), k_) for (k_, _), (x_, s_) in G6.items()]
        t6 = (suprow_ops.suprow_groups(g6) if dt != torch.bfloat16
              else None)                       # K6 takes no bfloat16
        f6, b6 = kc.suprow_work(G6, sz(dt))
        vn, en = node_base[t_n]
        base_n, eps_n = c(vn), en.to(dt)
        pan_n = base_n[:, lo_n:hi_n].clone()
        wk, wp = base_n.clone(), base_n.clone()
        nk = torch.zeros(1, dtype=torch.int32, device=dev)
        npl = torch.zeros_like(nk)

        def node_run(fn, work, nper):         # from the node's input panel
            def run():
                work[:, lo_n:hi_n].copy_(pan_n)
                nper.zero_()
                fn(work, eng_u._edges, step_n, eps_n, nper)
                return work[:, lo_n:hi_n], nper.to(dt)
            return run
        fn_, bn_ = kc.node_work(plan_u, t_n, sz(dt))
        e1, e2 = eps1.to(dt), eps2.to(dt)
        s = sz(dt)
        lower = torch.tril(blk, -1) + torch.eye(nrb, dtype=dt, device=dev)
        f1, n1 = bucket_work(C1.lay, K, s)
        return [
            ("panel_lu_bucketed", "panel_lu_bucket_inplace",
             "src/repro/kernels/panel/kernel.py:59", "src/repro_torch/csrc/panel_lu.cu",
             f"{K} systems x {B} members in place, padded ({nr}, {wt}) "
             f"wu={pb.wu}",
             k1(panel_ops.panel_lu_bucket_inplace, w1k, b1),
             k1(panel_ops.panel_lu_bucket_plain, w1p, b1), None, f1, n1,
             TOL, (k1(panel_ops.panel_lu_bucket_inplace, w1k, b1s),
                   k1(panel_ops.panel_lu_bucket_plain, w1p, b1s)),
             lambda: w1k.copy_(b1)),
            ("panel_lu", "panel_lu",
             "src/repro/kernels/panel/kernel.py:23",
             "src/repro_torch/csrc/panel_lu.cu",
             f"({K}, {nd.nr}, {nd.width}) lsize={nd.lsize}",
             lambda: panel_ops.panel_lu(p2, nd.nr, nd.lsize, e2),
             lambda: panel_ops.panel_lu_plain(p2, nd.lsize, nd.width, e2),
             None, kc.lu_flops(K, nd.nr, nd.lsize, nd.width),
             (2 * p2.numel() + e2.numel()) * s + K * (nd.nr + 1) * 4, TOL,
             (lambda: panel_ops.panel_lu(p2s, nd.nr, nd.lsize, e2),
              lambda: panel_ops.panel_lu_plain(p2s, nd.lsize, nd.width, e2))),
            ("trsm_right", "trsm_batched",
             "src/repro/kernels/trisolve/kernel.py:21", "src/repro_torch/csrc/trsm.cu",
             f"U ({K * E}, {eb.k}, {eb.k}) X ({K * E}, {eb.nr}, {eb.k})",
             lambda: trisolve_ops.trsm_batched(u, x),
             lambda: trisolve_ops.trsm_plain(u, x),
             lambda: torch.linalg.solve_triangular(u, x, upper=True,
                                                   left=False),
             float(K * E * eb.nr * eb.k * eb.k),
             (K * E * eb.k * (eb.k + 1) // 2 + 2 * x.numel()) * s, TOL,
             None),
            ("trsm_left_unit_lower", "trsm_left_unit_lower_batched",
             "src/repro/kernels/trisolve/kernel.py:21", "src/repro_torch/csrc/trsm.cu",
             f"blk ({K}, {nrb}, {nrb}) b ({K}, {nrb}, 1)",
             lambda: trisolve_ops.trsm_left_unit_lower_batched(blk, rhs),
             lambda: trisolve_ops.trsm_left_unit_lower_plain(blk, rhs),
             lambda: torch.linalg.solve_triangular(lower, rhs, upper=False,
                                                   unitriangular=True),
             float(K * nrb * (nrb - 1)),
             (K * nrb * (nrb - 1) // 2 + 2 * rhs.numel()) * s, TOL_LEFT,
             None),
            ("trsm_left_upper", "trsm_left_upper_batched",
             "src/repro/kernels/trisolve/kernel.py:21", "src/repro_torch/csrc/trsm.cu",
             f"blk ({K}, {nrb}, {nrb}) b ({K}, {nrb}, 1)",
             lambda: trisolve_ops.trsm_left_upper_batched(blk, rhs),
             lambda: trisolve_ops.trsm_left_upper_plain(blk, rhs),
             lambda: torch.linalg.solve_triangular(blk, rhs, upper=True),
             float(K * nrb * nrb),
             (K * nrb * (nrb + 1) // 2 + 2 * rhs.numel()) * s, TOL_LEFT,
             None),
            ("bmm", "gemm_batched",
             "src/repro/kernels/supsup/kernel.py:34", "src/repro_torch/csrc/bmm.cu",
             f"({K * E}, {eb.nr}, {eb.k}) @ ({K * E}, {eb.k}, {eb.m})",
             lambda: supsup_ops.gemm_batched(lts, us),
             lambda: supsup_ops.gemm_batched_plain(lts, us),
             lambda: torch.bmm(lts, us),
             2.0 * K * E * eb.nr * eb.k * eb.m,
             (lts.numel() + us.numel() + K * E * eb.nr * eb.m) * s, TOL,
             None),
            ("gemm_update", "gemm_update",
             "src/repro/kernels/supsup/kernel.py:21",
             "src/repro_torch/csrc/gemm_update.cu",
             f"C (1, {nr5}, {m5}) - A (1, {nr5}, {k5}) @ B (1, {k5}, {m5})",
             lambda: supsup_ops.gemm_update(x5c, x5a, s5b),
             lambda: supsup_ops.gemm_update_plain(x5c, x5a, s5b),
             lambda: torch.baddbmm(x5c, x5a, s5b, alpha=-1),
             2.0 * nr5 * k5 * m5,
             (2 * nr5 * m5 + nr5 * k5 + k5 * m5) * s, TOL, None),
            ("node_edges", "node_edges_inplace",
             "src/repro/kernels/supsup/kernel.py:21",
             "src/repro_torch/csrc/gemm_update.cu",
             f"node {t_n} in place (1, {step_n.nr}, {step_n.w}), "
             f"{step_n.e1 - step_n.e0} edges",
             node_run(supsup_ops.node_edges_inplace, wk, nk),
             node_run(supsup_ops.node_edges_plain, wp, npl), None, fn_, bn_,
             TOL, None, lambda: (wk[:, lo_n:hi_n].copy_(pan_n), nk.zero_())),
            ("suprow_update", "suprow_update",
             "src/repro/kernels/suprow/kernel.py:21",
             "src/repro_torch/csrc/suprow.cu",
             f"x (1, {k6} + {m6}) src (1, {k6}, {k6} + {m6})",
             lambda: suprow_ops.suprow_update(x6, s6, k6),
             lambda: suprow_ops.suprow_update_plain(x6, s6, k6),
             lambda: (lambda y_: (y_, x6[:, k6:] - torch.matmul(
                 y_, s6[:, :, k6:])[:, 0]))(torch.linalg.solve_triangular(
                     s6[:, :, :k6], x6k, upper=True, left=False)),
             float(k6 * k6 + 2 * k6 * m6),
             (2 * (k6 + m6) + k6 * (k6 + 1) // 2 + k6 * m6) * s, TOL, None),
            ("suprow_update_grouped", "suprow_update_grouped",
             "src/repro/kernels/suprow/kernel.py:21",
             "src/repro_torch/csrc/suprow.cu",
             f"{n6} sup-row edges x {K} systems, {len(G6)} (k, m) groups "
             f"in one launch",
             lambda: _flat(suprow_ops.suprow_update_grouped(t6)),
             lambda: _flat(suprow_ops.suprow_update_grouped_plain(g6)),
             lambda: _flat([suprow_library(torch, *g_) for g_ in g6]),
             f6, b6, TOL, None),
        ]

    def held(name, dname, tol, got, ref, what=""):
        """Check kernel output against plain output; returns the max
        error and, for a panel LU, (rows moved by pivoting, pivots
        perturbed).  bfloat16 (tol None): :func:`bf16_err` entry by entry,
        bit-equal for a panel LU, a product within its summation bound;
        its largest error in ulps of the entry and the entries that
        differ go into ``bf16_seen``."""
        torch.cuda.synchronize()
        moved = None
        if name.startswith("panel_lu"):             # (panels, perm, nper)
            check(torch.equal(got[1], ref[1]),
                  f"{name} {dname}{what}: pivot permutations differ")
            check(torch.equal(got[2], ref[2]),
                  f"{name} {dname}{what}: perturbation counts differ")
            ident = torch.arange(got[1].shape[-1], device=dev)
            moved = (int((got[1] != ident).sum()), int(got[2].sum()))
            got, ref = got[0], ref[0]
        pairs = (list(zip(got, ref)) if isinstance(got, tuple)
                 else [(got, ref)])
        if tol is None:
            err = 0.0
            exact = name.startswith("panel_lu")
            for i, (g, r) in enumerate(pairs):
                bound = (bf16_bounds[name]() if name in bf16_bounds
                         and i == 0 else None)
                e_, ulps, n_diff, n_over = bf16_err(torch, g, r, exact,
                                                    bound)
                check(n_over == 0, f"{name} {dname}{what}: {n_over} "
                      f"entries over the limit ({'bit-equal' if exact else f'{BF16_ULPS} ulps of the entry'}); max |kernel - "
                      f"plain| = {e_}, {ulps} ulps of its entry")
                err = max(err, e_)
                seen = bf16_seen.setdefault(name, [0.0, 0])
                seen[0], seen[1] = max(seen[0], ulps), seen[1] + n_diff
            return err, moved
        err = max(float((g - r).abs().max()) for g, r in pairs)
        check(all(bool(torch.allclose(g, r, rtol=tol, atol=tol))
                  for g, r in pairs),
              f"{name} {dname}{what}: max |kernel - plain| = {err} "
              f"outside rtol=atol={tol}")
        if dname == "float64" and name in REL_TOL_F64:
            rel = err / max(float(r.abs().max()) for _, r in pairs)
            check(rel <= REL_TOL_F64[name], f"{name} {dname}{what}: "
                  f"relative error {rel} > {REL_TOL_F64[name]}")
            records[name]["max_rel_err"] = rel
        return err, moved

    records, bf16_seen = {}, {}
    for dt in (torch.float64, torch.float32, torch.bfloat16):
        dname = str(dt).replace("torch.", "")
        bf = dt == torch.bfloat16
        for (name, wrapper, replaces, source, shape, kern, plain, lib, flops,
             nbytes, tol, shuf, *restore) in cases(dt):
            if bf and name not in BF16_ENTRY:        # K6: f64 / f32 only
                continue
            key = name + "_bf16" if bf else name
            rec = records.setdefault(key, {
                "name": key, "route": "cuda", "source": source,
                "replaces": replaces, "wrapper": wrapper, "shape": shape})
            if bf:
                rec.update(dtype="bfloat16", entry=BF16_ENTRY[name],
                           tol=("bit-equal" if name.startswith("panel_lu")
                                else f"{BF16_ULPS} bf16 ulps of each entry"
                                + (" + float32 summation bound"
                                   if name in ("bmm", "gemm_update")
                                   else "")))
                lib, note = bf16_library(torch, lib)
                if note:
                    rec["library_note"] = note
            err, moved = held(name, dname, None if bf else tol[dname],
                              kern(), plain())
            sfx = "_f32" if dname == "float32" else ""
            if shuf is not None:
                err_s, moved_s = held(name, dname,
                                      None if bf else tol[dname], shuf[0](),
                                      shuf[1](), " (rows shuffled)")
                check(moved_s[0] > 0, f"{name} {dname}: no row moved by "
                                      "pivoting on the shuffled panels")
                rec.update({"rows_moved" + sfx: moved[0],
                            "perturbed" + sfx: moved[1],
                            "max_abs_err_shuffled" + sfx: err_s,
                            "rows_moved_shuffled" + sfx: moved_s[0],
                            "perturbed_shuffled" + sfx: moved_s[1]})
            t_bytes = nbytes / HBM_BYTES_PER_S
            # bfloat16 runs on the tensor cores in K4 only; elsewhere its
            # float32 arithmetic is SIMT
            t_ops = flops / PEAK_FLOPS[
                ("bfloat16" if name == "bmm" else "float32") if bf
                else dname]
            r_ms = bench_ms(torch, restore[0]) if restore else 0.0
            if restore:
                rec["restore_ms" + sfx] = r_ms
            rec.update({
                "max_abs_err" + sfx: err,
                "tol" + sfx: rec["tol"] if bf else tol[dname],
                "ms" + sfx: bench_ms(torch, kern) - r_ms,
                "plain_ms" + sfx: bench_ms(torch, plain) - r_ms,
                "bound_ms" + sfx: max(t_bytes, t_ops) * 1e3,
                "bound_by" + sfx: "bytes" if t_bytes >= t_ops
                else "operations",
                "library_ms" + sfx: (bench_ms(torch, lib) if lib is not None
                                     else None)})
    for name, (ulps, n_diff) in bf16_seen.items():
        records[name + "_bf16"].update(max_ulps_of_entry=ulps,
                                       entries_differing=n_diff)
    # K1 and K2 with an exactly zero pivot under a zero threshold: the first
    # block column of one panel set to zero.  The Pallas arithmetic turns
    # the masked terms into 0 * inf = NaN (csrc/panel_lu.cu, "Non-finite
    # steps"); the kernel must give the plain version's NaN and inf
    # positions and its finite values.
    def zero_k1(dt):            # member 0's first block column, in place
        Z = C1.base.to(dt, copy=True)
        off, nr_, w, ls, _ = C1.lay.desc[0].tolist()
        Z[:, off + ls:off + nr_ * w:w] = 0.0
        ez = torch.zeros(K, dtype=dt, device=dev)
        g, r = Z.clone(), Z.clone()
        gp, gn = panel_ops.panel_lu_bucket_inplace(g, C1.lay, ez)
        rp, rn = panel_ops.panel_lu_bucket_plain(r, C1.lay, ez)
        return (g[:, C1.real], gp, gn), (r[:, C1.real], rp, rn)

    def zero_k2(dt):
        Z = P2[:1].to(dt).clone()
        Z[:, :, nd.lsize] = 0.0
        ez = torch.zeros(1, dtype=dt, device=dev)
        return (panel_ops.panel_lu(Z, nd.nr, nd.lsize, ez),
                panel_ops.panel_lu_plain(Z, nd.lsize, nd.width, ez))

    for name, run in (("panel_lu_bucketed", zero_k1), ("panel_lu", zero_k2)):
        for dt in (torch.float64, torch.float32):
            dname = str(dt).replace("torch.", "")
            got, ref = run(dt)
            torch.cuda.synchronize()
            what = f"{name} {dname} (zero pivot, eps = 0)"
            check(torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]),
                  f"{what}: pivots or perturbation counts differ")
            g, r = got[0], ref[0]
            check(torch.equal(torch.isnan(g), torch.isnan(r))
                  and torch.equal(torch.isinf(g), torch.isinf(r)),
                  f"{what}: NaN or inf positions differ")
            fin = torch.isfinite(r)
            err = float((g[fin] - r[fin]).abs().max())
            check(bool(torch.allclose(g[fin], r[fin], rtol=TOL[dname],
                                      atol=TOL[dname])),
                  f"{what}: finite values differ by {err}")
            sfx = "" if dname == "float64" else "_f32"
            records[name].update({
                "zero_pivot_nan" + sfx: int(torch.isnan(r).sum()),
                "zero_pivot_finite" + sfx: int(fin.sum()),
                "zero_pivot_max_abs_err" + sfx: err})

    records["gemm_update"]["edges"] = edges5
    records["node_edges"].update(node_extra(torch, np, eng_u, node_ts,
                                            node_base))
    records["suprow_update"]["edges"] = edges6
    records["suprow_update"].update(suprow_large(torch, suprow_ops, dev))
    records["suprow_update_grouped"].update(suprow_extra(torch, suprow_ops,
                                                         G6, K))
    k4, k4_bf16 = bmm_extra(torch, np, supsup_ops, sched, LTS, Us, K)
    records["bmm"].update(k4)
    records["bmm_bf16"].update(k4_bf16)
    for name, extra in trsm_extra(torch, trisolve_ops, eng, a_dev,
                                  (U, X, BLK, RHS)).items():
        records[name].update(extra)
    for name, extra in panel_extra(torch, np, eng, eng_u, a_dev).items():
        records[name].update(extra)
    log = _build.last_build["log"]
    for name, needles in BF16_PTXAS.items():
        records[name + "_bf16"]["ptxas"] = [
            ln for ln in ptxas_of(log, needles[0])
            if all(nd in ln for nd in needles[1:])]
    out = list(records.values())
    emit({"phase": "kernels", "dtypes": ["float64", "float32", "bfloat16"],
          "records": out, "seconds": time.perf_counter() - t})
    return out


def node_extra(torch, np, eng_u, node_ts, node_base):
    """K5's node step at each chosen node of the unrolled program (system
    0, its buffer just before the node), in float64 and float32: the
    kernel held to ``node_edges_plain`` (values within TOL, equal
    perturbation counts, no slot outside the node's panel written), its
    time per call (back-to-back calls through the wrapper, each from the
    node's input panel, the restoring copy's time taken off) and by
    CUDA-graph replay, beside the plain version's and the parent route's
    (``parent_node_step``: per edge a gather, K3 + ``gemm_update`` or torch
    ops, a write-back) and the bound of ``node_work``."""
    from repro_torch.kernels.supsup import ops as supsup_ops

    out = {}
    for label, t in node_ts.items():
        nd = eng_u.plan.nodes[t]
        _, step = eng_u._nodes[t]
        lo, hi = step.off, step.off + step.nr * step.w
        rec = out[label] = {
            "node": t, "nr": nd.nr, "w": nd.width, "edges": len(nd.edges),
            "supsup_edges": sum(eng_u.plan.nodes[e.src].nr > 1
                                for e in nd.edges),
            "max_k": max((eng_u.plan.nodes[e.src].nr for e in nd.edges),
                         default=0),
            "max_cols": max((len(e.col_map) for e in nd.edges), default=0)}
        for dt in (torch.float64, torch.float32):
            dname = str(dt).replace("torch.", "")
            sfx = "" if dt == torch.float64 else "_f32"
            base = node_base[t][0].to(dt)
            eps = node_base[t][1].to(dt)
            pan = base[:, lo:hi].clone()
            g, r = base.clone(), base.clone()
            ng = torch.zeros(1, dtype=torch.int32, device=base.device)
            nr_ = torch.zeros_like(ng)
            supsup_ops.node_edges_inplace(g, eng_u._edges, step, eps, ng)
            supsup_ops.node_edges_plain(r, eng_u._edges, step, eps, nr_)
            torch.cuda.synchronize()
            what = f"node_edges {label} {dname}"
            check(torch.equal(ng, nr_), f"{what}: perturbation counts differ")
            check(torch.equal(_bits(torch, g[:, :lo]), _bits(torch, base[:, :lo]))
                  and torch.equal(_bits(torch, g[:, hi:]),
                                  _bits(torch, base[:, hi:])),
                  f"{what}: a slot outside the node's panel changed")
            err = float((g[:, lo:hi] - r[:, lo:hi]).abs().max())
            check(bool(torch.allclose(g[:, lo:hi], r[:, lo:hi],
                                      rtol=TOL[dname], atol=TOL[dname])),
                  f"{what}: max |kernel - plain| = {err}")
            del r
            nper = torch.zeros_like(ng)

            def restore(g=g, pan=pan):
                g[:, lo:hi].copy_(pan)

            kern = lambda g=g, eps=eps: supsup_ops.node_edges_inplace(  # noqa: E731
                g, eng_u._edges, step, eps, nper)
            plain = lambda g=g, eps=eps: supsup_ops.node_edges_plain(  # noqa: E731
                g, eng_u._edges, step, eps, nper)
            parent = lambda g=g, eps=eps: parent_node_step(  # noqa: E731
                torch, eng_u, t, g, eps, nper)
            r_ms = bench_ms(torch, restore)
            try:
                parent_dev = fresh_graph_ms(torch, [parent], restore)
            except RuntimeError:            # a call the graph cannot capture
                torch.cuda.synchronize()
                parent_dev = None
            rec.update({
                "max_abs_err" + sfx: err, "perturbed" + sfx: int(ng.sum()),
                "bound_ms" + sfx: node_bound_ms(np, eng_u.plan, t, dname),
                "restore_ms" + sfx: r_ms,
                "ms" + sfx: bench_ms(torch, lambda: (restore(), kern()))
                - r_ms,
                "device_ms" + sfx: fresh_graph_ms(torch, [kern], restore),
                "plain_ms" + sfx: bench_ms(torch, lambda: (restore(),
                                                           plain())) - r_ms,
                "parent_ms" + sfx: bench_ms(torch, lambda: (restore(),
                                                            parent())) - r_ms,
                "parent_device_ms" + sfx: parent_dev})
            del g, base, pan
    torch.cuda.empty_cache()
    return {"nodes": out,
            "parent_route": "per edge: gather through col_map, divide or "
                            "K3 + gemm_update (sup-sup) or solve_triangular "
                            "+ matmul (sup-row), write back"}


def bmm_extra(torch, np, supsup_ops, sched, lts, us, K):
    """K4 beside ``torch.bmm``: on 2,048 products of the largest sup-sup
    bucket's shape (its K * E operands repeated), and summed over every
    sup-sup bucket of the bucketed schedule at K systems (random operands
    of each bucket's shape), in float64 and float32.  Times per launch by
    back-to-back calls (``bench_ms``, host cost included) and device times
    by CUDA-graph replay (``graph_ms``); K4 held to its plain version on
    the 2,048 products.  Returns those, and the bfloat16 instance's device
    time and ``torch.bmm``'s in bfloat16 by replay of 200 launches at the
    record's shape (the largest sup-sup bucket)."""
    out = {}
    dev = lts.device
    buckets = [e for s_ in sched.steps for e in s_.edges if e.k > 1]
    shapes = [(K * len(e.srcs), e.nr, e.k, e.m) for e in buckets]
    reps = -(-2048 // lts.shape[0])
    for dt in (torch.float64, torch.float32):
        dname = str(dt).replace("torch.", "")
        sfx = "" if dt == torch.float64 else "_f32"
        a = lts.to(dt).repeat(reps, 1, 1)[:2048].contiguous()
        b = us.to(dt).repeat(reps, 1, 1)[:2048].contiguous()
        got = supsup_ops.gemm_batched(a, b)
        ref = supsup_ops.gemm_batched_plain(a, b)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        check(bool(torch.allclose(got, ref, rtol=TOL[dname], atol=TOL[dname])),
              f"bmm {dname} (2,048 products): max |kernel - plain| = {err}")
        del got, ref
        x1, y1 = lts.to(dt), us.to(dt)
        one = [lambda: supsup_ops.gemm_batched(x1, y1)] * 200
        one_lib = [lambda: torch.bmm(x1, y1)] * 200
        gen = torch.Generator(device=dev)
        gen.manual_seed(3)
        pa = torch.randn(max(e * n * k for e, n, k, _ in shapes),
                         generator=gen, dtype=dt, device=dev)
        pb = torch.randn(max(e * k * m for e, _, k, m in shapes),
                         generator=gen, dtype=dt, device=dev)
        ops = [(pa[:e * n * k].view(e, n, k), pb[:e * k * m].view(e, k, m))
               for e, n, k, m in shapes]
        kern = [lambda x=x, y=y: supsup_ops.gemm_batched(x, y) for x, y in ops]
        lib = [lambda x=x, y=y: torch.bmm(x, y) for x, y in ops]
        sz = torch.finfo(dt).bits // 8
        flops = sum(2.0 * e * n * k * m for e, n, k, m in shapes)
        nbytes = sz * sum(e * (n * k + k * m + n * m) for e, n, k, m in shapes)
        bound = sum(max(2.0 * e * n * k * m / PEAK_FLOPS[dname],
                        sz * e * (n * k + k * m + n * m) / HBM_BYTES_PER_S)
                    for e, n, k, m in shapes) * 1e3
        out.update({
            "products_2048" + sfx: int(a.shape[0]),
            "max_abs_err_2048" + sfx: err,
            "ms_2048" + sfx: bench_ms(
                torch, lambda: supsup_ops.gemm_batched(a, b)),
            "library_ms_2048" + sfx: bench_ms(torch, lambda: torch.bmm(a, b)),
            "device_ms_2048" + sfx: graph_ms(
                torch, [lambda: supsup_ops.gemm_batched(a, b)] * 20) / 20,
            "library_device_ms_2048" + sfx: graph_ms(
                torch, [lambda: torch.bmm(a, b)] * 20) / 20,
            "device_ms" + sfx: graph_ms(torch, one) / len(one),
            "library_device_ms" + sfx: graph_ms(torch, one_lib) / len(one_lib),
            "buckets" + sfx: len(shapes),
            "buckets_products" + sfx: sum(e for e, _, _, _ in shapes),
            "buckets_flops" + sfx: flops, "buckets_bytes" + sfx: nbytes,
            "buckets_bound_ms" + sfx: bound,
            "buckets_device_ms" + sfx: graph_ms(torch, kern),
            "buckets_library_device_ms" + sfx: graph_ms(torch, lib),
            "buckets_loop_ms" + sfx: bench_ms(
                torch, lambda: [fn() for fn in kern], min_ms=200.0),
            "buckets_library_loop_ms" + sfx: bench_ms(
                torch, lambda: [fn() for fn in lib], min_ms=200.0)})
        del a, b, x1, y1, pa, pb, ops, kern, lib
        torch.cuda.empty_cache()
    a16, b16 = (t_.to(torch.bfloat16).contiguous() for t_ in (lts, us))
    out_bf16 = {
        "device_ms": graph_ms(
            torch, [lambda: supsup_ops.gemm_batched(a16, b16)] * 200) / 200,
        "library_device_ms": graph_ms(
            torch, [lambda: torch.bmm(a16, b16)] * 200) / 200}
    # each stream graph_ms ran torch.bmm on keeps a cuBLAS workspace
    # allocated; drop them, so the main path's peak memory is its own
    torch._C._cuda_clearCublasWorkspaces()
    return out, out_bf16


def trsm_extra(torch, trisolve_ops, eng, a_dev, table):
    """K3 beside ``torch.linalg.solve_triangular`` over whole calls, in
    float64 and float32: the right solve summed over every sup-sup bucket
    of the bucketed schedule at K systems (shapes (K * E, nr, k) from the
    schedule; U the strided view S[..., :k] of random (K * E, k, k + m)
    source rows, as the engine passes it, with U = triu(., 1) / sqrt(k) +
    3 I; X random), and both left solves summed over every node block with
    nr > 1 of the node-block apply (the finished factors' diagonal blocks,
    one random right-hand side each: m = 1).  Device times by CUDA-graph
    replay (``graph_ms``), back-to-back loop times (``bench_ms``, host cost
    included), the summed bound, and each kernel held to its plain version
    on every bucket and block.  Also the per-launch device times at the
    table's shapes (``table``: U, X, BLK, RHS in float64), by replay of 200
    launches, in float64, float32 and (records ``..._bf16``) bfloat16, the
    bfloat16 kernels also bit-equal to the plain versions summed in their
    order (``ref.*_bf16_ordered``).  A library call that a CUDA graph
    cannot capture keeps its loop time only (its device time is then
    None); none takes bfloat16."""
    from repro_torch.kernels.trisolve import ref as trisolve_ref

    dev = a_dev.device
    K = a_dev.shape[0]
    buckets = [e for s_ in eng.sched.steps for e in s_.edges if e.k > 1]
    blocks = [b_ for b_ in eng._blocks if b_[1] > 1]
    f = eng.refactor_batched(a_dev)
    out = {"trsm_right": {}, "trsm_left_unit_lower": {},
           "trsm_left_upper": {}}

    for dt in (torch.float64, torch.float32):
        dname = str(dt).replace("torch.", "")
        sfx = "" if dt == torch.float64 else "_f32"
        sz = torch.finfo(dt).bits // 8
        pk = PEAK_FLOPS[dname]
        gen = torch.Generator(device=dev)
        gen.manual_seed(4)
        # right: one operand pair per bucket
        ops, bound, err = [], 0.0, 0.0
        for e in buckets:
            n_, k, m, nr = K * len(e.srcs), e.k, e.m, e.nr
            S = torch.randn(n_, k, k + m, generator=gen, dtype=dt, device=dev)
            S[..., :k] = (torch.triu(S[..., :k], 1) / k ** 0.5
                          + 3 * torch.eye(k, dtype=dt, device=dev))
            x = torch.randn(n_, nr, k, generator=gen, dtype=dt, device=dev)
            u = S[..., :k]
            got = trisolve_ops.trsm_batched(u, x)
            ref = trisolve_ops.trsm_plain(u, x)
            torch.cuda.synchronize()
            e_ = float((got - ref).abs().max())
            check(bool(torch.allclose(got, ref, rtol=TOL[dname],
                                      atol=TOL[dname])),
                  f"trsm_right {dname} bucket {(n_, nr, k, m)}: max |kernel "
                  f"- plain| = {e_}")
            err = max(err, e_)
            ops.append((u, x))
            bound += max(n_ * nr * k * k / pk,
                         (n_ * k * (k + 1) // 2 + 2 * n_ * nr * k) * sz
                         / HBM_BYTES_PER_S)
        kern = [lambda u=u, x=x: trisolve_ops.trsm_batched(u, x)
                for u, x in ops]
        lib = [lambda u=u, x=x: torch.linalg.solve_triangular(
            u, x, upper=True, left=False) for u, x in ops]
        out["trsm_right"].update({
            "buckets" + sfx: len(ops),
            "buckets_products" + sfx: sum(u.shape[0] for u, _ in ops),
            "buckets_max_abs_err" + sfx: err,
            "buckets_bound_ms" + sfx: bound * 1e3,
            "buckets_device_ms" + sfx: graph_ms(torch, kern),
            "buckets_library_device_ms" + sfx: lib_graph_ms(torch, lib),
            "buckets_loop_ms" + sfx: bench_ms(
                torch, lambda: [fn() for fn in kern], min_ms=200.0),
            "buckets_library_loop_ms" + sfx: bench_ms(
                torch, lambda: [fn() for fn in lib], min_ms=200.0)})
        del ops, kern, lib
        # left: the finished factors' diagonal blocks, m = 1
        lops, bl, bu, el, eu = [], 0.0, 0.0, 0.0, 0.0
        for blk_node in blocks:
            nr = blk_node[1]
            blk = f.vals[:, blk_node[-1]].to(dt).contiguous()
            rhs = torch.randn(K, nr, 1, generator=gen, dtype=dt, device=dev)
            for name, kf, pf in (
                    ("trsm_left_unit_lower",
                     trisolve_ops.trsm_left_unit_lower_batched,
                     trisolve_ops.trsm_left_unit_lower_plain),
                    ("trsm_left_upper", trisolve_ops.trsm_left_upper_batched,
                     trisolve_ops.trsm_left_upper_plain)):
                got, ref = kf(blk, rhs), pf(blk, rhs)
                torch.cuda.synchronize()
                e_ = float((got - ref).abs().max())
                check(bool(torch.allclose(got, ref, rtol=TOL_LEFT[dname],
                                          atol=TOL_LEFT[dname])),
                      f"{name} {dname} block nr={nr}: max |kernel - plain| "
                      f"= {e_}")
                if name == "trsm_left_upper":
                    eu = max(eu, e_)
                else:
                    el = max(el, e_)
            lops.append((blk, rhs))
            vec = 2 * K * nr * sz                      # b read, w written
            bl += max(K * nr * (nr - 1) / pk,
                      (K * nr * (nr - 1) // 2 * sz + vec) / HBM_BYTES_PER_S)
            bu += max(K * nr * nr / pk,
                      (K * nr * (nr + 1) // 2 * sz + vec) / HBM_BYTES_PER_S)
        for name, kf, lf, err_, bnd in (
                ("trsm_left_unit_lower",
                 trisolve_ops.trsm_left_unit_lower_batched,
                 lambda a_, b_: torch.linalg.solve_triangular(
                     a_, b_, upper=False, unitriangular=True), el, bl),
                ("trsm_left_upper", trisolve_ops.trsm_left_upper_batched,
                 lambda a_, b_: torch.linalg.solve_triangular(
                     a_, b_, upper=True), eu, bu)):
            kern = [lambda a_=a_, b_=b_, kf=kf: kf(a_, b_) for a_, b_ in lops]
            lib = [lambda a_=a_, b_=b_, lf=lf: lf(a_, b_) for a_, b_ in lops]
            out[name].update({
                "blocks" + sfx: len(lops),
                "blocks_max_abs_err" + sfx: err_,
                "blocks_bound_ms" + sfx: bnd * 1e3,
                "blocks_device_ms" + sfx: graph_ms(torch, kern),
                "blocks_library_device_ms" + sfx: lib_graph_ms(torch, lib),
                "blocks_loop_ms" + sfx: bench_ms(
                    torch, lambda: [fn() for fn in kern], min_ms=200.0),
                "blocks_library_loop_ms" + sfx: bench_ms(
                    torch, lambda: [fn() for fn in lib], min_ms=200.0)})
        del lops, kern, lib
        # one launch at the table's shapes, by replay of 200 launches
        u, x, blk, rhs = (t_.to(dt).contiguous() for t_ in table)
        lower = torch.tril(blk, -1) + torch.eye(blk.shape[-1], dtype=dt,
                                                device=dev)
        for name, kf, lf in (
                ("trsm_right", lambda: trisolve_ops.trsm_batched(u, x),
                 lambda: torch.linalg.solve_triangular(u, x, upper=True,
                                                       left=False)),
                ("trsm_left_unit_lower",
                 lambda: trisolve_ops.trsm_left_unit_lower_batched(blk, rhs),
                 lambda: torch.linalg.solve_triangular(
                     lower, rhs, upper=False, unitriangular=True)),
                ("trsm_left_upper",
                 lambda: trisolve_ops.trsm_left_upper_batched(blk, rhs),
                 lambda: torch.linalg.solve_triangular(blk, rhs,
                                                       upper=True))):
            out[name]["device_ms" + sfx] = graph_ms(torch, [kf] * 200) / 200
            lib_ms = lib_graph_ms(torch, [lf] * 200)
            out[name]["library_device_ms" + sfx] = (
                None if lib_ms is None else lib_ms / 200)
        del u, x, blk, rhs, lower
        torch.cuda.empty_cache()
    u, x, blk, rhs = (t_.to(torch.bfloat16).contiguous() for t_ in table)
    for name, kf, ordered in (
            ("trsm_right", lambda: trisolve_ops.trsm_batched(u, x),
             lambda: trisolve_ref.trsm_bf16_ordered(u, x)),
            ("trsm_left_unit_lower",
             lambda: trisolve_ops.trsm_left_unit_lower_batched(blk, rhs),
             lambda: trisolve_ref.trsm_left_unit_lower_bf16_ordered(blk,
                                                                    rhs)),
            ("trsm_left_upper",
             lambda: trisolve_ops.trsm_left_upper_batched(blk, rhs),
             lambda: trisolve_ref.trsm_left_upper_bf16_ordered(blk, rhs))):
        got, seq = kf(), ordered()
        torch.cuda.synchronize()
        _, _, n_ord, n_over = bf16_err(torch, got, seq, exact=True)
        check(n_over == 0, f"{name} bfloat16: {n_ord} entries differ from "
              "the plain version summed in the kernel's order")
        out[name + "_bf16"] = {
            "entries_differing_ordered": n_ord,
            "device_ms": graph_ms(torch, [kf] * 200) / 200,
            "library_device_ms": None}
    del f, u, x, blk, rhs
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return out


def launched_entries(fn):
    """The kernel entry points one call of ``fn`` asks ``_build.launch``
    for, in order."""
    from repro_torch.kernels import _build

    names, launch = [], _build.launch

    def spy(name, *args, **kwargs):
        names.append(name)
        return launch(name, *args, **kwargs)

    _build.launch = spy
    try:
        fn()
    finally:
        _build.launch = launch
    return names


def _record_calls(obj, attr, run, keep):
    """Run ``run()`` with ``obj.attr`` replaced by a spy that records
    ``keep(args, result)`` for every call; returns the records."""
    calls, orig = [], getattr(obj, attr)

    def spy(*args):
        res = orig(*args)
        calls.append(keep(args, res))
        return res

    setattr(obj, attr, spy)
    try:
        run()
    finally:
        delattr(obj, attr)               # the class's method again
    return calls


def ptxas_of(log, needle):
    """ptxas's registers and spill lines of the entry functions whose
    (mangled) name holds ``needle``, from the build's ``-Xptxas -v`` log."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
        elif name and needle in name and ("registers" in ln or "spill" in ln):
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return out


def node_refactor_extra(torch, np, eng_u, a_dev):
    """K5 over one unrolled refactor of system 0.  The node steps are
    replayed in order on a buffer that starts from the scattered values:
    node t's step reads its own panel (untouched before it) and finished
    source panels, so after the step of a node with nr > 1 its panel is
    set to the refactor's finished one (K2's work, not replayed).  Every
    launch is held to ``node_edges_plain`` on a copy of its input (values
    within TOL, equal perturbation counts, no other slot written), in
    float64 and float32.  The summed device time of the launches is a
    CUDA graph of the whole replay less a graph of its copies alone, both
    from the restored start.  Beside it: the parent route over the same
    refactor (``parent_node_step`` and K2 per node; host seconds, its
    factors against the kernel route's) with its K3 and per-edge
    ``gemm_update`` launches recorded on their operands and their device
    times summed by graph replay, and the summed bounds."""
    from repro_torch.kernels.supsup import ops as supsup_ops
    from repro_torch.kernels.trisolve import ops as trisolve_ops

    t0 = time.perf_counter()
    plan = eng_u.plan
    b = a_dev.to(eng_u.dtype)[:, eng_u._src] * eng_u._scl
    v0 = torch.zeros((1, plan.total_slots), dtype=eng_u.dtype,
                     device=a_dev.device)
    v0[:, eng_u._a_scatter] = b
    eps0 = eng_u.perturb_eps * b.abs().amax(dim=1)
    fin = eng_u.refactor_batched(a_dev)
    steps = [(t, step) for t, (_, step) in enumerate(eng_u._nodes)
             if step.e1 > step.e0 or step.nr == 1]
    wide = [(step.off, step.off + step.nr * step.w) for _, step in steps
            if step.nr > 1]
    out = {"launches": len(steps), "wide_nodes_restored": len(wide),
           "edges": int(eng_u._edges.desc.shape[0])}
    for dt in (torch.float64, torch.float32):
        dname = str(dt).replace("torch.", "")
        sfx = "" if dt == torch.float64 else "_f32"
        start, done = v0.to(dt), fin.vals.to(dt)
        eps = eps0.to(dt)
        buf = start.clone()
        nper = torch.zeros(1, dtype=torch.int32, device=buf.device)
        err, bad, bound = 0.0, [], 0.0
        for t, step in steps:
            lo, hi = step.off, step.off + step.nr * step.w
            ref, nk, npl = buf.clone(), nper.clone(), nper.clone()
            supsup_ops.node_edges_inplace(buf, eng_u._edges, step, eps, nk)
            supsup_ops.node_edges_plain(ref, eng_u._edges, step, eps, npl)
            e_ = float((buf[:, lo:hi] - ref[:, lo:hi]).abs().max())
            err = max(err, e_)
            if not (torch.equal(nk, npl) and bool(torch.allclose(
                    buf[:, lo:hi], ref[:, lo:hi], rtol=TOL[dname],
                    atol=TOL[dname])) and torch.equal(
                    _bits(torch, buf[:, :lo]), _bits(torch, ref[:, :lo]))
                    and torch.equal(_bits(torch, buf[:, hi:]),
                                    _bits(torch, ref[:, hi:]))):
                bad.append(t)
            if step.nr > 1:
                buf[:, lo:hi] = done[:, lo:hi]
            bound += node_bound_ms(np, plan, t, dname)
        torch.cuda.synchronize()
        check(not bad, f"node_edges refactor {dname}: nodes {bad[:10]} "
                       "differ from the plain version")
        del ref

        def restore(buf=buf, start=start):
            buf.copy_(start)

        launch = [lambda s_=s_, buf=buf, eps=eps: supsup_ops.node_edges_inplace(
            buf, eng_u._edges, s_, eps, nper) for _, s_ in steps]
        copies = {}
        for t, step in steps:
            if step.nr > 1:
                lo, hi = step.off, step.off + step.nr * step.w
                copies[t] = (lambda lo=lo, hi=hi, buf=buf, done=done:
                             buf[:, lo:hi].copy_(done[:, lo:hi]))
        replay = []
        for (t, _), fn in zip(steps, launch):
            replay.append(fn)
            if t in copies:
                replay.append(copies[t])
        all_ms = fresh_graph_ms(torch, replay, restore)
        copy_ms = fresh_graph_ms(torch, list(copies.values()), restore)
        r_ms = bench_ms(torch, restore)
        out.update({
            "max_abs_err" + sfx: err, "bound_ms" + sfx: bound,
            "device_ms" + sfx: all_ms - copy_ms,
            "replay_with_copies_device_ms" + sfx: all_ms,
            "copies_device_ms" + sfx: copy_ms,
            "loop_ms" + sfx: bench_ms(torch, lambda: (
                restore(), [f() for f in replay]), min_ms=100.0) - r_ms})
        del buf, start, done, launch, copies, replay
        torch.cuda.empty_cache()
    # the parent route over the same refactor (float64, the refactor's
    # dtype), recording what it hands K3 and gemm_update
    rec = []

    def record(x, src, k):
        rec.append((x.clone(), src.clone(), k))

    vals = v0.clone()
    nper = torch.zeros(1, dtype=torch.int32, device=vals.device)
    torch.cuda.synchronize()
    tp = time.perf_counter()
    for t, (_, step) in enumerate(eng_u._nodes):
        parent_node_step(torch, eng_u, t, vals, eps0, nper, record)
        if step.nr > 1:
            nr, w = step.nr, step.w
            panel = vals[:, step.off:step.off + nr * w].view(1, nr, w)
            P, _, npn = eng_u._panel_lu(panel, nr, step.lsize, eps0)
            nper += npn
            panel.copy_(P)
    torch.cuda.synchronize()
    parent_s = time.perf_counter() - tp
    perr = float((vals - fin.vals).abs().max())
    check(perr <= 1e-10 and torch.equal(nper, fin.n_perturb),
          f"parent route vs node kernel route over the unrolled refactor: "
          f"{perr}, perturbations {nper.tolist()} vs "
          f"{fin.n_perturb.tolist()}")
    k3, k5, b3, b5 = [], [], 0.0, 0.0
    for x, src, k in rec:
        xk = x[..., :k].contiguous()
        lts = trisolve_ops.trsm_batched(src[..., :k], xk)
        xc, sb = x[..., k:].contiguous(), src[..., k:].contiguous()
        k3.append(lambda s_=src, xk=xk, k=k: trisolve_ops.trsm_batched(
            s_[..., :k], xk))
        k5.append(lambda xc=xc, lts=lts, sb=sb: supsup_ops.gemm_update(
            xc, lts, sb))
        nr, m = x.shape[1], x.shape[2] - k
        b3 += max(nr * k * k / PEAK_FLOPS["float64"],
                  8 * (k * (k + 1) // 2 + 2 * nr * k) / HBM_BYTES_PER_S)
        b5 += max(2.0 * nr * k * m / PEAK_FLOPS["float64"],
                  8 * (2 * nr * m + nr * k + k * m) / HBM_BYTES_PER_S)
    k3_ms, k5_ms = graph_ms(torch, k3), graph_ms(torch, k5)
    out.update({"parent_refactor_s": parent_s,
                "parent_vs_kernel_max_abs": perr,
                "parent_k3_calls": len(k3), "parent_k3_device_ms": k3_ms,
                "parent_k5_device_ms": k5_ms,
                "parent_k3_k5_device_ms": k3_ms + k5_ms,
                "parent_k3_k5_bound_ms": (b3 + b5) * 1e3,
                "seconds": time.perf_counter() - t0})
    k5_rec = {"calls": len(k5), "bound_ms": b5 * 1e3, "device_ms": k5_ms,
              "loop_ms": bench_ms(torch, lambda: [f() for f in k5],
                                  min_ms=100.0),
              "note": "the parent route's per-edge launches; no engine path "
                      "runs them since the node kernel"}
    del rec, k3, k5
    torch.cuda.empty_cache()
    return out, k5_rec


def panel_extra(torch, np, eng, eng_u, a_dev):
    """K2, K1 and K5 over whole refactors of fem2d_10k.  A spy on the
    engine's wrappers records the operands one unrolled refactor of system
    0 hands K2 (one launch per node with nr > 1, B = 1), and those one
    bucketed refactor at K systems hands K2
    (one launch per narrow-level node, B = K) and K1 (one per panel
    bucket).  The spy keeps each K2 panel's values and its layout (storage
    offset and strides: K2's panels are strided views of the value buffer),
    and every K2 call is replayed on a copy at that layout (``in_layout``).
    K1 reads and writes the value buffer in place: the spy checks on the
    engine's own buffer that each call leaves every slot outside its
    bucket's real slots bit-identical, and keeps the call's slots
    (``Compact``, row alignment kept).  Each K2 and K1 call is held to its
    plain version in float64 (the refactor's dtype) and float32 (the same
    operands), each side on its own copy: equal pivots and perturbation
    counts, values within TOL, and for K1 no other slot written.  Per
    schedule and dtype it reports the device ms summed over the call's
    kernel launches by CUDA-graph replay (for K2 also through the wrapper,
    as the engine calls it), the summed bound, and the same sums for the
    design before (``csrc/panel_lu.cu``'s ``panel_lu_kernel``: for K2
    launched with c0 = lsize on contiguous copies, as K2's wrapper did; for
    K1 the parent's whole bucket phase, gather, threshold repeat, kernel
    and scatter, as the engine ran it); as a yardstick, not a library call
    for the same function, ``torch.linalg.lu_factor_ex`` on the block,
    ``solve_triangular`` on the U suffix and an ``index_select`` of the
    prefix, on the same (for K1 the padded) panels.  K1's in-place calls
    are replayed on copies that ``fresh_graph_ms`` restores before each
    replay, outside the timed events.  Also K2's device time per launch at
    the largest narrow node (the kernel table's shape), K1's bucket census
    and ptxas's registers and spills of the window kernel.  K5: every node
    step of one unrolled refactor (``node_refactor_extra``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.panel import ops as panel_ops

    t = time.perf_counter()

    def keep_panel(args, res):
        P, eps = args[0], args[-1]
        layout = (P.storage_offset(), tuple(P.stride()), P.untyped_storage())
        return (P.clone(), layout) + tuple(args[1:-1]) + (eps.clone(),)

    k2_unrolled = _record_calls(
        eng_u, "_panel_lu", lambda: eng_u.refactor_batched(a_dev[:1]),
        keep_panel)
    k1_calls, untouched = [], []
    orig_k1 = eng._panel_lu_bucket

    def spy_k1(vals, lay, eps):
        comp = Compact(torch, np, vals, lay)            # before the call
        before = vals.clone()
        res = orig_k1(vals, lay, eps)
        real = torch.zeros(vals.shape[1], dtype=torch.bool,
                           device=vals.device)
        for off, nr_, w, _, _ in lay.desc.tolist():
            real[off:off + nr_ * w] = True
        untouched.append(torch.equal(_bits(torch, vals[:, ~real]),
                                     _bits(torch, before[:, ~real])))
        k1_calls.append((comp, eps.clone()))
        return res

    eng._panel_lu_bucket = spy_k1
    try:
        k2_bucketed = _record_calls(
            eng, "_panel_lu", lambda: eng.refactor_batched(a_dev),
            keep_panel)
    finally:
        del eng._panel_lu_bucket
    torch.cuda.synchronize()
    check(len(k1_calls) == sum(len(s_.panels) for s_ in eng.sched.steps),
          f"panel_extra: {len(k1_calls)} K1 calls in one bucketed refactor")
    check(all(untouched), "panel_extra: K1 wrote a slot outside its "
          "bucket's real slots in the engine's buffer")
    K = a_dev.shape[0]
    check(len(k2_unrolled) == sum(nd.nr > 1 for nd in eng_u.plan.nodes),
          f"panel_extra: {len(k2_unrolled)} K2 calls in one unrolled refactor")
    check(any(c[1][1] != c[0].stride() for c in k2_bucketed),
          "panel_extra: K2 is handed strided views")
    check(all(c[0].shape[0] == 1 for c in k2_unrolled)
          and all(c[0].shape[0] == K for c in k2_bucketed),
          "panel_extra: K2 batch sizes")

    def bound_of(P, flops, dname):
        b_, nr_, _ = P.shape
        nbytes = 2 * P.numel() * P.element_size() + b_ * (
            P.element_size() + 4 * (nr_ + 1))
        return max(nbytes / HBM_BYTES_PER_S,
                   flops / PEAK_FLOPS[dname]) * 1e3, nbytes

    def held(what, got, ref, tol):
        check(torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]),
              f"{what}: pivots or perturbation counts differ")
        err = float((got[0] - ref[0]).abs().max())
        check(bool(torch.allclose(got[0], ref[0], rtol=tol, atol=tol)),
              f"{what}: max |kernel - plain| = {err} outside {tol}")
        return err, int((got[1] != torch.arange(
            got[1].shape[-1], device=got[1].device)).sum()), int(got[2].sum())

    def sums(label, calls, dt):
        """K2: check every call, then the summed device times and bounds."""
        dname = str(dt).replace("torch.", "")
        tol = TOL[dname]
        kern, wrap, parent, yard = [], [], [], []
        bound = nbytes = steps = 0.0
        err, moved, perturbed, strided, unaligned = 0.0, 0, 0, 0, 0
        for P, nr_, lsize, eps in in_layout(torch, calls, dt):
            strided += not P.is_contiguous()
            unaligned += P.data_ptr() % 16 != 0
            w = P.shape[2]
            e = panel_ops._eps_in(eps, P.shape[0], P)
            got = panel_ops.panel_lu(P, nr_, lsize, e)
            ref = panel_ops.panel_lu_plain(P, lsize, w, e)
            torch.cuda.synchronize()
            e_, mv, pt = held(f"{label} {dname} ({tuple(P.shape)}, "
                              f"c0={lsize})", got, ref, tol)
            err, moved, perturbed = max(err, e_), moved + mv, perturbed + pt
            del got, ref
            bnd, nb = bound_of(P, kc.lu_flops(P.shape[0], nr_, lsize, w),
                               dname)
            bound, nbytes, steps = bound + bnd, nbytes + nb, steps + nr_
            kern.append(lambda P=P, l_=lsize, e=e:
                        panel_ops._launch_node(P, l_, e))
            wrap.append(lambda P=P, n_=nr_, l_=lsize, e=e:
                        panel_ops.panel_lu(P, n_, l_, e))
            parent.append(lambda P=P.contiguous(), l_=lsize, w_=w, e=e:
                          panel_ops._launch(P, l_, w_, e))
            idx = torch.arange(nr_, device=P.device)
            yard.append(lambda P=P, n_=nr_, l_=lsize, idx=idx:
                        _yardstick(torch, P, n_, l_, idx))
        out = {"calls": len(calls),
               "panels": int(sum(c[0].shape[0] for c in calls)),
               "pivot_steps": int(steps), "bytes": nbytes,
               "max_abs_err": err, "rows_moved": moved,
               "perturbed": perturbed, "strided_views": strided,
               "unaligned_views": unaligned, "bound_ms": bound,
               "device_ms": graph_ms(torch, kern),
               "loop_ms": bench_ms(torch, lambda: [f() for f in kern],
                                   min_ms=100.0),
               "wrapper_device_ms": graph_ms(torch, wrap),
               "parent_device_ms": graph_ms(torch, parent),
               "parent_loop_ms": bench_ms(
                   torch, lambda: [f() for f in parent], min_ms=100.0),
               "yardstick_device_ms": lib_graph_ms(torch, yard),
               "yardstick_loop_ms": bench_ms(
                   torch, lambda: [f() for f in yard], min_ms=100.0)}
        del kern, wrap, parent, yard
        torch.cuda.empty_cache()
        return out

    def k1_sums(dt):
        """K1: every recorded call held to its plain version, each on its
        own copy of the call's slots, then the device times summed over
        the refactor's calls (each replay from the recorded values) beside
        the parent's bucket phase, the yardstick and the summed bound."""
        dname = str(dt).replace("torch.", "")
        tol = TOL[dname]
        bases = [c.base.to(dt) for c, _ in k1_calls]
        works = [torch.empty_like(b_) for b_ in bases]
        es = [panel_ops._eps_in(e_, b_.shape[0], b_)
              for (_, e_), b_ in zip(k1_calls, bases)]

        def restore():
            for w_, b_ in zip(works, bases):
                w_.copy_(b_)

        kern, wrap, parent, yard, bounds = [], [], [], [], []
        bound = nbytes = flops = 0.0
        err, moved, perturbed, steps = 0.0, 0, 0, 0
        for (c, _), b_, w_, e in zip(k1_calls, bases, works, es):
            g, r = b_.clone(), b_.clone()
            gp, gn = panel_ops.panel_lu_bucket_inplace(g, c.lay, e)
            rp, rn = panel_ops.panel_lu_bucket_plain(r, c.lay, e)
            torch.cuda.synchronize()
            what = (f"K1 bucketed {dname} (nrp {c.lay.nr}, wt {c.lay.wt}, "
                    f"B {c.lay.desc.shape[0]})")
            check(torch.equal(gp, rp) and torch.equal(gn, rn),
                  f"{what}: pivots or perturbation counts differ")
            check(torch.equal(_bits(torch, g[:, c.other]),
                              _bits(torch, b_[:, c.other])),
                  f"{what}: a slot outside the bucket's real slots changed")
            gr, rr = g[:, c.real], r[:, c.real]
            e_ = float((gr - rr).abs().max())
            check(bool(torch.allclose(gr, rr, rtol=tol, atol=tol)),
                  f"{what}: max |kernel - plain| = {e_} outside {tol}")
            err = max(err, e_)
            moved += int((gp != torch.arange(c.lay.nr,
                                             device=gp.device)).sum())
            perturbed += int(gn.sum())
            del g, r, gr, rr
            f_, nb = bucket_work(c.lay, b_.shape[0], b_.element_size())
            flops, nbytes = flops + f_, nbytes + nb
            bounds.append(max(nb / HBM_BYTES_PER_S, f_ / PEAK_FLOPS[dname]))
            bound += bounds[-1]
            steps += b_.shape[0] * int(c.lay.desc[:, 1].sum())
            kern.append(lambda w_=w_, c=c, e=e:
                        panel_ops._launch_bucket(w_, c.lay, e))
            wrap.append(lambda w_=w_, c=c, e=e:
                        panel_ops.panel_lu_bucket_inplace(w_, c.lay, e))
            parent.append(lambda w_=w_, c=c, e=e:
                          parent_bucket(panel_ops, w_, c.lay, e))
            # the padded panels as [prefix | block | U] for the yardstick
            kk, bb = b_.shape[0], c.lay.desc.shape[0]
            P = b_[:, c.lay.gather].view(kk * bb, c.lay.nr, c.lay.wt)
            P = torch.cat([P[:, :, c.lay.wu:], P[:, :, :c.lay.wu]], dim=2)
            idx = torch.arange(c.lay.nr, device=P.device)
            yard.append(lambda P=P, n_=c.lay.nr, l_=c.lay.wt - c.lay.wu,
                        idx=idx: _yardstick(torch, P, n_, l_, idx))
        r_ms = bench_ms(torch, restore, min_ms=100.0)
        out = {"calls": len(k1_calls),
               "panels": int(sum(b_.shape[0] * c.lay.desc.shape[0]
                                 for (c, _), b_ in zip(k1_calls, bases))),
               "pivot_steps": steps, "flops": flops, "bytes": nbytes,
               "max_abs_err": err, "rows_moved": moved,
               "perturbed": perturbed,
               "member_rows": sum(c.rows for c, _ in k1_calls),
               "unaligned_member_rows": sum(c.unaligned_rows[dname]
                                            for c, _ in k1_calls),
               "bound_ms": bound * 1e3,
               "device_ms": fresh_graph_ms(torch, kern, restore),
               "wrapper_device_ms": fresh_graph_ms(torch, wrap, restore),
               "parent_device_ms": fresh_graph_ms(torch, parent, restore),
               "restore_loop_ms": r_ms,
               "loop_ms": bench_ms(torch, lambda: (
                   restore(), [f() for f in wrap]), min_ms=100.0) - r_ms,
               "parent_loop_ms": bench_ms(torch, lambda: (
                   restore(), [f() for f in parent]), min_ms=100.0) - r_ms,
               "yardstick_device_ms": lib_graph_ms(torch, yard),
               "yardstick_loop_ms": bench_ms(
                   torch, lambda: [f() for f in yard], min_ms=100.0)}
        # the same sums over the buckets of each padded row count
        out["by_nrp"] = {}
        for nrp in sorted({c.lay.nr for c, _ in k1_calls}):
            sel = [i for i, (c, _) in enumerate(k1_calls) if c.lay.nr == nrp]

            def restore_sel(sel=sel):
                for i in sel:
                    works[i].copy_(bases[i])

            out["by_nrp"][str(nrp)] = {
                "calls": len(sel),
                "panels": sum(bases[i].shape[0]
                              * k1_calls[i][0].lay.desc.shape[0]
                              for i in sel),
                "bound_ms": sum(bounds[i] for i in sel) * 1e3,
                "device_ms": fresh_graph_ms(torch, [kern[i] for i in sel],
                                            restore_sel),
                "parent_device_ms": fresh_graph_ms(
                    torch, [parent[i] for i in sel], restore_sel)}
        del kern, wrap, parent, yard, bases, works
        torch.cuda.empty_cache()
        return out

    res = {"panel_lu": {}, "panel_lu_bucketed": {}, "gemm_update": {},
           "node_edges": {}}
    for dt in (torch.float64, torch.float32):
        sfx = "" if dt == torch.float64 else "_f32"
        res["panel_lu"]["refactor_unrolled" + sfx] = sums(
            "K2 unrolled", k2_unrolled, dt)
        res["panel_lu"]["refactor_bucketed" + sfx] = sums(
            "K2 bucketed", k2_bucketed, dt)
        res["panel_lu_bucketed"]["refactor_bucketed" + sfx] = k1_sums(dt)
        # K2 per launch at the largest narrow node, by replay of 20 launches
        P, nr_, lsize, eps = in_layout(
            torch, [max(k2_bucketed, key=lambda c: c[0].numel())], dt)[0]
        e = panel_ops._eps_in(eps, P.shape[0], P)
        res["panel_lu"]["device_ms" + sfx] = graph_ms(
            torch, [lambda: panel_ops.panel_lu(P, nr_, lsize, e)] * 20) / 20
        Pc = P.contiguous()
        res["panel_lu"]["parent_device_ms" + sfx] = graph_ms(
            torch, [lambda: panel_ops._launch(Pc, lsize, Pc.shape[2], e)]
            * 20) / 20
        del P, Pc
    # K5: every node step of one unrolled refactor, and the parent route's
    # K3 + per-edge gemm_update over the same refactor
    (res["node_edges"]["refactor_unrolled"],
     res["gemm_update"]["refactor_unrolled"]) = node_refactor_extra(
        torch, np, eng_u, a_dev[:1])
    # the window kernel's instantiations: <type, pivot warps, window in
    # shared memory, bucket members in place>
    res["panel_lu"]["ptxas"] = ptxas_of(_build.last_build["log"],
                                        "panel_lu_window_kernel")
    res["panel_lu"]["yardstick"] = res["panel_lu_bucketed"]["yardstick"] = (
        "torch.linalg.lu_factor_ex(block) + solve_triangular(L, U suffix) "
        "+ index_select(prefix): not the same function, a scale")
    res["panel_lu_bucketed"]["timing"] = (
        "in place: each graph replay starts from the recorded values, "
        "restored by a copy outside the timed events; loop times have "
        "the restoring copy's loop time taken off")
    # per bucket: (nrp, wu, wt, B), the share of padded rows and of padded
    # entries of the (B, nrp, wt) panels
    census = []
    for c, _ in k1_calls:
        d = c.lay.desc.cpu().numpy().astype(np.int64)
        bb = len(d)
        census.append([c.lay.nr, c.lay.wu, c.lay.wt, bb,
                       float(1.0 - d[:, 1].sum() / (bb * c.lay.nr)),
                       float(1.0 - (d[:, 1] * d[:, 2]).sum()
                             / (bb * c.lay.nr * c.lay.wt))])
    res["panel_lu_bucketed"]["census"] = census
    res["panel_lu_bucketed"]["census_keys"] = [
        "nrp", "wu", "wt", "B", "padded_row_share", "padded_entry_share"]
    del k2_unrolled, k2_bucketed, k1_calls
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    emit({"phase": "panel_extra", "matrix": "fem2d_10k", "k": K,
          "results": res, "seconds": time.perf_counter() - t})
    return res


def in_layout(torch, calls, dt):
    """Recorded panel calls ``(values, (offset, strides, storage), *args)``
    as ``(panel, *args)`` with each panel in dtype ``dt`` at its recorded
    layout: one NaN-filled buffer per storage the program handed the
    panels in, each panel copied into its view there.  The panels of one
    storage must not overlap, so every view is checked after all copies."""
    bufs, out = {}, []
    for P, (off, stride, stor), *rest in calls:
        key = stor.data_ptr()
        if key not in bufs:
            bufs[key] = torch.full((stor.nbytes() // P.element_size(),),
                                   float("nan"), dtype=dt, device=P.device)
        view = torch.as_strided(bufs[key], P.shape, stride, off)
        view.copy_(P)
        out.append((view, *rest))
    for (P, *_), (view, *_) in zip(calls, out):
        check(torch.equal(torch.isnan(view), torch.isnan(P))
              and bool((view == P.to(dt))[~torch.isnan(view)].all()),
              "panel_extra: recorded panels overlap in their buffer")
    return out


def _yardstick(torch, P, nr, lsize, idx):
    """Library calls on a node panel's three parts (a scale for K2, not
    the same function): LU of the block, the unit-lower solve of the U
    suffix, a row gather of the prefix."""
    lu, _, _ = torch.linalg.lu_factor_ex(P[:, :, lsize:lsize + nr])
    if P.shape[2] > lsize + nr:
        torch.linalg.solve_triangular(lu, P[:, :, lsize + nr:], upper=False,
                                      unitriangular=True)
    if lsize:
        P[:, :, :lsize].index_select(1, idx)


def _bits(torch, t):
    """A float tensor's bits, for comparisons that NaN and -0.0 pass."""
    return t.contiguous().view(torch.int64 if t.element_size() == 8
                               else torch.int32)


class Compact:
    """The slots one in-place K1 call reads and writes, copied out of the
    value buffer into a (K, L) buffer of their own: each member's panel at
    an offset congruent to its own mod 4 (and L to the buffer's row length
    mod 4), so every row keeps its 16-byte alignment in float64 and
    float32; pi in the few slots between them; then the zero, one and
    scratch slots.  ``lay`` describes the members there, ``real`` indexes
    their slots, ``other`` every other slot, ``zero`` the first
    sentinel."""

    def __init__(self, torch, np, vals, lay):
        from repro_torch.kernels.panel import ops as panel_ops

        desc = lay.desc.cpu().numpy().astype(np.int64)
        k, n_ext = vals.shape
        new, src, dst, pos = desc.copy(), [], [], 0
        for i, (off, nr, w, _, _) in enumerate(desc):
            pos += (off - pos) % 4
            new[i, 0] = pos
            src.append(np.arange(off, off + nr * w))
            dst.append(np.arange(pos, pos + nr * w))
            pos += nr * w
        zero = pos
        width = zero + 3 + (n_ext - zero - 3) % 4
        dev = vals.device
        src, dst = (torch.from_numpy(np.concatenate(a)).to(dev)
                    for a in (src, dst))
        self.base = torch.full((k, width), np.pi, dtype=vals.dtype,
                               device=dev)
        self.base[:, dst] = vals[:, src]
        self.base[:, zero] = vals[:, lay.zero_slot]
        self.base[:, zero + 1] = vals[:, lay.one_slot]
        self.base[:, zero + 2] = 0.0
        g, sc = panel_ops.bucket_maps(new, lay.nr, lay.wu, lay.wt, zero,
                                      zero + 1, zero + 2)
        self.lay = panel_ops.bucket_layout(new, lay.nr, lay.wu, lay.wt, zero,
                                           zero + 1, g, sc, dev)
        mask = torch.zeros(width, dtype=torch.bool, device=dev)
        mask[dst] = True
        self.real, self.other = dst, (~mask).nonzero()[:, 0]
        self.zero = zero
        # the members' rows, and those that start off a 16-byte boundary
        # in the engine's buffer (system k's row at k * n_ext)
        starts = (n_ext * np.arange(k))[:, None] + np.concatenate(
            [off + np.arange(nr) * w for off, nr, w, _, _ in desc])[None]
        self.rows = int(starts.size)
        self.unaligned_rows = {"float64": int((starts % 2 != 0).sum()),
                               "float32": int((starts % 4 != 0).sum())}


def bucket_work(lay, k, elem):
    """``kernel_cost.bucket_work`` of one K1 call on ``k`` systems of the
    bucket ``lay`` (its descriptors read back from the card)."""
    return kc.bucket_work(lay.desc.cpu().numpy(), lay.nr, k, elem)


def parent_bucket(panel_ops, vals, lay, eps):
    """K1's bucket phase as the engine ran it before the in-place kernel:
    gather the padded panels, repeat each system's threshold per member,
    the parent kernel (``hylu_panel_lu_*``), scatter back."""
    k, b = vals.shape[0], lay.desc.shape[0]
    P = vals[:, lay.gather].view(k * b, lay.nr, lay.wt)
    out, perm, nper = panel_ops._launch(P, 0, lay.wu, eps.repeat_interleave(b))
    vals[:, lay.scatter] = out.view(k, -1)
    return perm, nper


def fresh_graph_ms(torch, calls, restore, reps=5):
    """Device time of one pass of ``calls``, thunks that work in place, by
    CUDA events around replays of a CUDA graph that captured the pass;
    before each replay ``restore()`` copies the recorded values back,
    outside the timed events, so every replay starts from them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        restore()
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for fn in calls:
            fn()
    total = 0.0
    for _ in range(reps):
        restore()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        g.replay()
        t1.record()
        torch.cuda.synchronize()
        total += t0.elapsed_time(t1)
    del g
    torch.cuda.empty_cache()
    return total / reps


def shuffle_members(torch, np, comp, rng):
    """The compact buffer with each member's rows shuffled (per system),
    so that pivoting has to move rows."""
    out = comp.base.clone()
    k = out.shape[0]
    for off, nr, w, _, _ in comp.lay.desc.tolist():
        blk = out[:, off:off + nr * w].view(k, nr, w)
        idx = torch.from_numpy(np.argsort(rng.random((k, nr)), axis=1)).to(
            out.device)
        blk.copy_(torch.gather(blk, 1, idx[..., None].expand(k, nr, w)))
    return out


def device_kernels(torch, fn):
    """Kernels (and copies) the device runs in ``fn()``, by torch.profiler
    with CPU and CUDA activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def scalar_phase(torch, np, kernels, A, an64, an_u, an32):
    """Phase 8: factor -> refactor -> solve of one system at fem2d_10k under
    both schedules (float64) and with float32 factors; returns the launches
    of the whole phase by wrapper."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from repro_torch.core import (CSR, factor, refactor, solve,
                                  torch_repeated_engine)

    t_all = time.perf_counter()
    rng = np.random.default_rng(9)
    v1, v2 = (A.data * rng.uniform(0.8, 1.2, A.nnz) for _ in range(2))
    A1 = CSR(A.n, A.indptr, A.indices, v1)
    A2 = CSR(A.n, A.indptr, A.indices, v2)
    b = rng.normal(size=A.n)
    xr = spla.spsolve(sp.csr_matrix((v2, A.indices, A.indptr),
                                    shape=(A.n, A.n)).tocsc(), b)
    nodes = an64.plan.nodes
    n_supsup = sum(1 for nd in nodes for e in nd.edges
                   if nd.nr > 1 and nodes[e.src].nr > 1)
    n_wide = sum(1 for nd in nodes if nd.nr > 1)
    total = dict.fromkeys(kernels.launch_counts(), 0)
    res, states = {}, {}
    for label, an in (("bucketed", an64), ("unrolled", an_u),
                      ("bucketed_f32", an32)):
        torch_repeated_engine(an)               # built outside the timing
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        st = factor(an, A1)
        t_factor = time.perf_counter() - t0
        per_factor = kernels.launch_counts()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        st = refactor(st, A2)
        t_refactor = time.perf_counter() - t0
        per_refactor = kernels.launch_counts()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        x, info = solve(st, b)
        t_solve = time.perf_counter() - t0
        per_solve = kernels.launch_counts()
        for w in total:
            total[w] += per_factor[w] + per_refactor[w] + per_solve[w]
        states[label] = st.torch_factors
        res[label] = {
            "factor_ms": t_factor * 1e3, "refactor_ms": t_refactor * 1e3,
            "solve_ms": t_solve * 1e3, "residual": info["residual"],
            "n_refine": info["n_refine"], "n_perturb": info["n_perturb"],
            "refine_failed": info["refine_failed"],
            "scipy_rel_err": float(np.abs(x - xr).max() / np.abs(xr).max()),
            "launches_per_refactor": {w: c for w, c in per_refactor.items()
                                      if c}}
    fb, fu = states["bucketed"], states["unrolled"]
    unrolled_vs_bucketed = float((fu.vals - fb.vals).abs().max())
    same_pivots = bool(torch.equal(fu.inode_perm, fb.inode_perm))
    u_counts = res["unrolled"]["launches_per_refactor"]
    n_steps = sum(1 for nd in an_u.plan.nodes if nd.edges or nd.nr == 1)
    # everything the device runs in one refactor of one system
    dk = {}
    for label, an in (("unrolled", an_u), ("bucketed", an64)):
        eng_ = torch_repeated_engine(an)
        a2 = torch.from_numpy(v2).to(eng_.device)
        dk[label] = device_kernels(torch, lambda: eng_.refactor(a2))
    emit({"phase": "scalar", "matrix": "fem2d_10k", "runs": res,
          "unrolled_vs_bucketed_max_abs": unrolled_vs_bucketed,
          "same_inode_perm": same_pivots,
          "plan_supsup_edges": n_supsup, "plan_wide_nodes": n_wide,
          "plan_node_steps": n_steps, "device_kernels_per_refactor": dk,
          "seconds": time.perf_counter() - t_all})
    for label, r in res.items():
        check(r["residual"] <= 1e-10, f"scalar {label}: residual "
                                      f"{r['residual']} > 1e-10")
        check(r["scipy_rel_err"] <= 1e-10, f"scalar {label}: spsolve "
                                           f"disagreement {r['scipy_rel_err']}")
        check(not r["refine_failed"], f"scalar {label}: refine_failed")
    check(same_pivots, "unrolled and bucketed pivots differ")
    check(int(fu.n_perturb) == int(fb.n_perturb),
          "unrolled and bucketed perturbation counts differ")
    check(unrolled_vs_bucketed <= 1e-10,
          f"unrolled vs bucketed factors {unrolled_vs_bucketed} > 1e-10")
    check(u_counts.get("node_edges_inplace", 0) == n_steps > 0
          and "node_edges_wide" not in u_counts,
          f"K5 node steps per unrolled refactor {u_counts} != {n_steps} "
          "of the k <= 128 instance")
    check(n_supsup > 0 and "gemm_update" not in u_counts
          and "trsm_batched" not in u_counts,
          f"the unrolled refactor launched per-edge K3 or K5: {u_counts}")
    check(u_counts.get("panel_lu", 0) == n_wide > 0,
          f"K2 launches per unrolled refactor {u_counts} != {n_wide}")
    b_counts = res["bucketed"]["launches_per_refactor"]
    for w in ("panel_lu_bucket_inplace", "panel_lu", "trsm_batched",
              "gemm_batched"):
        check(b_counts.get(w, 0) > 0,
              f"kernel {w} was not launched by the bucketed refactor")
    return total


def plain_phase(torch, np, kernels, A, an64, bst, values0, b, t_factor,
                t_solve):
    """Phase 9: one batched step with use_kernels=False (plain factor
    program, level-scheduled substitution) beside the kernel route."""
    from repro_torch.core import (HyluOptions, analyze, factor_batched,
                                  solve_batched, torch_repeated_engine)

    t_all = time.perf_counter()
    an_p = analyze(A, HyluOptions(use_kernels=False), reuse=an64)
    eng_p = torch_repeated_engine(an_p)
    eng_k = torch_repeated_engine(an64)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    bst_p = factor_batched(an_p, A, values0)
    t_factor_p = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_p, info_p = solve_batched(bst_p, b)
    t_solve_p = time.perf_counter() - t0
    moved = {w: c for w, c in kernels.launch_counts().items() if c}
    # one substitution of the same factors by each schedule
    b_dev = torch.from_numpy(b).to(eng_k.device)
    apply_level = bench_ms(torch, lambda: eng_p.apply_batched(
        bst.vals, bst.inode_perm, b_dev), min_ms=0.0)
    apply_block = bench_ms(torch, lambda: eng_k.apply_batched(
        bst.vals, bst.inode_perm, b_dev), min_ms=0.0)
    levels = {name: len(getattr(eng_p.ss, name).rows)
              for name in ("l_fwd", "u_bwd")}
    emit({"phase": "plain", "matrix": "fem2d_10k", "k": K_MAIN,
          "factor_batched_ms": t_factor_p * 1e3,
          "solve_batched_ms": t_solve_p * 1e3,
          "kernel_route_factor_batched_ms": t_factor * 1e3,
          "kernel_route_solve_batched_ms": t_solve * 1e3,
          "apply_level_scheduled_ms": apply_level,
          "apply_node_block_ms": apply_block,
          "levels": levels, "block_nodes": len(eng_k._blocks),
          "max_residual": float(info_p["residual"].max()),
          "refine_iters": info_p["n_refine"], "kernel_launches": moved,
          "seconds": time.perf_counter() - t_all})
    check(not moved, f"use_kernels=False launched kernels: {moved}")
    check(np.isfinite(x_p).all() and info_p["residual"].max() <= 1e-10,
          f"use_kernels=False residual {info_p['residual'].max()}")


def baselines_phase(torch, np, kernels, A, an64, values0, b):
    """Phase 7: the paper's §4 comparison on fem2d_10k at K = 32 — the
    ``hylu``, ``pardiso_like`` and ``klu_like`` presets
    (``repro_torch.core.baselines``), each analyzed by ``reuse=`` of the
    main phase's analysis (hylu is that analysis), factored by
    ``factor_batched`` and solved by ``solve_batched`` on the main phase's
    values and right-hand sides, once (its launches counted) and then
    ``PRESET_REPEATS`` times (the median and range timed); then the
    host-loop solve (``_solve_batched_hostloop``) on hylu's and klu_like's
    factors beside the fused one, pardiso_like on a small plan with a
    140-row panel bucket and edge source (``wide_plan_run``), and the wide
    paths' kernel records (``wide_records``).  Returns (launch counts of
    the phase, the new kernel records)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from repro_torch.core import (analyze, baselines, factor_batched,
                                  solve_batched, torch_repeated_engine)
    from repro_torch.core.api import _solve_batched_hostloop

    t_all = time.perf_counter()
    ref = {}
    for k in (0, K_MAIN - 1):
        ak = sp.csr_matrix((values0[k], A.indices, A.indptr),
                           shape=(A.n, A.n)).tocsc()
        ref[k] = spla.spsolve(ak, b[k])
    total = {w: 0 for w in kernels.WRAPPERS}
    presets, states = {}, {}
    for name in ("hylu", "pardiso_like", "klu_like"):
        t0 = time.perf_counter()
        an = (an64 if name == "hylu" else
              analyze(A, baselines.BASELINES[name](), reuse=an64))
        analyze_s = time.perf_counter() - t0
        eng = torch_repeated_engine(an)          # built outside the timing
        nodes = an.plan.nodes
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        bst = factor_batched(an, A, values0)
        t_factor = time.perf_counter() - t0
        t0 = time.perf_counter()
        x, info = solve_batched(bst, b)
        t_solve = time.perf_counter() - t0
        counts = kernels.launch_counts()
        for w, c in counts.items():
            total[w] += c
        err = [float(np.abs(x[k] - ref[k]).max() / np.abs(ref[k]).max())
               for k in ref]
        states[name] = (an, eng, bst, x, info, t_solve)
        reps = []                        # after the first (warm-up) pass
        for _ in range(PRESET_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bst_r = factor_batched(an, A, values0)
            t1 = time.perf_counter()
            solve_batched(bst_r, b)
            reps.append((t1 - t0, time.perf_counter() - t1))
            del bst_r
        f_s, s_s = (sorted(v) for v in zip(*reps))
        states[name] = states[name][:5] + (_median(s_s),)
        sps = sorted(K_MAIN / (f + s_) for f, s_ in reps)
        presets[name] = {
            "mode": an.choice.mode, "ordering": an.ordering_name,
            "nodes": len(nodes), "max_nr": max(nd.nr for nd in nodes),
            "nodes_over_128": sum(nd.nr > 128 for nd in nodes),
            "total_slots": int(an.plan.total_slots),
            "block_nodes": len(eng._blocks), "analyze_reuse_s": analyze_s,
            "first_factor_batched_ms": t_factor * 1e3,
            "first_solve_batched_ms": t_solve * 1e3,
            "repeats": PRESET_REPEATS,
            "factor_batched_ms": _median(f_s) * 1e3,
            "factor_batched_ms_range": [f_s[0] * 1e3, f_s[-1] * 1e3],
            "solve_batched_ms": _median(s_s) * 1e3,
            "solve_batched_ms_range": [s_s[0] * 1e3, s_s[-1] * 1e3],
            "systems_per_s": _median(sps),
            "systems_per_s_range": [sps[0], sps[-1]],
            "max_residual": float(info["residual"].max()),
            "refine_iters": info["n_refine"],
            "n_perturb": int(info["n_perturb"].sum()),
            "scipy_rel_err": err,
            "launches": {w: c for w, c in counts.items() if c}}
        check(np.isfinite(x).all() and x.shape == (K_MAIN, A.n),
              f"{name}: solutions are finite and (K, n)")
        check(presets[name]["max_residual"] <= 1e-10,
              f"{name}: residual {presets[name]['max_residual']} > 1e-10")
        check(max(err) <= 1e-10, f"{name}: spsolve disagreement {err}")
    for w in ("panel_lu_wide", "trsm_left_unit_lower_wide",
              "trsm_left_upper_wide"):
        check(presets["pardiso_like"]["launches"].get(w, 0) >= 1,
              f"pardiso_like: the wide path {w} was not launched")
    # the host-loop solve (warm) beside the fused one's median over the
    # repeats: on hylu's factors (no refinement) and on klu_like's (one
    # refinement, so the loop's improved / converged masking runs)
    hostloop = {}
    for name in ("hylu", "klu_like"):
        an, eng, bst, x_f, info_f, t_fused = states[name]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        x_h, info_h = _solve_batched_hostloop(bst, b)
        t_host = time.perf_counter() - t0
        for w, c in kernels.launch_counts().items():
            total[w] += c
        host_err = float(np.abs(x_h - x_f).max() / np.abs(x_f).max())
        masks = {m: bool(np.array_equal(info_h[m], info_f[m]))
                 for m in ("refine_failed", "refine_stalled")}
        hostloop[name] = {
            "hostloop_solve_ms": t_host * 1e3,
            "fused_solve_ms_median": t_fused * 1e3,
            "hostloop_over_fused": t_host / t_fused,
            "x_rel_err": host_err,
            "n_refine": [info_h["n_refine"], info_f["n_refine"]],
            "masks_equal": masks,
            "max_residual": float(info_h["residual"].max())}
        check(host_err <= 1e-10,
              f"{name}: host loop vs fused solve: {host_err}")
        check(info_h["n_refine"] == info_f["n_refine"],
              f"{name}: host loop refinements {info_h['n_refine']} != "
              f"fused {info_f['n_refine']}")
        check(all(masks.values()), f"{name}: host loop masks {masks}")
    check(hostloop["klu_like"]["n_refine"][0] >= 1,
          "klu_like: the host loop ran no refinement")
    # pardiso_like on a plan with a 140-row panel bucket and edge source
    # (fem2d_10k has neither), through the same entry points
    wide_plan = wide_plan_run(torch, np, kernels, analyze, baselines,
                              factor_batched, solve_batched)
    for w, c in wide_plan.pop("counts").items():
        total[w] += c
    records = wide_records(torch, np, states["pardiso_like"][1], values0)
    bf16_entries = wide_plan.pop("bf16_entries")
    for rec in records:
        if rec.get("dtype") == "bfloat16":
            rec["launches_by_path"] = {
                "bf16_wide_plan": bf16_entries.get(rec["entry"], 0)}
    records.append(wide_plan.pop("node_edges_wide"))
    emit({"phase": "baselines", "matrix": "fem2d_10k", "k": K_MAIN,
          "presets": presets, "hostloop": hostloop, "wide_plan": wide_plan,
          "wide_records": records, "seconds": time.perf_counter() - t_all})
    return total, records


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def wide_source_matrix(n=200, blk=140, cpl=20, seed=6):
    """A dense 140-row diagonal block coupled to a sparse rest by ``cpl``
    rows and columns: under natural ordering, ``pardiso_like`` makes the
    block one supernode, a panel bucket of its own (padded to 256 rows)
    and the source of sup-sup edges with k = 140."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    r = n - blk
    a = sp.lil_matrix((n, n))
    a[blk:, blk:] = sp.random(r, r, density=0.05,
                              random_state=np.random.RandomState(seed))
    a[:blk, :blk] = rng.normal(size=(blk, blk))
    a[blk:blk + cpl, :blk] = rng.normal(size=(cpl, blk))
    a[:blk, blk:blk + cpl] = rng.normal(size=(blk, cpl))
    diag = rng.uniform(1.0, 2.0, n) * rng.choice([-1, 1], n) * 30
    return (a.tocsr() + sp.diags(diag)).tocsr()


def wide_plan_run(torch, np, kernels, analyze, baselines, factor_batched,
                  solve_batched):
    """``pardiso_like`` (natural ordering, bulk_min_width 2) on
    ``wide_source_matrix`` at K = 8 through ``analyze``,
    ``factor_batched`` and ``solve_batched``: the wide paths fem2d_10k
    does not reach, K1's (``panel_lu_bucket_wide``) and K3's wide right
    solve (``trsm_right_wide``), run in the engine and are checked
    against ``spsolve``; then the same plan under the unrolled schedule,
    whose node steps with the 140-row source run K5's wide instance
    (``node_edges_wide``): against ``spsolve`` and the bucketed run's
    factors (1e-10, equal pivots and perturbation counts), and that wide
    node step's kernel record (``wide_node_record``); then the bucketed
    plan in bfloat16 factors (``factor_dtype="bfloat16"``), whose sup-sup
    edges from the 140-row source and whose substitution on its 140-row
    block run K3's wide bfloat16 solves: x against ``spsolve`` (1e-10,
    after the float64 refinement and fallback), its launches by entry
    point (a spy on ``_build.launch``), none of the per-edge K5.  Returns
    the record, its launch counts under ``counts`` (the float64 runs'),
    the kernel record under ``node_edges_wide`` and the bfloat16 run's
    launches by entry point under ``bf16_entries``."""
    import dataclasses

    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from repro_torch.core import torch_repeated_engine
    from repro_torch.kernels import _build
    from repro_torch.matrices import to_csr

    t = time.perf_counter()
    a = wide_source_matrix()
    A = to_csr(a)
    rng = np.random.default_rng(7)
    vb = A.data[None] * rng.uniform(0.8, 1.2, (8, A.nnz))
    bb = rng.normal(size=(8, A.n))
    kw = dict(orderings=("natural",), bulk_min_width=2)
    an = analyze(A, baselines.pardiso_like_options(**kw))
    an_u = analyze(A, baselines.pardiso_like_options(
        factor_schedule="unrolled", **kw), reuse=an)
    torch_repeated_engine(an_u)                 # built outside the counts
    refs = [spla.spsolve(sp.csr_matrix((vb[k], A.indices, A.indptr),
                                       shape=(A.n, A.n)).tocsc(), bb[k])
            for k in range(vb.shape[0])]

    def err_of(x):
        return max(float(np.abs(x[k] - r).max() / np.abs(r).max())
                   for k, r in enumerate(refs))

    kernels.reset_launch_counts()
    bst = factor_batched(an, A, vb)
    x, info = solve_batched(bst, bb)
    bst_u = factor_batched(an_u, A, vb)
    x_u, info_u = solve_batched(bst_u, bb)
    counts = kernels.launch_counts()
    err, err_u = err_of(x), err_of(x_u)
    vals_err = float((bst_u.vals - bst.vals).abs().max())
    same = {"inode_perm": bool(torch.equal(bst_u.inode_perm,
                                           bst.inode_perm)),
            "n_perturb": bool(np.array_equal(bst_u.n_perturb,
                                             bst.n_perturb))}
    rec = {"matrix": "wide_source_matrix(200, 140, 20, seed=6)", "k": 8,
           "max_nr": max(nd.nr for nd in an.plan.nodes),
           "max_residual": float(info["residual"].max()),
           "scipy_rel_err": err,
           "unrolled": {"max_residual": float(info_u["residual"].max()),
                        "scipy_rel_err": err_u,
                        "vals_vs_bucketed_max_abs": vals_err,
                        "same_as_bucketed": same,
                        "wide_node_steps": sum(
                            st.kmax > 128 for _, st in
                            torch_repeated_engine(an_u)._nodes)},
           "launches": {w: c for w, c in counts.items() if c},
           "seconds": time.perf_counter() - t, "counts": counts}
    check(np.isfinite(x).all() and rec["max_residual"] <= 1e-10,
          f"wide plan: residual {rec['max_residual']}")
    check(err <= 1e-10, f"wide plan: spsolve disagreement {err}")
    check(np.isfinite(x_u).all() and info_u["residual"].max() <= 1e-10
          and err_u <= 1e-10, f"wide plan unrolled: residual "
                              f"{info_u['residual'].max()}, spsolve {err_u}")
    check(vals_err <= 1e-10 and all(same.values()),
          f"wide plan unrolled vs bucketed: vals {vals_err}, {same}")
    for w in ("panel_lu_bucket_wide", "trsm_right_wide",
              "node_edges_wide"):
        check(counts[w] >= 1, f"wide plan: the wide path {w} was not "
                              "launched")
    rec["node_edges_wide"] = wide_node_record(
        torch, np, torch_repeated_engine(an_u),
        torch.from_numpy(vb).to(bst.vals.device))
    an_bf = analyze(A, dataclasses.replace(an.opts, factor_dtype="bfloat16"),
                    reuse=an)
    torch_repeated_engine(an_bf)
    entries, launch = {}, _build.launch

    def spy(name, *args, **kwargs):
        entries[name] = entries.get(name, 0) + 1
        return launch(name, *args, **kwargs)

    _build.launch = spy
    try:
        x_bf, info_bf = solve_batched(factor_batched(an_bf, A, vb), bb)
    finally:
        _build.launch = launch
    err_bf = err_of(x_bf)
    rec["bfloat16"] = {"max_residual": float(info_bf["residual"].max()),
                       "scipy_rel_err": err_bf,
                       "n_fp64_fallback": info_bf["n_fp64_fallback"],
                       "refine_failed": int(info_bf["refine_failed"].sum()),
                       "entry_points": dict(entries)}
    check(np.isfinite(x_bf).all() and err_bf <= 1e-10
          and rec["bfloat16"]["refine_failed"] == 0,
          f"wide plan bf16: spsolve disagreement {err_bf}, "
          f"{rec['bfloat16']['refine_failed']} failed")
    for name in ("hylu_trsm_right_wide_bf16",
                 "hylu_trsm_left_unit_lower_wide_bf16",
                 "hylu_trsm_left_upper_wide_bf16"):
        check(entries.get(name, 0) >= 1,
              f"wide plan bf16: {name} was not launched")
    per_edge = [n for n in entries if n.startswith("hylu_gemm_update_")]
    check(not per_edge, f"wide plan bf16: the per-edge K5 ran: {per_edge}")
    rec["bf16_entries"] = entries
    rec["seconds"] = time.perf_counter() - t
    return rec


def wide_node_record(torch, np, eng_u, a_dev):
    """The kernel record of K5's wide instance (``node_edges_wide``) at the
    unrolled plan's node with a source over 128 rows and the most edge
    work, on the buffer its program hands it (all K systems), float64:
    held to ``node_edges_plain`` (values within 1e-10, equal perturbation
    counts, no slot outside the panel written), its time per call by CUDA
    events (back-to-back calls, each from the node's input panel, the
    restoring copy's time taken off), the plain version's and the bound of
    ``node_work`` over the K systems."""
    from repro_torch.kernels.supsup import ops as supsup_ops

    plan = eng_u.plan
    nodes = plan.nodes
    K = a_dev.shape[0]
    wide = [t for t, (_, st) in enumerate(eng_u._nodes)
            if st.kmax > supsup_ops.WIDE_K]
    t = max(wide, key=lambda t_: kc.node_work(plan, t_, 8)[0])
    _, step = eng_u._nodes[t]
    base, eps = eng_u.refactor_batched(a_dev, stop=(t, 0))
    lo, hi = step.off, step.off + step.nr * step.w
    pan = base[:, lo:hi].clone()
    g, r = base.clone(), base.clone()
    ng = torch.zeros(K, dtype=torch.int32, device=base.device)
    nr_ = torch.zeros_like(ng)
    before = supsup_ops.node_edges_wide.launches
    supsup_ops.node_edges_inplace(g, eng_u._edges, step, eps, ng)
    supsup_ops.node_edges_plain(r, eng_u._edges, step, eps, nr_)
    torch.cuda.synchronize()
    check(supsup_ops.node_edges_wide.launches == before + 1,
          "node_edges_wide: the node step did not run the wide instance")
    check(torch.equal(ng, nr_), "node_edges_wide: perturbation counts differ")
    check(torch.equal(_bits(torch, g[:, :lo]), _bits(torch, base[:, :lo]))
          and torch.equal(_bits(torch, g[:, hi:]), _bits(torch, base[:, hi:])),
          "node_edges_wide: a slot outside the node's panel changed")
    err = float((g[:, lo:hi] - r[:, lo:hi]).abs().max())
    check(bool(torch.allclose(g[:, lo:hi], r[:, lo:hi], rtol=TOL["float64"],
                              atol=TOL["float64"])),
          f"node_edges_wide: max |kernel - plain| = {err}")
    nper = torch.zeros_like(ng)

    def restore():
        g[:, lo:hi].copy_(pan)

    r_ms = bench_ms(torch, restore)
    flops, nbytes = kc.node_work(plan, t, 8, K)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float64"]
    nd = nodes[t]
    rec = {"name": "node_edges_wide", "route": "cuda",
           "source": "src/repro_torch/csrc/gemm_update.cu",
           "replaces": "src/repro/kernels/supsup/kernel.py:21",
           "wrapper": "node_edges_wide",
           "shape": f"node {t} in place ({K}, {step.nr}, {step.w}), "
                    f"{step.e1 - step.e0} edges, widest source "
                    f"{step.kmax} rows (wide_source_matrix, pardiso_like, "
                    "unrolled)",
           "edge_ks": sorted(nodes[e.src].nr for e in nd.edges),
           "max_abs_err": err, "tol": TOL["float64"], "restore_ms": r_ms,
           "ms": bench_ms(torch, lambda: (restore(), supsup_ops.
                                          node_edges_inplace(
                                              g, eng_u._edges, step, eps,
                                              nper))) - r_ms,
           "plain_ms": bench_ms(torch, lambda: (restore(), supsup_ops.
                                                node_edges_plain(
                                                    g, eng_u._edges, step,
                                                    eps, nper))) - r_ms,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None,
           "library_none_because": "no single PyTorch call runs a node's "
                                   "edge loop (per edge a gather, a "
                                   "triangular solve, a product and a "
                                   "scatter)"}
    del g, r, base
    return rec


def inplace_ms(torch, fn, restore, reps=5):
    """Median time of one call of ``fn`` that works in place, by CUDA
    events around the call; ``restore()`` copies the recorded values back
    before each call, outside the timed events (a data-dependent index
    keeps such a call out of a CUDA graph)."""
    restore()
    fn()
    times = []
    for _ in range(reps):
        restore()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return _median(times)


def wide_bucket(torch, np, panel_ops, rng, K, members, nrp, dev):
    """A value buffer (K, slots) holding one panel bucket of ``members``
    (nr, lsize, usize), dominant random panels with shuffled rows, padded
    to ``nrp`` rows, and its :class:`BucketLayout`: slots past the members
    are the zero, one and scratch slots.  Returns (vals, layout, real
    slots)."""
    desc, off = [], 0
    for nr, ls, us in members:
        desc.append((off, nr, ls + nr + us, ls, us))
        off += nr * (ls + nr + us)
    zero, one, scratch = off, off + 1, off + 2
    usp = max(us for _, _, us in members)
    lsp = max(ls for _, ls, _ in members)
    wu, wt = nrp + usp, nrp + usp + lsp
    gather, scat = panel_ops.bucket_maps(desc, nrp, wu, wt, zero, one,
                                         scratch)
    lay = panel_ops.bucket_layout(desc, nrp, wu, wt, zero, one, gather,
                                  scat, dev)
    vals = np.zeros((K, off + 3))
    vals[:, one] = 1.0
    for (o, nr, w, ls, _) in desc:
        p = rng.normal(size=(K, nr, w))
        p[:, :, ls:ls + nr] += 16 * np.eye(nr)
        rows = np.argsort(rng.random((K, nr)), axis=1)
        vals[:, o:o + nr * w] = np.take_along_axis(
            p, rows[:, :, None], axis=1).reshape(K, -1)
    return torch.from_numpy(vals).to(dev), lay, off


def wide_records(torch, np, eng, values0):
    """Kernel records of the wide paths on the card, float64: K2's
    (``panel_lu_wide``) on the 32 panels of pardiso_like's 150-row root
    as its factor program hands them (strided views of the value buffer),
    and at 256 and 300 rows (the window kernel in device memory, then
    ``panel_lu_kernel``) on dominant random panels; K1's
    (``panel_lu_bucket_wide``) on buckets of two members padded to 256
    and 512 rows (in place; gather, ``panel_lu_kernel``, write-back);
    K3's wide right solve at k = 140, 256 and 600 on 256 rows of X, and
    its wide left solves at k = 150 on the root's diagonal block of the
    finished factors, m = 1 — each held to its plain version, with its
    time, the plain version's, the library's and the bound (K3's also
    its launches per call, which must be the one wide kernel, and its
    and the library's device time by CUDA-graph replay).  Then K3's wide
    bfloat16 instances on the same operands rounded to bfloat16 (records
    ``..._wide_bf16``): bit-equal to the plain version summed in the
    kernels' order (``ref.*_bf16_ordered``), their difference from the
    plain version itself reported (:func:`bf16_err`: where x - bf16(S)
    cancels, one ulp of S from cuBLAS's summation order is many ulps of
    the entry), one launch a call, no library call (``solve_triangular``
    takes no bfloat16 on the card), the ptxas lines of their kernels."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.panel import ops as panel_ops
    from repro_torch.kernels.trisolve import ops as trisolve_ops
    from repro_torch.kernels.trisolve import ref as trisolve_ref

    dev, plan, sched = eng.device, eng.plan, eng.sched
    nodes = plan.nodes
    K = values0.shape[0]
    a_dev = torch.from_numpy(values0).to(dev)
    st, t_root = max(((i, int(t_)) for i, s_ in enumerate(sched.steps)
                      for t_ in s_.seq), key=lambda it: nodes[it[1]].nr)
    nd = nodes[t_root]
    vals, eps = eng.refactor_batched(a_dev, stop=(st, "seq"))
    off = int(plan.panel_offset[t_root])
    root = vals[:, off:off + nd.nr * nd.width].view(K, nd.nr, nd.width)
    rng = np.random.default_rng(23)

    def dominant(nr, ls, us):
        p = rng.normal(size=(K, nr, ls + nr + us))
        p[:, :, ls:ls + nr] += 16 * np.eye(nr)
        rows = np.argsort(rng.random((K, nr)), axis=1)
        return torch.from_numpy(np.take_along_axis(
            p, rows[:, :, None], axis=1)).to(dev)

    e = eps.to(torch.float64)
    shapes = {"": (root, nd.nr, nd.lsize),
              "_nr256": (dominant(256, 40, 8), 256, 40),
              "_nr300": (dominant(300, 40, 8), 300, 40)}
    k2 = {"name": "panel_lu_wide", "route": "cuda",
          "source": "src/repro_torch/csrc/panel_lu.cu",
          "replaces": "src/repro/kernels/panel/kernel.py:23",
          "wrapper": "panel_lu_wide"}
    for sfx, (P, nr, ls) in shapes.items():
        w = P.shape[2]
        got = panel_ops.panel_lu(P, nr, ls, e)
        want = panel_ops.panel_lu_plain(P, ls, w, e)
        torch.cuda.synchronize()
        check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
              f"panel_lu_wide{sfx}: pivots or perturbation counts differ")
        err = float((got[0] - want[0]).abs().max())
        check(bool(torch.allclose(got[0], want[0], rtol=TOL["float64"],
                                  atol=TOL["float64"])),
              f"panel_lu_wide{sfx}: max |kernel - plain| = {err}")
        t_bytes = ((2 * P.numel() + K) * 8 + K * (nr + 1) * 4) \
            / HBM_BYTES_PER_S
        t_ops = kc.lu_flops(K, nr, ls, w) / PEAK_FLOPS["float64"]
        k2.update({
            "shape" + sfx: f"({K}, {nr}, {w}) lsize={ls}",
            "max_abs_err" + sfx: err, "tol" + sfx: TOL["float64"],
            "rows_moved" + sfx: int((got[1] != torch.arange(
                nr, device=dev)).sum()),
            "ms" + sfx: bench_ms(torch, lambda: panel_ops.panel_lu(
                P, nr, ls, e)),
            "plain_ms" + sfx: bench_ms(torch, lambda: panel_ops.panel_lu_plain(
                P, ls, w, e)),
            "bound_ms" + sfx: max(t_bytes, t_ops) * 1e3,
            "bound_by" + sfx: "bytes" if t_bytes >= t_ops else "operations",
            "library_ms" + sfx: None})
    k2["library_none_because"] = ("no single PyTorch call computes a "
                                  "threshold-pivoted LU restricted to the "
                                  "block, with perturbation")
    # K1's wide path on buckets padded to 256 (in place, the window kernel
    # with its window in device memory) and 512 rows (gather,
    # panel_lu_kernel, write-back)
    k1 = {"name": "panel_lu_bucket_wide", "route": "cuda",
          "source": "src/repro_torch/csrc/panel_lu.cu",
          "replaces": "src/repro/kernels/panel/kernel.py:59",
          "wrapper": "panel_lu_bucket_wide"}
    for sfx, members, nrp in (("", ((140, 40, 8), (136, 32, 6)), 256),
                              ("_nrp512", ((300, 40, 8), (280, 32, 6)),
                               512)):
        v0, lay, n_real = wide_bucket(torch, np, panel_ops, rng, K, members,
                                      nrp, dev)
        v_k, v_p = v0.clone(), v0.clone()
        got = panel_ops.panel_lu_bucket_wide(v_k, lay, e)
        want = panel_ops.panel_lu_bucket_plain(v_p, lay, e)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"panel_lu_bucket_wide{sfx}: pivots or perturbation counts "
              "differ")
        check(torch.equal(v_k[:, n_real:], v0[:, n_real:]),
              f"panel_lu_bucket_wide{sfx}: wrote a slot outside the members")
        err = float((v_k[:, :n_real] - v_p[:, :n_real]).abs().max())
        check(bool(torch.allclose(v_k[:, :n_real], v_p[:, :n_real],
                                  rtol=TOL["float64"], atol=TOL["float64"])),
              f"panel_lu_bucket_wide{sfx}: max |kernel - plain| = {err}")
        flops, nbytes = bucket_work(lay, K, 8)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[
            "float64"]
        k1.update({
            "shape" + sfx: f"K {K} x members (nr, lsize, usize) "
                           f"{list(members)}, padded ({lay.nr}, {lay.wt})",
            "max_abs_err" + sfx: err, "tol" + sfx: TOL["float64"],
            "ms" + sfx: inplace_ms(
                torch, lambda: panel_ops.panel_lu_bucket_wide(v_k, lay, e),
                lambda: v_k.copy_(v0)),
            "plain_ms" + sfx: inplace_ms(
                torch, lambda: panel_ops.panel_lu_bucket_plain(v_p, lay, e),
                lambda: v_p.copy_(v0)),
            "bound_ms" + sfx: max(t_bytes, t_ops) * 1e3,
            "bound_by" + sfx: "bytes" if t_bytes >= t_ops else "operations",
            "library_ms" + sfx: None})
        del v0, v_k, v_p
    k1["library_none_because"] = k2["library_none_because"]
    # K3's wide right solve at k = 140, 256 and 600, 256 rows of X
    k3r = {"name": "trsm_right_wide", "route": "cuda",
           "source": "src/repro_torch/csrc/trsm.cu",
           "replaces": "src/repro/kernels/trisolve/kernel.py:21",
           "wrapper": "trsm_right_wide"}
    nrx, reps = 256, 20
    right_ops = {}
    for sfx, k in (("", 140), ("_k256", 256), ("_k600", 600)):
        u = torch.from_numpy(rng.normal(size=(K, k, k))
                             + 16 * np.eye(k)).to(dev)
        x = torch.from_numpy(rng.normal(size=(K, nrx, k))).to(dev)
        right_ops[sfx] = (u, x)

        def call():
            return trisolve_ops.trsm_batched(u, x)

        def lib():
            return torch.linalg.solve_triangular(u, x, upper=True,
                                                 left=False)

        entries = launched_entries(call)
        check(entries == ["hylu_trsm_right_wide_f64"],
              f"trsm_right_wide{sfx}: one call launched {entries}")
        got, want = call(), trisolve_ops.trsm_plain(u, x)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.allclose(got, want, rtol=TOL["float64"],
                                  atol=TOL["float64"])),
              f"trsm_right_wide{sfx}: max |kernel - plain| = {err}")
        t_bytes = (K * k * (k + 1) // 2 + 2 * x.numel()) * 8 \
            / HBM_BYTES_PER_S
        t_ops = float(K * nrx * k * k) / PEAK_FLOPS["float64"]
        lib_dev = lib_graph_ms(torch, [lib] * reps)
        k3r.update({
            "shape" + sfx: f"u ({K}, {k}, {k}) x ({K}, {nrx}, {k})",
            "launches_per_call" + sfx: len(entries),
            "max_abs_err" + sfx: err, "tol" + sfx: TOL["float64"],
            "ms" + sfx: bench_ms(torch, call),
            "device_ms" + sfx: graph_ms(torch, [call] * reps) / reps,
            "plain_ms" + sfx: bench_ms(torch, lambda: trisolve_ops.trsm_plain(
                u, x)),
            "bound_ms" + sfx: max(t_bytes, t_ops) * 1e3,
            "bound_by" + sfx: "bytes" if t_bytes >= t_ops else "operations",
            "library_ms" + sfx: bench_ms(torch, lib),
            "library_device_ms" + sfx: (None if lib_dev is None
                                        else lib_dev / reps)})
    # K3's wide left solves on the root's diagonal block
    f = eng.refactor_batched(a_dev)
    blk_slots = next(b_[-1] for b_ in eng._blocks if b_[1] == nd.nr)
    blk = f.vals[:, blk_slots].contiguous()
    k = nd.nr
    rhs = torch.from_numpy(rng.normal(size=(K, k, 1))).to(dev)
    lower = torch.tril(blk, -1) + torch.eye(k, dtype=blk.dtype, device=dev)
    out = [k2, k1, k3r]
    for name, fn, plain, lib, flops, tri in (
            ("trsm_left_unit_lower_wide",
             trisolve_ops.trsm_left_unit_lower_batched,
             trisolve_ops.trsm_left_unit_lower_plain,
             lambda: torch.linalg.solve_triangular(
                 lower, rhs, upper=False, unitriangular=True),
             float(K * k * (k - 1)), K * k * (k - 1) // 2),
            ("trsm_left_upper_wide", trisolve_ops.trsm_left_upper_batched,
             trisolve_ops.trsm_left_upper_plain,
             lambda: torch.linalg.solve_triangular(blk, rhs, upper=True),
             float(K * k * k), K * k * (k + 1) // 2)):
        entries = launched_entries(lambda: fn(blk, rhs))
        check(entries == [f"hylu_{name}_f64"],
              f"{name}: one call launched {entries}")
        got, want = fn(blk, rhs), plain(blk, rhs)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.allclose(got, want, rtol=TOL_LEFT["float64"],
                                  atol=TOL_LEFT["float64"])),
              f"{name}: max |kernel - plain| = {err}")
        t_bytes = (tri + 2 * rhs.numel()) * 8 / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS["float64"]
        lib_dev = lib_graph_ms(torch, [lib] * reps)
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/trsm.cu",
            "replaces": "src/repro/kernels/trisolve/kernel.py:21",
            "wrapper": name,
            "shape": f"blk ({K}, {k}, {k}) b ({K}, {k}, 1)",
            "launches_per_call": len(entries),
            "max_abs_err": err, "tol": TOL_LEFT["float64"],
            "ms": bench_ms(torch, lambda: fn(blk, rhs)),
            "device_ms": graph_ms(torch, [lambda: fn(blk, rhs)] * reps)
            / reps,
            "plain_ms": bench_ms(torch, lambda: plain(blk, rhs)),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": bench_ms(torch, lib),
            "library_device_ms": None if lib_dev is None else lib_dev / reps})
    # the bfloat16 instances on the same operands
    bf = torch.bfloat16
    log = _build.last_build["log"]
    ptx = {"trsm_right": ("trsm_right_wide_kernel", "nv_bfloat16"),
           "trsm_left_unit_lower": ("trsm_left_wide_kernel",
                                    "nv_bfloat16Lb0"),
           "trsm_left_upper": ("trsm_left_wide_kernel", "nv_bfloat16Lb1")}
    bf_recs = {}
    for name, (needle, *more) in ptx.items():
        bf_recs[name] = {
            "name": f"{name}_wide_bf16", "route": "cuda",
            "source": "src/repro_torch/csrc/trsm.cu",
            "replaces": "src/repro/kernels/trisolve/kernel.py:21",
            "wrapper": f"{name}_wide", "dtype": "bfloat16",
            "entry": f"hylu_{name}_wide_bf16",
            "tol": "bit-equal to the plain version summed in the kernel's "
                   "order (ref.*_bf16_ordered); against the plain version "
                   "itself reported, not held",
            "library_note": "no library call: solve_triangular is not "
                            "implemented for bfloat16 on CUDA",
            "ptxas": [ln for ln in ptxas_of(log, needle)
                      if all(m in ln for m in more)]}

    def bf16_case(rec, sfx, shape, entry, call, plain, ordered, flops,
                  elems):
        entries = launched_entries(call)
        check(entries == [entry], f"{rec['name']}{sfx}: one call launched "
                                  f"{entries}")
        got, want, seq = call(), plain(), ordered()
        torch.cuda.synchronize()
        _, _, n_ord, n_over = bf16_err(torch, got, seq, exact=True)
        check(n_over == 0, f"{rec['name']}{sfx}: {n_ord} entries differ "
              "from the plain version summed in the kernel's order")
        e_, ulps, n_diff, n_far = bf16_err(torch, got, want)
        t_bytes = elems * 2 / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS["float32"]
        rec.update({
            "shape" + sfx: shape, "launches_per_call" + sfx: len(entries),
            "entries_differing_ordered" + sfx: n_ord,
            "max_abs_err" + sfx: e_, "max_ulps_of_entry" + sfx: ulps,
            "entries_differing" + sfx: n_diff,
            "entries_over_bf16_ulps" + sfx: n_far,
            "entries" + sfx: int(want.numel()),
            "ms" + sfx: bench_ms(torch, call),
            "device_ms" + sfx: graph_ms(torch, [call] * reps) / reps,
            "plain_ms" + sfx: bench_ms(torch, plain),
            "bound_ms" + sfx: max(t_bytes, t_ops) * 1e3,
            "bound_by" + sfx: "bytes" if t_bytes >= t_ops else "operations",
            "library_ms" + sfx: None})

    for sfx, (u, x) in right_ops.items():
        u16, x16 = u.to(bf), x.to(bf)
        k = u.shape[-1]
        bf16_case(bf_recs["trsm_right"], sfx,
                  f"u ({K}, {k}, {k}) x ({K}, {nrx}, {k})",
                  "hylu_trsm_right_wide_bf16",
                  lambda: trisolve_ops.trsm_batched(u16, x16),
                  lambda: trisolve_ops.trsm_plain(u16, x16),
                  lambda: trisolve_ref.trsm_bf16_ordered(u16, x16),
                  float(K * nrx * k * k),
                  K * k * (k + 1) // 2 + 2 * x16.numel())
    blk16, rhs16 = blk.to(bf), rhs.to(bf)
    k = nd.nr
    for name, fn, plain, ordered, flops, tri in (
            ("trsm_left_unit_lower",
             trisolve_ops.trsm_left_unit_lower_batched,
             trisolve_ops.trsm_left_unit_lower_plain,
             trisolve_ref.trsm_left_unit_lower_bf16_ordered,
             float(K * k * (k - 1)), K * k * (k - 1) // 2),
            ("trsm_left_upper", trisolve_ops.trsm_left_upper_batched,
             trisolve_ops.trsm_left_upper_plain,
             trisolve_ref.trsm_left_upper_bf16_ordered, float(K * k * k),
             K * k * (k + 1) // 2)):
        bf16_case(bf_recs[name], "", f"blk ({K}, {k}, {k}) b ({K}, {k}, 1)",
                  f"hylu_{name}_wide_bf16",
                  lambda fn=fn: fn(blk16, rhs16),
                  lambda plain=plain: plain(blk16, rhs16),
                  lambda ordered=ordered: ordered(blk16, rhs16), flops,
                  tri + 2 * rhs16.numel())
    out.extend(bf_recs.values())
    del vals, f, right_ops
    return out


def spsolve_oracle(a, b):
    """float64 reference solution by scipy's sparse LU: independent of the
    solver stack, and affordable at n = 10,000 where a dense solve is not."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    m = sp.csr_matrix((a.data, a.indices, a.indptr), shape=(a.n, a.n))
    return np.asarray(spla.spsolve(m.tocsc(), np.asarray(b, np.float64)))


def solver_stream(np, A, C):
    """The serving_solver phase's requests, in a seeded order: healthy
    fem2d_10k traffic (values A.data x U(0.8, 1.2), four of them with an
    (n, 2) right-hand side), healthy circuit traffic, and the faults on
    each pattern (``SERVING_FAULTS``), each with the statuses it may end
    in and, where it must be solved, its spsolve solution."""
    from repro_torch.core import CSR
    from repro_torch.serve import faultinject as fi

    rng = np.random.default_rng(22)
    items = []
    for pat, n_healthy, n_wide, name in ((A, SERVING_HEALTHY[0], 4, "fem"),
                                         (C, SERVING_HEALTHY[1], 0, "cir")):
        for i in range(n_healthy):
            a = CSR(pat.n, pat.indptr, pat.indices,
                    pat.data * rng.uniform(0.8, 1.2, pat.nnz))
            b = rng.normal(size=(pat.n, 2) if i < n_wide else pat.n)
            items.append(fi.Injected(a, b, oracle_x=spsolve_oracle(a, b),
                                     tag=(name, "healthy", i)))
        for j, kind in enumerate(SERVING_FAULTS[name]):
            items.append(fi.inject(kind, pat, seed=100 + j,
                                   tag=(name, kind), oracle=spsolve_oracle))
    return [items[i] for i in rng.permutation(len(items))]


def serving_solver_phase(torch, np, kernels, A, an64, C, anc):
    """Phase 10: solver serving at the corpus's FEM size.  The analyses of
    fem2d_10k and circuit_like(2000, seed 3) are put into a PlanCache on a
    temporary directory; a fresh SolverService on that directory serves a
    mixed, fault-laced stream (``solver_stream``) twice, once by
    ``solve_batch`` and once through an AsyncSolverServer by
    ``faultinject.run_stream``.  Its healthy traffic must load both plans
    from disk and analyze nothing; only the retries of the ladder analyze
    (a boosted perturb_eps is a new fingerprint).  Returns the launches of
    the two runs by wrapper."""
    import asyncio
    import dataclasses
    import tempfile

    import repro_torch.serve.solver_service as ss
    from repro_torch.core import HyluOptions, PlanCache
    from repro_torch.core.options import (plan_fingerprint,
                                          resolve_retry_perturb)
    from repro_torch.serve import faultinject as fi
    from repro_torch.serve.async_server import AsyncSolverServer

    t_all = time.perf_counter()
    stream = solver_stream(np, A, C)
    t_stream = time.perf_counter() - t_all
    dispatches = []                      # (n, k, factor ms, solve ms)
    real_factor, real_solve = ss.factor_batched, ss.solve_batched

    def factor_spy(an, pattern, vb):
        t0 = time.perf_counter()
        out = real_factor(an, pattern, vb)
        dispatches.append([an.n, len(vb), (time.perf_counter() - t0) * 1e3])
        return out

    def solve_spy(bst, bb):
        t0 = time.perf_counter()
        out = real_solve(bst, bb)
        dispatches[-1].append((time.perf_counter() - t0) * 1e3)
        return out

    with tempfile.TemporaryDirectory(prefix="hylu_plan_cache_") as tmp:
        t0 = time.perf_counter()
        fps = [PlanCache(directory=tmp).put(an) for an in (an64, anc)]
        put_s = time.perf_counter() - t0
        svc = ss.SolverService(cache_dir=tmp, batch_size=8,
                               opts=HyluOptions(retry_max=1))
        ss.factor_batched, ss.solve_batched = factor_spy, solve_spy
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held_before = torch.cuda.memory_allocated()   # earlier phases' tensors
        kernels.reset_launch_counts()
        try:
            t0 = time.perf_counter()
            results = svc.solve_batch([ss.SolveRequest(a=it.a, b=it.b,
                                                       tag=it.tag)
                                       for it in stream])
            sync_s = time.perf_counter() - t0
            sync_cache = dict(svc.cache.stats)
            sync_stats = dict(svc.stats)
            n_sync = len(dispatches)

            async def drive():
                async with AsyncSolverServer(svc, max_queue_per_group=64,
                                             max_pending=256,
                                             max_linger_ms=50.0) as server:
                    t = time.perf_counter()
                    rep = await fi.run_stream(server, stream, warmup=False)
                    rep["wall_s"] = time.perf_counter() - t
                    return rep

            report = asyncio.run(drive())
        finally:
            ss.factor_batched, ss.solve_batched = real_factor, real_solve
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        cached = set(svc.cache.fingerprints())

    sync = fi.score_outcomes(stream, [
        (it, r.status, r.error and r.error.code, r)
        for it, r in zip(stream, results)])
    retry_opts = dataclasses.replace(
        svc.opts, perturb_eps=resolve_retry_perturb(svc.opts, 1))
    retry_fps = {plan_fingerprint(it.a, retry_opts)
                 for it, r in zip(stream, results) if r.n_retries}
    lat_sync = sync_s * 1e3          # every request returns with the call
    srv = report["server_stats"]

    def per_pattern(rows):
        out = {}
        for n, k, f_ms, s_ms in rows:
            d = out.setdefault(str(n), {"dispatches": 0, "systems": 0,
                                        "factor_ms": [], "solve_ms": []})
            d["dispatches"] += 1
            d["systems"] += k
            d["factor_ms"].append(f_ms)
            d["solve_ms"].append(s_ms)
        return out

    wrappers = ("panel_lu_bucket_inplace", "panel_lu", "trsm_batched",
                "trsm_left_unit_lower_batched", "trsm_left_upper_batched",
                "gemm_batched")
    rec = {"phase": "serving_solver",
           "patterns": {"fem2d_10k": A.n, "circuit_like(2000, seed=3)": C.n},
           "requests": len(stream), "batch_size": 8, "retry_max": 1,
           "solve_batch": {"wall_s": sync_s,
                           "requests_per_s": len(stream) / sync_s,
                           "p50_ms": lat_sync, "p99_ms": lat_sync,
                           "by_status": sync["by_status"],
                           "lost": sync["lost"],
                           "violations": fi.check_report(sync)[:10],
                           "worst_healthy_err": sync["worst_healthy_err"],
                           "dispatches": per_pattern(dispatches[:n_sync]),
                           "service": sync_stats, "cache": sync_cache},
           "async": {"wall_s": report["wall_s"],
                     "requests_per_s": len(stream) / report["wall_s"],
                     "p50_ms": srv["p50_ms"], "p99_ms": srv["p99_ms"],
                     "by_status": report["by_status"],
                     "lost": report["lost"],
                     "violations": fi.check_report(report)[:10],
                     "worst_healthy_err": report["worst_healthy_err"],
                     "n_healthy_checked": report["n_healthy_checked"],
                     "dispatch_batches": srv["dispatch_batches"],
                     "deadline_misses": srv["deadline_misses"],
                     "dispatches": per_pattern(dispatches[n_sync:])},
           "cache": {"put_s": put_s, **svc.cache.stats,
                     "retry_fingerprints": len(retry_fps)},
           "service": dict(svc.stats),
           "launches": {w: counts[w] for w in wrappers},
           "max_memory_allocated": peak,
           "memory_allocated_before": held_before,
           "peak_over_before": peak - held_before,
           "stream_build_s": t_stream,
           "seconds": time.perf_counter() - t_all}
    emit(rec)
    for name, run in (("solve_batch", rec["solve_batch"]),
                      ("async", rec["async"])):
        check(run["lost"] == 0 and not run["violations"],
              f"serving {name}: {run['lost']} lost, violations "
              f"{run['violations']}")
    check(sync_cache["disk_hits"] == 2 and svc.cache.stats["disk_hits"] == 2,
          f"plans not loaded from disk: {svc.cache.stats}")
    check(svc.cache.stats["analyze_calls"] == len(retry_fps)
          and cached == set(fps) | retry_fps,
          f"healthy traffic analyzed: {svc.cache.stats}, "
          f"{len(retry_fps)} retry plans")
    for w in wrappers:
        check(counts[w] > 0, f"kernel {w} was not launched by serving")
    return counts


def layer_input(T, L, cfg, params, prompt, layer):
    """The model's forward stopped at sub-layer ``layer`` (every layer of
    the served models is one attention or one RWKV6 block): its input
    through ``ln1`` — what its attention or time-mix receives — and that
    layer's params."""
    kind, fkind = cfg.layer_kinds()[0], cfg.ffn_kinds()[0]
    x = params["embed"][prompt]
    positions = torch_arange_like(prompt)
    for i in range(layer):
        x, _, _ = T._sublayer_seq(cfg, kind, fkind,
                                  T.layer_slice(params["blocks"][0], i),
                                  x, positions, False, True)
    sub = T.layer_slice(params["blocks"][0], layer)
    return L.rms_norm(x, sub["ln1"], cfg.norm_eps), sub


def torch_arange_like(prompt):
    """The positions of a (B, T) prompt, as the forward makes them."""
    import torch

    b, t = prompt.shape
    return torch.arange(t, device=prompt.device)[None].expand(b, t)


def flash_record(torch, L, T, cfg, params, prompt):
    """Phase 11 for phi3-medium: K7 on the q/k/v its first and last
    attention layers make (the (B, H, T, D) views of the (B, T, H, D)
    projections that ``attention_seq`` hands the kernel), bfloat16 as
    served and float32, held to its plain version on both layers and timed
    on the first."""
    import torch.nn.functional as F

    from repro_torch.kernels.flashattn import ops as flash

    t = time.perf_counter()
    positions = torch_arange_like(prompt)
    last = cfg.n_layers - 1
    layers = {}
    for layer in (0, last):
        h, sub = layer_input(T, L, cfg, params, prompt, layer)
        layers[layer] = [a.transpose(1, 2) for a in L.attention_qkv(
            cfg, sub["attn"], h, positions)]
        del h
    q, k, v = layers[0]
    b, hq, tq, d = q.shape
    rec = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attn.cu",
           "replaces": "src/repro/kernels/flashattn/kernel.py:28",
           "shape": f"q ({b}, {hq}, {tq}, {d}) k, v ({b}, {k.shape[1]}, "
                    f"{tq}, {d}), causal, phi3-medium-14b layer 0 (timed) "
                    f"and layer {last} (held)",
           "dtype": "bfloat16", "layers_held": [0, last]}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).replace("torch.", "")
        sfx = "" if dt == torch.bfloat16 else "_f32"
        for layer, qkv in layers.items():
            tag = "" if layer == 0 else "_last"
            lops = [a.to(dt) for a in qkv]
            cases = {"": (lops, True),
                     "_ragged": ([a[:, :, :RAGGED_T] for a in lops], True),
                     "_noncausal": (lops, False)}
            for label, (args, causal) in cases.items():
                got = flash.flash_attention(*args, causal=causal).float()
                ref = flash.attention_plain(*args, causal=causal).float()
                torch.cuda.synchronize()
                diff = (got - ref).abs()
                err = float(diff.max())
                rtol, atol = TOL_MODEL[dname]
                ratio = float((diff / (atol + rtol * ref.abs())).max())
                check(ratio <= 1.0, f"flash_attention {dname} layer {layer}"
                                    f"{label}: |kernel - plain| up to {ratio} "
                                    f"times rtol={rtol}, atol={atol} (max "
                                    f"{err})")
                rec["max_abs_err" + label + tag + sfx] = err
                rec["max_err_over_limit" + label + tag + sfx] = ratio
                del got, ref, diff
            del lops
        ops = [a.to(dt) for a in (q, k, v)]
        flops, nbytes = kc.flash(b, hq, k.shape[1], tq, tq, d,
                                 ops[0].element_size())
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dname]
        rec.update({
            "rtol_atol" + sfx: TOL_MODEL[dname],
            "ms" + sfx: bench_ms(torch, lambda: flash.flash_attention(*ops)),
            "plain_ms" + sfx: bench_ms(
                torch, lambda: flash.attention_plain(*ops)),
            "bound_ms" + sfx: max(t_bytes, t_ops) * 1e3,
            "bound_by" + sfx: "bytes" if t_bytes >= t_ops else "operations",
            "library_ms" + sfx: bench_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    *ops, is_causal=True, enable_gqa=True))})
    rec["library"] = ("torch.nn.functional.scaled_dot_product_attention("
                      "is_causal=True, enable_gqa=True)")
    rec["ragged_t"] = RAGGED_T
    rec["design"] = {"bfloat16": "tensor cores: wgmma m64 (S = Q.K^T from "
                                 "shared memory, O += P.V with P in "
                                 "registers), TMA K/V ring with mbarriers, "
                                 "one producer warp, two consumer warpgroups",
                     "float32": "SIMT, exact float32 FMA"}
    rec.update(gemma_case(torch, F, flash))
    emit({"phase": "model_kernels", "model": cfg.name, "record": rec,
          "seconds": time.perf_counter() - t})
    return rec


def gemma_case(torch, F, flash):
    """K7 in bfloat16 at gemma-7b's attention shape (B 4, 16 query and KV
    heads, D 256, T = S = 2,048, causal) on random q/k/v from SEED in the
    model's (B, T, H, D) layout, against its plain version and beside SDPA."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    q, k, v = (torch.randn(BATCH, PROMPT, 16, 256, generator=gen,
                           device="cuda", dtype=torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    got = flash.flash_attention(q, k, v).float()
    ref = flash.attention_plain(q, k, v).float()
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    rtol, atol = TOL_MODEL["bfloat16"]
    ratio = float((diff / (atol + rtol * ref.abs())).max())
    err = float(diff.max())
    check(ratio <= 1.0, f"flash_attention bfloat16 (gemma-7b shape): |kernel "
                        f"- plain| up to {ratio} times the limit (max {err})")
    del got, ref, diff
    flops, nbytes = kc.flash(BATCH, 16, 16, PROMPT, PROMPT, 256,
                             q.element_size())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"]
    out = {"gemma_shape": f"q, k, v ({BATCH}, 16, {PROMPT}, 256), causal, "
                          "gemma-7b attention, random",
           "max_abs_err_gemma": err, "max_err_over_limit_gemma": ratio,
           "ms_gemma": bench_ms(torch, lambda: flash.flash_attention(q, k, v)),
           "plain_ms_gemma": bench_ms(
               torch, lambda: flash.attention_plain(q, k, v)),
           "bound_ms_gemma": max(t_bytes, t_ops) * 1e3,
           "bound_by_gemma": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms_gemma": bench_ms(
               torch, lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True))}
    del q, k, v
    torch.cuda.empty_cache()
    return out


def wkv_err(torch, got, ref):
    """K8 against its plain version: the largest |got - ref| and the largest
    |got - ref| / (TOL_WKV + TOL_WKV |ref|), at most 1 within the limit
    (``torch.allclose`` at rtol = atol = TOL_WKV; NaN fails)."""
    diff = (got - ref).abs()
    ratio = (diff / (TOL_WKV + TOL_WKV * ref.abs())).max()
    return float(diff.max()), float(ratio) if bool(torch.isfinite(
        ratio)) else float("inf")


def wkv_record(torch, L, T, cfg, params, prompt):
    """Phase 11 for rwkv6: K8 on the r/k/v/w its first and last time-mix
    layers make (the (B, H, T, hs) views ``rwkv_time_mix_seq`` hands the
    kernel), held on both and timed on the first; also on layer 0's r, k,
    v, u with decays drawn from [1e-6, 0.05] and with decays of exactly
    1.0, and its device time summed over one prefill's 24 launches by
    CUDA-graph replay of layer 0's call, beside both bound terms and
    ptxas's registers and spills of each head-size instance."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv import ops as wkvops

    t = time.perf_counter()
    last = cfg.n_layers - 1
    layers = {}
    for layer in (0, last):
        h, sub = layer_input(T, L, cfg, params, prompt, layer)
        r, k, v, w, u, _ = L.rwkv_wkv_inputs(cfg, sub["rwkv"], h)
        layers[layer] = ([a.transpose(1, 2) for a in (r, k, v, w)], u)
        del h, r, k, v, w
    ops, u = layers[0]
    b, nh, tq, hs = ops[0].shape
    rec = {"name": "wkv", "route": "cuda", "source": "src/repro_torch/csrc/wkv.cu",
           "replaces": "src/repro/kernels/wkv/kernel.py:26",
           "shape": f"r, k, v, w ({b}, {nh}, {tq}, {hs}) u ({nh}, {hs}), "
                    f"rwkv6-1.6b layer 0 (timed) and layer {last} (held)",
           "dtype": "float32", "layers_held": [0, last]}
    for layer, (lops, lu) in layers.items():
        tag = "" if layer == 0 else "_last"
        for label, args in (("", lops), ("_ragged", [a[:, :, :RAGGED_T]
                                                     for a in lops])):
            got = wkvops.wkv(*args, lu)
            ref = wkvops.wkv_plain(*args, lu)
            torch.cuda.synchronize()
            for part, g, r_ in (("", got[0], ref[0]),
                                ("_state", got[1], ref[1])):
                err, ratio = wkv_err(torch, g, r_)
                check(ratio <= 1.0, f"wkv layer {layer}{label}{part}: "
                                    f"|kernel - plain| up to {ratio} times "
                                    f"rtol=atol={TOL_WKV} (max {err})")
                rec["max_abs_err" + label + tag + part] = err
                rec["max_err_over_limit" + label + tag + part] = ratio
    # layer 0's r, k, v, u with the decays where a float32 redesign is most
    # likely to part from the plain version: near zero (a state of about
    # one step) and exactly one (a sum over all 2,048 steps)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    extreme = {"_tiny_decay": torch.empty_like(ops[3]).uniform_(
                   *WKV_TINY_DECAY, generator=gen),   # the model's strides
               "_unit_decay": torch.ones_like(ops[3])}
    for label, w_x in extreme.items():
        args = (*ops[:3], w_x)
        got = wkvops.wkv(*args, u)
        ref = wkvops.wkv_plain(*args, u)
        torch.cuda.synchronize()
        for part, g, r_ in (("", got[0], ref[0]), ("_state", got[1], ref[1])):
            err, ratio = wkv_err(torch, g, r_)
            check(ratio <= 1.0, f"wkv layer 0{label}{part}: |kernel - plain| "
                                f"up to {ratio} times rtol=atol={TOL_WKV} "
                                f"(max {err})")
            rec["max_abs_err" + label + part] = err
            rec["max_err_over_limit" + label + part] = ratio
        del got, ref
    del extreme, w_x
    # the least operations of the function, per step and head: k v^T, the
    # S update and y's sum over rows (5 hs^2), the bonus sum_k r u k and its
    # product with v (5 hs); the plain form r . (S + u k v^T) takes 7 hs^2
    flops, nbytes = kc.wkv(b, nh, tq, hs, u.numel())
    flops_plain = 7.0 * hs * hs * tq * b * nh
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]
    rec.update({"tol": TOL_WKV, "ragged_t": RAGGED_T, "steps": tq,
                "tiny_decay_range": WKV_TINY_DECAY,
                "ms": bench_ms(torch, lambda: wkvops.wkv(*ops, u)),
                "plain_ms": bench_ms(torch, lambda: wkvops.wkv_plain(*ops, u)),
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_bytes_ms": t_bytes * 1e3, "bound_ops_ms": t_ops * 1e3,
                "bytes": nbytes, "operations": flops,
                "operations_plain_form": flops_plain,
                "bound_ops_ms_plain_form":
                    flops_plain / PEAK_FLOPS["float32"] * 1e3,
                "library_ms": None,
                "graph_replay_calls": cfg.n_layers,
                "prefill_device_ms": graph_ms(
                    torch, [lambda: wkvops.wkv(*ops, u)] * cfg.n_layers),
                "ptxas": ptxas_of(_build.last_build["log"], "wkv_kernel")})
    emit({"phase": "model_kernels", "model": cfg.name, "record": rec,
          "seconds": time.perf_counter() - t})
    return rec


def decode_vs_forward(torch, T, cfg, params, prompt):
    """Greedy decode of NEW_TOKENS after the prompt against the
    teacher-forced forward over the prompt and the generated tokens:
    (max |decode logits - forward logits|, the sequence, the prefill's
    logits)."""
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

    s = prompt.shape[1]
    prefill = make_prefill_step(cfg, s_max=s + NEW_TOKENS)
    decode = make_decode_step(cfg)
    logits, cache = prefill(params, tokens=prompt)
    steps, toks = [logits[:, -1]], [logits[:, -1].argmax(-1)]
    for i in range(NEW_TOKENS - 1):
        lg, cache = decode(params, toks[-1][:, None], cache, s + i)
        steps.append(lg[:, -1])
        toks.append(lg[:, -1].argmax(-1))
    seq = torch.cat([prompt, torch.stack(toks[:-1], 1)], 1)
    hidden, _, _ = T.forward(cfg, params, tokens=seq)
    full = T.lm_logits(cfg, params, hidden[:, s - 1:])
    return float((torch.stack(steps, 1) - full).abs().max()), seq, logits


def f32_checks(torch, T, cfg, prompt):
    """decode ≡ teacher-forced forward, and the kernel route against
    ``use_kernels=False``, in float32 at full width and 2 layers."""
    import dataclasses

    from repro_torch.serve.serve_step import make_prefill_step

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = T.init_params(cfg2, seed=SEED, dtype=torch.float32)
    decode_err, seq, logits = decode_vs_forward(torch, T, cfg2, params,
                                                prompt)
    plain, _ = make_prefill_step(cfg2, use_kernels=False)(params,
                                                          tokens=prompt)
    route_err = float((plain[:, -1] - logits[:, -1]).abs().max())
    check(decode_err < TOL_DECODE, f"{cfg.name} f32 2 layers: decode vs "
                                   f"forward {decode_err} >= {TOL_DECODE}")
    check(route_err < TOL_DECODE, f"{cfg.name} f32 2 layers: kernel vs plain "
                                  f"route {route_err} >= {TOL_DECODE}")
    return {"decode_vs_forward_max_abs": decode_err,
            "kernel_vs_plain_route_max_abs": route_err,
            "teacher_forced_tokens": int(seq.shape[1])}


def f32_routes(torch, T, cfg, prompt):
    """rwkv6 at full width and F32_ROUTE_LAYERS layers in float32: the
    kernel route's prefill logits against ``use_kernels=False``'s, where
    only the order of the WKV sums differs, to set beside the bfloat16
    routes' difference."""
    import dataclasses

    from repro_torch.serve.serve_step import greedy_generate, make_prefill_step

    cfg = dataclasses.replace(cfg, n_layers=F32_ROUTE_LAYERS)
    params = T.init_params(cfg, seed=SEED, dtype=torch.float32)
    got, _ = make_prefill_step(cfg)(params, tokens=prompt)
    ref, _ = make_prefill_step(cfg, use_kernels=False)(params, tokens=prompt)
    got, ref = got[:, -1], ref[:, -1]
    tokens = [greedy_generate(cfg, params, prompt, NEW_TOKENS, use_kernels=u)
              for u in (True, False)]
    del params
    return {"last_logits_max_abs": float((got - ref).abs().max()),
            "last_logits_max": float(ref.abs().max()),
            "greedy_token_agreement": float(
                (tokens[0] == tokens[1]).float().mean())}


def serving_phase(torch, np, kernels, cfg):
    """Phases 9 and 10 for one model; returns its kernel's record for the
    kernels line, with the launches of the main path's run."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serve.serve_step import (greedy_generate,
                                              make_decode_step,
                                              make_prefill_step)

    t_all = time.perf_counter()
    attn = cfg.layer_kinds()[0] == "attn"
    wrapper = "flash_attention" if attn else "wkv"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(a.numel() for a in _leaves(params))
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (BATCH, PROMPT))).cuda()
    torch.cuda.reset_peak_memory_stats()
    rec = (flash_record if attn else wkv_record)(torch, L, T, cfg, params,
                                                 prompt)
    check_peak = torch.cuda.max_memory_allocated()

    # ---- 10. the serving path -------------------------------------------
    # the peak of serving alone: weights, caches and the path's activations
    t = time.perf_counter()
    kernels.reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tokens = greedy_generate(cfg, params, prompt, NEW_TOKENS)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    path_counts = kernels.launch_counts()
    # the same requests step by step through the steps greedy_generate runs
    prefill = make_prefill_step(cfg, s_max=PROMPT + NEW_TOKENS)
    decode = make_decode_step(cfg)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, tokens=prompt)
    nxt = logits[:, -1].argmax(-1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    per_prefill = kernels.launch_counts()
    finite = [bool(torch.isfinite(logits).all())]
    last_kernel = logits[:, -1].float()
    out, step_s = [nxt], []
    kernels.reset_launch_counts()
    for i in range(NEW_TOKENS - 1):
        t0 = time.perf_counter()
        lg, cache = decode(params, out[-1][:, None], cache, PROMPT + i)
        nxt = lg[:, -1].argmax(-1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        finite.append(bool(torch.isfinite(lg).all()))
        out.append(nxt)
    per_decode = kernels.launch_counts()
    stepped = torch.stack(out, 1)
    peak = torch.cuda.max_memory_allocated()
    # the roofline of the timed calls (phase 19): one more prefill, and for
    # the attention model one decode step into the cache's last row
    kernels.reset_launch_counts()
    roof = [roofline_record(
        torch, f"{cfg.name} prefill ({BATCH} x {PROMPT}, bfloat16)",
        lambda: prefill(params, tokens=prompt), prefill_s * 1e3,
        expect=(f"hylu_{'flash_attn' if attn else 'wkv'}_",))]
    if attn:
        roof.append(roofline_record(
            torch, f"{cfg.name} decode step ({BATCH} x 1, bfloat16)",
            lambda: decode(params, out[-1][:, None], cache,
                           PROMPT + NEW_TOKENS - 1),
            1e3 * float(np.mean(step_s))))
    roof_counts = kernels.launch_counts()
    del cache, lg, logits
    # the plain route at full depth in bfloat16, beside the kernel route
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    plain_logits, plain_cache = make_prefill_step(cfg, use_kernels=False)(
        params, tokens=prompt)
    torch.cuda.synchronize()
    plain_prefill_s = time.perf_counter() - t0
    del plain_cache
    plain_tokens = greedy_generate(cfg, params, prompt, NEW_TOKENS,
                                   use_kernels=False)
    plain_counts = kernels.launch_counts()
    route_diff = float((plain_logits[:, -1].float() - last_kernel).abs().max())
    agree = float((plain_tokens == tokens).float().mean())
    del params, plain_logits
    torch.cuda.empty_cache()
    f32 = f32_checks(torch, T, cfg, prompt)
    torch.cuda.empty_cache()
    if not attn:
        f32["routes"] = f32_routes(torch, T, cfg, prompt)
        torch.cuda.empty_cache()
        err = f32["routes"]["last_logits_max_abs"]
        check(err < TOL_DECODE, f"{cfg.name} f32, {F32_ROUTE_LAYERS} "
                                f"layers: kernel vs plain route {err} >= "
                                f"{TOL_DECODE}")
    n_kernel_layers = cfg.n_layers          # every layer is attn or rwkv
    decode_ms = 1e3 * float(np.mean(step_s))
    res = {"phase": "transformer", "model": cfg.name, "dtype": "bfloat16",
           "batch": BATCH, "prompt_tokens": PROMPT, "new_tokens": NEW_TOKENS,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": n_params, "init_params_s": init_s,
           "greedy_generate_s": generate_s, "prefill_ms": prefill_s * 1e3,
           "prefill_tokens_per_s": BATCH * PROMPT / prefill_s,
           "decode_ms_per_step": decode_ms,
           "decode_ms_per_step_all": [x_ * 1e3 for x_ in step_s],
           "generated_tokens_per_s": BATCH * NEW_TOKENS / generate_s,
           "max_memory_allocated": peak,
           "weight_bytes": n_params * 2,
           "model_kernels_max_memory_allocated": check_peak,
           "launches_greedy_generate": path_counts[wrapper],
           "launches_per_prefill": per_prefill[wrapper],
           "launches_decode": per_decode[wrapper],
           "launches_plain_route": plain_counts[wrapper],
           "all_logits_finite": all(finite),
           "stepped_equals_greedy": bool(torch.equal(stepped, tokens)),
           "plain_route_prefill_ms": plain_prefill_s * 1e3,
           "bf16_route_last_logits_max_abs": route_diff,
           "bf16_route_greedy_token_agreement": agree,
           "f32_two_layers": f32, "seconds": time.perf_counter() - t,
           "phase_seconds": time.perf_counter() - t_all}
    emit(res)
    check(res["all_logits_finite"], f"{cfg.name}: non-finite bf16 logits")
    check(tokens.shape == (BATCH, NEW_TOKENS), f"{cfg.name}: tokens "
                                               f"{tuple(tokens.shape)}")
    check(res["stepped_equals_greedy"],
          f"{cfg.name}: step-by-step tokens differ from greedy_generate's")
    check(path_counts[wrapper] == per_prefill[wrapper] == n_kernel_layers,
          f"{cfg.name}: {wrapper} launched {path_counts[wrapper]} times by "
          f"greedy_generate, {per_prefill[wrapper]} by one prefill; "
          f"expected {n_kernel_layers} (one per layer)")
    check(not any(per_decode.values()),
          f"{cfg.name}: decode launched kernels {per_decode}")
    check(not any(plain_counts.values()),
          f"{cfg.name}: use_kernels=False launched kernels {plain_counts}")
    rec["launches"] = path_counts[wrapper]
    rec["launches_by_path"] = {"greedy_generate": path_counts[wrapper],
                               "per_prefill": per_prefill[wrapper],
                               "decode": per_decode[wrapper],
                               "roofline": roof_counts[wrapper]}
    rec["roofline"] = roof
    return rec


def repairs_phase(torch, np, kernels, A, an64, values0, b):
    """Phase 9d: the repairs of the port's faults at fem2d_10k.

    C1: bfloat16 with ``use_kernels=False`` on the card, where
    ``torch.linalg.solve_triangular`` takes no bfloat16: the bucketed
    schedule at K = 32 through ``factor_batched`` + ``solve_batched``
    (every x within 1e-10 of ``spsolve`` after the float64 fallback, no
    kernel launched, ms) with its first CPU_SYSTEMS factors held to the
    CPU's plain bfloat16 route (equal pivots and counts, the values by
    :func:`held_to_cpu`); the unrolled schedule's factor of CPU_SYSTEMS
    value sets (its solve is the same level-scheduled one) with equal
    pivots and counts to the CPU's, its differing entries printed: its
    per-edge bf16 products round as cuBLAS sums, now and then on the
    other side of a tie from the CPU's sum, and later edges carry that
    ulp on.
    C3: the one-system bfloat16 ``apply`` (level-scheduled, its row
    scatters in ordered passes) twice on the card on one factor of the
    kernel route, bit-identical to each other and to the CPU's ``apply``
    on the same factor."""
    import dataclasses

    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from repro_torch.core import (analyze, factor_batched, solve_batched,
                                  torch_repeated_engine)

    t_all = time.perf_counter()
    K = values0.shape[0]
    rec = {"phase": "repairs", "matrix": "fem2d_10k", "k": K}
    # ---- C1 ----------------------------------------------------------------
    c1 = {}
    for schedule in ("bucketed", "unrolled"):
        an = analyze(A, dataclasses.replace(
            an64.opts, factor_dtype="bfloat16", use_kernels=False,
            factor_schedule=schedule), reuse=an64)
        torch_repeated_engine(an)
        run = {}
        vals = values0 if schedule == "bucketed" else values0[:CPU_SYSTEMS]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        bst = factor_batched(an, A, vals)
        t_f = time.perf_counter() - t0
        if schedule == "bucketed":
            t0 = time.perf_counter()
            x, info = solve_batched(bst, b)
            t_s = time.perf_counter() - t0
            xr = np.stack([spla.spsolve(sp.csr_matrix(
                (vals[k], A.indices, A.indptr),
                shape=(A.n, A.n)).tocsc(), b[k]) for k in (0, K - 1)])
            run.update({
                "solve_batched_ms": t_s * 1e3,
                "fallback_ms": info.get("fallback_time", 0.0) * 1e3,
                "n_refine": info["n_refine"],
                "n_fp64_fallback": info["n_fp64_fallback"],
                "max_residual": float(info["residual"].max()),
                "refine_failed": int(info["refine_failed"].sum()),
                "scipy_rel_err": float(np.abs(x[[0, -1]] - xr).max()
                                       / np.abs(xr).max())})
        counts = kernels.launch_counts()
        t0 = time.perf_counter()
        f_cpu = torch_repeated_engine(an, device="cpu").refactor_batched(
            torch.from_numpy(vals[:CPU_SYSTEMS]))
        got = bst.vals[:CPU_SYSTEMS].cpu()
        e_, u_, d_, o_ = bf16_err(torch, got, f_cpu.vals)
        run.update({
            "k": int(vals.shape[0]), "factor_batched_ms": t_f * 1e3,
            "launches": {w: c for w, c in counts.items() if c},
            "vs_cpu_plain": {
                "systems": CPU_SYSTEMS,
                "held": held_to_cpu(torch, got, f_cpu.vals, d_),
                "same_pivots": bool(torch.equal(
                    bst.inode_perm[:CPU_SYSTEMS].cpu(), f_cpu.inode_perm)),
                "same_n_perturb": bool(np.array_equal(
                    bst.n_perturb[:CPU_SYSTEMS], f_cpu.n_perturb.numpy())),
                "max_abs_err": e_, "max_ulps_of_entry": u_,
                "entries_differing": d_, "entries_over_2_ulps_of_entry": o_,
                "entries": int(got.numel()),
                "cpu_s": time.perf_counter() - t0}})
        c1[schedule] = run
        del bst, f_cpu, got
    rec["c1_bf16_plain_route"] = c1
    # ---- C3 ----------------------------------------------------------------
    an_bf = analyze(A, dataclasses.replace(an64.opts,
                                           factor_dtype="bfloat16"),
                    reuse=an64)
    eng = torch_repeated_engine(an_bf)
    f = eng.refactor(torch.from_numpy(values0[0]).to(eng.device))
    b0 = torch.from_numpy(b[0])
    xs_card = [eng.apply(f.vals, f.inode_perm, b0.to(eng.device)).cpu()
               for _ in range(2)]
    t0 = time.perf_counter()
    x_cpu = torch_repeated_engine(an_bf, device="cpu").apply(
        f.vals.cpu(), f.inode_perm.cpu(), b0)

    def same_bits(u, v):
        return bool(torch.equal(u.view(torch.int16), v.view(torch.int16)))

    rec["c3_bf16_apply"] = {
        "x_dtype": str(x_cpu.dtype),
        "card_runs_bit_identical": same_bits(xs_card[0], xs_card[1]),
        "card_equals_cpu_bits": same_bits(xs_card[0], x_cpu),
        "entries_differing_from_cpu": int((xs_card[0].view(torch.int16)
                                           != x_cpu.view(torch.int16)).sum()),
        "finite": bool(torch.isfinite(x_cpu.float()).all()),
        "cpu_s": time.perf_counter() - t0}
    rec["seconds"] = time.perf_counter() - t_all
    emit(rec)
    bk = c1["bucketed"]
    check(bk["scipy_rel_err"] <= 1e-10 and bk["max_residual"] <= 1e-10
          and bk["refine_failed"] == 0,
          f"C1 bucketed: x off spsolve by {bk['scipy_rel_err']}, "
          f"residual {bk['max_residual']}")
    check(bk["vs_cpu_plain"]["held"], f"C1 bucketed: the card's plain "
                                      f"bf16 factors differ from the CPU's: "
                                      f"{bk['vs_cpu_plain']}")
    for schedule, run in c1.items():
        v = run["vs_cpu_plain"]
        check(not run["launches"], f"C1 {schedule}: use_kernels=False "
                                   f"launched {run['launches']}")
        check(v["same_pivots"] and v["same_n_perturb"],
              f"C1 {schedule}: the card's plain bf16 pivots differ from "
              f"the CPU's: {v}")
    c3 = rec["c3_bf16_apply"]
    check(c3["card_runs_bit_identical"] and c3["card_equals_cpu_bits"],
          f"C3: the one-system bf16 apply is not deterministic: {c3}")


def moe_serving_phase(torch, np, kernels, name=MOE_MODEL):
    """Phase 13: MoE serving at full width and depth.  qwen3-moe-30b-a3b
    (48 layers, 128 experts top-8) in bfloat16, random weights from SEED,
    BATCH requests of PROMPT random tokens, NEW_TOKENS new tokens, greedy,
    after the earlier models are freed: K7 on layer 0's q/k/v held to its
    plain version; ``greedy_generate`` timed, then one prefill and the
    decode steps timed alone; peak memory of the serving calls; MoE's
    share of the prefill's device time (CUDA events around every ``moe``
    call against events around the prefill) and the device busy share of
    one prefill and its top kernels (``profile_serve._profile``:
    torch.profiler's kernel time over the unprofiled prefill time); K7 launched once per layer per prefill and never in decode;
    finite logits.  Then decode ≡ forward in float32 at full width and 2
    layers on a short prompt and one request, at capacity_factor 8.0
    (printed with its dropped copies) and held at E / k, where no copy
    can be dropped.
    Returns (K7's launches by greedy_generate, the record)."""
    import dataclasses

    from repro_torch import profile_serve
    from repro_torch.configs import registry
    from repro_torch.kernels.flashattn import ops as flash
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serve.serve_step import (greedy_generate,
                                              make_decode_step,
                                              make_prefill_step)

    t_all = time.perf_counter()
    cfg = registry.get(name)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(a.numel() for a in _leaves(params))
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (BATCH, PROMPT))).cuda()
    # K7 on layer 0 against its plain version
    h, sub = layer_input(T, L, cfg, params, prompt, 0)
    q, k, v = (a.transpose(1, 2) for a in L.attention_qkv(
        cfg, sub["attn"], h, torch_arange_like(prompt)))
    got = flash.flash_attention(q, k, v).float()
    ref = flash.attention_plain(q, k, v).float()
    rtol, atol = TOL_MODEL["bfloat16"]
    diff = (got - ref).abs()
    k7 = {"shape": f"q {tuple(q.shape)} k, v {tuple(k.shape)}, causal",
          "max_abs_err": float(diff.max()),
          "max_err_over_limit": float((diff / (atol + rtol * ref.abs()))
                                      .max()), "rtol_atol": [rtol, atol]}
    del h, sub, q, k, v, got, ref, diff
    # the serving path, its peak alone
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tokens = greedy_generate(cfg, params, prompt, NEW_TOKENS)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    path_counts = kernels.launch_counts()
    prefill = make_prefill_step(cfg, s_max=PROMPT + NEW_TOKENS)
    decode = make_decode_step(cfg)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, tokens=prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    per_prefill = kernels.launch_counts()
    finite = [bool(torch.isfinite(logits).all())]
    out, step_s = [logits[:, -1].argmax(-1)], []
    kernels.reset_launch_counts()
    for i in range(NEW_TOKENS - 1):
        t0 = time.perf_counter()
        lg, cache = decode(params, out[-1][:, None], cache, PROMPT + i)
        out.append(lg[:, -1].argmax(-1))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        finite.append(bool(torch.isfinite(lg).all()))
    per_decode = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    stepped = torch.stack(out, 1)
    del cache, lg, logits
    # MoE's share of one prefill's device time, by CUDA events
    marks, orig_moe = [], L.moe

    def marked_moe(*a, **kw):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        res = orig_moe(*a, **kw)
        e1.record()
        marks.append((e0, e1))
        return res

    p0, p1, d0, d1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(4))
    L.moe = marked_moe
    try:
        p0.record()
        _, cache = prefill(params, tokens=prompt)
        p1.record()
        n_prefill = len(marks)
        d0.record()
        decode(params, out[0][:, None], cache, PROMPT)
        d1.record()
    finally:
        L.moe = orig_moe
    torch.cuda.synchronize()
    del cache
    moe_ms = sum(a.elapsed_time(b_) for a, b_ in marks[:n_prefill])
    moe_dec_ms = sum(a.elapsed_time(b_) for a, b_ in marks[n_prefill:])
    span_ms = p0.elapsed_time(p1)
    dec_span_ms = d0.elapsed_time(d1)
    busy = profile_serve._profile(
        torch, lambda: prefill(params, tokens=prompt), prefill_s)
    del params
    torch.cuda.empty_cache()
    # decode ≡ forward in float32, 2 layers: at capacity_factor 8.0 (the
    # JAX test's) and at E / k, where every expert has a slot for every
    # token, so that no copy can be dropped
    dec = {}
    no_drop = float(cfg.moe.n_experts / cfg.moe.top_k)
    for cf in (8.0, no_drop):
        cfg2 = dataclasses.replace(cfg, n_layers=2, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        params2 = T.init_params(cfg2, seed=SEED, dtype=torch.float32)
        dropped, orig_route = [0], L.moe_route

        def counted_route(*a, **kw):
            r = orig_route(*a, **kw)
            dropped[0] += int((~r[3]).sum())
            return r

        L.moe_route = counted_route
        try:
            err, _, _ = decode_vs_forward(torch, T, cfg2, params2,
                                          prompt[:1, :DECODE_CHECK_TOKENS])
        finally:
            L.moe_route = orig_route
        dec[cf] = {"capacity_factor": cf, "max_abs": err,
                   "copies_dropped": dropped[0]}
        del params2
        torch.cuda.empty_cache()
    dec_err, n_drop = dec[no_drop]["max_abs"], dec[no_drop]["copies_dropped"]
    n_attn = cfg.n_layers
    res = {"phase": "moe_serving", "model": name, "dtype": "bfloat16",
           "batch": BATCH, "prompt_tokens": PROMPT, "new_tokens": NEW_TOKENS,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
           "params": n_params, "init_params_s": init_s,
           "greedy_generate_s": generate_s, "prefill_ms": prefill_s * 1e3,
           "prefill_tokens_per_s": BATCH * PROMPT / prefill_s,
           "decode_ms_per_step": 1e3 * float(np.mean(step_s)),
           "decode_ms_per_step_all": [x_ * 1e3 for x_ in step_s],
           "max_memory_allocated": peak, "weight_bytes": n_params * 2,
           "memory_allocated_before_init": held_before,
           "prefill_device_span_ms": span_ms, "moe_device_ms": moe_ms,
           "moe_share_of_prefill": moe_ms / span_ms,
           "moe_calls_per_prefill": n_prefill,
           "prefill_profile": busy,
           "decode_step_device_span_ms": dec_span_ms,
           "moe_decode_device_ms": moe_dec_ms,
           "moe_share_of_decode_step": moe_dec_ms / dec_span_ms,
           "launches_greedy_generate": path_counts["flash_attention"],
           "launches_per_prefill": per_prefill["flash_attention"],
           "launches_decode": per_decode["flash_attention"],
           "all_logits_finite": all(finite),
           "stepped_equals_greedy": bool(torch.equal(stepped, tokens)),
           "k7_layer0_held": k7,
           "f32_decode_vs_forward": {
               "layers": 2, "requests": 1, "prompt_tokens":
                   DECODE_CHECK_TOKENS, "runs": list(dec.values()),
               "held_at_capacity_factor": no_drop,
               "why": "decode equals the forward only where no copy is "
                      "dropped; with random weights the attention output "
                      "(a running mean of v) is common to the tokens, so "
                      "the router sends most of them to the same experts "
                      "and capacity_factor 8.0 drops copies in the forward; "
                      "at E / k every expert has a slot for every token"},
           "seconds": time.perf_counter() - t_all}
    emit(res)
    check(k7["max_err_over_limit"] <= 1.0,
          f"{name}: K7 layer 0 off its plain version: {k7}")
    check(res["all_logits_finite"], f"{name}: non-finite bf16 logits")
    check(tokens.shape == (BATCH, NEW_TOKENS) and res["stepped_equals_greedy"],
          f"{name}: greedy tokens {tuple(tokens.shape)}, stepped equal: "
          f"{res['stepped_equals_greedy']}")
    check(path_counts["flash_attention"] == per_prefill["flash_attention"]
          == n_attn, f"{name}: K7 launched {path_counts['flash_attention']} "
                     f"times by greedy_generate, expected {n_attn}")
    check(not any(per_decode.values()),
          f"{name}: decode launched kernels {per_decode}")
    check(n_prefill == len(marks) - n_prefill == cfg.n_layers,
          f"{name}: {n_prefill} MoE calls a prefill, "
          f"{len(marks) - n_prefill} a decode step")
    check(n_drop == 0 and dec_err < TOL_DECODE,
          f"{name}: f32 decode vs forward {dec_err} at capacity_factor "
          f"{no_drop} (dropped {n_drop} copies)")
    return path_counts["flash_attention"], res


def jamba_reduced_phase(torch, np, kernels):
    """Phase 14: jamba-1.5-large-398b at ``.reduced()`` (1 attention + 7
    Mamba sub-layers a period, MoE every second one, two periods) end to
    end in float32 on the card, MoE capacity_factor 8.0: BATCH requests of
    JAMBA_PROMPT tokens through ``greedy_generate`` (K7 on its two
    attention layers, once each per prefill), K7 on layer 0 held to its
    plain version, the kernel route's prefill logits against
    ``use_kernels=False``'s, and decode ≡ forward, both within 2e-3.
    Returns (K7's launches by greedy_generate, the record)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.kernels.flashattn import ops as flash
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serve.serve_step import greedy_generate, make_prefill_step

    t_all = time.perf_counter()
    red = registry.get("jamba-1.5-large-398b").reduced()
    cfg = dataclasses.replace(red, moe=dataclasses.replace(
        red.moe, capacity_factor=8.0))
    params = T.init_params(cfg, seed=SEED, dtype=torch.float32)
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (BATCH, JAMBA_PROMPT))).cuda()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tokens = greedy_generate(cfg, params, prompt, NEW_TOKENS)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    h, sub = layer_input(T, L, cfg, params, prompt, 0)
    q, k, v = (a.transpose(1, 2) for a in L.attention_qkv(
        cfg, sub["attn"], h, torch_arange_like(prompt)))
    k7_ref = flash.attention_plain(q, k, v)
    rtol, atol = TOL_MODEL["float32"]
    k7_diff = (flash.flash_attention(q, k, v) - k7_ref).abs()
    k7_err = float(k7_diff.max())
    k7_over = float((k7_diff / (atol + rtol * k7_ref.abs())).max())
    got, _ = make_prefill_step(cfg)(params, tokens=prompt)
    ref, _ = make_prefill_step(cfg, use_kernels=False)(params, tokens=prompt)
    route_err = float((got[:, -1] - ref[:, -1]).abs().max())
    dec_err, _, _ = decode_vs_forward(torch, T, cfg, params, prompt)
    n_attn = cfg.layer_kinds().count("attn") * cfg.n_periods
    res = {"phase": "jamba_reduced", "model": cfg.name, "dtype": "float32",
           "layers": cfg.n_layers, "kinds": cfg.layer_kinds(),
           "ffn_kinds": cfg.ffn_kinds(), "batch": BATCH,
           "prompt_tokens": JAMBA_PROMPT, "new_tokens": NEW_TOKENS,
           "greedy_generate_s": generate_s,
           "launches_greedy_generate": counts["flash_attention"],
           "k7_layer0_max_abs_err": k7_err,
           "k7_layer0_max_err_over_limit": k7_over,
           "kernel_vs_plain_route_max_abs": route_err,
           "decode_vs_forward_max_abs": dec_err,
           "tokens_shape": list(tokens.shape),
           "seconds": time.perf_counter() - t_all}
    emit(res)
    del params
    torch.cuda.empty_cache()
    check(counts["flash_attention"] == n_attn,
          f"jamba reduced: K7 launched {counts['flash_attention']} times, "
          f"expected {n_attn}")
    check(k7_over <= 1.0, f"jamba reduced: K7 off its plain version by "
                          f"{k7_err} ({k7_over} times the limit)")
    check(route_err < TOL_DECODE and dec_err < TOL_DECODE,
          f"jamba reduced: kernel vs plain {route_err}, decode vs forward "
          f"{dec_err}")
    return counts["flash_attention"], res


def mamba_layer_phase(torch, np):
    """Phase 15: one Mamba layer at jamba-1.5-large's full width (d 8,192,
    DI 16,384, N 16, dt_rank 512, d_conv 4), BATCH × PROMPT tokens:
    ``mamba_seq`` (the chunked scan, chunk 128) and NEW_TOKENS
    ``mamba_step`` calls from its state, timed in float32 and bfloat16
    (one warm-up call, then one timed); in float32 the steps' outputs
    against ``mamba_seq`` over the extended sequence, within 2e-3; the
    peak memory of each."""
    from repro_torch.configs import registry
    from repro_torch.models import layers as L

    from repro_torch.core.options import resolve_device

    t_all = time.perf_counter()
    cfg = registry.get("jamba-1.5-large-398b")
    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xf = torch.randn((BATCH, PROMPT + NEW_TOKENS, cfg.d_model),
                     generator=gen, device=dev)
    res = {"phase": "mamba_layer", "model": cfg.name,
           "d_model": cfg.d_model, "d_inner": cfg.mamba.expand * cfg.d_model,
           "d_state": cfg.mamba.d_state, "chunk": L.MAMBA_CHUNK,
           "batch": BATCH, "prompt_tokens": PROMPT, "steps": NEW_TOKENS}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).replace("torch.", "")
        p = L.init_mamba(cfg, gen, dt, dev)
        x = xf.to(dt)

        def run():
            out, st = L.mamba_seq(cfg, p, x[:, :PROMPT], return_state=True)
            outs = []
            for i in range(NEW_TOKENS):
                o, st = L.mamba_step(cfg, p, x[:, PROMPT + i:PROMPT + i + 1],
                                     st)
                outs.append(o)
            return out, torch.cat(outs, 1)

        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        _, st0 = L.mamba_seq(cfg, p, x[:, :PROMPT], return_state=True)
        e[1].record()
        for i in range(NEW_TOKENS):
            _, st0 = L.mamba_step(cfg, p, x[:, PROMPT + i:PROMPT + i + 1],
                                  st0)
        e[2].record()
        torch.cuda.synchronize()
        r = {"mamba_seq_ms": e[0].elapsed_time(e[1]),
             "mamba_step_ms": e[1].elapsed_time(e[2]) / NEW_TOKENS,
             "peak_bytes": torch.cuda.max_memory_allocated()}
        if dt == torch.float32:
            _, steps = run()
            full = L.mamba_seq(cfg, p, x)[:, PROMPT:]
            r["step_vs_seq_max_abs"] = float((steps - full).abs().max())
            r["seq_out_max_abs"] = float(full.abs().max())
            r["finite"] = bool(torch.isfinite(full).all())
        res[dname] = r
        del p, x, st0
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_all
    emit(res)
    f32 = res["float32"]
    check(f32["finite"] and f32["step_vs_seq_max_abs"] < TOL_DECODE,
          f"mamba layer: steps vs sequence {f32['step_vs_seq_max_abs']}")


def roofline_record(torch, name, fn, measured_ms, expect=()):
    """Phase 19, one call: ``fn()`` once under ``roofline.op_cost`` (the
    FLOPs by dtype and the bytes of its ATen ops, the hand-written
    kernels' work by their formulas), its two bounds at the card's peaks
    beside ``measured_ms`` (the phase's own timed call) and the device's
    busy share in a torch.profiler window of one more call (its kernels'
    device time over the window's wall time).  The eager bound takes the
    eager program's own traffic (every intermediate written and read
    again), the least-traffic bound the call's arguments read and its
    results written once (``OpCost.min_bytes``), both with the same
    FLOPs.  Fails when a launch has no formula, when either bound over
    measured exceeds ROOFLINE_LIMIT (no card beats its roofline: the
    count would be wrong) or when an entry point of ``expect`` was not
    launched."""
    from repro_torch import profile_serve
    from repro_torch.roofline import analysis as RA
    from repro_torch.roofline.op_cost import OpCost

    t = time.perf_counter()
    torch.cuda.synchronize()
    with OpCost() as cost:
        res = fn()
        torch.cuda.synchronize()
    min_bytes = cost.min_bytes(res)
    del res
    terms, bott = RA.terms(cost.flops, cost.bytes)
    least, least_bott = RA.terms(cost.flops, min_bytes)
    bound_ms = max(terms["compute"], terms["memory"]) * 1e3
    min_bound_ms = max(least["compute"], least["memory"]) * 1e3
    prof = profile_serve._profile(torch, fn, measured_ms / 1e3)
    rec = {"name": name, "flops_by_dtype": dict(cost.flops),
           "flops": cost.total_flops, "bytes": cost.bytes,
           "min_bytes": min_bytes, "t_compute": terms["compute"],
           "t_memory": terms["memory"], "min_t_memory": least["memory"],
           "bottleneck": bott, "min_bottleneck": least_bott,
           "eager_bound_ms": bound_ms, "min_bound_ms": min_bound_ms,
           "ms": measured_ms,
           "bound_over_measured": bound_ms / measured_ms,
           "min_bound_over_measured": min_bound_ms / measured_ms,
           "busy": prof["device_busy_share_profiled"],
           "device_kernel_ms": prof["device_kernel_s"] * 1e3,
           "kernels": {k: v["launches"] for k, v in cost.kernels.items()},
           "uncounted": dict(cost.uncounted), "aten_ops": cost.n_ops,
           "top_bytes": sorted(([k, v[2]] for k, v in cost.by_op.items()),
                               key=lambda kv: -kv[1])[:6]}
    emit({"phase": "roofline", **rec, "seconds": time.perf_counter() - t})
    check(not cost.uncounted, f"roofline {name}: launches without a work "
                              f"formula {dict(cost.uncounted)}")
    for key in ("bound_over_measured", "min_bound_over_measured"):
        check(rec[key] <= ROOFLINE_LIMIT,
              f"roofline {name}: {key} {rec[key]} (measured {measured_ms} "
              f"ms) exceeds {ROOFLINE_LIMIT}")
    for entry in expect:
        check(any(k.startswith(entry) for k in cost.kernels),
              f"roofline {name}: no {entry}* launch ({cost.kernels})")
    return rec


def solver_share_phase(torch, np, kernels):
    """Phase 20: ``launch/solver_dryrun.py``'s per-device share on the card
    (n = 800, K = 4,096 / 256 = 16, float32 factor and one unrefined
    float32 solve, the JAX dry run's program) under ``op_cost``, in the
    mode the analysis chooses (row-row) and in supernodal mode, which
    runs K1-K4.  An unrefined float32 solve of these systems (condition
    up to about 4.5e4) is as accurate as float32 and the condition allow:
    each x is held to ``spsolve`` within 4 cond eps32 of its largest
    entry and its normwise backward error to n eps32, and to the same
    share's CPU plain route within twice the first bound (both sit within
    it).  Returns the supernodal share's launch counts."""
    import scipy.sparse.linalg as spla

    from repro_torch.launch import solver_dryrun as SD

    t = time.perf_counter()
    eps = float(np.finfo(np.float32).eps)
    out, refs = {}, []
    for mode in (None, "supernodal"):
        kernels.reset_launch_counts()
        rec, x, (a, values, b), _ = SD.share(device="cuda", mode=mode)
        counts = kernels.launch_counts()
        _, x_cpu, _, _ = SD.share(device="cpu", mode=mode)
        worst = {"forward_over_bound": 0.0, "backward_over_bound": 0.0,
                 "card_vs_cpu_over_bound": 0.0}
        for k in range(x.shape[0]):
            ak = a.copy()
            ak.data = values[k]
            if len(refs) <= k:            # the same systems in both modes
                xr = spla.spsolve(ak.tocsc(), b[k])
                refs.append((xr, 4 * np.linalg.cond(ak.toarray(), np.inf)
                             * eps * np.abs(xr).max()))
            xr, bound = refs[k]
            r = ak @ x[k].astype(np.float64) - b[k]
            bwd = np.abs(r).max() / (abs(ak).sum(axis=1).max()
                                     * np.abs(x[k]).max()
                                     + np.abs(b[k]).max())
            for key, val in (
                    ("forward_over_bound", np.abs(x[k] - xr).max() / bound),
                    ("backward_over_bound", bwd / (x.shape[1] * eps)),
                    ("card_vs_cpu_over_bound",
                     np.abs(x[k] - x_cpu[k]).max() / (2 * bound))):
                worst[key] = max(worst[key], float(val))
        bound_ms = max(rec["t_compute"], rec["t_memory"]) * 1e3
        rec.update(launches=counts, ms=rec["t_run_s"] * 1e3,
                   bound_ms=bound_ms,
                   bound_over_measured=bound_ms / (rec["t_run_s"] * 1e3),
                   card_vs_cpu_rel=float(np.abs(x - x_cpu).max()
                                         / np.abs(x_cpu).max()), **worst)
        emit({"phase": "solver_share", "forced_mode": mode, "record": rec})
        check(np.isfinite(x).all() and max(worst.values()) <= 1.0,
              f"solver share ({mode}): x against spsolve and the CPU route "
              f"{worst} (1 = the float32 bound)")
        check(not rec["uncounted"], f"solver share ({mode}): launches "
                                    f"without a formula {rec['uncounted']}")
        out[mode] = counts
    for w in ("panel_lu_bucket_inplace", "panel_lu", "trsm_batched",
              "trsm_left_unit_lower_batched", "trsm_left_upper_batched",
              "gemm_batched"):
        check(out["supernodal"][w] > 0,
              f"solver share (supernodal): {w} was not launched")
    emit({"phase": "solver_share_done",
          "seconds": time.perf_counter() - t})
    return out["supernodal"]


def dryrun_phase(torch):
    """Phase 21: one full-size dry-run cell on the host,
    qwen3-moe-30b-a3b x decode_32k x pod16x16 (expert sharding and the
    MoE groups), traced on fake tensors as rank 0 of a fake group of 256;
    the group is torn down after."""
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh

    t = time.perf_counter()
    try:
        mesh = make_production_mesh(multi_pod=False)
        rec, cost = D.trace_cell(registry.get(MOE_MODEL),
                                 SHAPES["decode_32k"], mesh, "pod16x16")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    emit({"phase": "dryrun", "record": rec,
          "seconds": time.perf_counter() - t})
    check(rec["status"] == "ok" and rec["flops_per_device"] > 0
          and rec["coll_bytes_per_device"] > 0 and not cost.uncounted,
          f"dryrun {MOE_MODEL} x decode_32k: {rec}")


def _train_run(torch, argv):
    """``repro_torch.launch.train.main(argv)`` with its peak memory,
    seconds and kernel launches (the counts zeroed just before it); returns
    the ``out`` dict (log, params, resumed, launches)."""
    from repro_torch import kernels
    from repro_torch.launch import train as launch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    check(launch.main(argv, out=out) == 0, f"train main {argv} failed")
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = kernels.launch_counts()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def _moved(torch, cfg, params, seed):
    """(leaves that moved, leaves) against a fresh draw of the initial
    params from ``seed``."""
    from repro_torch import tree as tr
    from repro_torch.models import transformer as T

    init = T.init_params(cfg, seed=seed, dtype=torch.float32)
    pairs = list(zip(tr.leaves(init), tr.leaves(params)))
    moved = sum(bool((a != b).any()) for a, b in pairs)
    del init, pairs
    torch.cuda.empty_cache()
    return moved, len(tr.leaves(params))


def _step_stats(log, tokens):
    dts = [r["dt"] for r in log[1:]] or [r["dt"] for r in log]
    ms = 1e3 * sorted(dts)[len(dts) // 2]
    return {"step_ms": [1e3 * r["dt"] for r in log], "median_step_ms": ms,
            "tokens_per_s": tokens / (ms / 1e3),
            "losses": [r["loss"] for r in log]}


def train_musicgen_phase(torch, np):
    """Phase 16: musicgen-medium trained at full width and depth through
    the launcher (its timed steps and, on its trainer, the roofline of
    one step), then the checkpoint and resume check at full width and
    TRAIN_RESUME_LAYERS layers."""
    import tempfile

    from repro_torch.configs import registry

    t_all = time.perf_counter()
    cfg = registry.get(TRAIN_MUSICGEN)
    b, t, steps = TRAIN_MUSICGEN_SHAPE
    argv = ["--arch", cfg.name, "--batch", str(b), "--seq", str(t),
            "--steps", str(steps), "--seed", str(SEED)]
    with tempfile.TemporaryDirectory(prefix="train_musicgen_") as ck:
        first = _train_run(torch, argv + ["--ckpt-dir", ck, "--ckpt-every",
                                          str(steps + 1)])
    moved, n_leaves = _moved(torch, cfg, first.pop("params"), SEED)
    stats = _step_stats(first["log"], b * t)
    trainer = first.pop("trainer")
    batch = trainer._batch(trainer.step)
    roof = roofline_record(
        torch, f"{cfg.name} train step (B {b}, T {t}, float32)",
        lambda: trainer._step_fn(trainer.params, trainer.opt_state,
                                 trainer.err_state, batch),
        stats["median_step_ms"])
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    # the checkpoint and resume check, at a cut depth (two checkpoints of
    # the 48-layer model were 16.4 GB each on disk)
    argv += ["--layers", str(TRAIN_RESUME_LAYERS)]
    with tempfile.TemporaryDirectory(prefix="train_musicgen_") as ck:
        cut = _train_run(torch, argv + ["--ckpt-dir", ck,
                                        "--ckpt-every", "2"])
        cut.pop("params")
        cut.pop("trainer")
        steps_saved = sorted(os.listdir(ck))
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(ck) for f in fs)
        # a crash before step 4's commit: the resume takes step 2
        os.remove(os.path.join(ck, f"step_{steps:09d}", "COMMIT"))
        t0 = time.perf_counter()
        second = _train_run(torch, argv + ["--ckpt-dir", ck,
                                           "--ckpt-every",
                                           str(steps + 1), "--resume"])
        second.pop("params")
        second.pop("trainer")
        resume_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    l1 = [r["loss"] for r in first["log"]]
    lc = [r["loss"] for r in cut["log"]]
    l2 = [r["loss"] for r in second["log"]]
    rel = [abs(a - b_) / abs(a) for a, b_ in zip(lc[2:], l2)]
    res = {"phase": "train_musicgen", "model": cfg.name, "dtype": "float32",
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": cfg.param_count(), "batch": b, "seq": t,
           "seq_chunk": min(512, t), "steps": steps, **stats,
           "first_run_s": first["seconds"],
           "peak_bytes": first["peak_bytes"],
           "roofline_bound_over_measured": roof["bound_over_measured"],
           "resume_layers": TRAIN_RESUME_LAYERS,
           "resume_cut_losses": lc, "resume_cut_run_s": cut["seconds"],
           "checkpoints": steps_saved, "checkpoint_bytes_on_disk": ckpt_bytes,
           "resumed_from": second["resumed"],
           "resumed_steps": [r["step"] for r in second["log"]],
           "resumed_losses": l2, "resume_rel_err": rel,
           "resumed_run_s": resume_s,
           "resumed_peak_bytes": second["peak_bytes"],
           "leaves_moved": moved, "leaves": n_leaves,
           "launches": first["launches"],
           "resumed_launches": second["launches"],
           "seconds": time.perf_counter() - t_all}
    emit(res)
    _check_no_kernel_launch("musicgen training", first["launches"])
    _check_no_kernel_launch("musicgen resume", second["launches"])
    check(all(math.isfinite(x) for x in l1 + lc + l2),
          f"musicgen training: a loss is not finite {l1} {lc} {l2}")
    check(moved == n_leaves, f"musicgen training: {n_leaves - moved} param "
                             "leaves did not move")
    check(second["resumed"] == 2 and len(l2) == steps - 2
          and max(rel) <= 1e-5,
          f"musicgen resume from step 2: {second['resumed']}, losses {l2} "
          f"against {lc[2:]} (rel {rel})")
    return roof


def train_rwkv_phase(torch, np):
    """Phase 17: rwkv6-1.6b trained at full width and TRAIN_RWKV_LAYERS
    layers (the plain WKV loop under autograd)."""
    import dataclasses
    import tempfile

    from repro_torch.configs import registry

    t_all = time.perf_counter()
    cfg = dataclasses.replace(registry.get("rwkv6-1.6b"),
                              n_layers=TRAIN_RWKV_LAYERS)
    b, t, steps = TRAIN_RWKV_SHAPE
    with tempfile.TemporaryDirectory(prefix="train_rwkv_") as ck:
        run = _train_run(torch, ["--arch", cfg.name, "--batch", str(b),
                                 "--seq", str(t), "--steps", str(steps),
                                 "--layers", str(TRAIN_RWKV_LAYERS),
                                 "--ckpt-dir", ck, "--ckpt-every", "1000",
                                 "--seed", str(SEED)])
    run.pop("trainer")
    moved, n_leaves = _moved(torch, cfg, run.pop("params"), SEED)
    gc.collect()
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in run["log"]]
    res = {"phase": "train_rwkv", "model": cfg.name, "dtype": "float32",
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": cfg.param_count(), "batch": b, "seq": t,
           "steps": steps, **_step_stats(run["log"], b * t),
           "run_s": run["seconds"], "peak_bytes": run["peak_bytes"],
           "leaves_moved": moved, "leaves": n_leaves,
           "launches": run["launches"],
           "seconds": time.perf_counter() - t_all}
    emit(res)
    _check_no_kernel_launch("rwkv6 training", run["launches"])
    check(all(math.isfinite(x) for x in losses),
          f"rwkv6 training: a loss is not finite {losses}")
    check(moved == n_leaves, f"rwkv6 training: {n_leaves - moved} param "
                             "leaves did not move")


def _check_no_kernel_launch(phase, counts):
    """The training step takes the plain route: K7 and K8 launch nothing
    (``counts`` read over the phase's own runs)."""
    check(counts["flash_attention"] == 0 and counts["wkv"] == 0,
          f"{phase}: K7 / K8 launched during training: {counts}")


def _held_steps(torch, cfg, b, t, devices=("cuda", "cpu")):
    """Two ``train_step`` calls of ``cfg`` on each of ``devices`` from the
    same params, optimizer state and batches.  The params and m / v after
    the first step are held (``devices[0]`` against ``devices[1]``); the
    second step's loss is the loss at the first step's params, so its
    rise from the first is printed beside the other route's.  Returns
    (record, checks)."""
    from repro_torch import kernels
    from repro_torch import tree as tr
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    p0 = T.init_params(cfg, seed=SEED, dtype=torch.float32, device="cpu")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=t, global_batch=b, seed=SEED)
    batches = [data.batch(s) for s in range(2)]
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=4)
    step = make_train_step(cfg, ocfg, seq_chunk=min(512, t))
    out = []
    kernels.reset_launch_counts()
    for dev in devices:
        params = tr.map_leaves(lambda p: p.to(dev, copy=True), p0)
        st = adamw.init_state(params)
        ms, secs = [], []
        for s, batch in enumerate(batches):
            t0 = time.perf_counter()
            params, st, _, m = step(params, st, None,
                                    {k: torch.from_numpy(v).to(dev)
                                     for k, v in batch.items()})
            ms.append({k: float(v) for k, v in m.items()})
            secs.append(time.perf_counter() - t0)
            if s == 0:      # the step updates in place: copy the state
                snap = tr.map_leaves(lambda x: x.to("cpu", copy=True),
                                     (params, (st.m, st.v)))
        out.append((snap, ms, secs))
        del params, st
    counts = kernels.launch_counts()
    ((pa, sa), ma, ta), ((pb, sb), mb, tb) = out
    lr = mb[0]["lr"]
    far = n = 0
    p_max = 0.0
    for a, b_ in zip(tr.leaves(pa), tr.leaves(pb)):
        d = (a - b_).abs() / lr
        p_max = max(p_max, float(d.max()))
        far, n = far + int((d > 1e-3).sum()), n + d.numel()
    mv_rel = max(float((a - b_).abs().max()) / float(b_.abs().max())
                 for a, b_ in zip(tr.leaves(sa), tr.leaves(sb)))
    loss_rel = [abs(x["loss"] - y["loss"]) / abs(y["loss"])
                for x, y in zip(ma, mb)]
    del p0, pa, pb, sa, sb, out
    rec = {"model": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": "float32", "batch": b, "seq": t,
           "devices": list(devices),
           "losses": {devices[0]: [x["loss"] for x in ma],
                      devices[1]: [x["loss"] for x in mb]},
           "loss_rel_err": loss_rel,
           "metrics": {devices[0]: ma, devices[1]: mb},
           "params_max_err_over_lr": p_max,
           "params_share_beyond_1e-3_lr": far / n,
           "moments_max_rel_err": mv_rel,
           "step_s": {devices[0]: ta, devices[1]: tb},
           "launches": counts}
    checks = [
        (loss_rel[0] <= 1e-5, f"{cfg.name}: step-1 loss {ma[0]['loss']} "
                              f"against {mb[0]['loss']}"),
        # the step-2 loss is taken at params that differ by the bounds
        # below, so it is held at 1e-4
        (loss_rel[1] <= 1e-4, f"{cfg.name}: step-2 loss {ma[1]['loss']} "
                              f"against {mb[1]['loss']}"),
        # an entry whose gradient is noise near Adam's eps moves by a
        # sizeable part of lr when the summation order changes that noise
        # (measured 0.057 lr on musicgen, 0.220 lr on rwkv6)
        (p_max <= 0.5 and far <= 1e-3 * n,
         f"{cfg.name}: params off by {p_max} lr, {far} of {n} entries "
         "beyond 1e-3 lr"),
        (mv_rel <= 1e-4, f"{cfg.name}: m / v off by {mv_rel}")]
    return rec, checks


def _refusal(torch, cfg, t):
    """``forward(use_kernels=True)`` under grad on the card: returns the
    error it raised (None if it ran) and the K7 / K8 launches it made."""
    from repro_torch import kernels
    from repro_torch import tree as tr
    from repro_torch.models import transformer as T

    params = tr.map_leaves(lambda p: p.requires_grad_(True),
                           T.init_params(cfg, seed=SEED,
                                         dtype=torch.float32))
    toks = torch.zeros((1, t), dtype=torch.long, device="cuda")
    kernels.reset_launch_counts()
    refused = None
    try:
        T.forward(cfg, params, tokens=toks, use_kernels=True)
    except RuntimeError as e:
        refused = str(e)
    c = kernels.launch_counts()
    del params
    torch.cuda.empty_cache()
    return refused, c["flash_attention"] + c["wkv"]


def train_held_phase(torch, np):
    """Phase 18: two training steps of musicgen-medium and of rwkv6-1.6b
    at full width and 2 layers on the card against the CPU, then the
    kernel route's refusal under grad."""
    import dataclasses

    from repro_torch.configs import registry

    b, t = TRAIN_HELD_SHAPE
    for name, kernel in TRAIN_HELD:
        t_all = time.perf_counter()
        cfg = dataclasses.replace(registry.get(name), n_layers=2)
        rec, checks = _held_steps(torch, cfg, b, t)
        refused, refuse_launches = _refusal(torch, cfg, t)
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "train_held", **rec,
              "kernel_route_under_grad": refused,
              "kernel_route_launches": refuse_launches,
              "seconds": time.perf_counter() - t_all})
        for ok, what in checks:
            check(ok, f"train_held: {what}")
        _check_no_kernel_launch(f"train_held {name}", rec["launches"])
        check(refused is not None and "use_kernels=False" in refused
              and kernel in refused and refuse_launches == 0,
              f"train_held {name}: the kernel route under grad did not "
              f"raise ({refused}, {refuse_launches} launches)")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
