#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(into ``build/repro_torch/``, one ``nvcc`` per source, all started
together: ``timing_scan``, ``flash_attention``, ``ssd_scan``, ``rmsnorm``
and ``fused_reduce``), then, each phase printing one JSON line:

1. ``card`` / ``build``: the card's name and power limit, each kernel's
   build time, ptxas report and count of HGMMA (tensor-core ``wgmma``)
   instructions in its SASS (``cuobjdump -sass``; the flash-attention
   library must have some);
2. ``main_path``: ``repro_torch.core.api.plan`` on the full sweep grid --
   32 message sizes (1-32 MB) x 32 reconfiguration delays (12.5-400 us)
   of a 128-node pairwise all-to-all (127 steps) on 8 planes, 1024 cells,
   default options -- cold, warm and with attribution, with the kernels'
   launch counts read around the cold run; the Fig. 5 anchor (1300 us
   planned, 1500 us strawman, the strawman also planned per instance);
3. ``kernel_vs_plain``: ``timing_scan`` against its plain torch version on
   the card, bitwise, attribution off and on, on the grid's strawman and
   greedy decisions and on a 64-cell relay-carrying (bypass) batch, with
   warm median times;
4. ``card_vs_cpu``: the card's plans bitwise equal to the port's CPU
   plans on the first 8 grid cells, the attribution of every grid cell
   whose decomposition misses its CCT by one ulp, the 64-cell bypass grid
   and a 64-cell INDEPENDENT grid (packing and water-fill splitting);
5. ``serve``: ``ServeEngine.generate`` through full-width qwen2-1.5B (28
   layers, random weights from seed 0, attention through the
   ``flash_attention`` kernel, every RMSNorm through the ``rmsnorm``
   kernel) on 8 requests of 1024-2048 prompt tokens x 32 new tokens:
   prefill cold and warm, decode per step, tokens/s, peak memory, every
   kernel's launch count read around one ``generate`` -- exactly the
   count worked out from the model code (``generate_launches``: 28
   flash-attention launches, 57 norms x 33 forwards = 1881 RMSNorm
   launches, no other kernel) -- and the generated tokens;
6. ``attention_vs_plain``: the ``flash_attention`` kernel against its
   plain torch version on the serving shapes of qwen2-1.5B, of
   zamba2-1.2b's shared block and of gemma-2b (head dim 256, 8 query
   heads per KV head), on qwen2's shape in float16, and on head dims 120
   (with a window), 256, 16 and 36 (padded by the wrapper), a float32
   case and a ragged length: max and mean error, the share of outputs not
   bitwise equal to the plain version's (at most 2% at the serving
   shapes: P.V at float32 accuracy), warm median times and TFLOP/s, and
   ``scaled_dot_product_attention`` timed on the serving shapes as the
   library yardstick;
7. ``serve_kernel_vs_plain``: the 8 requests' prefill through a 2-layer
   full-width model with every kernel, and with one kernel's plain
   version forced at a time (flash attention, then RMSNorm), logits
   within 0.05;
8. ``serve_card_vs_cpu``: a 2-layer full-width model with the same
   weights on the CPU and on the card, two 64-token prompts, prefill and
   3 decode steps, logits within 0.05, three runs with the same weights
   and prompts (each run's logits also compared bitwise with the first
   run's, on each side; the host's CPU capability beside them);
9. ``ssd_vs_plain``: the ``ssd_scan`` kernel against its plain torch
   version (y and the final state within 3e-4 of their scale) on the
   serving shapes of mamba2-130m (8 x 24 rows of 1895 x 64, state 128)
   and zamba2-1.2b (8 x 64 rows, state 64) and on S < chunk, S a multiple
   of the chunk, an initial state, a bf16 x, and P and N off the tiles,
   with warm median times and the bound (no library call computes it);
10. ``serve_ssm``: the same requests through full-width mamba2-130m (24
    Mamba2 layers, random weights from seed 0), 24 ``ssd_scan`` and
    49 x 33 = 1617 ``rmsnorm`` launches around one ``generate``;
11. ``serve_hybrid``: the same through full-width zamba2-1.2b (38 Mamba2
    layers in 6 groups of 6 around one shared attention block, then 2),
    38 ``ssd_scan``, 6 ``flash_attention`` and 89 x 33 = 2937
    ``rmsnorm`` launches;
12. ``serve_ssm_kernel_vs_plain``: the requests' prefill through mamba2
    cut to 2 layers and zamba2 cut to 3 (one group of 2, one trailing),
    with every kernel, and with one kernel's plain version forced at a
    time;
13. ``serve_ssm_card_vs_cpu``: those cut models with the same weights on
    the CPU and on the card, two 300-token prompts, prefill and 3 decode
    steps;
14. ``rmsnorm_vs_plain``: the ``rmsnorm`` kernel against its plain torch
    version (one bf16 ulp of the output's magnitude, 1e-5 of it in
    float32) on the prefill norms of qwen2-1.5B, mamba2-130m, zamba2-1.2b
    and gemma-2b (8 x 1895 rows), a decode step, float32 x, a bf16 and a
    float16 weight, D = 48 and 1234 and T = 7, with warm median times, the
    bound and
    ``torch.nn.functional.rms_norm`` as the library yardstick;
15. ``serve_gemma``: the same requests through full-width gemma-2b (18
    layers, d_model 2048, 8 query heads over 1 KV head of 256, GeGLU,
    vocab 256,000, (1 + w) RMSNorm), 18 ``flash_attention`` and 37 x 33 =
    1221 ``rmsnorm`` launches;
16. ``serve_gemma_kernel_vs_plain`` / ``serve_gemma_card_vs_cpu``: gemma
    cut to 2 layers, as phases 7 and 8 (one card-vs-CPU run).  Phases 12,
    13 and 16 hold the logits within 0.05 of their scale (max(1, max
    |logit|)), phases 7 and 8 within 0.05 absolute;
17. ``reduce_vs_plain``: the ``fused_reduce`` kernel bitwise against its
    plain torch version on the kernel bench's 2^20 bf16, 8 M float32,
    192,964,288 bf16, bf16 summed into float32, a bf16 plus a float32
    buffer and odd sizes, with warm median times, the bound and
    ``torch.add`` (where it computes the same function) as the library
    yardstick;
18. ``kernel_bench``: ``repro_torch.benchmarks.kernel_bench`` on the card
    (the reference's one path to ``fused_reduce``), every kernel count
    set to 0 just before it and read just after; its six rows finite and
    within their error limits.

Then one line listing each kernel with its numbers, and last
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
exits non-zero and prints no ``ok`` line.  It imports nothing of JAX or of
the reference package.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N_NODES, N_PLANES = 128, 8
SIZES = tuple(1e6 * (1 + i) for i in range(32))
RECFGS = tuple(12.5e-6 * (1 + i) for i in range(32))
KERNELS = {
    "timing_scan": ("src/repro_torch/kernels/csrc/timing_scan.cu",
                    "src/repro/kernels/timing_scan.py:47"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:32"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:31"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:23"),
    "fused_reduce": ("src/repro_torch/kernels/csrc/fused_reduce.cu",
                     "src/repro/kernels/fused_reduce.py:25"),
}
SERVE_ARCH = "qwen2_1_5b"
SSM_ARCH, HYBRID_ARCH = "mamba2_130m", "zamba2_1_2b"
GEMMA_ARCH = "gemma_2b"
CARD_VS_CPU_RUNS = 3  # runs of qwen2's card-vs-CPU check, same prompts
SSD_TOL = 3e-4  # of the output's own scale: the reference's kernel atol
# (name, batch, heads, S, P, N, chunk, with an initial state, x dtype); S
# None: the serving phases' padded prompt length.  The two serving shapes
# (mamba2-130m, zamba2-1.2b), S shorter than a chunk, S a multiple of the
# chunk, an initial state, a bf16 x, and P and N off the kernel's tiles.
SSD_CASES = [
    ("mamba2_130m", 8, 24, None, 64, 128, 128, False, "float32"),
    ("zamba2_1_2b", 8, 64, None, 64, 64, 128, False, "float32"),
    ("short_37", 2, 3, 37, 64, 128, 128, False, "float32"),
    ("multiple_256", 2, 4, 256, 64, 128, 128, False, "float32"),
    ("init_state", 2, 4, 300, 64, 64, 128, True, "float32"),
    ("bf16_x", 2, 4, 500, 64, 128, 128, False, "bfloat16"),
    ("p80_n18_chunk48", 3, 2, 200, 80, 18, 48, True, "float32"),
]
SERVE_REQUESTS, SERVE_NEW_TOKENS, SERVE_MAX_LEN = 8, 32, 2080
SERVE_PROMPT_RANGE = (1024, 2048)
LOGIT_TOL = 0.05  # the reference's prefill/decode tolerance
MARGIN = 0.1  # top-2 logit margin above which greedy tokens must agree
# (name, BHq, BHkv, Sq, Skv, D, dtype, causal, window); Sq, Skv None: the
# serving phases' padded prompt length.  "main_path" is qwen2-1.5B's shape
# (8 x 12 query heads over 8 x 2 KV heads of 128), "zamba2_shared" the
# zamba2-1.2b shared block's (8 x 32 heads of 64, no grouping), "gemma_2b"
# gemma-2b's (8 x 8 query heads over 8 x 1 KV head of 256), "float16"
# qwen2's shape in float16; "d36_pad" a head dim the wrapper pads to 48.
ATTENTION_CASES = [
    ("main_path", 96, 16, None, None, 128, "bfloat16", True, None),
    ("zamba2_shared", 256, 256, None, None, 64, "bfloat16", True, None),
    ("gemma_2b", 64, 8, None, None, 256, "bfloat16", True, None),
    ("d120_window", 32, 8, 1024, 1024, 120, "bfloat16", True, 512),
    ("d256_group1", 8, 8, 1024, 1024, 256, "bfloat16", True, None),
    ("d16", 12, 4, 300, 300, 16, "bfloat16", True, None),
    ("float32", 24, 12, 500, 777, 64, "float32", False, None),
    ("ragged_2000", 24, 4, 2000, 2000, 128, "bfloat16", True, None),
    ("float16", 96, 16, None, None, 128, "float16", True, None),
    ("d36_pad", 32, 8, 700, 700, 36, "bfloat16", True, None),
]
# The cases at the serving shapes, whose 16-bit outputs may differ bitwise
# from the plain version's in at most DIFFER_SHARE of their entries.
SERVING_ATTENTION = ("main_path", "zamba2_shared", "gemma_2b", "float16")
DIFFER_SHARE = 0.02
# (name, T, D, x dtype, w dtype, offset, gated); T None: the serving
# requests' padded prompt tokens (8 x 1895).  The serving paths' prefill
# norms -- qwen2-1.5B's layer norm, mamba2-130m's and zamba2-1.2b's gated
# norm (x = y * silu(z)), gemma-2b's (1 + w) norm -- a decode step, float32
# x, a bf16 weight, D off the 16-byte vector width, T = 7, and a float16
# weight (cast to float32 by the wrapper).
RMSNORM_CASES = [
    ("qwen2_prefill", None, 1536, "bfloat16", "float32", False, False),
    ("mamba2_gated", None, 1536, "bfloat16", "float32", False, True),
    ("zamba2_gated", None, 4096, "bfloat16", "float32", False, True),
    ("gemma_prefill", None, 2048, "bfloat16", "float32", True, False),
    ("decode", 8, 2048, "bfloat16", "float32", True, False),
    ("float32", 4096, 1536, "float32", "float32", False, False),
    ("bf16_weight", 4096, 2048, "bfloat16", "bfloat16", True, False),
    ("d48", 1024, 48, "bfloat16", "float32", False, False),
    ("d1234", 300, 1234, "bfloat16", "float32", True, False),
    ("t7", 7, 2048, "float32", "float32", True, False),
    ("f16_weight", 4096, 2048, "bfloat16", "float16", True, False),
]
# (name, shape, a dtype, b dtype, output dtype): the kernel bench's 2^20
# bf16, 8 M float32, 192,964,288 bf16 (large enough for the bytes bound to
# be read), a bf16 sum kept in float32, a bf16 a plus a float32 b (mixed
# dtypes, cast to float32 by the wrapper), and odd sizes.
REDUCE_CASES = [
    ("bench_2^20", (1 << 20,), "bfloat16", "bfloat16", "bfloat16"),
    ("f32_8M", (8388608,), "float32", "float32", "float32"),
    ("bf16_193M", (192964288,), "bfloat16", "bfloat16", "bfloat16"),
    ("bf16_to_f32_8M", (8388608,), "bfloat16", "bfloat16", "float32"),
    ("bf16_plus_f32_8M", (8388608,), "bfloat16", "float32", "float32"),
    ("odd_17", (17,), "float32", "float32", "float32"),
    ("odd_17_bf16", (17,), "bfloat16", "bfloat16", "bfloat16"),
    ("odd_3x5x7", (3, 5, 7), "bfloat16", "bfloat16", "float32"),
    ("odd_3x5x7_f16", (3, 5, 7), "float16", "float16", "float16"),
    ("odd_100000", (100000,), "bfloat16", "bfloat16", "bfloat16"),
    ("odd_100000_f32", (100000,), "float32", "float32", "float32"),
]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def median_ms(fn, reps):
    """Warm median of ``reps`` CUDA-event-timed samples of ``fn``, in ms a
    call: ``repro_torch.benchmarks.kernel_bench.device_us``, whose samples
    batch back-to-back calls to span at least 1 ms of the card's time."""
    from repro_torch.benchmarks.kernel_bench import device_us

    return device_us(fn, reps) / 1e3


def wall_ms(fn):
    """Host-clock ms of ``fn`` ending in a synchronize; returns (out, ms)."""
    import torch

    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - start) * 1e3


def attention_tolerance(dtype: str, want) -> float:
    """2e-5 in float32; one ulp of the output magnitude in bf16 and
    float16."""
    if dtype == "float32":
        return 2e-5
    mantissa = 7 if dtype == "bfloat16" else 10
    return 2.0 ** (math.floor(math.log2(float(want.float().abs().max()))) - mantissa)


def sass_count(_build, lib, opcode: str) -> int:
    """Instructions of ``opcode`` in a built library's SASS, read with the
    toolkit's ``cuobjdump -sass`` (beside ``nvcc``)."""
    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return sum(opcode in line for line in sass.splitlines())


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout (src/repro_torch)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))

    from repro_torch.core import (
        FIG5_LINK_BANDWIDTH,
        BatchInstance,
        DependencyMode,
        OpticalFabric,
        PlannerOptions,
        PlanRequest,
        batch_evaluate,
        plan,
        prestage_for,
        strawman_instance,
    )
    from repro_torch.core.convert import packed_from_numpy
    from repro_torch.core.ir import pack_instances
    from repro_torch.core.patterns import pairwise_alltoall, rabenseifner_allreduce
    from repro_torch.benchmarks import roofline
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_reduce as fr
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.timing_scan import (
        timing_scan,
        timing_scan_cuda,
        timing_scan_plain,
    )

    dev = torch.device("cuda")

    # -- card and build ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("card", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    def build(name):
        t0 = time.perf_counter()
        lib = _build.build(name)
        _build.load(name)
        log = Path(f"{lib}.log")
        return dict(
            kernel=name, seconds=time.perf_counter() - t0,
            ptxas=log.read_text().strip().splitlines()[-8:] if log.exists() else [],
            sass_hgmma=sass_count(_build, lib, "HGMMA"),
        )

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(build, KERNELS))
    emit("build", kernels=built)
    hgmma = next(b["sass_hgmma"] for b in built if b["kernel"] == "flash_attention")
    check(hgmma > 0, "the flash_attention library has no HGMMA (wgmma) instruction")

    # -- main path at full width ---------------------------------------------
    patterns = {size: pairwise_alltoall(N_NODES, size) for size in SIZES}
    cells = [
        (OpticalFabric(N_NODES, N_PLANES, t_recfg=t), patterns[size])
        for size in SIZES
        for t in RECFGS
    ]
    request = PlanRequest.grid(cells, options=PlannerOptions(device="cuda"))

    def timed_plan(req):
        return wall_ms(lambda: plan(req))

    # Each kernel's launch counter, and the dispatcher that a kernel-vs-
    # plain check replaces with the plain version (module, name).
    counters = {
        "timing_scan": timing_scan,
        "flash_attention": fa.flash_attention_bhsd,
        "ssd_scan": ssd.ssd_scan_bhsp,
        "rmsnorm": rn.rmsnorm_2d,
        "fused_reduce": fr.fused_reduce_flat,
    }
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    result, cold_ms = timed_plan(request)
    launches = timing_scan.launches
    check(launches == 2, f"plan() launched timing_scan {launches} times, want 2")
    for name, fn in counters.items():
        check(name == "timing_scan" or fn.launches == 0, f"plan() launched {name}")
    _, warm_ms = timed_plan(request)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    att_result, att_ms = timed_plan(
        PlanRequest.grid(
            cells, options=PlannerOptions(device="cuda", attribution=True)
        )
    )
    ccts = torch.tensor(result.ccts, dtype=torch.float64)
    check(len(result.ccts) == len(cells), "one CCT per cell")
    check(bool(torch.isfinite(ccts).all() and (ccts > 0).all()), "CCTs finite, positive")
    check(att_result.ccts == result.ccts, "attribution changed a CCT")
    # Conservation: components + idle == CCT bitwise, except where the
    # reference's own closing-idle refinement (4 passes) stops one ulp
    # short -- the port reproduces the reference bitwise there too (every
    # such cell is held to the CPU plan in the card_vs_cpu phase).
    unconserved = []
    for k, cell in enumerate(att_result.grid):
        att = cell.plan.attribution
        if not bool((att.plane_total == att.cct).all()):
            unconserved.append(k)
            ulp = float(np.spacing(att.cct))
            check(
                bool((abs(att.plane_total - att.cct) <= ulp).all()),
                f"cell {k}: attribution off the CCT by more than one ulp",
            )
    for i in (0, 511, len(cells) - 1):
        sched = result.schedule(i)  # execute() validates P1-P4
        check(sched.cct == result.ccts[i], f"cell {i}: object CCT != kernel CCT")
    greedy = [
        BatchInstance(c.plan.fabric, c.plan.pattern, c.plan.decisions)
        for c in result.grid
    ]
    scored = batch_evaluate(greedy, device="cuda")
    check(bool(scored.feasible.all()), "a planned cell is infeasible")
    check(bool(scored.volume_ok.all()), "a planned cell breaks volume conservation")
    check(list(scored.cct) == list(result.ccts), "re-scored CCTs differ")
    fig5_pattern = rabenseifner_allreduce(8, 40e6)
    fig5_fabric = prestage_for(
        OpticalFabric(8, 2, bandwidth=FIG5_LINK_BANDWIDTH, t_recfg=200e-6),
        fig5_pattern,
    )
    fig5 = plan(
        PlanRequest.grid(
            [(fig5_fabric, fig5_pattern)], options=PlannerOptions(device="cuda")
        )
    )
    fig5_cct, fig5_straw = fig5.ccts[0], fig5.grid[0].strawman_cct
    check(abs(fig5_cct - 1300e-6) <= 1e-12, f"fig5 CCT {fig5_cct!r} != 1300 us")
    check(abs(fig5_straw - 1500e-6) <= 1e-12, f"fig5 strawman {fig5_straw!r} != 1500 us")
    before = timing_scan.launches
    fig5_single = plan(PlanRequest.single(
        fig5_fabric, fig5_pattern,
        options=PlannerOptions(method="strawman", device="cuda"),
    ))
    check(timing_scan.launches == before + 1, "per-instance strawman skipped the kernel")
    check(fig5_single.cct == fig5_straw, f"per-instance strawman {fig5_single.cct!r} != grid's")
    vs = [c.vs_strawman for c in result.grid]
    emit(
        "main_path",
        cells=len(cells), n_steps=cells[0][1].n_steps, n_planes=N_PLANES,
        candidate_rows=len(cells) * (2**N_PLANES - 1),
        timing_scan_launches=launches, cold_ms=cold_ms, warm_ms=warm_ms,
        attribution_ms=att_ms, peak_mem_mb=peak_mb,
        attribution_unconserved_cells=unconserved,
        cct_us_min=float(ccts.min()) * 1e6, cct_us_max=float(ccts.max()) * 1e6,
        vs_strawman_mean=statistics.fmean(vs),
        fig5_cct_us=fig5_cct * 1e6, fig5_strawman_us=fig5_straw * 1e6,
    )

    # -- kernel against its plain version, on the card -----------------------
    bypass_pattern = {s: pairwise_alltoall(8, s) for s in (1e6 * (1 + i) for i in range(8))}
    bypass_cells = [
        (OpticalFabric(8, 4, t_recfg=t).prestaged(p.steps[0].config), p)
        for p in bypass_pattern.values()
        for t in (200e-6 * 2 ** (4 * k / 7) for k in range(8))
    ]
    bypass_plan = plan(
        PlanRequest.grid(
            bypass_cells, options=PlannerOptions(device="cuda", bypass_depth=2)
        )
    )
    n_relay = sum(
        bool(c.plan.decisions.bypass and any(c.plan.decisions.bypass))
        for c in bypass_plan.grid
    )
    check(n_relay > 0, "no bypass cell chose a relay")
    batches = {
        "strawman": [strawman_instance(f, p, prestage=True) for f, p in cells],
        "greedy": greedy,
        "bypass": [
            BatchInstance(c.plan.fabric, c.plan.pattern, c.plan.decisions)
            for c in bypass_plan.grid
        ],
    }
    rows = {}
    for name, instances in batches.items():
        tensors = packed_from_numpy(pack_instances(instances, None), dev)
        for attribution in (False, True):
            got = timing_scan_cuda(tensors, attribution=attribution)
            want = timing_scan_plain(tensors, attribution=attribution)
            torch.cuda.synchronize()
            for k, (g, w) in enumerate(zip(got, want)):
                check(torch.equal(g, w), f"{name} att={attribution}: output {k} differs")
            err = max(
                float((g - w).abs().max()) if g.is_floating_point() and g.numel() else 0.0
                for g, w in zip(got, want)
            )
            ms = median_ms(lambda: timing_scan_cuda(tensors, attribution=attribution), 20)
            plain_ms = median_ms(lambda: timing_scan_plain(tensors, attribution=attribution), 3)
            bound_ms, bound_by = roofline.timing_scan_bound(tensors, got)
            row = dict(
                batch=name, attribution=attribution,
                shape=list(tensors["vol"].shape) + [tensors["byp_vol"].shape[2], tensors["byp_plane"].shape[3]],
                bitwise_equal=True, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
            )
            rows[(name, attribution)] = row
            emit("kernel_vs_plain", **row)

    # -- the card's plans against the port's CPU plans -----------------------
    def same_plans(card, cpu, what):
        check(len(card) == len(cpu), f"{what}: cell count")
        for k, (a, b) in enumerate(zip(card, cpu)):
            check(a.plan.decisions == b.plan.decisions, f"{what} cell {k}: decisions")
            check(a.cct == b.cct, f"{what} cell {k}: CCT")
            check(a.strawman_cct == b.strawman_cct, f"{what} cell {k}: strawman")
            check(a.plan.n_reconfigurations == b.plan.n_reconfigurations, f"{what} cell {k}: n_recfg")
            check(a.plan.utilization == b.plan.utilization, f"{what} cell {k}: utilization")

    t0 = time.perf_counter()
    cpu_first = plan(PlanRequest.grid(cells[:8], options=PlannerOptions(device="cpu")))
    same_plans(result.grid[:8], cpu_first.grid, "grid[:8]")
    if unconserved:
        cpu_att = plan(PlanRequest.grid(
            [cells[k] for k in unconserved],
            options=PlannerOptions(device="cpu", attribution=True),
        ))
        for k, cpu_cell in zip(unconserved, cpu_att.grid):
            card_att = att_result.grid[k].plan.attribution
            for field in ("t_xmit", "t_bypass", "t_recfg_wait", "t_recfg_hidden", "t_idle"):
                check(
                    np.array_equal(getattr(card_att, field), getattr(cpu_cell.plan.attribution, field)),
                    f"cell {k}: {field} differs between card and CPU",
                )
    cpu_bypass = plan(
        PlanRequest.grid(bypass_cells, options=PlannerOptions(device="cpu", bypass_depth=2))
    )
    same_plans(bypass_plan.grid, cpu_bypass.grid, "bypass")
    indep_cells = [
        (OpticalFabric(64, N_PLANES, t_recfg=25e-6 * (1 + j)), pairwise_alltoall(64, 1e6 * (1 + i)))
        for i in range(8)
        for j in range(8)
    ]
    for split in (False, True):
        opts = dict(mode=DependencyMode.INDEPENDENT, independent_split=split)
        card = plan(PlanRequest.grid(indep_cells, options=PlannerOptions(device="cuda", **opts)))
        cpu = plan(PlanRequest.grid(indep_cells, options=PlannerOptions(device="cpu", **opts)))
        same_plans(card.grid, cpu.grid, f"independent split={split}")
    emit("card_vs_cpu", grid_cells=8, unconserved_cells=unconserved,
         bypass_cells=len(bypass_cells),
         bypass_cells_with_relays=n_relay, independent_cells=len(indep_cells),
         bitwise_equal=True, seconds=time.perf_counter() - t0)

    # -- serving, the kernels of the serving paths, the kernel bench ---------
    serve, attention = serve_phases(np, torch, counters)
    ssd_rows, serve_ssm, _ = ssm_phases(np, torch, counters)
    norm_rows, serve_gemma = norm_phases(np, torch, counters)
    reduce_rows = reduce_phase(torch)
    bench_launches = bench_phase(torch, counters)

    def kernel_row(name, rows, main_case, n_launches, library=True):
        main = rows[main_case]
        return {
            "name": name,
            "route": "cuda",
            "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "launches": n_launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"] if library else None,
        }

    timing_rows = {f"{b}_{a}": r for (b, a), r in rows.items()}
    print(json.dumps({"kernels": [
        kernel_row("timing_scan", timing_rows, "greedy_False", launches, library=False),
        kernel_row("flash_attention", attention, "main_path",
                   serve["flash_attention_launches"]),
        kernel_row("ssd_scan", ssd_rows, SSM_ARCH, serve_ssm["ssd_scan_launches"]),
        kernel_row("rmsnorm", norm_rows, "gemma_prefill", serve_gemma["rmsnorm_launches"]),
        kernel_row("fused_reduce", reduce_rows, "bench_2^20", bench_launches["fused_reduce"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def serve_prompts(np, vocab):
    """The serving phases' requests: SERVE_REQUESTS prompts with lengths
    from ``default_rng(0)`` uniform in SERVE_PROMPT_RANGE (the same lengths
    for every vocabulary)."""
    rng = np.random.default_rng(0)
    lo, hi = SERVE_PROMPT_RANGE
    return [
        rng.integers(2, vocab, int(n)).tolist()
        for n in rng.integers(lo, hi + 1, SERVE_REQUESTS)
    ]


def prefill_launches(cfg):
    """Kernel launches of one prefill of ``cfg``, from the model code
    (`repro_torch.models.lm`): ``flash_attention`` once per attention layer
    (each decoder layer; each call of the hybrid's shared block),
    ``ssd_scan`` once per Mamba2 layer, and ``rmsnorm`` once per norm: two
    per attention layer (before attention and before the FFN), two more
    with qk-norm, two per Mamba2 layer (the layer's norm and the gated
    norm), and the final norm."""
    check(cfg.attention_impl == "pallas" or cfg.family == "ssm",
          f"{cfg.name}: attention is not routed to the kernel")
    attn = {"dense": cfg.n_layers, "ssm": 0,
            "hybrid": cfg.n_layers // max(cfg.hybrid_period, 1)}[cfg.family]
    mamba = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    norms = (4 if cfg.qk_norm else 2) * attn + 2 * mamba + 1
    return {"flash_attention": attn, "ssd_scan": mamba, "rmsnorm": norms}


def generate_launches(cfg):
    """Kernel launches of one ``generate`` of the serving requests: a
    prefill, then SERVE_NEW_TOKENS decode steps, each of which launches
    ``rmsnorm`` as often as a prefill and no other kernel (the decode
    attention and the Mamba2 recurrence are plain torch, as in the
    reference)."""
    out = prefill_launches(cfg)
    out["rmsnorm"] *= 1 + SERVE_NEW_TOKENS
    return out


def serve_run(np, torch, cfg, counters):
    """Serve the requests through ``cfg`` on the card, random weights from
    seed 0: prefill cold and warm, one ``generate`` with every kernel count
    set to 0 just before it and read just after (each exactly
    ``generate_launches(cfg)``; every other kernel must not launch), decode
    steps.  Returns the phase's fields and the padded prompt batch."""
    from repro_torch.models.lm import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    dev = torch.device("cuda")
    prompts = serve_prompts(np, cfg.vocab_size)
    requests = [Request(prompt=p, max_new_tokens=SERVE_NEW_TOKENS) for p in prompts]
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(model, params, max_len=SERVE_MAX_LEN)
    tokens = engine._pad_batch(requests)
    batch = {"tokens": tokens}
    with torch.inference_mode():
        (logits, _), prefill_cold_ms = wall_ms(lambda: model.prefill(params, batch))
        _, prefill_warm_ms = wall_ms(lambda: model.prefill(params, batch))
    check(bool(torch.isfinite(logits.float()).all()), f"{cfg.name}: prefill logits not finite")
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    completions, generate_ms = wall_ms(lambda: engine.generate(requests))
    launches = {name: fn.launches for name, fn in counters.items()}
    expect = generate_launches(cfg)
    for name, n in launches.items():
        want = expect.get(name, 0)
        check(n == want, f"{cfg.name}: generate() launched {name} {n} times, want {want}")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    generated = [c.tokens for c in completions]
    check(
        all(len(t) == SERVE_NEW_TOKENS and all(0 <= x < cfg.padded_vocab for x in t)
            for t in generated),
        f"{cfg.name}: a completion has the wrong length or an out-of-vocab token",
    )
    top2 = logits.float().topk(2, dim=-1).values
    decided = ((top2[:, 0] - top2[:, 1]) > MARGIN).tolist()
    first = torch.argmax(logits, dim=-1).tolist()
    check(
        all(t[0] == f for t, f, ok in zip(generated, first, decided) if ok),
        f"{cfg.name}: generate()'s first tokens != the prefill's argmax",
    )
    with torch.inference_mode():
        step_logits, cache = model.prefill(params, batch)
        cache = engine._grow(cache, len(requests))
        tok = torch.argmax(step_logits, dim=-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(SERVE_NEW_TOKENS):
            step_logits, cache = model.decode_step(params, cache, tok)
            tok = torch.argmax(step_logits, dim=-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - start) * 1e3
    check(bool(torch.isfinite(step_logits.float()).all()), f"{cfg.name}: decode logits not finite")
    decode_step_ms = decode_ms / SERVE_NEW_TOKENS
    fields = dict(
        arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        requests=len(requests), prompt_lens=[len(p) for p in prompts],
        padded_prompt_len=int(tokens.shape[1]), new_tokens=SERVE_NEW_TOKENS,
        max_len=SERVE_MAX_LEN,
        prefill_cold_ms=prefill_cold_ms, prefill_warm_ms=prefill_warm_ms,
        generate_ms=generate_ms,
        decode_step_ms=decode_step_ms,
        decode_tokens_per_s=len(requests) / decode_step_ms * 1e3,
        generate_tokens_per_s=len(requests) * SERVE_NEW_TOKENS / generate_ms * 1e3,
        peak_mem_mb=peak_mb,
        **{f"{name}_launches": n for name, n in launches.items()},
        tokens=generated,
    )
    del model, params, engine, cache, logits, step_logits
    torch.cuda.empty_cache()
    return fields, batch


def serve_phases(np, torch, counters):
    """Phases 5-8: serving, the attention kernel, serving checks.

    Returns the ``serve`` phase's fields and the ``attention_vs_plain``
    rows by case name.
    """
    import torch.nn.functional as F

    from repro_torch.benchmarks import roofline
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    cfg = get_config(SERVE_ARCH).replace(attention_impl="pallas")

    # -- 5. serve ---------------------------------------------------------
    serve, batch = serve_run(np, torch, cfg, counters)
    emit("serve", **serve)

    # -- 6. attention kernel against its plain version ------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    s_main = serve["padded_prompt_len"]
    attention = {}
    for name, bhq, bhkv, sq, skv, d, dtype, causal, window in ATTENTION_CASES:
        sq, skv = sq or s_main, skv or s_main
        q, k, v = (
            torch.randn(shape, generator=gen, device=dev).to(getattr(torch, dtype))
            for shape in ((bhq, sq, d), (bhkv, skv, d), (bhkv, skv, d))
        )
        kw = dict(causal=causal, window=window)
        got = fa.flash_attention_bhsd_cuda(q, k, v, **kw)
        want = fa.flash_attention_bhsd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"attention {name}: dtype or shape")
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        tol = attention_tolerance(dtype, want)
        check(err <= tol, f"attention {name}: max abs error {err} > {tol}")
        # The share of outputs not bitwise equal to the plain version's: a
        # 16-bit rounding of P would move many by an ulp; P.V at float32
        # accuracy leaves only those within float32 noise of a rounding
        # boundary.
        differ = float((got != want).float().mean())
        if name in SERVING_ATTENTION:
            check(differ <= DIFFER_SHARE,
                  f"attention {name}: {differ} of the outputs differ > {DIFFER_SHARE}")
        bound_ms, bound_by = roofline.attention_bound(q, k, causal, window)
        flops = roofline.attention_flops(bhq, sq, skv, d, causal, window)
        ms = median_ms(lambda: fa.flash_attention_bhsd_cuda(q, k, v, **kw), 10)
        row = dict(
            case=name, q=[bhq, sq, d], kv=[bhkv, skv, d], dtype=dtype,
            causal=causal, window=window, max_abs_err=err, tolerance=tol,
            mean_abs_err=float(diff.mean()), differ_share=differ,
            ms=ms, tflops=flops / ms / 1e9,
            plain_ms=median_ms(lambda: fa.flash_attention_bhsd_plain(q, k, v, **kw), 3),
            bound_ms=bound_ms, bound_by=bound_by, flops=flops, library_ms=None,
        )
        if name in SERVING_ATTENTION:
            # Library yardstick on the serving shapes, timed only: the
            # (BH, S, D) tensors as one batch row of BH heads; the library's
            # GQA maps query head i to KV head i // group, as the fold does.
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q[None], k[None], v[None], is_causal=True, enable_gqa=True
            )[0]
            lib_err = float((sdpa().float() - want.float()).abs().max())
            row.update(library_ms=median_ms(sdpa, 10), library_max_abs_err=lib_err)
        attention[name] = row
        emit("attention_vs_plain", **row)

    # -- 7, 8. kernel vs plain attention and card vs CPU, depth 2 -------------
    shallow_checks(np, torch, "serve", cfg.replace(n_layers=2), batch,
                   relative=False, prompt_len=64, runs=CARD_VS_CPU_RUNS)
    return serve, attention


def ssd_inputs(torch, gen, batch, heads, s, p, n, with_init, dtype):
    """Model-layout scan inputs on the card, as a Mamba2 layer makes them:
    x, dt > 0 (softplus), a_log, b, c and an optional initial state."""
    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = draw(batch, s, heads, p).to(getattr(torch, dtype))
    dt = torch.nn.functional.softplus(draw(batch, s, heads) - 1.0)
    a_log = 0.5 * draw(heads)
    b, c = draw(batch, s, n), draw(batch, s, n)
    return x, dt, a_log, b, c, draw(batch, heads, p, n) if with_init else None


def ssd_error(got, want, dtype):
    """Max abs error and its tolerance: SSD_TOL of the output's own scale,
    plus one bf16 ulp of that scale for a bf16 output (the cast's
    rounding)."""
    scale = float(want.float().abs().max())
    tol = SSD_TOL * scale
    if dtype == "bfloat16":
        tol += 2.0 ** (math.floor(math.log2(scale)) - 7)
    return float((got.float() - want.float()).abs().max()), tol


def logits_close(got, want, what, relative):
    """Logits within LOGIT_TOL -- absolute, or (``relative``) of their
    scale max(1, max |logit|) -- and the greedy first tokens equal wherever
    the top-2 margin > MARGIN; returns the check's numbers."""
    import torch

    got, want = got.float().cpu(), want.float().cpu()
    scale = max(1.0, float(want.abs().max())) if relative else 1.0
    err = float((got - want).abs().max())
    check(err <= LOGIT_TOL * scale, f"{what}: logits off by {err} (scale {scale})")
    top2 = want.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > MARGIN
    same = torch.argmax(got, -1) == torch.argmax(want, -1)
    check(bool((same | ~decided).all()), f"{what}: a decided first token differs")
    return dict(max_abs_err=err, logit_scale=scale, tolerance=LOGIT_TOL * scale,
                decided_first_tokens=int(decided.sum()), equal_first_tokens=int(same.sum()))


def kernel_routes():
    """Per kernel of the serving paths: (module, name) of the dispatcher
    that carries its launch count and that a kernel-vs-plain check replaces
    by ``<name>_plain``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd

    return {
        "flash_attention": (fa, "flash_attention_bhsd"),
        "ssd_scan": (ssd, "ssd_scan_bhsp"),
        "rmsnorm": (rn, "rmsnorm_2d"),
    }


def launched(counters, fn):
    """``fn()`` and the launches of each counter's kernel during it."""
    before = {name: c.launches for name, c in counters.items()}
    out = fn()
    return out, {name: c.launches - before[name] for name, c in counters.items()}


def shallow_checks(np, torch, phase, cfg, batch, *, relative, prompt_len, runs=1):
    """The serving checks of a full-width model cut in depth (``cfg``),
    with the logits held by ``logits_close(relative=...)``:

    * ``<phase>_kernel_vs_plain``, one per kernel the prefill launches:
      ``batch``'s prefill with every kernel, and with that one kernel's
      plain version forced (the others launching as before), same weights;
    * ``<phase>_card_vs_cpu``, ``runs`` times with the same weights and
      prompts: the CPU and the card, two ``prompt_len``-token prompts,
      prefill and 3 decode steps, each run's logits also compared bitwise
      with the first run's on each side.
    """
    from repro_torch.models.common import tree_map
    from repro_torch.models.lm import build_model
    from repro_torch.serve.engine import ServeEngine

    dev = torch.device("cuda")
    routes = kernel_routes()
    # The dispatchers, read before any is replaced by its plain version.
    counters = {name: getattr(*route) for name, route in routes.items()}
    expect = {name: prefill_launches(cfg)[name] for name in routes}
    fields = dict(arch=cfg.name, n_layers=cfg.n_layers, hybrid_period=cfg.hybrid_period)

    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    with torch.inference_mode():
        (kernel_logits, _), n = launched(counters, lambda: model.prefill(params, batch))
        check(n == expect, f"{cfg.name}: depth-{cfg.n_layers} prefill launched {n}, want {expect}")
        for name, (module, attr) in routes.items():
            if not expect[name]:
                continue
            with mock.patch.object(module, attr, getattr(module, f"{attr}_plain")):
                (plain_logits, _), n = launched(counters, lambda: model.prefill(params, batch))
            want = {**expect, name: 0}
            check(n == want, f"{cfg.name}: prefill with plain {name} launched {n}, want {want}")
            emit(f"{phase}_kernel_vs_plain", **fields, forced_plain=[name],
                 prefill_launches=n, **logits_close(
                     kernel_logits, plain_logits,
                     f"{cfg.name} kernel vs plain {name}", relative))
    del model, params, kernel_logits, plain_logits
    torch.cuda.empty_cache()

    steps_n = 3
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
    card_model = build_model(cfg, device=dev)
    prompts_cpu = torch.from_numpy(
        np.random.default_rng(1).integers(2, cfg.vocab_size, (2, prompt_len)).astype(np.int32)
    )
    max_len = prompt_len + steps_n + 1
    first = None
    for run in range(runs):
        card_params = tree_map(lambda t: t.to(dev), cpu_params)
        with torch.inference_mode():
            cpu_logits, cpu_cache = cpu_model.prefill(cpu_params, {"tokens": prompts_cpu})
            (card_logits, card_cache), n = launched(
                counters, lambda: card_model.prefill(card_params, {"tokens": prompts_cpu.to(dev)}))
            check(n == expect, f"{cfg.name}: the card's prefill launched {n}, want {expect}")
            steps = [(cpu_logits, card_logits)]
            cpu_cache = ServeEngine(cpu_model, cpu_params, max_len=max_len)._grow(cpu_cache, 2)
            card_cache = ServeEngine(card_model, card_params, max_len=max_len)._grow(card_cache, 2)
            for _ in range(steps_n):
                tok = torch.argmax(steps[-1][0], dim=-1)[:, None].to(torch.int32)
                cpu_logits, cpu_cache = cpu_model.decode_step(cpu_params, cpu_cache, tok)
                card_logits, card_cache = card_model.decode_step(card_params, card_cache, tok.to(dev))
                steps.append((cpu_logits, card_logits))
        steps = [(want, got.cpu()) for want, got in steps]
        first = first or steps
        close = [
            logits_close(got, want, f"{cfg.name} card vs CPU, run {run}, step {i}", relative)
            for i, (want, got) in enumerate(steps)
        ]
        emit(f"{phase}_card_vs_cpu", **fields, run=run, prompts=[2, prompt_len],
             decode_steps=steps_n,
             max_abs_err=[c["max_abs_err"] for c in close],
             tolerance=[c["tolerance"] for c in close],
             max_abs_logit=float(steps[0][0].float().abs().max()),
             cpu_equal_to_run_0=all(torch.equal(a[0], b[0]) for a, b in zip(steps, first)),
             card_equal_to_run_0=all(torch.equal(a[1], b[1]) for a, b in zip(steps, first)),
             cpu_capability=torch.backends.cpu.get_cpu_capability(),
             cpu_threads=torch.get_num_threads())
        del card_params, card_cache, cpu_cache
    del cpu_model, cpu_params, card_model
    torch.cuda.empty_cache()


def ssm_phases(np, torch, counters):
    """Phases 9-13: the SSD kernel, serving the ssm and hybrid families,
    serving checks.

    Returns the ``ssd_vs_plain`` rows by case name and the two serving
    phases' fields.
    """
    from repro_torch.benchmarks import roofline
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ssd_scan as ssd

    dev = torch.device("cuda")
    s_main = len(max(serve_prompts(np, 2 ** 15), key=len))

    # -- 9. the SSD kernel against its plain version ---------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for name, batch, heads, s, p, n, chunk, with_init, dtype in SSD_CASES:
        s = s or s_main
        x, dt, a_log, b, c, init = ssd_inputs(torch, gen, batch, heads, s, p, n, with_init, dtype)
        y, state = ssd.ssd_scan(x, dt, a_log, b, c, chunk=chunk, init_state=init)
        with mock.patch.object(ssd, "ssd_scan_bhsp_cuda", ssd.ssd_scan_bhsp_plain):
            want_y, want_state = ssd.ssd_scan(x, dt, a_log, b, c, chunk=chunk, init_state=init)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y.float()).all() and torch.isfinite(state).all()),
              f"ssd {name}: not finite")
        err_y, tol_y = ssd_error(y, want_y, dtype)
        err_s, tol_s = ssd_error(state, want_state, "float32")
        check(err_y <= tol_y, f"ssd {name}: y off by {err_y} > {tol_y}")
        check(err_s <= tol_s, f"ssd {name}: final state off by {err_s} > {tol_s}")
        # Times of the kernel and its plain version on the head-major inputs.
        xdt, logd = ssd.head_major(x, dt, a_log)
        h_init = None if init is None else init.reshape(batch * heads, p, n)
        kw = dict(n_heads=heads, chunk=chunk, init_state=h_init)
        bound_ms, bound_by = roofline.ssd_bound(batch, heads, s, p, n, chunk, with_init)
        flops = roofline.ssd_flops(batch, heads, s, p, n, chunk)
        row = dict(
            case=name, batch=batch, heads=heads, s=s, p=p, n=n, chunk=chunk,
            init_state=with_init, x_dtype=dtype,
            max_abs_err=err_y, tolerance=tol_y,
            state_max_abs_err=err_s, state_tolerance=tol_s,
            ms=median_ms(lambda: ssd.ssd_scan_bhsp_cuda(xdt, logd, b, c, **kw), 10),
            plain_ms=median_ms(lambda: ssd.ssd_scan_bhsp_plain(xdt, logd, b, c, **kw), 3),
            bound_ms=bound_ms, bound_by=bound_by, flops=flops, library_ms=None,
        )
        rows[name] = row
        emit("ssd_vs_plain", **row)
    del x, dt, a_log, b, c, init, y, state, want_y, want_state, xdt, logd
    torch.cuda.empty_cache()

    # -- 10, 11. serve mamba2-130m and zamba2-1.2b at full width and depth -----
    ssm_cfg = get_config(SSM_ARCH)
    hybrid_cfg = get_config(HYBRID_ARCH).replace(attention_impl="pallas")
    serve_ssm, ssm_batch = serve_run(np, torch, ssm_cfg, counters)
    emit("serve_ssm", **serve_ssm)
    serve_hybrid, hybrid_batch = serve_run(np, torch, hybrid_cfg, counters)
    emit("serve_hybrid", **serve_hybrid)

    # -- 12, 13. kernel vs plain scan and card vs CPU, depth cut --------------
    shallow = {
        SSM_ARCH: (ssm_cfg.replace(n_layers=2), ssm_batch),
        HYBRID_ARCH: (hybrid_cfg.replace(n_layers=3, hybrid_period=2), hybrid_batch),
    }
    for cfg, batch in shallow.values():
        shallow_checks(np, torch, "serve_ssm", cfg, batch, relative=True, prompt_len=300)
    return rows, serve_ssm, serve_hybrid


def norm_tolerance(dtype, want):
    """One bf16 ulp of the output's magnitude in bf16; 1e-5 of it in
    float32."""
    scale = float(want.float().abs().max())
    if dtype == "float32":
        return 1e-5 * scale
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def norm_phases(np, torch, counters):
    """Phases 14-16: the RMSNorm kernel, serving gemma-2b, its serving
    checks.

    Returns the ``rmsnorm_vs_plain`` rows by case name and the
    ``serve_gemma`` phase's fields.
    """
    import torch.nn.functional as F

    from repro_torch.benchmarks import roofline
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import rmsnorm as rn

    dev = torch.device("cuda")
    tokens = SERVE_REQUESTS * len(max(serve_prompts(np, 2 ** 15), key=len))

    # -- 14. the RMSNorm kernel against its plain version ---------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for name, t, d, x_dtype, w_dtype, offset, gated in RMSNORM_CASES:
        t = t or tokens
        x = 3 * torch.randn((t, d), generator=gen, device=dev)
        if gated:
            x = x * F.silu(torch.randn((t, d), generator=gen, device=dev))
        x = x.to(getattr(torch, x_dtype))
        w = torch.randn((d,), generator=gen, device=dev).to(getattr(torch, w_dtype))
        kw = dict(offset=offset)
        got = rn.rmsnorm_2d_cuda(x, w, **kw)
        want = rn.rmsnorm_2d_plain(x, w, **kw)
        torch.cuda.synchronize()
        check(got.dtype == x.dtype and bool(torch.isfinite(got.float()).all()),
              f"rmsnorm {name}: not finite or wrong dtype")
        err = float((got.float() - want.float()).abs().max())
        tol = norm_tolerance(x_dtype, want)
        check(err <= tol, f"rmsnorm {name}: max abs error {err} > {tol}")
        # Library yardstick, timed only: the (1 + w) of the offset form is
        # folded into the weight before the call.
        w_lib = 1.0 + w.float() if offset else w
        lib = lambda: F.rms_norm(x, (d,), w_lib, 1e-6)  # noqa: E731
        bound_ms, bound_by = roofline.rmsnorm_bound(x, w)
        row = dict(
            case=name, x=[t, d], x_dtype=x_dtype, w_dtype=w_dtype, offset=offset,
            max_abs_err=err, tolerance=tol,
            ms=median_ms(lambda: rn.rmsnorm_2d_cuda(x, w, **kw), 20),
            plain_ms=median_ms(lambda: rn.rmsnorm_2d_plain(x, w, **kw), 5),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=median_ms(lib, 20),
            library_max_abs_err=float((lib().float() - want.float()).abs().max()),
        )
        rows[name] = row
        emit("rmsnorm_vs_plain", **row)
    del x, w, got, want
    torch.cuda.empty_cache()

    # -- 15. serve gemma-2b at full width and depth ----------------------------
    cfg = get_config(GEMMA_ARCH).replace(attention_impl="pallas")
    serve, batch = serve_run(np, torch, cfg, counters)
    emit("serve_gemma", **serve)

    # -- 16. kernel vs plain and card vs CPU, depth 2 ---------------------------
    shallow_checks(np, torch, "serve_gemma", cfg.replace(n_layers=2), batch,
                   relative=True, prompt_len=64)
    return rows, serve


def reduce_phase(torch):
    """Phase 17: the fused-reduce kernel bitwise against its plain version,
    with warm median times, ``torch.add`` where it computes the same
    function (its promoted dtype is the output's), and the bound.  Returns
    the rows by case name."""
    from repro_torch.benchmarks import roofline
    from repro_torch.kernels import fused_reduce as fr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for name, shape, a_dtype, b_dtype, out_dtype in REDUCE_CASES:
        a, b = (
            torch.randn(shape, generator=gen, device=dev).to(getattr(torch, dt))
            for dt in (a_dtype, b_dtype)
        )
        out = getattr(torch, out_dtype)
        got = fr.fused_reduce_flat_cuda(a, b, out_dtype=out)
        want = fr.fused_reduce_flat_plain(a, b, out_dtype=out)
        torch.cuda.synchronize()
        check(got.dtype == out and tuple(got.shape) == shape, f"reduce {name}: dtype or shape")
        check(torch.equal(got, want), f"reduce {name}: kernel != plain")
        bound_ms, bound_by = roofline.reduce_bound(a, out, b)
        row = dict(
            case=name, shape=list(shape), a_dtype=a_dtype, b_dtype=b_dtype,
            out_dtype=out_dtype, bitwise_equal=True, max_abs_err=0.0,
            ms=median_ms(lambda: fr.fused_reduce_flat_cuda(a, b, out_dtype=out), 20),
            plain_ms=median_ms(lambda: fr.fused_reduce_flat_plain(a, b, out_dtype=out), 5),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        )
        if torch.result_type(a, b) == out:
            row["library_equal"] = torch.equal(torch.add(a, b), want)
            if row["library_equal"]:
                row["library_ms"] = median_ms(lambda: torch.add(a, b), 20)
        if name in ("f32_8M", "bf16_193M"):
            # The same sum on views one element off 16-byte alignment: the
            # scalar loop, timed beside the aligned buffers' vector loop.
            a1, b1 = a[1:], b[1:]
            check(torch.equal(fr.fused_reduce_flat_cuda(a1, b1, out_dtype=out), want[1:]),
                  f"reduce {name} misaligned: kernel != plain")
            row["misaligned_ms"] = median_ms(
                lambda: fr.fused_reduce_flat_cuda(a1, b1, out_dtype=out), 20)
        rows[name] = row
        emit("reduce_vs_plain", **row)
        del a, b, got, want
    torch.cuda.empty_cache()
    return rows


def bench_phase(torch, counters):
    """Phase 18: ``repro_torch.benchmarks.kernel_bench`` on the card -- the
    reference's one path to ``fused_reduce`` -- with every kernel count set
    to 0 just before it and read just after.  Every row must be finite and
    within its error limit, and every kernel must have launched.  Returns
    the launch counts."""
    from repro_torch.benchmarks import kernel_bench

    for fn in counters.values():
        fn.launches = 0
    rows = kernel_bench.run(device="cuda")
    launches = {name: fn.launches for name, fn in counters.items()}
    check(len(rows) == 6, f"kernel bench gave {len(rows)} rows, want 6")
    for row in rows:
        check(math.isfinite(row.us) and row.us > 0, f"{row.name}: time {row.us}")
        check(row.err is not None and row.err <= row.tol,
              f"{row.name}: error {row.err} > {row.tol}")
        emit("kernel_bench", name=row.name, us=row.us, note=row.note,
             err=row.err, tolerance=row.tol)
    check(all(n > 0 for n in launches.values()), f"kernel bench launches {launches}")
    emit("kernel_bench_launches", **launches)
    return launches

if __name__ == "__main__":
    sys.exit(main())
