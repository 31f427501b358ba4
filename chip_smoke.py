#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``src/repro_torch/kernels/csrc``
(into ``build/repro_torch/``), then, each phase printing one JSON line:

1. ``card`` / ``build``: the card's name and power limit, the build time;
2. ``main_path``: ``repro_torch.core.api.plan`` on the full sweep grid --
   32 message sizes (1-32 MB) x 32 reconfiguration delays (12.5-400 us)
   of a 128-node pairwise all-to-all (127 steps) on 8 planes, 1024 cells,
   default options -- cold, warm and with attribution, with the kernel's
   launch count read around the cold run; the Fig. 5 anchor (1300 us
   planned, 1500 us strawman, the strawman also planned per instance);
3. ``kernel_vs_plain``: the kernel against its plain torch version on the
   card, bitwise, attribution off and on, on the grid's strawman and
   greedy decisions and on a 64-cell relay-carrying (bypass) batch, with
   warm median times;
4. ``card_vs_cpu``: the card's plans bitwise equal to the port's CPU
   plans on the first 8 grid cells, the attribution of every grid cell
   whose decomposition misses its CCT by one ulp, the 64-cell bypass grid
   and a 64-cell INDEPENDENT grid (packing and water-fill splitting).

Then one line listing each kernel with its numbers, and last
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
exits non-zero and prints no ``ok`` line.  It imports nothing of JAX or of
the reference package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N_NODES, N_PLANES = 128, 8
SIZES = tuple(1e6 * (1 + i) for i in range(32))
RECFGS = tuple(12.5e-6 * (1 + i) for i in range(32))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP64_FLOPS = 34e12  # H100 SXM fp64 outside the tensor cores, data sheet
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/timing_scan.cu"
KERNEL_REPLACES = "src/repro/kernels/timing_scan.py:47"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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
    from repro_torch.kernels import _build
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
    t0 = time.perf_counter()
    lib = _build.build("timing_scan")
    _build.load("timing_scan")
    log = Path(f"{lib}.log")
    emit("build", kernel="timing_scan", seconds=time.perf_counter() - t0,
         ptxas=log.read_text().strip().splitlines()[-8:] if log.exists() else [])

    # -- main path at full width ---------------------------------------------
    patterns = {size: pairwise_alltoall(N_NODES, size) for size in SIZES}
    cells = [
        (OpticalFabric(N_NODES, N_PLANES, t_recfg=t), patterns[size])
        for size in SIZES
        for t in RECFGS
    ]
    request = PlanRequest.grid(cells, options=PlannerOptions(device="cuda"))

    def timed_plan(req):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = plan(req)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - start) * 1e3

    torch.cuda.reset_peak_memory_stats()
    timing_scan.launches = 0
    result, cold_ms = timed_plan(request)
    launches = timing_scan.launches
    check(launches == 2, f"plan() launched timing_scan {launches} times, want 2")
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
    def median_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def bound(tensors, outs):
        """Least time for the work: bytes at HBM rate vs fp64 ops at peak."""
        n_bytes = sum(t.numel() * t.element_size() for t in tensors.values())
        n_bytes += sum(t.numel() * t.element_size() for t in outs)
        live = tensors["step_mask"][:, :, None] & tensors["plane_mask"][:, None, :]
        hops = (tensors["byp_plane"] >= 0) & (tensors["byp_vol"] > 0)[..., None]
        # Per live (step, plane): divide, add, max, busy add, step max;
        # per live step: 5 conservation/barrier ops; per hop: 5.
        ops = 5 * int(live.sum()) + 5 * int(tensors["step_mask"].sum())
        ops += 5 * int(hops.sum())
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP64_FLOPS * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

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
            bound_ms, bound_by = bound(tensors, got)
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

    main_row = rows[("greedy", False)]
    print(json.dumps({"kernels": [{
        "name": "timing_scan",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
