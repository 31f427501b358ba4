#!/usr/bin/env python3
"""Where one warm ``plan()`` of the 1024-cell sweep grid spends its time.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/profile_plan.py [--cells N]

It plans the grid of ``chip_smoke.py`` (``--cells`` takes the first N
cells; default all 1024) once to warm up, times one more plan on the host
clock, then profiles a third with ``torch.profiler`` (CPU and CUDA
activities) and prints one JSON line: the unprofiled wall time, the
profiled wall time, the device's summed kernel time and its idle share of
the profiled window, the number of kernel launches, and the operators and
kernels that take the most device time.  The card's name and power limit
come first, as ``nvidia-smi`` prints them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cells", type=int, default=1024)
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_plan: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import OpticalFabric, PlannerOptions, PlanRequest, plan
    from repro_torch.core.patterns import pairwise_alltoall

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0], flush=True)
    sizes = tuple(1e6 * (1 + i) for i in range(32))
    recfgs = tuple(12.5e-6 * (1 + i) for i in range(32))
    patterns = {s: pairwise_alltoall(128, s) for s in sizes}
    cells = [
        (OpticalFabric(128, 8, t_recfg=t), patterns[s])
        for s in sizes
        for t in recfgs
    ][: args.cells]
    request = PlanRequest.grid(cells, options=PlannerOptions(device="cuda"))

    def timed() -> float:
        torch.cuda.synchronize()
        start = time.perf_counter()
        plan(request)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3

    timed()
    wall_ms = timed()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_ms = timed()
    events = prof.key_averages()
    device_us = sum(
        e.self_device_time_total for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    launches = sum(
        e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel")
    )
    top_ops = sorted(
        (e for e in events if e.device_type == torch.autograd.DeviceType.CPU
         and e.key.startswith("aten::") and e.self_device_time_total > 0),
        key=lambda e: -e.device_time_total,
    )[:8]
    top_kernels = sorted(
        (e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: -e.self_device_time_total,
    )[:5]
    print(json.dumps({
        "cells": len(cells),
        "device": torch.cuda.get_device_name(0),
        "wall_ms": wall_ms,
        "profiled_wall_ms": profiled_ms,
        "device_kernel_ms": device_us / 1e3,
        "device_idle_share": 1.0 - device_us / 1e3 / profiled_ms,
        "kernel_launches": launches,
        "top_ops_device_ms": {
            e.key: [e.device_time_total / 1e3, e.count] for e in top_ops
        },
        "top_kernels_device_ms": {
            e.key[:80]: [e.self_device_time_total / 1e3, e.count]
            for e in top_kernels
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
