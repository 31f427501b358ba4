#!/usr/bin/env python3
"""Where a warm prefill and a warm decode step of the serving path go.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/profile_serve.py [--arch ID] [--layers N] [--steps N]

It builds one of ``chip_smoke.py``'s serving configurations -- full-width
qwen2-1.5B (the default), mamba2-130m or zamba2-1.2b (``--arch``), at full
depth unless ``--layers``, random weights from seed 0, attention through
the ``flash_attention`` kernel and the Mamba2 scan through the
``ssd_scan`` kernel, 8 requests of 1024-2048 prompt tokens from
``numpy.random.default_rng(0)`` -- warms it up, then
profiles one prefill and ``--steps`` decode steps with ``torch.profiler``
(CPU and CUDA activities), each window on its own.  For each window it
prints one JSON line: the profiled wall time, the device's summed kernel
time and its idle share of the window, the number of kernel launches,
and the kernels that take the most device time.  The card's name and
power limit come first, as ``nvidia-smi`` prints them.
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
    parser.add_argument("--arch", default="qwen2_1_5b")
    parser.add_argument("--layers", type=int, default=None)
    parser.add_argument("--steps", type=int, default=8)
    args = parser.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0], flush=True)
    cfg = get_config(args.arch).replace(attention_impl="pallas")
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(2, cfg.vocab_size, int(n)).tolist()
        for n in rng.integers(1024, 2049, 8)
    ]
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    engine = ServeEngine(model, params, max_len=2080)
    batch = {"tokens": engine._pad_batch([Request(prompt=p) for p in prompts])}

    def prefill():
        logits, cache = model.prefill(params, batch)
        return logits, engine._grow(cache, len(prompts))

    def decode(state):
        logits, cache = state
        for _ in range(args.steps):
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            logits, cache = model.decode_step(params, cache, tok)
        return logits, cache

    def window(name, fn, *fn_args):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            out = fn(*fn_args)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3
        events = prof.key_averages()
        kernels = [
            e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
        ]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        print(json.dumps({
            "window": name,
            "arch": cfg.name,
            "layers": cfg.n_layers,
            "device": torch.cuda.get_device_name(0),
            "profiled_wall_ms": wall_ms,
            "device_kernel_ms": device_ms,
            "device_idle_share": 1.0 - device_ms / wall_ms,
            "kernel_launches": sum(
                e.count for e in events
                if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
            ),
            "top_kernels_device_ms": {
                e.key[:80]: [e.self_device_time_total / 1e3, e.count]
                for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
            },
        }), flush=True)
        return out

    with torch.inference_mode():
        decode(prefill())  # warm-up
        state = window("prefill", prefill)
        window(f"decode_{args.steps}_steps", decode, state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
