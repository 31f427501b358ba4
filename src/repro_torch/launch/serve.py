"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Builds a model (the smoke config, or the full one with ``--full``) with
random weights and serves a batch of synthetic requests through the
batched engine, on the card unless ``--device cpu`` is given.

Weights come from a ``torch.Generator`` seeded with 0 on the target
device, and prompts from ``numpy.random.default_rng(1)``; both differ from
the reference launcher's ``jax.random`` draws.  Restoring a trainer
checkpoint (the reference's ``--ckpt-dir``) waits for the training slice
(ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.lm import build_model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", choices=ARCH_IDS, default="qwen2_1_5b")
    parser.add_argument("--requests", type=int, default=4)
    parser.add_argument("--max-new-tokens", type=int, default=12)
    parser.add_argument("--max-len", type=int, default=256)
    parser.add_argument("--full", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = get_config(args.arch) if args.full else smoke_config(args.arch)
    device = resolve_device(args.device)
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))

    engine = ServeEngine(model, params, max_len=args.max_len)
    rng = np.random.default_rng(1)
    requests = []
    for _ in range(args.requests):
        length = int(rng.integers(2, 9))
        prompt = [int(t) for t in rng.integers(1, cfg.vocab_size, length)]
        requests.append(
            Request(prompt=prompt, max_new_tokens=args.max_new_tokens)
        )
    for i, completion in enumerate(engine.generate(requests)):
        print(
            f"request {i}: {len(completion.prompt)} prompt tokens -> "
            f"{completion.tokens}"
        )


if __name__ == "__main__":
    main()
