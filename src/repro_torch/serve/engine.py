"""Batched serving engine: prefill + greedy decode over request batches.

The port of ``src/repro/serve/engine.py``.  Requests are left-padded into
one batch (token 1, no padding mask, exactly as the reference does), the
prompts are prefilled in one call, and decoding proceeds greedily
(``argmax``, first maximal index, as ``jnp.argmax``) until the longest
request's ``max_new_tokens``.  The engine runs on the model's device
(`repro_torch.models.lm.build_model`, which defaults to the card); the
generated tokens stay there until the end of ``generate``.

The reference's ``recorder`` hook (collective traces of each engine step)
is not ported yet (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.lm import COMPUTE_DTYPE, Model


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 16


@dataclasses.dataclass
class Completion:
    prompt: list[int]
    tokens: list[int]


class ServeEngine:
    def __init__(
        self, model: Model, params, max_len: int = 256, recorder=None
    ):
        if recorder is not None:
            raise NotImplementedError(
                "the serving trace recorder is not ported yet "
                "(ROADMAP Queue 1 item 10)"
            )
        self.model = model
        self.params = params
        self.max_len = max_len

    def _pad_batch(self, requests: list[Request]) -> torch.Tensor:
        max_prompt = max(len(r.prompt) for r in requests)
        tokens = torch.ones((len(requests), max_prompt), dtype=torch.int32)
        for i, r in enumerate(requests):
            # Left-pad with token 1 so every prompt ends at the same
            # position (keeps the prefill cache rectangular).
            tokens[i, max_prompt - len(r.prompt) :] = torch.tensor(
                r.prompt, dtype=torch.int32
            )
        return tokens.to(self.model.device)

    @torch.inference_mode()
    def generate(self, requests: list[Request]) -> list[Completion]:
        cfg = self.model.cfg
        tokens = self._pad_batch(requests)
        batch = {"tokens": tokens}
        if cfg.n_image_patches and cfg.family in ("vlm", "moe"):
            batch["image_embeds"] = torch.zeros(
                (tokens.shape[0], cfg.n_image_patches, cfg.d_model),
                dtype=COMPUTE_DTYPE,
                device=tokens.device,
            )
        logits, cache = self.model.prefill(self.params, batch)
        cache = self._grow(cache, tokens.shape[0])
        max_new = max(r.max_new_tokens for r in requests)
        outs = []
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        for _ in range(max_new):
            outs.append(tok[:, 0])
            logits, cache = self.model.decode_step(self.params, cache, tok)
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        columns = torch.stack(outs, dim=1).tolist()  # (B, max_new)
        return [
            Completion(
                prompt=list(r.prompt),
                tokens=columns[i][: r.max_new_tokens],
            )
            for i, r in enumerate(requests)
        ]

    def _grow(self, cache, batch_size: int):
        """Pad prefill-length KV caches to max_len capacity."""
        specs = self.model.cache_specs(batch_size, self.max_len)
        grown = {}
        for name, value in cache.items():
            shape = tuple(
                max(c, t) for c, t in zip(value.shape, specs[name].shape)
            )
            if value.dim() >= 3 and tuple(value.shape) != shape:
                out = value.new_zeros(shape)
                out[tuple(slice(0, c) for c in value.shape)] = value
                grown[name] = out
            else:
                grown[name] = value
        return grown
