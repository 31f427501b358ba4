"""Architecture registry: ``get_config(name)`` / ``--arch <id>``.

Exact assigned configs live in one module per architecture
(``repro_torch.configs.<id>``); ``smoke_config(name)`` returns the reduced
same-family variant used by CPU smoke tests.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

ARCH_IDS: tuple[str, ...] = (
    "qwen3_4b",
    "gemma_2b",
    "qwen2_1_5b",
    "h2o_danube3_4b",
    "mamba2_130m",
    "zamba2_1_2b",
    "pixtral_12b",
    "qwen2_moe_a2_7b",
    "llama4_scout_17b_16e",
    "whisper_small",
)

_ALIASES = {
    "qwen3-4b": "qwen3_4b",
    "gemma-2b": "gemma_2b",
    "qwen2-1.5b": "qwen2_1_5b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "mamba2-130m": "mamba2_130m",
    "zamba2-1.2b": "zamba2_1_2b",
    "pixtral-12b": "pixtral_12b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_16e",
    "whisper-small": "whisper_small",
}


def canonical(name: str) -> str:
    name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return name


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def smoke_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.SMOKE


def all_configs() -> dict[str, ArchConfig]:
    return {name: get_config(name) for name in ARCH_IDS}
