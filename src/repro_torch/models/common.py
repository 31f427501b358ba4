"""Shared model building blocks: param specs, norms, rope, activations.

The port of ``src/repro/models/common.py``.  Models are spec-first: every
module describes its parameters as a nested dict of ``ParamSpec`` (shape,
logical axes, initializer, dtype), and ``init_params`` materializes one.
Parameters are plain nested dicts of tensors in the reference's layouts,
so the model functions read like the reference's and a JAX params tree
converts leaf for leaf (`repro_torch.models.convert`).

The numerics keep the reference's float32 up-casts and its casts back to
the input dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.kernels import rmsnorm as rmsnorm_lib

Pytree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative parameter: shape, logical axes, initializer."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float | None = None  # stddev override; default 1/sqrt(fan_in)
    dtype: torch.dtype = torch.float32

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"axes arity {self.axes} != shape arity {self.shape}"
            )

    @property
    def fan_in(self) -> int:
        return self.shape[0] if self.shape else 1

    def materialize(
        self, generator: torch.Generator, device: torch.device
    ) -> torch.Tensor:
        """Draw the leaf with ``generator`` (on the generator's device),
        then place it on ``device``: the same seed gives the same weights
        wherever they end up."""
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        if self.init == "embed":
            std = self.scale if self.scale is not None else 1.0
        else:
            std = (
                self.scale
                if self.scale is not None
                else 1.0 / math.sqrt(max(self.fan_in, 1))
            )
        out = torch.randn(
            self.shape,
            generator=generator,
            dtype=self.dtype,
            device=generator.device,
        )
        return out.mul_(std).to(device)


def tree_map(fn: Callable, tree: Pytree) -> Pytree:
    """Apply ``fn`` to every leaf of a nested dict (keys in sorted order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree: Pytree) -> list:
    """Leaves of a nested dict, keys in sorted order (as ``jax.tree``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def init_params(
    spec_tree: Pytree,
    generator: torch.Generator,
    device: "str | torch.device | None" = None,
) -> Pytree:
    """Materialize a ParamSpec tree, leaf by leaf in sorted-key order.

    ``device`` defaults to the generator's.  The reference folds one
    ``jax.random`` key per leaf; the draws here differ from it.
    """
    dev = torch.device(device) if device is not None else generator.device
    return tree_map(lambda s: s.materialize(generator, dev), spec_tree)


def stack_specs(spec_tree: Pytree, n: int, axis_name: str = "layers") -> Pytree:
    """Prepend a stacking dimension (the reference's scan-over-layers
    layout, kept so that parameters convert leaf for leaf)."""
    return tree_map(
        lambda s: dataclasses.replace(
            s, shape=(n, *s.shape), axes=(axis_name, *s.axes)
        ),
        spec_tree,
    )


def param_count(spec_tree: Pytree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(spec_tree))


# ---------------------------------------------------------------------------
# Numerics.


def rms_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    eps: float = 1e-6,
    offset: bool = False,
) -> torch.Tensor:
    """RMSNorm in fp32; ``offset=True`` uses the Gemma (1 + w) convention.

    Through `repro_torch.kernels.rmsnorm`: the hand-written CUDA kernel on
    CUDA tensors, its plain torch version (the reference's order of
    operations) on CPU tensors.
    """
    return rmsnorm_lib.rmsnorm(x, weight, eps=eps, offset=offset)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * weight + bias).to(dtype)


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def rope_frequencies(
    head_dim: int, theta: float, positions: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embeddings at given positions (fp32)."""
    half = head_dim // 2
    exponent = -torch.arange(
        0, half, dtype=torch.float32, device=positions.device
    ) / half
    # A Python base: no host-to-device copy (which would sync the stream).
    freq = torch.pow(float(theta), exponent)
    angles = positions.float()[..., None] * freq  # (..., half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """Rotate pairs (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2 cos).

    ``x``: (..., seq, heads, head_dim); cos/sin: (..., seq, half).
    """
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)
