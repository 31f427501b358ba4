"""Carry planner state across from the reference package into the port.

The scheduler's counterpart of carrying weights across: the port builds
its own ``OpticalFabric``, ``Pattern``, ``Decisions``/``BypassRoute`` and
``BatchInstance`` from objects of the reference package (or any object
with the same attributes), read by duck typing -- this module imports
nothing of the reference.  ``packed_from_numpy`` moves a ``pack_instances``
array set onto a torch device for the timing kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fabric import OpticalFabric
from repro_torch.core.ir.engine import BatchInstance
from repro_torch.core.patterns import Pattern, Step
from repro_torch.core.schedule import BypassRoute, Decisions, DependencyMode


def fabric_from(obj) -> OpticalFabric:
    """The port's ``OpticalFabric`` with ``obj``'s fields."""
    return OpticalFabric(
        n_nodes=obj.n_nodes,
        n_planes=obj.n_planes,
        bandwidth=obj.bandwidth,
        t_recfg=obj.t_recfg,
        plane_bandwidth_scale=(
            None
            if obj.plane_bandwidth_scale is None
            else tuple(obj.plane_bandwidth_scale)
        ),
        initial_configs=(
            None
            if obj.initial_configs is None
            else tuple(obj.initial_configs)
        ),
    )


def pattern_from(obj) -> Pattern:
    """The port's ``Pattern`` with ``obj``'s name, nodes and steps."""
    return Pattern(
        name=obj.name,
        n_nodes=obj.n_nodes,
        steps=tuple(
            Step(config=s.config, volume=s.volume, perm=tuple(s.perm))
            for s in obj.steps
        ),
    )


def mode_from(obj) -> DependencyMode:
    """The port's ``DependencyMode`` of the same value."""
    return DependencyMode(getattr(obj, "value", obj))


def decisions_from(obj) -> Decisions:
    """The port's ``Decisions``: splits, mode and bypass routes."""
    bypass = None
    if obj.bypass is not None:
        bypass = tuple(
            tuple(
                BypassRoute(planes=tuple(r.planes), volume=r.volume)
                for r in routes
            )
            for routes in obj.bypass
        )
    return Decisions(
        splits=tuple(dict(s) for s in obj.splits),
        mode=mode_from(obj.mode),
        bypass=bypass,
    )


def cell_from(fabric, pattern) -> tuple[OpticalFabric, Pattern]:
    """One (fabric, pattern) grid cell in the port's types."""
    return fabric_from(fabric), pattern_from(pattern)


def instance_from(obj) -> BatchInstance:
    """The port's ``BatchInstance`` of a (fabric, pattern, decisions)."""
    return BatchInstance(
        fabric_from(obj.fabric),
        pattern_from(obj.pattern),
        decisions_from(obj.decisions),
    )


def packed_from_numpy(
    packed: dict[str, np.ndarray], device: "str | torch.device"
) -> dict[str, torch.Tensor]:
    """A packed batch as contiguous tensors on ``device``.

    Dtypes carry over unchanged (float64, int64, bool), as the timing
    kernel takes them.
    """
    return {
        key: torch.as_tensor(np.ascontiguousarray(arr), device=device)
        for key, arr in packed.items()
    }
