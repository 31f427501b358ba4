"""Optical fabric model: p compute nodes fully connected to k OCS planes.

A copy of the reference package's fabric model, kept in the port so that
``repro_torch`` stands alone.

The paper's topology (Fig. 2): every node has k interfaces; interface j is
wired to OCS j ("plane" j).  Each OCS is an N x N circuit switch whose state
is a bijective port map -- a permutation P in {0,1}^{NxN} -- and changing
that state costs ``t_recfg`` seconds during which the plane carries no
traffic.  All links run at ``bandwidth`` bytes/s.

Because every node participates symmetrically in a collective step (uniform
message sizes, dedicated per-plane links), scheduling collapses to per-plane
decisions -- exactly the (step i, OCS j) index space of the paper's MILP
(Table 1).  ``OpticalFabric`` therefore tracks per-plane config ids rather
than full permutations; ``repro_torch.core.patterns`` owns the mapping
from config ids to node-level bijective pairings.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

# Paper's evaluation constants (Section 4.1): 200 Gbps links, 200 us reconfig.
PAPER_LINK_BANDWIDTH = 200e9 / 8  # bytes/s
PAPER_RECONFIG_LATENCY = 200e-6  # seconds
# Motivation example (Fig. 5) uses 400 Gbps links.
FIG5_LINK_BANDWIDTH = 400e9 / 8  # bytes/s


@dataclasses.dataclass(frozen=True)
class OpticalFabric:
    """Static description of the optical interconnect.

    Attributes:
      n_nodes: number of compute nodes (p in the paper).
      n_planes: number of OCS devices / NICs per node (k in the paper).
      bandwidth: per-link bandwidth in bytes/s (B in the paper).
      t_recfg: OCS reconfiguration latency in seconds (T_recfg).
      plane_bandwidth_scale: optional per-plane multiplier on ``bandwidth``;
        values < 1 model degraded ("straggler") optical planes.  Length
        ``n_planes``; defaults to all-ones.
      initial_configs: config id installed on each plane before the
        collective starts (``None`` entries mean unconfigured).  The paper's
        motivation example pre-stages every plane at the first step's config.
    """

    n_nodes: int
    n_planes: int
    bandwidth: float = PAPER_LINK_BANDWIDTH
    t_recfg: float = PAPER_RECONFIG_LATENCY
    plane_bandwidth_scale: tuple[float, ...] | None = None
    initial_configs: tuple[int | None, ...] | None = None

    def __post_init__(self) -> None:
        if self.n_nodes < 2:
            raise ValueError(f"need >= 2 nodes, got {self.n_nodes}")
        if self.n_planes < 1:
            raise ValueError(f"need >= 1 plane, got {self.n_planes}")
        if self.bandwidth <= 0:
            raise ValueError("bandwidth must be positive")
        if self.t_recfg < 0:
            raise ValueError("t_recfg must be non-negative")
        if self.plane_bandwidth_scale is not None:
            if len(self.plane_bandwidth_scale) != self.n_planes:
                raise ValueError("plane_bandwidth_scale length mismatch")
            if any(s <= 0 for s in self.plane_bandwidth_scale):
                raise ValueError("plane bandwidth scales must be positive")
        if self.initial_configs is not None:
            if len(self.initial_configs) != self.n_planes:
                raise ValueError("initial_configs length mismatch")

    def plane_bandwidth(self, plane: int) -> float:
        """Effective bandwidth of ``plane`` in bytes/s."""
        scale = 1.0
        if self.plane_bandwidth_scale is not None:
            scale = self.plane_bandwidth_scale[plane]
        return self.bandwidth * scale

    def initial_config(self, plane: int) -> int | None:
        if self.initial_configs is None:
            return None
        return self.initial_configs[plane]

    def with_initial_configs(
        self, configs: Sequence[int | None]
    ) -> "OpticalFabric":
        return dataclasses.replace(self, initial_configs=tuple(configs))

    def prestaged(self, config: int) -> "OpticalFabric":
        """All planes pre-staged at ``config`` (the paper's Fig. 5 setup)."""
        return self.with_initial_configs((config,) * self.n_planes)
