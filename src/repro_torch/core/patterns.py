"""Collective-communication algorithms as multi-step bijective pairings.

A copy of the reference package's pattern library, kept in the port so
that ``repro_torch`` stands alone.

The paper (Section 2.1.2) formalizes a CC algorithm as a sequence of steps;
at step ``i`` every node ``x`` exchanges data with node ``perm[x]`` (a
bijection over nodes) and the aggregate volume a node must move at that step
is ``volume`` bytes.  Each distinct bijection corresponds to one OCS setting
("config"); steps sharing a config id can reuse an installed circuit without
paying the reconfiguration latency.

Volumes follow the standard algorithm analyses, with ``size`` denoting the
per-node collective buffer in bytes (the "message size" axis of the paper's
Figure 7):

* Ring AllReduce        -- 2(N-1) steps of ``size/N``; a single rotation
                           config for every step.
* Rabenseifner AllReduce-- reduce-scatter: log2 N steps of ``size/2^t``;
                           all-gather mirrors them (Fig. 3's 20/10/5 MB for
                           size=40 MB, N=8).
* Pairwise All-to-All   -- N-1 steps of ``size/N`` (one block per peer),
                           every step a distinct rotation config.
* Bruck All-to-All      -- ceil(log2 N) phases; phase k moves the blocks
                           whose destination offset has bit k set
                           (~``size/2`` per phase), rotation-by-2^k configs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable


@dataclasses.dataclass(frozen=True)
class Step:
    """One communication step of a collective algorithm.

    Attributes:
      config: config id; equal ids denote identical OCS settings.
      volume: bytes each node must move during this step (aggregated over
        planes -- the scheduler splits it across planes).
      perm: node-level pairing pi_i as a tuple (perm[x] = peer of node x).
    """

    config: int
    volume: float
    perm: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Pattern:
    """A collective algorithm instance: an ordered sequence of steps."""

    name: str
    n_nodes: int
    steps: tuple[Step, ...]

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    @property
    def configs(self) -> tuple[int, ...]:
        return tuple(s.config for s in self.steps)

    @property
    def volumes(self) -> tuple[float, ...]:
        return tuple(s.volume for s in self.steps)

    @property
    def n_distinct_configs(self) -> int:
        return len(set(self.configs))

    @property
    def total_volume(self) -> float:
        """Total bytes moved per node over the whole collective."""
        return sum(s.volume for s in self.steps)

    def validate(self) -> None:
        n = self.n_nodes
        by_config: dict[int, tuple[int, ...]] = {}
        for step in self.steps:
            if len(step.perm) != n:
                raise ValueError(f"{self.name}: perm arity != {n}")
            if sorted(step.perm) != list(range(n)):
                raise ValueError(f"{self.name}: step pairing is not bijective")
            if step.volume < 0:
                raise ValueError(f"{self.name}: negative volume")
            prev = by_config.setdefault(step.config, step.perm)
            if prev != step.perm:
                raise ValueError(
                    f"{self.name}: config id {step.config} maps to two "
                    "different permutations"
                )


def _rotation(n: int, k: int) -> tuple[int, ...]:
    return tuple((x + k) % n for x in range(n))


def _xor_pairing(n: int, mask: int) -> tuple[int, ...]:
    return tuple(x ^ mask for x in range(n))


def _require_power_of_two(n: int, name: str) -> int:
    log = n.bit_length() - 1
    if 1 << log != n:
        raise ValueError(f"{name} requires power-of-two nodes, got {n}")
    return log


def ring_allreduce(n_nodes: int, size: float) -> Pattern:
    """Ring AllReduce: reduce-scatter ring then all-gather ring."""
    if n_nodes < 2:
        raise ValueError("need >= 2 nodes")
    chunk = size / n_nodes
    perm = _rotation(n_nodes, 1)
    steps = tuple(
        Step(config=0, volume=chunk, perm=perm)
        for _ in range(2 * (n_nodes - 1))
    )
    return Pattern("ring_allreduce", n_nodes, steps)


def rabenseifner_allreduce(n_nodes: int, size: float) -> Pattern:
    """Rabenseifner's AllReduce: recursive-halving RS + recursive-doubling AG."""
    log = _require_power_of_two(n_nodes, "rabenseifner_allreduce")
    steps: list[Step] = []
    # Reduce-scatter phase: step t exchanges size/2^t with peer i xor 2^(t-1).
    for t in range(1, log + 1):
        steps.append(
            Step(
                config=t - 1,
                volume=size / (2**t),
                perm=_xor_pairing(n_nodes, 1 << (t - 1)),
            )
        )
    # All-gather phase mirrors the reduce-scatter phase.
    for t in range(log, 0, -1):
        steps.append(
            Step(
                config=t - 1,
                volume=size / (2**t),
                perm=_xor_pairing(n_nodes, 1 << (t - 1)),
            )
        )
    return Pattern("rabenseifner_allreduce", n_nodes, tuple(steps))


def reduce_scatter(n_nodes: int, size: float) -> Pattern:
    """Recursive-halving reduce-scatter (first half of Rabenseifner)."""
    log = _require_power_of_two(n_nodes, "reduce_scatter")
    steps = tuple(
        Step(
            config=t - 1,
            volume=size / (2**t),
            perm=_xor_pairing(n_nodes, 1 << (t - 1)),
        )
        for t in range(1, log + 1)
    )
    return Pattern("reduce_scatter", n_nodes, steps)


def all_gather(n_nodes: int, size: float) -> Pattern:
    """Recursive-doubling all-gather (second half of Rabenseifner)."""
    log = _require_power_of_two(n_nodes, "all_gather")
    steps = tuple(
        Step(
            config=t - 1,
            volume=size / (2**t),
            perm=_xor_pairing(n_nodes, 1 << (t - 1)),
        )
        for t in range(log, 0, -1)
    )
    return Pattern("all_gather", n_nodes, steps)


def pairwise_alltoall(n_nodes: int, size: float) -> Pattern:
    """Pairwise-exchange All-to-All: N-1 steps, step k pairs i with i+k."""
    if n_nodes < 2:
        raise ValueError("need >= 2 nodes")
    block = size / n_nodes
    steps = tuple(
        Step(config=k - 1, volume=block, perm=_rotation(n_nodes, k))
        for k in range(1, n_nodes)
    )
    return Pattern("pairwise_alltoall", n_nodes, steps)


def bruck_alltoall(n_nodes: int, size: float) -> Pattern:
    """Bruck's All-to-All: ceil(log2 N) phases of rotation-by-2^k sends.

    Phase k forwards every block whose remaining destination offset has bit
    k set; for offset o in [1, N), that is ``popcount-style`` membership, so
    the phase volume is ``(#offsets with bit k set) * size / N``.
    """
    if n_nodes < 2:
        raise ValueError("need >= 2 nodes")
    block = size / n_nodes
    n_phases = max(1, math.ceil(math.log2(n_nodes)))
    steps = []
    for k in range(n_phases):
        n_blocks = sum(1 for o in range(1, n_nodes) if (o >> k) & 1)
        if n_blocks == 0:
            continue
        steps.append(
            Step(
                config=k,
                volume=n_blocks * block,
                perm=_rotation(n_nodes, (1 << k) % n_nodes),
            )
        )
    return Pattern("bruck_alltoall", n_nodes, tuple(steps))


def neighbor_exchange(n_nodes: int, size: float) -> Pattern:
    """Single-step ring handoff: every node sends ``size`` to its successor.

    The point-to-point pattern pipeline parallelism issues per microbatch
    tick (the stage handoff) and the optical image of a collective
    permute: one bijective pairing, one circuit configuration, no
    multi-step structure.
    """
    if n_nodes < 2:
        raise ValueError("need >= 2 nodes")
    return Pattern(
        "neighbor_exchange",
        n_nodes,
        (Step(config=0, volume=size, perm=_rotation(n_nodes, 1)),),
    )


ALGORITHMS: dict[str, Callable[[int, float], Pattern]] = {
    "ring_allreduce": ring_allreduce,
    "rabenseifner_allreduce": rabenseifner_allreduce,
    "reduce_scatter": reduce_scatter,
    "all_gather": all_gather,
    "pairwise_alltoall": pairwise_alltoall,
    "bruck_alltoall": bruck_alltoall,
    "neighbor_exchange": neighbor_exchange,
}


def get_pattern(name: str, n_nodes: int, size: float) -> Pattern:
    try:
        factory = ALGORITHMS[name]
    except KeyError:
        raise KeyError(
            f"unknown collective algorithm {name!r}; "
            f"available: {sorted(ALGORITHMS)}"
        ) from None
    pattern = factory(n_nodes, size)
    pattern.validate()
    return pattern
