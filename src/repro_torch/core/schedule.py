"""Schedule data structures and legality validation.

The port's copy of the reference package's schedule objects.

A ``Schedule`` is a set of timed per-plane activities (transmissions and
reconfigurations) realizing a collective ``Pattern`` on an ``OpticalFabric``.
``validate`` enforces the paper's three legality properties (Section 3.2):

* **P1  Transmission-reconfiguration precedence** -- a plane transmits a
  step's data only while holding that step's config; reconfiguration
  installs it beforehand.
* **P2  No overlapping activity per OCS** -- activities on one plane are
  pairwise disjoint in time.
* **P3  Cross-step synchronization** -- step ``i`` transmissions start only
  after step ``i-1`` completes ("chain" mode).  The beyond-paper
  "independent" mode replaces the global barrier with true data
  dependencies (none, for pairwise all-to-all), validating only P1/P2 and
  volume conservation.
* **P4  Bypass relay legality** -- a transmission whose config differs
  from its step's config must belong to a relay route (Topology
  Bypassing, `repro_torch.core.bypass`): its hops ride *installed* circuits
  (P1 enforces that per plane), carry equal volumes, run in data order
  (hop ``k+1`` starts no earlier than hop ``k`` ends), and their
  permutations compose to the step's pairing.  Delivered volume counts
  once per route; each hop still consumes its plane's full link capacity
  for its duration (P2 enforces that).

Plus physical feasibility: transmission intervals are long enough for their
volume at plane bandwidth, reconfigurations last at least ``t_recfg``, and
per-step volumes sum to the pattern's requirement.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import defaultdict

from repro_torch.core.fabric import OpticalFabric
from repro_torch.core.patterns import Pattern
from repro_torch.core.tolerances import REL_TOL as _REL_TOL
from repro_torch.core.tolerances import TOL as _TOL
from repro_torch.core.tolerances import times_close as _times_close


class DependencyMode(str, enum.Enum):
    """How steps depend on one another.

    CHAIN is the paper's P3 (global step barrier).  INDEPENDENT is the
    beyond-paper relaxation for collectives whose steps carry no data
    dependency (pairwise all-to-all).
    """

    CHAIN = "chain"
    INDEPENDENT = "independent"


class Kind(str, enum.Enum):
    XMIT = "xmit"
    RECFG = "recfg"


@dataclasses.dataclass(frozen=True)
class PlaneActivity:
    """A timed activity on one optical plane.

    For XMIT: ``step`` is the pattern step served, ``volume`` the bytes
    carried on this plane, ``config`` the OCS setting the traffic rides.
    For RECFG: ``config`` is the setting being installed; ``step`` records
    the step that motivated it (bookkeeping only).

    Bypass relays (Topology Bypassing): a transmission that is hop
    ``hop`` of relay route ``route`` carries ``config`` equal to the
    plane's *installed* setting rather than the step's; ``route`` is a
    schedule-unique non-negative id grouping the hops, and ``route=-1``
    marks an ordinary direct transmission.
    """

    plane: int
    kind: Kind
    step: int
    start: float
    end: float
    config: int
    volume: float = 0.0
    route: int = -1
    hop: int = 0

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class Schedule:
    fabric: OpticalFabric
    pattern: Pattern
    activities: tuple[PlaneActivity, ...]
    mode: DependencyMode = DependencyMode.CHAIN

    @property
    def cct(self) -> float:
        """Communication completion time: latest transmission end."""
        ends = [a.end for a in self.activities if a.kind is Kind.XMIT]
        return max(ends) if ends else 0.0

    @property
    def total_reconfigurations(self) -> int:
        return sum(1 for a in self.activities if a.kind is Kind.RECFG)

    def step_window(self, step: int) -> tuple[float, float]:
        xs = [
            a
            for a in self.activities
            if a.kind is Kind.XMIT and a.step == step
        ]
        if not xs:
            raise ValueError(f"no transmissions for step {step}")
        return min(a.start for a in xs), max(a.end for a in xs)

    def validate(self) -> None:
        """Check legality through the vectorized IR path.

        ``validate_object`` (this module) is the interpreted validator,
        kept as the debug oracle; ``repro_torch.core.ir.validate_ir``
        accepts/rejects identically.
        """
        from repro_torch.core.ir import to_ir, validate_ir

        validate_ir(to_ir(self))


def validate_object(schedule: Schedule) -> None:
    """Raise ``ValueError`` unless the schedule is legal (P1, P2, P3).

    The interpreted object-path validator.  ``Schedule.validate`` runs the
    vectorized IR twin instead; this one is retained as the debug oracle
    the IR path is property-tested against.
    """
    fabric = schedule.fabric
    pattern = schedule.pattern
    acts = schedule.activities
    n_steps = pattern.n_steps

    for a in acts:
        if not 0 <= a.plane < fabric.n_planes:
            raise ValueError(f"activity on unknown plane {a.plane}")
        if a.start < -_TOL or a.end < a.start - _TOL:
            raise ValueError(f"activity has invalid interval: {a}")
        if a.kind is Kind.XMIT:
            if not 0 <= a.step < n_steps:
                raise ValueError(f"transmission for unknown step {a.step}")
            step = pattern.steps[a.step]
            if a.route < 0 and a.config != step.config:
                raise ValueError(
                    f"step {a.step} transmission tagged config {a.config}, "
                    f"pattern requires {step.config}"
                )
            if a.volume < -_TOL:
                raise ValueError("negative transmission volume")
            min_dur = a.volume / fabric.plane_bandwidth(a.plane)
            if not _times_close(min_dur, a.duration):
                raise ValueError(
                    f"plane {a.plane} step {a.step}: {a.volume:.0f} B needs "
                    f"{min_dur * 1e6:.2f} us, interval is "
                    f"{a.duration * 1e6:.2f} us"
                )
        else:
            if not _times_close(fabric.t_recfg, a.duration):
                raise ValueError(
                    f"reconfiguration shorter than t_recfg: {a}"
                )

    # Volume conservation (paper Eq. 1).  A relay route delivers its
    # volume once, however many hops carry it: only hop 0 counts.
    sent = defaultdict(float)
    for a in acts:
        if a.kind is Kind.XMIT and (a.route < 0 or a.hop == 0):
            sent[a.step] += a.volume
    for i, step in enumerate(pattern.steps):
        if abs(sent[i] - step.volume) > max(
            _TOL, _REL_TOL * max(step.volume, 1.0)
        ):
            raise ValueError(
                f"step {i}: scheduled volume {sent[i]:.1f} != "
                f"required {step.volume:.1f}"
            )

    # P2: no overlapping activities on one plane; P1: config correctness,
    # tracked through the plane's reconfiguration state machine.
    by_plane: dict[int, list[PlaneActivity]] = defaultdict(list)
    for a in acts:
        by_plane[a.plane].append(a)
    for plane, plane_acts in by_plane.items():
        plane_acts.sort(key=lambda a: (a.start, a.end))
        prev_end = 0.0
        config = fabric.initial_config(plane)
        for a in plane_acts:
            if a.start < prev_end - _TOL - _REL_TOL * abs(prev_end):
                raise ValueError(
                    f"P2 violation on plane {plane}: activity starting at "
                    f"{a.start * 1e6:.2f} us overlaps previous ending at "
                    f"{prev_end * 1e6:.2f} us"
                )
            if a.kind is Kind.RECFG:
                config = a.config
            else:
                if config != a.config:
                    raise ValueError(
                        f"P1 violation on plane {plane}: step {a.step} "
                        f"needs config {a.config}, plane holds {config}"
                    )
            prev_end = max(prev_end, a.end)

    # P4: bypass relay legality (Topology Bypassing).
    routes: dict[int, list[PlaneActivity]] = defaultdict(list)
    for a in acts:
        if a.kind is Kind.XMIT and a.route >= 0:
            routes[a.route].append(a)
    if routes:
        perms = {s.config: s.perm for s in pattern.steps}
        for rid, hops in routes.items():
            hops.sort(key=lambda a: a.hop)
            if [a.hop for a in hops] != list(range(len(hops))):
                raise ValueError(
                    f"P4 violation: route {rid} hops are not contiguous"
                )
            if len(hops) < 2:
                raise ValueError(
                    f"P4 violation: route {rid} has fewer than 2 hops"
                )
            if len({a.step for a in hops}) != 1:
                raise ValueError(
                    f"P4 violation: route {rid} spans multiple steps"
                )
            v0 = hops[0].volume
            for a in hops:
                if abs(a.volume - v0) > max(
                    _TOL, _REL_TOL * max(abs(v0), 1.0)
                ):
                    raise ValueError(
                        f"P4 violation: route {rid} hop volumes differ"
                    )
            composed: tuple[int, ...] | None = None
            for a in hops:
                if a.config not in perms:
                    raise ValueError(
                        f"P4 violation: route {rid} hop config {a.config} "
                        "has no known pairing"
                    )
                p = perms[a.config]
                composed = p if composed is None else tuple(
                    p[y] for y in composed
                )
            if composed != pattern.steps[hops[0].step].perm:
                raise ValueError(
                    f"P4 violation: route {rid} composition does not "
                    "realize the step pairing"
                )
            for prev, nxt in zip(hops, hops[1:]):
                if not _times_close(prev.end, nxt.start):
                    raise ValueError(
                        f"P4 violation: route {rid} hop starts before its "
                        "data arrives"
                    )

    # P3: cross-step synchronization (chain mode only).
    if schedule.mode is DependencyMode.CHAIN:
        prev_window_end = 0.0
        for i in range(n_steps):
            if pattern.steps[i].volume <= _TOL:
                continue  # zero-volume steps occupy no window
            start, end = schedule.step_window(i)
            if not _times_close(prev_window_end, start):
                raise ValueError(
                    f"P3 violation: step {i} starts at "
                    f"{start * 1e6:.2f} us before step {i - 1} ends at "
                    f"{prev_window_end * 1e6:.2f} us"
                )
            prev_window_end = end



@dataclasses.dataclass(frozen=True)
class BypassRoute:
    """A relay route carrying one step's traffic over installed circuits.

    ``planes`` lists the hop planes in forward data order; hop ``k``
    forwards every node's chunk over plane ``planes[k]``'s *installed*
    circuit, and the composition of the hops' permutations must equal the
    step's pairing (P4).  ``volume`` is the bytes *delivered*: every hop
    carries the full volume, so an ``h``-hop relay spends ``h x volume``
    of link capacity and -- with the executor's store-and-forward
    serialization -- delivers at ``bandwidth / h`` on a uniform fabric.
    A single-plane route ``(j,) * h`` is the self-composition relay the
    greedy enumerates (`repro_torch.core.bypass.relay_depth_table`).
    """

    planes: tuple[int, ...]
    volume: float


@dataclasses.dataclass(frozen=True)
class Decisions:
    """Discrete scheduling decisions; timing is derived by the executor.

    ``splits[i]`` maps plane -> volume for step ``i`` (planes absent from
    the dict are idle at that step).  Reconfigurations are implied: a plane
    whose config does not match its next assigned step reconfigures as early
    as possible (immediately after its previous activity), which is optimal
    -- all timing constraints are lower bounds, so earliest-start timing
    minimizes every completion time for fixed discrete decisions.

    ``bypass`` optionally adds Topology-Bypassing relays: per step, a
    tuple of ``BypassRoute`` carried on planes' installed configs without
    reconfiguring (``None`` means no bypassing anywhere -- the pre-bypass
    decision format, kept as the default for back-compat).
    """

    splits: tuple[dict[int, float], ...]
    mode: DependencyMode = DependencyMode.CHAIN
    bypass: tuple[tuple[BypassRoute, ...], ...] | None = None
