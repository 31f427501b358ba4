"""One typed planning facade: ``plan(PlanRequest) -> PlanResult``.

The port of the reference package's facade.  ``PlannerOptions`` carries
every knob with the reference's defaults, plus ``device`` (`repro_torch.
device`: ``None`` is the card); ``PlanRequest`` is the work; ``plan()``
dispatches:

* many cells (or ``PlanRequest.grid``) -> the instance-batched grid path:
  ``swot_greedy_grid`` on the device plus one batched strawman scoring
  pass, both through one ``TorchBackend``;
* one cell with ``batched=False`` -> the per-instance path, where only
  ``method="strawman"`` is ported: scored on the device, its activity
  objects materialized on the host.  ``milp``, ``greedy`` and ``auto``
  need the per-instance greedy, LP polish and the MILP (host scipy code
  of a later slice) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.baselines import strawman_decisions, strawman_instance
from repro_torch.core.fabric import OpticalFabric
from repro_torch.core.greedy import GridPlan, swot_greedy_grid
from repro_torch.core.ir import (
    TimingBackend,
    backend_on,
    batch_evaluate,
    evaluate_decisions,
)
from repro_torch.core.patterns import Pattern
from repro_torch.core.schedule import DependencyMode, Schedule
from repro_torch.core.simulator import execute
from repro_torch.device import resolve_device

_METHODS = ("auto", "milp", "greedy", "strawman")
_GRID_METHODS = ("auto", "greedy")


@dataclasses.dataclass(frozen=True)
class PlannerOptions:
    """Every planning knob, validated, with the reference's defaults.

    The reference's per-instance knobs (``polish``, ``milp_time_limit``)
    arrive with the per-instance planner.

    ================== ============================================ =========
    field              meaning                                      default
    ================== ============================================ =========
    method             auto | milp | greedy | strawman              "auto"
    mode               CHAIN (paper) or INDEPENDENT                 CHAIN
    backend            a ``TimingBackend``; None = TorchBackend     None
    planner            None | "step" ("fused" is not ported)        None
    bypass_depth       0 (off) or >= 2 relay hops                   0
    independent_split  water-fill INDEPENDENT steps across planes   False
    rollout_horizon    greedy rollout depth in steps                24
    max_enum_planes    reserve-set enumeration cap                  8
    attribution        attach the per-cell CCT decomposition        False
    device             torch device; None = "cuda"                  None
    ================== ============================================ =========
    """

    method: str = "auto"
    mode: DependencyMode = DependencyMode.CHAIN
    backend: TimingBackend | None = None
    planner: str | None = None
    bypass_depth: int = 0
    independent_split: bool = False
    rollout_horizon: int = 24
    max_enumerated_planes: int = 8
    attribution: bool = False
    device: str | None = None

    def __post_init__(self) -> None:
        if self.method not in _METHODS:
            raise ValueError(
                f"method must be one of {_METHODS}, got {self.method!r}"
            )
        if not isinstance(self.mode, DependencyMode):
            raise ValueError(
                f"mode must be a DependencyMode, got {self.mode!r}"
            )
        if self.backend is not None and not isinstance(
            self.backend, TimingBackend
        ):
            raise ValueError(
                "backend must be None or a TimingBackend instance, got "
                f"{self.backend!r}"
            )
        if self.planner not in (None, "step", "fused"):
            raise ValueError(
                "planner must be None, 'step' or 'fused', got "
                f"{self.planner!r}"
            )
        if self.bypass_depth != 0 and self.bypass_depth < 2:
            raise ValueError(
                "bypass_depth is 0 (off) or >= 2 (relay hop budget), "
                f"got {self.bypass_depth}"
            )
        if (
            self.independent_split
            and self.mode is not DependencyMode.INDEPENDENT
        ):
            raise ValueError(
                "independent_split requires mode=INDEPENDENT "
                "(water-fill splitting has no CHAIN analogue)"
            )
        if self.rollout_horizon < 1:
            raise ValueError("rollout_horizon must be >= 1")
        if self.max_enumerated_planes < 1:
            raise ValueError("max_enumerated_planes must be >= 1")


@dataclasses.dataclass(frozen=True)
class PlanRequest:
    """The work to plan: one or many (fabric, pattern) cells.

    ``batched=None`` picks the path by cell count; ``batched=True`` forces
    the grid path even for one cell; ``batched=False`` forces
    per-instance planning and requires exactly one cell.
    """

    cells: tuple[tuple[OpticalFabric, Pattern], ...]
    plane_ready: tuple[float, ...] | None = None
    options: PlannerOptions = PlannerOptions()
    batched: bool | None = None

    @classmethod
    def single(
        cls,
        fabric: OpticalFabric,
        pattern: Pattern,
        *,
        plane_ready: Sequence[float] | None = None,
        options: PlannerOptions | None = None,
    ) -> "PlanRequest":
        return cls(
            cells=((fabric, pattern),),
            plane_ready=(
                tuple(plane_ready) if plane_ready is not None else None
            ),
            options=options or PlannerOptions(),
            batched=False,
        )

    @classmethod
    def grid(
        cls,
        cells: Sequence[tuple[OpticalFabric, Pattern]],
        *,
        options: PlannerOptions | None = None,
    ) -> "PlanRequest":
        return cls(
            cells=tuple(cells),
            options=options or PlannerOptions(),
            batched=True,
        )

    @property
    def is_batched(self) -> bool:
        if self.batched is not None:
            return self.batched
        return len(self.cells) > 1

    def __post_init__(self) -> None:
        if not self.cells:
            raise ValueError("PlanRequest needs at least one cell")
        if self.batched is False and len(self.cells) != 1:
            raise ValueError(
                "batched=False (per-instance planning) takes exactly "
                "one cell"
            )
        if self.plane_ready is not None and self.is_batched:
            raise ValueError(
                "plane_ready applies to per-instance requests only"
            )


@dataclasses.dataclass(frozen=True)
class GridCellPlan:
    """One sweep cell planned by the grid path: greedy plan + baseline."""

    plan: GridPlan
    strawman_cct: float

    @property
    def cct(self) -> float:
        return self.plan.cct

    @property
    def vs_strawman(self) -> float | None:
        if self.strawman_cct == 0:
            return None
        return 1.0 - self.plan.cct / self.strawman_cct


@dataclasses.dataclass(frozen=True)
class PlanResult:
    """What ``plan()`` produced, one entry per request cell.

    ``schedules`` is populated on the per-instance path; the grid path
    returns ``grid`` (decisions + scores) and materializes activity
    objects lazily via ``schedule(i)``.
    """

    options: PlannerOptions
    methods: tuple[str, ...]  # planner that produced each cell
    ccts: tuple[float, ...]
    schedules: tuple[Schedule, ...] | None = None
    grid: tuple[GridCellPlan, ...] | None = None

    def schedule(self, i: int = 0) -> Schedule:
        """The cell's schedule (materialized from decisions on the grid
        path)."""
        if self.schedules is not None:
            return self.schedules[i]
        if self.grid is None:
            raise ValueError("result holds neither schedules nor a grid")
        return self.grid[i].plan.schedule()

    @property
    def cct(self) -> float:
        """Single-cell convenience accessor."""
        if len(self.ccts) != 1:
            raise ValueError(
                f"result holds {len(self.ccts)} cells; use .ccts"
            )
        return self.ccts[0]

    @property
    def method(self) -> str:
        if len(self.methods) != 1:
            raise ValueError(
                f"result holds {len(self.methods)} cells; use .methods"
            )
        return self.methods[0]


def _plan_single(
    fabric: OpticalFabric,
    pattern: Pattern,
    plane_ready: tuple[float, ...] | None,
    opts: PlannerOptions,
) -> tuple[float, Schedule]:
    """The per-instance path: the strawman baseline only, so far.

    The CCT is scored on ``opts.device`` (the ``timing_scan`` kernel on the
    card); the activity objects are materialized on the host by the object
    executor, whose CCT the batched engine matches bitwise.
    """
    dev = resolve_device(opts.device)
    if opts.method != "strawman":
        raise NotImplementedError(
            f"per-instance method={opts.method!r} needs the per-instance "
            "greedy, LP polish and the MILP, which are not ported yet "
            "(ROADMAP Queue 1); use method='strawman' or a grid request"
        )
    decisions = strawman_decisions(fabric, pattern)
    cct = evaluate_decisions(
        fabric, pattern, decisions, plane_ready=plane_ready,
        backend=backend_on(opts.backend, dev),
    ).cct
    schedule = execute(fabric, pattern, decisions, plane_ready=plane_ready)
    if schedule.cct != cct:
        raise RuntimeError(
            f"device CCT {cct!r} != object-executor CCT {schedule.cct!r}"
        )
    return cct, schedule


def _plan_grid(
    cells: tuple[tuple[OpticalFabric, Pattern], ...],
    opts: PlannerOptions,
) -> tuple[GridCellPlan, ...]:
    """The instance-batched path: grid greedy + strawman scoring."""
    if opts.method not in _GRID_METHODS:
        raise ValueError(
            f"grid requests support method in {_GRID_METHODS}, got "
            f"{opts.method!r} (plan cells one at a time for "
            "milp/strawman)"
        )
    backend = backend_on(opts.backend, resolve_device(opts.device))
    plans = swot_greedy_grid(
        cells,
        rollout_horizon=opts.rollout_horizon,
        max_enumerated_planes=opts.max_enumerated_planes,
        backend=backend,
        mode=opts.mode,
        bypass_depth=opts.bypass_depth,
        independent_split=opts.independent_split,
        planner=opts.planner,
        attribution=opts.attribution,
        device=opts.device,
    )
    straw = batch_evaluate(
        [strawman_instance(fabric, pattern) for fabric, pattern in cells],
        backend=backend,
    )
    return tuple(
        GridCellPlan(plan=plan, strawman_cct=float(straw.cct[i]))
        for i, plan in enumerate(plans)
    )


def plan(request: PlanRequest) -> PlanResult:
    """Plan every cell of ``request`` under its ``PlannerOptions``.

    Many cells route through the grid path on ``options.device``; one
    cell with ``batched=False`` routes through the per-instance path
    (``method="strawman"`` only, so far).
    """
    opts = request.options
    if not request.is_batched:
        fabric, pattern = request.cells[0]
        cct, schedule = _plan_single(
            fabric, pattern, request.plane_ready, opts
        )
        return PlanResult(
            options=opts,
            methods=("strawman",),
            ccts=(cct,),
            schedules=(schedule,),
        )
    grid = _plan_grid(request.cells, opts)
    return PlanResult(
        options=opts,
        methods=("greedy",) * len(grid),
        ccts=tuple(cell.cct for cell in grid),
        grid=grid,
    )
