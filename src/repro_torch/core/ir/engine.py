"""Array-based schedule IR: vectorized legality, CCT, and batched sweeps.

The port's counterpart of the reference package's ``core/ir/engine.py``.
Host side, copied and kept in numpy (the float order of these functions
is the reference's, and the port's results are held bitwise to it):

* ``ScheduleIR`` with the lossless ``to_ir``/``from_ir`` converters,
  ``validate_ir`` (P1-P4 + feasibility) and ``execute_ir``;
* ``pack_instances`` -- the flat padded float64/int64/bool array set that
  the timing backends consume -- and ``finalize_result``, the shared numpy
  epilogue every backend ends in;
* ``batch_evaluate`` / ``evaluate_decisions``, which pack on the host and
  hand the arrays to a ``TorchBackend`` on ``device``.

Device side, float64 torch on ``device``:

* ``waterfill_batch`` / ``rollout_batch`` -- the greedy's equalized-finish
  water level and its no-reserve rollout score, vectorized over candidate
  rows.  Bitwise equal to the reference's numpy versions: the prefix sums
  over planes are unrolled loops in plane order (``np.cumsum`` is
  sequential; ``torch.cumsum`` on CUDA promises no order), the plane sort
  is a stable ``torch.sort``, and every arithmetic step is its own tensor
  op, so no multiply-add is ever contracted.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch.core.fabric import OpticalFabric
from repro_torch.core.patterns import Pattern
from repro_torch.core.schedule import (
    Decisions,
    DependencyMode,
    Kind,
    PlaneActivity,
    Schedule,
)
from repro_torch.core.tolerances import (
    EPS,
    EPS_VOLUME,
    REL_TOL,
    TOL,
    times_close_arr,
)

if TYPE_CHECKING:
    from repro_torch.core.ir.backends import TimingBackend
    from repro_torch.obs.attribution import Attribution

KIND_XMIT = 0
KIND_RECFG = 1
NO_CONFIG = -1  # array sentinel for "unconfigured" (object path: ``None``)

_BIG = 1e30  # finite stand-in for +inf ready times (keeps bw*ready NaN-free)


def fabric_arrays(fabric: OpticalFabric) -> tuple[np.ndarray, np.ndarray]:
    """``(plane_bw, initial_config)`` arrays for a fabric.

    The single source of the fabric-to-arrays mapping (``NO_CONFIG``
    encodes an unconfigured plane); shared by ``to_ir`` and the greedy's
    state initialization.
    """
    plane_bw = np.array(
        [fabric.plane_bandwidth(j) for j in range(fabric.n_planes)],
        dtype=np.float64,
    )
    initial = np.array(
        [
            NO_CONFIG if (c := fabric.initial_config(j)) is None else c
            for j in range(fabric.n_planes)
        ],
        dtype=np.int64,
    )
    return plane_bw, initial


# ---------------------------------------------------------------------------
# The IR proper + lossless converters
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ScheduleIR:
    """Struct-of-arrays schedule representation.

    Activity arrays are parallel and keep the *original* activity order of
    the source ``Schedule`` so the round trip is lossless.  Config ids are
    non-negative ints; ``NO_CONFIG`` encodes the object path's ``None``.
    """

    # Instance metadata.
    n_planes: int
    n_steps: int
    mode: DependencyMode
    t_recfg: float
    plane_bw: np.ndarray  # (P,) float64, effective bytes/s per plane
    initial_config: np.ndarray  # (P,) int64, NO_CONFIG = unconfigured
    step_config: np.ndarray  # (S,) int64
    step_volume: np.ndarray  # (S,) float64
    # Activity arrays, all shape (N,).
    plane_id: np.ndarray  # int64
    kind: np.ndarray  # int64: KIND_XMIT | KIND_RECFG
    step: np.ndarray  # int64
    config: np.ndarray  # int64
    t_start: np.ndarray  # float64
    t_end: np.ndarray  # float64
    volume: np.ndarray  # float64
    route: np.ndarray  # int64; bypass route id, -1 = direct
    hop: np.ndarray  # int64; hop index within a bypass route
    # Provenance (object handles for the lossless round trip).
    fabric: OpticalFabric
    pattern: Pattern

    @property
    def n_activities(self) -> int:
        return int(self.plane_id.shape[0])


def to_ir(schedule: Schedule) -> ScheduleIR:
    """Convert a ``Schedule`` to the array IR (lossless)."""
    fabric = schedule.fabric
    pattern = schedule.pattern
    acts = schedule.activities
    n = len(acts)
    plane_id = np.fromiter(
        (a.plane for a in acts), dtype=np.int64, count=n
    )
    kind = np.fromiter(
        (KIND_RECFG if a.kind is Kind.RECFG else KIND_XMIT for a in acts),
        dtype=np.int64,
        count=n,
    )
    step = np.fromiter((a.step for a in acts), dtype=np.int64, count=n)
    config = np.fromiter((a.config for a in acts), dtype=np.int64, count=n)
    if n and config.min() < 0:
        raise ValueError("IR requires non-negative config ids")
    t_start = np.fromiter(
        (a.start for a in acts), dtype=np.float64, count=n
    )
    t_end = np.fromiter((a.end for a in acts), dtype=np.float64, count=n)
    volume = np.fromiter(
        (a.volume for a in acts), dtype=np.float64, count=n
    )
    route = np.fromiter((a.route for a in acts), dtype=np.int64, count=n)
    hop = np.fromiter((a.hop for a in acts), dtype=np.int64, count=n)
    plane_bw, initial = fabric_arrays(fabric)
    return ScheduleIR(
        n_planes=fabric.n_planes,
        n_steps=pattern.n_steps,
        mode=schedule.mode,
        t_recfg=fabric.t_recfg,
        plane_bw=plane_bw,
        initial_config=initial,
        step_config=np.asarray(pattern.configs, dtype=np.int64),
        step_volume=np.asarray(pattern.volumes, dtype=np.float64),
        plane_id=plane_id,
        kind=kind,
        step=step,
        config=config,
        t_start=t_start,
        t_end=t_end,
        volume=volume,
        route=route,
        hop=hop,
        fabric=fabric,
        pattern=pattern,
    )


def from_ir(ir: ScheduleIR) -> Schedule:
    """Reconstruct the exact source ``Schedule`` (inverse of ``to_ir``)."""
    activities = tuple(
        PlaneActivity(
            plane=int(ir.plane_id[i]),
            kind=Kind.RECFG if ir.kind[i] == KIND_RECFG else Kind.XMIT,
            step=int(ir.step[i]),
            start=float(ir.t_start[i]),
            end=float(ir.t_end[i]),
            config=int(ir.config[i]),
            volume=float(ir.volume[i]),
            route=int(ir.route[i]),
            hop=int(ir.hop[i]),
        )
        for i in range(ir.n_activities)
    )
    return Schedule(
        fabric=ir.fabric,
        pattern=ir.pattern,
        activities=activities,
        mode=ir.mode,
    )


# ---------------------------------------------------------------------------
# Vectorized legality (P1 / P2 / P3 + feasibility)
# ---------------------------------------------------------------------------
def validate_ir(ir: ScheduleIR) -> None:
    """Raise ``ValueError`` unless the IR encodes a legal schedule.

    Mirrors the object-path validator check for check (same tolerances via
    ``repro_torch.core.tolerances``), so it accepts/rejects identically; only the
    error messages differ in formatting.
    """
    n = ir.n_activities
    dur = ir.t_end - ir.t_start
    xm = ir.kind == KIND_XMIT
    rc = ~xm

    if np.any((ir.plane_id < 0) | (ir.plane_id >= ir.n_planes)):
        raise ValueError("activity on unknown plane")
    if np.any(ir.t_start < -TOL) or np.any(dur < -TOL):
        raise ValueError("activity has invalid interval")
    if np.any((ir.step[xm] < 0) | (ir.step[xm] >= ir.n_steps)):
        raise ValueError("transmission for unknown step")
    direct = xm & (ir.route < 0)
    if np.any(ir.config[direct] != ir.step_config[ir.step[direct]]):
        raise ValueError("transmission tagged with wrong config")
    if np.any(ir.volume[xm] < -TOL):
        raise ValueError("negative transmission volume")
    min_dur = ir.volume[xm] / ir.plane_bw[ir.plane_id[xm]]
    if not np.all(times_close_arr(min_dur, dur[xm])):
        raise ValueError("transmission interval shorter than volume needs")
    if not np.all(
        times_close_arr(np.full(int(rc.sum()), ir.t_recfg), dur[rc])
    ):
        raise ValueError("reconfiguration shorter than t_recfg")

    # Volume conservation (paper Eq. 1).  Relay routes deliver their
    # volume once (hop 0); later hops re-carry the same bytes.
    counted = xm & ((ir.route < 0) | (ir.hop == 0))
    sent = np.zeros(ir.n_steps)
    np.add.at(sent, ir.step[counted], ir.volume[counted])
    tol = np.maximum(TOL, REL_TOL * np.maximum(ir.step_volume, 1.0))
    if np.any(np.abs(sent - ir.step_volume) > tol):
        raise ValueError("scheduled volume != required step volume")

    # P2 (no per-plane overlap) + P1 (config correctness via the plane's
    # reconfiguration state machine), vectorized per plane slice.
    for p in np.unique(ir.plane_id):
        idx = np.where(ir.plane_id == p)[0]
        order = idx[np.lexsort((ir.t_end[idx], ir.t_start[idx]))]
        s = ir.t_start[order]
        e = ir.t_end[order]
        k = ir.kind[order]
        cfg = ir.config[order]
        prev_end = np.empty(order.size)
        prev_end[0] = 0.0
        if order.size > 1:
            prev_end[1:] = np.maximum.accumulate(e[:-1])
            prev_end[1:] = np.maximum(prev_end[1:], 0.0)
        if np.any(s < prev_end - TOL - REL_TOL * np.abs(prev_end)):
            raise ValueError(f"P2 violation on plane {int(p)}")
        is_r = k == KIND_RECFG
        r_pos = np.where(is_r)[0]
        if r_pos.size:
            last = (
                np.searchsorted(r_pos, np.arange(order.size), side="left")
                - 1
            )
            held = np.where(
                last >= 0,
                cfg[r_pos[np.clip(last, 0, None)]],
                ir.initial_config[int(p)],
            )
        else:
            held = np.full(order.size, ir.initial_config[int(p)])
        if np.any(~is_r & (held != cfg)):
            raise ValueError(f"P1 violation on plane {int(p)}")

    # P4: bypass relay legality, mirroring the object oracle's checks
    # (contiguous hops, >= 2 of them, one step, equal volumes, pairing
    # composition, data-order hop timing).  Routes are few; the per-route
    # loop composes pairings as array gathers.
    byp = xm & (ir.route >= 0)
    if np.any(byp):
        perms = {
            s.config: np.asarray(s.perm, dtype=np.int64)
            for s in ir.pattern.steps
        }
        rows = np.where(byp)[0]
        order = rows[np.lexsort((ir.hop[rows], ir.route[rows]))]
        rids = ir.route[order]
        starts = np.nonzero(np.r_[True, rids[1:] != rids[:-1]])[0]
        bounds = np.r_[starts, rids.size]
        for s0, s1 in zip(bounds[:-1], bounds[1:]):
            grp = order[s0:s1]
            rid = int(rids[s0])
            if not np.array_equal(ir.hop[grp], np.arange(grp.size)):
                raise ValueError(
                    f"P4 violation: route {rid} hops are not contiguous"
                )
            if grp.size < 2:
                raise ValueError(
                    f"P4 violation: route {rid} has fewer than 2 hops"
                )
            if np.unique(ir.step[grp]).size != 1:
                raise ValueError(
                    f"P4 violation: route {rid} spans multiple steps"
                )
            v0 = ir.volume[grp[0]]
            if np.any(
                np.abs(ir.volume[grp] - v0)
                > max(TOL, REL_TOL * max(abs(v0), 1.0))
            ):
                raise ValueError(
                    f"P4 violation: route {rid} hop volumes differ"
                )
            composed: np.ndarray | None = None
            for c in ir.config[grp]:
                if int(c) not in perms:
                    raise ValueError(
                        f"P4 violation: route {rid} hop config {int(c)} "
                        "has no known pairing"
                    )
                p_arr = perms[int(c)]
                composed = p_arr if composed is None else p_arr[composed]
            target = perms[int(ir.step_config[ir.step[grp[0]]])]
            if not np.array_equal(composed, target):
                raise ValueError(
                    f"P4 violation: route {rid} composition does not "
                    "realize the step pairing"
                )
            if not np.all(
                times_close_arr(ir.t_end[grp[:-1]], ir.t_start[grp[1:]])
            ):
                raise ValueError(
                    f"P4 violation: route {rid} hop starts before its "
                    "data arrives"
                )

    # P3: cross-step synchronization (chain mode only).
    if ir.mode is DependencyMode.CHAIN:
        wstart = np.full(ir.n_steps, np.inf)
        wend = np.full(ir.n_steps, -np.inf)
        np.minimum.at(wstart, ir.step[xm], ir.t_start[xm])
        np.maximum.at(wend, ir.step[xm], ir.t_end[xm])
        nz = np.where(ir.step_volume > TOL)[0]
        if np.any(np.isinf(wstart[nz])):
            # Mirrors the object path's ``step_window`` raising for a
            # non-zero step with no transmissions at all.
            raise ValueError("no transmissions for a non-zero-volume step")
        prev = np.concatenate(([0.0], wend[nz][:-1]))
        if not np.all(times_close_arr(prev, wstart[nz])):
            raise ValueError("P3 violation: step starts before predecessor")


# ---------------------------------------------------------------------------
# IR evaluation: CCT + utilization via array reductions
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class IRMetrics:
    """Evaluation of one schedule: the quantities sweeps care about."""

    cct: float
    n_reconfigurations: int
    plane_busy: np.ndarray  # (P,) seconds transmitting or reconfiguring
    utilization: float  # mean busy fraction of [0, cct] across planes


def execute_ir(ir: ScheduleIR) -> IRMetrics:
    """CCT and per-plane utilization from the IR, no object traversal."""
    xm = ir.kind == KIND_XMIT
    cct = float(ir.t_end[xm].max()) if np.any(xm) else 0.0
    busy = np.bincount(
        ir.plane_id,
        weights=ir.t_end - ir.t_start,
        minlength=ir.n_planes,
    )
    util = (
        float(busy.sum() / (cct * ir.n_planes)) if cct > 0.0 else 0.0
    )
    return IRMetrics(
        cct=cct,
        n_reconfigurations=int((~xm).sum()),
        plane_busy=busy,
        utilization=util,
    )


# ---------------------------------------------------------------------------
# Batched water-filling + rollout (the grid greedy's scoring primitives)
# ---------------------------------------------------------------------------
def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the plane axis, in plane order.

    ``np.cumsum`` adds left to right; this loop does the same additions in
    the same order on any device, one (rows,) add per plane.
    """
    out = torch.empty_like(x)
    acc = x[:, 0]
    out[:, 0] = acc
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k]
        out[:, k] = acc
    return out


def waterfill_batch(
    ready: torch.Tensor,  # (C, P) per-candidate plane ready times
    bw: torch.Tensor,  # (P,) or (C, P) plane bandwidths
    volume: "float | torch.Tensor",  # scalar or (C,) per-candidate volumes
) -> tuple[torch.Tensor, torch.Tensor]:
    """Equalized-finish water level per candidate row.

    Returns ``(level (C,), split (C, P))`` where ``split`` carries
    ``bw * (level - ready)`` for planes strictly below the level (others
    zero).  Planes excluded from a candidate should be passed with
    ``ready = _BIG`` -- they absorb nothing and never set the level.
    Zero-volume rows return ``level = ready.min`` with an all-zero split.
    All float64 on ``ready``'s device; bitwise equal to the reference's
    numpy ``waterfill_batch``.  (The reference returns early when every row
    has zero volume; the general path below gives the same values for such
    rows, so the port takes it always and never reads the device on the
    host.)
    """
    n_rows, n_planes = ready.shape
    bw = torch.broadcast_to(bw, ready.shape)
    vol = torch.broadcast_to(
        torch.as_tensor(volume, dtype=ready.dtype, device=ready.device),
        (n_rows,),
    )
    zero = vol <= EPS
    r_s, order = torch.sort(ready, dim=1, stable=True)
    b_s = torch.gather(bw, 1, order)
    cb = _prefix_sum(b_s)  # inclusive cumulative bandwidth
    cbr = _prefix_sum(b_s * r_s)
    # Volume absorbed by planes 0..k-1 when the level reaches r_s[:, k].
    cb_prev = torch.zeros_like(cb)
    cb_prev[:, 1:] = cb[:, :-1]
    cbr_prev = torch.zeros_like(cbr)
    cbr_prev[:, 1:] = cbr[:, :-1]
    absorbed = r_s * cb_prev - cbr_prev
    # Monotone: the largest k whose absorbed volume fits.
    k = ((absorbed <= vol[:, None]).sum(dim=1) - 1)[:, None]
    level = (vol + torch.gather(cbr, 1, k)[:, 0]) / torch.gather(cb, 1, k)[:, 0]
    level = torch.where(zero, ready.amin(dim=1), level)
    gap = level[:, None] - ready
    split = torch.where((gap > EPS) & ~zero[:, None], bw * gap, 0.0)
    return level, split


def rollout_batch(
    bw: torch.Tensor,  # (P,)
    t_recfg: float,
    step_configs: torch.Tensor,  # (S,) int64
    step_volumes: torch.Tensor,  # (S,) float64
    config: torch.Tensor,  # (C, P) int64, NO_CONFIG for unconfigured
    free: torch.Tensor,  # (C, P)
    barrier: torch.Tensor,  # (C,)
    start_step: int,
    horizon: int,
) -> torch.Tensor:
    """No-reserve rollout CCT estimate, vectorized over candidates.

    Runs the remaining steps with water-filling splits from each
    candidate's plane state, then adds the aggregate-bandwidth tail lower
    bound past the horizon.  The tail's two sums are taken in numpy on the
    host, as the reference takes them (``np.sum`` is pairwise).
    """
    n_steps = int(step_configs.shape[0])
    n_planes = int(bw.shape[0])
    end_step = min(n_steps, start_step + horizon)
    # A 0-dim float64 tensor, so ``where`` of two scalars cannot fall back
    # to torch's float32 default.
    t_recfg_t = free.new_tensor(t_recfg)
    for i in range(start_step, end_step):
        extra = torch.where(config == step_configs[i], 0.0, t_recfg_t)
        ready = torch.maximum(barrier[:, None], free + extra)
        level, split = waterfill_batch(ready, bw, step_volumes[i])
        active = split > 0.0
        free = torch.where(active, level[:, None], free)
        config = torch.where(active, step_configs[i], config)
        barrier = level
    if end_step < n_steps:
        # Tail lower-bound: remaining volume at aggregate bandwidth plus
        # one reconfiguration per config change.
        vols = step_volumes.cpu().numpy()
        cfgs = step_configs.cpu().numpy()
        tail_volume = float(vols[end_step:].sum())
        changes = sum(
            1
            for i in range(end_step, n_steps)
            if cfgs[i] != cfgs[max(i - 1, end_step)]
        )
        barrier = barrier + tail_volume / float(bw.cpu().numpy().sum())
        barrier = barrier + changes * t_recfg / n_planes
    return barrier


# ---------------------------------------------------------------------------
# Batched decision evaluation (the scenario-sweep engine)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BatchInstance:
    """One (fabric, pattern, decisions) cell of a scenario sweep."""

    fabric: OpticalFabric
    pattern: Pattern
    decisions: Decisions


@dataclasses.dataclass(frozen=True)
class BatchResult:
    """Per-instance outcomes of one ``batch_evaluate`` pass."""

    cct: np.ndarray  # (B,)
    n_reconfigurations: np.ndarray  # (B,) int
    plane_busy: np.ndarray  # (B, P_max); padded planes stay 0
    utilization: np.ndarray  # (B,)
    feasible: np.ndarray  # (B,) bool: every non-zero step had a server
    volume_ok: np.ndarray  # (B,) bool: splits conserve per-step volume
    # CCT decomposition (``batch_evaluate(..., attribution=True)`` only):
    # per-(instance, step, plane) component arrays summing bitwise to
    # ``cct``.  See `repro_torch.obs.attribution`.
    attribution: "Attribution | None" = None

    def __len__(self) -> int:
        return int(self.cct.shape[0])


def finalize_result(
    cct: np.ndarray,
    n_recfg: np.ndarray,
    busy: np.ndarray,
    feasible: np.ndarray,
    volume_ok: np.ndarray,
    plane_mask: np.ndarray,
    attribution: tuple[np.ndarray, ...] | None = None,
    step_mask: np.ndarray | None = None,
) -> BatchResult:
    """Assemble a ``BatchResult`` from raw recurrence outputs.

    One shared epilogue for every backend, so the utilization formula (and
    its tolerance behavior) cannot drift between the kernel and its plain
    version.  ``attribution`` optionally carries the raw ``(t_xmit, t_bypass,
    t_recfg_wait, t_recfg_hidden)`` component arrays, each (B, S, P);
    the closing idle term is derived *here* (one canonical float
    expression, `repro_torch.obs.attribution.closing_idle`) so conservation is
    bitwise on every backend by construction.
    """
    cct = np.asarray(cct, dtype=np.float64)
    busy = np.asarray(busy, dtype=np.float64)
    util = np.where(
        cct > 0.0,
        busy.sum(axis=1)
        / np.maximum(cct * plane_mask.sum(axis=1), EPS),
        0.0,
    )
    att = None
    if attribution is not None:
        from repro_torch.obs.attribution import build_attribution

        if step_mask is None:
            raise ValueError("attribution requires step_mask")
        att = build_attribution(
            cct, *attribution, plane_mask=plane_mask, step_mask=step_mask
        )
    return BatchResult(
        cct=cct,
        n_reconfigurations=np.asarray(n_recfg, dtype=np.int64),
        plane_busy=busy,
        utilization=util,
        feasible=np.asarray(feasible, dtype=bool),
        volume_ok=np.asarray(volume_ok, dtype=bool),
        attribution=att,
    )


def pack_instances(
    instances: Sequence[BatchInstance],
    plane_ready: Sequence[Sequence[float]] | None,
) -> dict[str, np.ndarray]:
    """Pad a batch of instances into one flat array set.

    The packed dict is the contract between the sweep engine and the
    timing backends (`repro_torch.core.ir.backends`): every array is a plain
    float64/int64/bool NumPy array with batch dimension first, so backends
    can consume it unchanged (the CUDA kernel takes it as it is, with no
    padding to bucket shapes).
    """
    b = len(instances)
    s_max = max(inst.pattern.n_steps for inst in instances)
    p_max = max(inst.fabric.n_planes for inst in instances)
    vol = np.zeros((b, s_max, p_max))
    step_vol = np.zeros((b, s_max))
    step_cfg = np.full((b, s_max), NO_CONFIG, dtype=np.int64)
    step_mask = np.zeros((b, s_max), dtype=bool)
    plane_mask = np.zeros((b, p_max), dtype=bool)
    bw = np.ones((b, p_max))
    init = np.full((b, p_max), NO_CONFIG, dtype=np.int64)
    t_recfg = np.zeros(b)
    chain = np.zeros(b, dtype=bool)
    ready = np.zeros((b, p_max))
    # Bypass relay routes: (B, S, R) delivered volumes + (B, S, R, H)
    # hop plane ids (-1 pads).  R/H are 0 when no instance bypasses, so
    # the recurrence's route loops vanish for bypass-free sweeps.  Idle
    # routes (volume at or below EPS_VOLUME) are dropped like idle
    # splits, mirroring the object executor.
    r_max = h_max = 0
    live_routes: list[list[list]] = []
    for inst in instances:
        byp = inst.decisions.bypass
        per_step: list[list] = []
        if byp is not None:
            if len(byp) != inst.pattern.n_steps:
                raise ValueError(
                    f"bypass covers {len(byp)} steps, pattern has "
                    f"{inst.pattern.n_steps}"
                )
            for routes in byp:
                kept = [r for r in routes if r.volume > EPS_VOLUME]
                for r in kept:
                    if len(r.planes) < 2:
                        raise ValueError(
                            f"bypass route needs >= 2 hops, got {r.planes}"
                        )
                    if any(
                        not 0 <= j < inst.fabric.n_planes
                        for j in r.planes
                    ):
                        raise ValueError(
                            f"unknown plane in bypass route {r.planes}"
                        )
                    h_max = max(h_max, len(r.planes))
                r_max = max(r_max, len(kept))
                per_step.append(kept)
        live_routes.append(per_step)
    byp_vol = np.zeros((b, s_max, r_max))
    byp_plane = np.full((b, s_max, r_max, h_max), -1, dtype=np.int64)
    for bi, per_step in enumerate(live_routes):
        for i, kept in enumerate(per_step):
            for r, route in enumerate(kept):
                byp_vol[bi, i, r] = route.volume
                byp_plane[bi, i, r, : len(route.planes)] = route.planes
    for bi, inst in enumerate(instances):
        fabric, pattern, dec = inst.fabric, inst.pattern, inst.decisions
        if len(dec.splits) != pattern.n_steps:
            raise ValueError(
                f"decisions cover {len(dec.splits)} steps, pattern has "
                f"{pattern.n_steps}"
            )
        n_p, n_s = fabric.n_planes, pattern.n_steps
        step_mask[bi, :n_s] = True
        plane_mask[bi, :n_p] = True
        step_vol[bi, :n_s] = pattern.volumes
        step_cfg[bi, :n_s] = pattern.configs
        for j in range(n_p):
            bw[bi, j] = fabric.plane_bandwidth(j)
            c = fabric.initial_config(j)
            init[bi, j] = NO_CONFIG if c is None else c
        t_recfg[bi] = fabric.t_recfg
        chain[bi] = dec.mode is DependencyMode.CHAIN
        for i, split in enumerate(dec.splits):
            for j, v in split.items():
                if not 0 <= j < n_p:
                    # Match the object executor: idle entries (volume at or
                    # below EPS_VOLUME) are filtered before the plane-range
                    # check, so only *active* unknown planes reject.
                    if v > EPS_VOLUME:
                        raise ValueError(
                            f"unknown plane {j} in step {i} split"
                        )
                    continue
                vol[bi, i, j] = v
        if plane_ready is not None and plane_ready[bi] is not None:
            r = tuple(plane_ready[bi])
            if len(r) != n_p:
                raise ValueError("plane_ready length mismatch")
            if any(x < 0 for x in r):
                raise ValueError("plane_ready times must be non-negative")
            ready[bi, :n_p] = r
    return {
        "vol": vol,
        "step_vol": step_vol,
        "step_cfg": step_cfg,
        "step_mask": step_mask,
        "plane_mask": plane_mask,
        "bw": bw,
        "init": init,
        "t_recfg": t_recfg,
        "chain": chain,
        "ready": ready,
        "byp_vol": byp_vol,
        "byp_plane": byp_plane,
    }


def batch_evaluate(
    instances: Sequence[BatchInstance],
    plane_ready: Sequence[Sequence[float]] | None = None,
    backend: "TimingBackend | None" = None,
    attribution: bool = False,
    device: str | None = None,
) -> BatchResult:
    """Evaluate many (fabric, pattern, decisions) cells in one array pass.

    Instances are padded to the batch's max step/plane counts; padded cells
    carry zero volume and are masked out.  ``plane_ready`` optionally gives
    per-instance plane ready-time offsets (the re-planning case).
    ``backend`` is a ``TimingBackend`` instance; ``None`` builds a
    ``TorchBackend`` on ``device`` (the card unless ``device="cpu"``, see
    `repro_torch.device`).  ``attribution=True`` additionally
    returns the per-(instance, step, plane) CCT decomposition on
    ``BatchResult.attribution`` (`repro_torch.obs.attribution`); the default
    leaves the hot path untouched.
    """
    from repro_torch.core.ir.backends import TorchBackend

    if backend is None:
        backend = TorchBackend(device=device)
    if not instances:
        att = None
        if attribution:
            from repro_torch.obs.attribution import build_attribution

            att = build_attribution(
                np.zeros(0),
                *(np.zeros((0, 0, 0)) for _ in range(4)),
                plane_mask=np.zeros((0, 0), dtype=bool),
                step_mask=np.zeros((0, 0), dtype=bool),
            )
        return BatchResult(
            cct=np.zeros(0),
            n_reconfigurations=np.zeros(0, dtype=np.int64),
            plane_busy=np.zeros((0, 0)),
            utilization=np.zeros(0),
            feasible=np.ones(0, dtype=bool),
            volume_ok=np.ones(0, dtype=bool),
            attribution=att,
        )
    return backend.derive_timing(
        pack_instances(instances, plane_ready), attribution=attribution
    )


def evaluate_decisions(
    fabric: OpticalFabric,
    pattern: Pattern,
    decisions: Decisions,
    plane_ready: Sequence[float] | None = None,
    backend: "TimingBackend | None" = None,
    device: str | None = None,
) -> IRMetrics:
    """Single-instance evaluation through the batched engine.

    Raises ``ValueError`` on the same malformed-decision cases as the
    object executor + validator: step count mismatch, active unknown
    plane, negative ready offsets, a step with volume but no active
    plane, or splits that fail per-step volume conservation.  (The other
    legality properties hold by construction of earliest-start timing.)
    """
    res = batch_evaluate(
        [BatchInstance(fabric, pattern, decisions)],
        None if plane_ready is None else [plane_ready],
        backend=backend,
        device=device,
    )
    if not bool(res.feasible[0]):
        raise ValueError("a step has volume but no active planes")
    if not bool(res.volume_ok[0]):
        raise ValueError("scheduled volume != required step volume")
    return IRMetrics(
        cct=float(res.cct[0]),
        n_reconfigurations=int(res.n_reconfigurations[0]),
        plane_busy=res.plane_busy[0, : fabric.n_planes],
        utilization=float(res.utilization[0]),
    )
