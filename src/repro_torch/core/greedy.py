"""Instance-batched grid greedy with its per-step loop on the device.

The port of the reference package's grid path (``swot_greedy_grid``): a
whole grid of (fabric, pattern) cells advances through the per-step loop
together.

CHAIN mode (the paper's reserve-set greedy): per step, every cell's
candidate reserve sets come from a table built once at grid construction
(`_GridState`); all candidate rows of all live cells form one (rows x
planes) float64 state batch on the device, and each step costs one batched
candidate construction, one ``waterfill_batch``, one row-batched rollout
and one instance-keyed lexicographic selection.  With ``bypass_depth >= 2``
every candidate gains a Topology-Bypassing twin row, and the bypass plan
is kept per cell only on a strict CCT win.

INDEPENDENT mode packs every cell's step onto its least-finish-time plane
(or, with ``independent_split=True``, water-fills it across planes).

The grid state's tables are built in numpy on the host exactly as the
reference builds them (their float order is load-bearing), then moved to
the device once.  Inside the loop nothing is read back to the host: row
layouts depend only on which cells are still live, which the host knows,
and the "every live cell has a feasible candidate" check is a device flag
read once after the loop.  Decisions are bitwise equal to the reference's
``swot_greedy_grid(..., planner="step", backend="numpy")``.  Final CCTs
and the strawman come from one ``batch_evaluate`` pass each on the given
``TorchBackend``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch.core.bypass import relay_depth_table
from repro_torch.core.fabric import OpticalFabric
from repro_torch.core.ir import (
    NO_CONFIG,
    _BIG,
    BatchInstance,
    backend_on,
    batch_evaluate,
    fabric_arrays,
    waterfill_batch,
)
from repro_torch.core.patterns import Pattern
from repro_torch.core.schedule import (
    BypassRoute,
    Decisions,
    DependencyMode,
    Schedule,
)
from repro_torch.core.simulator import execute
from repro_torch.core.tolerances import EPS as _EPS
from repro_torch.core.tolerances import EPS_VOLUME as _EPS_VOLUME
from repro_torch.device import resolve_device

if TYPE_CHECKING:
    from repro_torch.core.ir.backends import TimingBackend

_FUSED_NOT_PORTED = (
    "planner='fused' (the one-program grid planner) is not ported yet: "
    "ROADMAP Queue 1 #4; use planner='step' or None"
)


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """One cell's outcome from ``swot_greedy_grid``."""

    fabric: OpticalFabric
    pattern: Pattern
    decisions: Decisions
    cct: float
    n_reconfigurations: int
    utilization: float
    # Per-cell CCT decomposition (``attribution=True`` only): an
    # `repro_torch.obs.attribution.Attribution` with (S, P) component
    # arrays sliced from the batch scoring pass.
    attribution: "object | None" = None

    def schedule(self) -> Schedule:
        """Materialize the activity-object schedule (validated)."""
        return execute(self.fabric, self.pattern, self.decisions)


def _subset_masks(n_p: int, p_max: int) -> np.ndarray:
    """Every proper subset of ``n_p`` planes, sizes ascending, each size in
    ``itertools.combinations`` order, as (rows, p_max) bool masks."""
    masks = []
    for size in range(n_p):
        for combo in itertools.combinations(range(n_p), size):
            m = np.zeros(p_max, dtype=bool)
            m[list(combo)] = True
            masks.append(m)
    return np.stack(masks, axis=0)


class _GridState:
    """Packed per-instance planner state for the instance-batched greedy.

    Built in numpy on the host as the reference builds it, then moved to
    ``device``: ``bw``, ``config``, ``free``, ``barrier`` and the other
    per-cell arrays become float64/int64/bool tensors under the same
    names.  The few host arrays the loop's index layout needs keep a
    ``*_host`` copy.

    CHAIN mode also holds the *candidate reserve-set table*: one flat row
    per (instance, reserve set) in the reference's enumeration order
    (every proper subset when ``n_planes <= max_enumerated_planes``,
    soonest-free prefixes of sizes 0..3 otherwise), plus the ``prev_same``
    first-occurrence table that lets upcoming-target retargeting run as
    array ops.
    """

    def __init__(
        self,
        cells: Sequence[tuple[OpticalFabric, Pattern]],
        mode: DependencyMode = DependencyMode.CHAIN,
        max_enumerated_planes: int = 8,
        bypass_depth: int = 0,
        device: "str | torch.device" = "cpu",
    ):
        b = len(cells)
        self.cells = list(cells)
        self.mode = mode
        self.max_enumerated_planes = max_enumerated_planes
        self.bypass_depth = bypass_depth
        self.device = torch.device(device)
        self.n_p = np.array([f.n_planes for f, _ in cells], dtype=np.int64)
        self.n_s = np.array([p.n_steps for _, p in cells], dtype=np.int64)
        p_max = int(self.n_p.max())
        s_max = int(self.n_s.max())
        self.p_max, self.s_max = p_max, s_max
        self.bw = np.ones((b, p_max))
        self.config = np.full((b, p_max), NO_CONFIG, dtype=np.int64)
        self.free = np.zeros((b, p_max))
        self.barrier = np.zeros(b)
        self.real = np.zeros((b, p_max), dtype=bool)
        self.step_cfg = np.full((b, s_max), NO_CONFIG, dtype=np.int64)
        self.step_vol = np.zeros((b, s_max))
        self.t_recfg = np.zeros(b)
        for bi, (fabric, pattern) in enumerate(cells):
            n_p, n_s = fabric.n_planes, pattern.n_steps
            bw, init = fabric_arrays(fabric)
            self.bw[bi, :n_p] = bw
            self.config[bi, :n_p] = init
            self.real[bi, :n_p] = True
            self.step_cfg[bi, :n_s] = pattern.configs
            self.step_vol[bi, :n_s] = pattern.volumes
            self.t_recfg[bi] = fabric.t_recfg
        device_keys = [
            "bw", "config", "free", "barrier", "real", "step_cfg",
            "step_vol", "t_recfg", "n_s", "n_p",
        ]
        if mode is DependencyMode.CHAIN:
            self._init_chain_tables()
            self._init_candidate_table()
            device_keys += [
                "bw_sum", "suffix_vol", "suffix_changes", "prev_same",
                "cand_mask", "cand_inst", "cand_start", "cand_size",
                "cand_valid",
            ]
        # Physically-installed configs (the executor's lazy state): only
        # direct serves advance it, never reserve retargets -- bypass
        # relay depths are derived from this, not from `config`.
        self.installed = self.config.copy()
        # Per-instance self-relay depth tables, padded to the grid's max
        # config-id range; shape (B, 0, 0) when bypassing is off.
        if mode is DependencyMode.CHAIN and bypass_depth >= 2:
            tabs = [
                relay_depth_table(pattern, bypass_depth)
                for _, pattern in cells
            ]
            c_max = max(t.shape[0] for t in tabs)
            self.depth_tab = np.zeros((b, c_max, c_max), dtype=np.int64)
            for bi, t in enumerate(tabs):
                self.depth_tab[bi, : t.shape[0], : t.shape[1]] = t
        else:
            self.depth_tab = np.zeros((b, 0, 0), dtype=np.int64)
        self.any_relay = bool(self.depth_tab.any())
        device_keys += ["installed", "depth_tab"]
        self.n_s_host = self.n_s
        self.n_p_host = self.n_p
        if mode is DependencyMode.CHAIN:
            self.cand_inst_host = self.cand_inst
            self.cand_start_host = self.cand_start
        for key in device_keys:
            setattr(
                self, key, torch.as_tensor(getattr(self, key), device=device)
            )

    def _init_chain_tables(self) -> None:
        """Rollout tail tables + the ``prev_same`` first-occurrence table."""
        b, s_max = len(self.cells), self.s_max
        # Tail lower-bound tables (same summation order as the reference's
        # rollout: a direct np.sum over the suffix slice, per start offset).
        self.bw_sum = np.array(
            [self.bw[bi, : self.n_p[bi]].sum() for bi in range(b)]
        )
        self.suffix_vol = np.zeros((b, s_max + 1))
        self.suffix_changes = np.zeros((b, s_max + 1), dtype=np.int64)
        # prev_same[bi, k]: largest k' < k with the same step config, else
        # -1 -- so "k is the first occurrence of its config in steps >= s"
        # is the O(1) test prev_same[bi, k] < s.
        self.prev_same = np.full((b, s_max), -1, dtype=np.int64)
        for bi in range(b):
            n_s = int(self.n_s[bi])
            last_seen: dict[int, int] = {}
            for k in range(n_s):
                # Per-offset direct np.sum: load-bearing for float-order
                # parity with the reference's tail_volume computation.
                self.suffix_vol[bi, k] = self.step_vol[bi, k:n_s].sum()
                cfg = int(self.step_cfg[bi, k])
                self.prev_same[bi, k] = last_seen.get(cfg, -1)
                last_seen[cfg] = k
            if n_s > 1:
                # suffix_changes[k] counts adjacent config changes in
                # steps k..n_s-1; integer-exact.
                changes = (
                    self.step_cfg[bi, 1:n_s] != self.step_cfg[bi, : n_s - 1]
                ).astype(np.int64)
                self.suffix_changes[bi, : n_s - 1] = np.cumsum(
                    changes[::-1]
                )[::-1]

    def _init_candidate_table(self) -> None:
        """Flat padded reserve-set rows, in the reference's order.

        Enumerated instances (``n_planes <= max_enumerated_planes``) get
        static masks: every subset except the full set, sizes ascending,
        lexicographic within a size.  Larger instances get 4 *dynamic*
        rows -- soonest-free prefixes of sizes 0..3 -- whose masks are
        refreshed from ``free`` at every step (`_refresh_dynamic_rows`).
        """
        b, p_max = len(self.cells), self.p_max
        subsets: dict[int, np.ndarray] = {}
        blocks: list[np.ndarray] = []
        inst: list[np.ndarray] = []
        self.cand_start = np.zeros(b, dtype=np.int64)
        dynamic: list[int] = []
        n_rows = 0
        for bi in range(b):
            n_p = int(self.n_p[bi])
            self.cand_start[bi] = n_rows
            if n_p <= self.max_enumerated_planes:
                if n_p not in subsets:
                    subsets[n_p] = _subset_masks(n_p, p_max)
                block = subsets[n_p]
            else:
                dynamic.append(bi)
                block = np.zeros((4, p_max), dtype=bool)  # sizes 0..3
            blocks.append(block)
            inst.append(np.full(block.shape[0], bi, dtype=np.int64))
            n_rows += block.shape[0]
        self.cand_mask = np.concatenate(blocks, axis=0)
        self.cand_inst = np.concatenate(inst)
        self.cand_size = self.cand_mask.sum(axis=1)
        self.cand_valid = self.cand_size != self.n_p[self.cand_inst]
        self.dyn_insts = np.asarray(dynamic, dtype=np.int64)

    def _refresh_dynamic_rows(self, dyn: torch.Tensor, rows: torch.Tensor):
        """Rebuild soonest-free prefix masks for live fallback instances.

        ``dyn`` lists the live fallback instances and ``rows`` their four
        table rows each.  Matches the reference's ``sorted(range(n_planes),
        key=free)`` (stable: ties break by plane index); prefixes longer
        than ``n_planes`` saturate to the full plane set.
        """
        inf = torch.tensor(float("inf"), dtype=torch.float64, device=dyn.device)
        ranks = _stable_ranks(torch.where(self.real[dyn], self.free[dyn], inf))
        for size in range(4):
            self.cand_mask[self.cand_start[dyn] + size] = (
                ranks < size
            ) & self.real[dyn]
        self.cand_size[rows] = self.cand_mask[rows].sum(dim=1)
        self.cand_valid[rows] = (
            self.cand_size[rows] != self.n_p[self.cand_inst[rows]]
        )

    def upcoming_targets_table(
        self, step_idx: int
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-instance retarget tables for reserve sets at ``step_idx``.

        Returns ``(targets (B, P_max), n_avail (B,))``: for each instance,
        the first ``P_max`` distinct configs of steps ``step_idx + 1..``
        (first-occurrence order) that are neither held on a plane nor
        equal to the current step's config.  The reference scatters the
        taken slots with a host ``nonzero``; here slots past ``P_max`` land
        in a spill column that is dropped, so nothing is read back.
        """
        b, p_max = len(self.cells), self.p_max
        dev = self.config.device
        s = step_idx + 1
        if s >= self.s_max:
            return (
                torch.full((b, p_max), NO_CONFIG, dtype=torch.int64, device=dev),
                torch.zeros(b, dtype=torch.int64, device=dev),
            )
        window = self.step_cfg[:, s:]
        first_occ = self.prev_same[:, s:] < s
        in_window = (
            torch.arange(s, self.s_max, device=dev)[None, :]
            < self.n_s[:, None]
        )
        held = (window[:, :, None] == self.config[:, None, :]).any(dim=2)
        held |= window == self.step_cfg[:, step_idx][:, None]
        avail = first_occ & ~held & in_window
        slot = torch.cumsum(avail, dim=1) - 1
        take = avail & (slot < p_max)
        targets = torch.full(
            (b, p_max + 1), NO_CONFIG, dtype=torch.int64, device=dev
        )
        targets.scatter_(1, torch.where(take, slot, p_max), window)
        return targets[:, :p_max], avail.sum(dim=1)


def _stable_ranks(key: torch.Tensor) -> torch.Tensor:
    """Per-row rank of each column under a stable ascending sort of ``key``.

    Ties rank in column order (``torch.sort(stable=True)``, the twin of
    ``np.argsort(kind="stable")``).
    """
    order = torch.sort(key, dim=1, stable=True).indices
    ranks = torch.empty_like(order)
    cols = torch.arange(key.shape[1], device=key.device).expand_as(order)
    ranks.scatter_(1, order, cols)
    return ranks


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Index tensors of one set of live cells (host-known, on the device).

    ``live`` changes only when a cell's pattern runs out, so the loop
    builds a layout once per distinct live set and never reads the device
    to index rows.
    """

    live_insts: torch.Tensor  # (L,) live cell ids, ascending
    live_insts_host: np.ndarray
    rows: torch.Tensor  # candidate-table rows of live cells
    inst: torch.Tensor  # (rows,) cell id of each row
    inst_twin: torch.Tensor  # inst, twice over when bypass twins exist
    best_pos: torch.Tensor  # (L,) first sorted position of each live cell
    dyn: torch.Tensor  # live fallback cells (dynamic rows)
    dyn_rows: torch.Tensor  # their four table rows each
    max_ns: int  # longest pattern among live cells


def _layout(st: _GridState, live: np.ndarray, twin: bool) -> _Layout:
    """The CHAIN loop's row layout for the live cells ``live``."""
    live_insts = np.nonzero(live)[0]

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=st.device)

    rows = np.nonzero(live[st.cand_inst_host])[0]
    inst = st.cand_inst_host[rows]
    inst_all = np.concatenate([inst, inst]) if twin else inst
    # The selection sorts rows by cell id first, so each live cell's
    # segment starts after the rows of every smaller live cell.
    counts = np.bincount(inst_all, minlength=len(st.cells))
    first = np.cumsum(counts) - counts
    dyn = st.dyn_insts[live[st.dyn_insts]]
    dyn_rows = (st.cand_start_host[dyn][:, None] + np.arange(4)).ravel()
    return _Layout(
        live_insts=t(live_insts),
        live_insts_host=live_insts,
        rows=t(rows),
        inst=t(inst),
        inst_twin=t(inst_all),
        best_pos=t(first[live_insts]),
        dyn=t(dyn),
        dyn_rows=t(dyn_rows),
        max_ns=int(st.n_s_host[live].max()),
    )


def _reserve_rows(
    st: _GridState, step_idx: int, lay: _Layout
) -> tuple[torch.Tensor, ...]:
    """Batched candidate reserve-set states across every live instance.

    Returns ``(inst, trial_cfg, trial_free, reserved_mask, valid)`` with
    rows grouped contiguously per live instance.  Reserved planes are
    retargeted toward upcoming configs soonest-free first (stable on
    ties), with the same single ``free + t_recfg`` float bump as the
    reference.
    """
    if lay.dyn.numel():
        st._refresh_dynamic_rows(lay.dyn, lay.dyn_rows)
    rows, inst = lay.rows, lay.inst
    mask = st.cand_mask[rows]
    free_rows = st.free[inst]
    cfg_rows = st.config[inst]
    # Rank reserved planes by (free time, plane index): stable sort over
    # free with non-reserved planes pushed to +inf.
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=st.device)
    ranks = _stable_ranks(torch.where(mask, free_rows, inf))
    targets, n_avail = st.upcoming_targets_table(step_idx)
    n_tgt = torch.minimum(st.cand_size[rows], n_avail[inst])
    assigned = mask & (ranks < n_tgt[:, None])
    tgt = torch.gather(targets[inst], 1, ranks)
    trial_free = torch.where(
        assigned, free_rows + st.t_recfg[inst][:, None], free_rows
    )
    trial_cfg = torch.where(assigned, tgt, cfg_rows)
    return inst, trial_cfg, trial_free, mask, st.cand_valid[rows]


def _rollout_rows(
    st: _GridState,
    inst: torch.Tensor,  # (R,) row -> instance index
    cfg: torch.Tensor,  # (R, P_max)
    free: torch.Tensor,  # (R, P_max)
    barrier: torch.Tensor,  # (R,)
    start_step: int,
    horizon: int,
    max_ns: int,
) -> torch.Tensor:
    """Row-batched no-reserve rollout with per-row step tables.

    Rows of different grid cells roll out their own remaining steps
    (masked once a row's pattern runs out), operation for operation as
    the reference does.  ``max_ns`` is the longest pattern among the
    rows' cells: the loop stops there, where the reference's "no row is
    live" test stops it.
    """
    bw_rows = st.bw[inst]
    real_rows = st.real[inst]
    t_rows = st.t_recfg[inst][:, None]
    n_s_rows = st.n_s[inst]
    end_step = torch.clamp(n_s_rows, max=start_step + horizon)
    stop = min(st.s_max, start_step + horizon, max_ns)
    for k in range(start_step, stop):
        live = k < n_s_rows
        cfg_k = st.step_cfg[inst, k][:, None]
        vol_k = torch.where(live, st.step_vol[inst, k], 0.0)
        extra = torch.where(cfg == cfg_k, 0.0, t_rows)
        ready = torch.maximum(barrier[:, None], free + extra)
        ready = torch.where(real_rows, ready, _BIG)
        level, split = waterfill_batch(ready, bw_rows, vol_k)
        active = (split > 0.0) & live[:, None]
        free = torch.where(active, level[:, None], free)
        cfg = torch.where(active, cfg_k, cfg)
        barrier = torch.where(live, level, barrier)
    # Aggregate-bandwidth tail past the horizon (two separate additions,
    # in the reference's float evaluation order).
    has_tail = end_step < n_s_rows
    tail_vol = st.suffix_vol[inst, end_step] / st.bw_sum[inst]
    barrier = torch.where(has_tail, barrier + tail_vol, barrier)
    tail_rec = (
        st.suffix_changes[inst, end_step] * st.t_recfg[inst] / st.n_p[inst]
    )
    return torch.where(has_tail, barrier + tail_rec, barrier)


def _lexsort_rows(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``np.lexsort`` of 1-D keys (last key primary) with an implicit
    final ``arange`` tie-break key: successive stable sorts, least
    significant key first, starting from the identity permutation (which
    *is* the ``arange`` pass)."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in keys:
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def _chain_grid_chosen(
    st: _GridState, rollout_horizon: int
) -> list[tuple[np.ndarray, torch.Tensor, torch.Tensor]]:
    """The batched CHAIN per-step loop, on the device.

    Per step: one `_reserve_rows`, one ``waterfill_batch``, one
    row-batched rollout and one instance-keyed lexicographic selection of
    every live instance's winner.  Returns per-step ``(live_insts, split,
    byp_h)`` tuples (splits and hop counts still on the device).
    """
    b = len(st.cells)
    with_bypass = st.bypass_depth >= 2 and st.depth_tab.shape[1] > 0
    chosen: list[tuple[np.ndarray, torch.Tensor, torch.Tensor]] = []
    layouts: dict[int, _Layout] = {}
    all_feasible = torch.ones((), dtype=torch.bool, device=st.device)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=st.device)
    for i in range(st.s_max):
        live = i < st.n_s_host
        n_live = int(live.sum())
        if not n_live:
            break
        if n_live not in layouts:  # live only ever shrinks
            layouts[n_live] = _layout(st, live, with_bypass)
        lay = layouts[n_live]
        inst, trial_cfg, trial_free, reserved_mask, valid = _reserve_rows(
            st, i, lay
        )
        byp_h = torch.zeros_like(trial_cfg)
        if with_bypass:
            # Bypass twin rows, appended after ALL base rows: within one
            # instance every base row still precedes every bypass row, as
            # in the reference's candidate order.
            c_max = st.depth_tab.shape[1]
            scfg = st.step_cfg[inst, i]
            inst_rows = st.installed[inst]
            known = (inst_rows >= 0) & (inst_rows < c_max)
            plane_hops = torch.where(
                known,
                st.depth_tab[
                    inst[:, None],
                    inst_rows.clamp(0, c_max - 1),
                    scfg.clamp(0, c_max - 1)[:, None],
                ],
                0,
            )
            hops = torch.where(
                reserved_mask | (trial_cfg == scfg[:, None]), 0, plane_hops
            )
            inst = lay.inst_twin
            trial_cfg = torch.cat([trial_cfg, trial_cfg], dim=0)
            trial_free = torch.cat([trial_free, trial_free], dim=0)
            reserved_mask = torch.cat([reserved_mask, reserved_mask], dim=0)
            valid = torch.cat([valid, valid & hops.any(dim=1)])
            byp_h = torch.cat([torch.zeros_like(hops), hops], dim=0)
        bypassing = byp_h >= 2
        cfg_i = st.step_cfg[inst, i][:, None]
        vol_i = st.step_vol[inst, i]
        extra = torch.where(
            (trial_cfg == cfg_i) | bypassing, 0.0, st.t_recfg[inst][:, None]
        )
        ready = torch.maximum(st.barrier[inst][:, None], trial_free + extra)
        ready = torch.where(reserved_mask | ~st.real[inst], _BIG, ready)
        bw_rows = st.bw[inst]
        # float64 / int64 stays float64, as numpy's true division does.
        bw_eff = torch.where(
            bypassing, bw_rows / torch.clamp(byp_h, min=1), bw_rows
        )
        level, split = waterfill_batch(ready, bw_eff, vol_i)
        valid = valid & ((vol_i <= _EPS) | (split > 0.0).any(dim=1))
        # logical_or.at over rows: an integer count, no float atomics.
        n_valid = torch.zeros(b, dtype=torch.int64, device=st.device)
        n_valid.index_add_(0, inst, valid.to(torch.int64))
        all_feasible &= (n_valid[lay.live_insts] > 0).all()
        active = split > 0.0
        new_free = torch.where(active, level[:, None], trial_free)
        new_cfg = torch.where(active & ~bypassing, cfg_i, trial_cfg)
        scores = _rollout_rows(
            st, inst, new_cfg, new_free, level, i + 1, rollout_horizon,
            lay.max_ns,
        )
        scores = torch.where(valid, scores, inf)
        level_key = torch.where(valid, level, inf)
        # Per-instance min by (score, level, candidate order): one global
        # lexsort with the instance id as primary key; the first row of
        # each instance segment is its winner.
        order = _lexsort_rows((level_key, scores, inst))
        best = order[lay.best_pos]
        live_insts = lay.live_insts
        st.config[live_insts] = new_cfg[best]
        st.free[live_insts] = new_free[best]
        st.barrier[live_insts] = level[best]
        # Installed state mirrors the executor's idle-split filter.
        st.installed[live_insts] = torch.where(
            (split[best] > _EPS_VOLUME) & ~bypassing[best],
            st.step_cfg[live_insts, i][:, None],
            st.installed[live_insts],
        )
        chosen.append((lay.live_insts_host, split[best], byp_h[best]))
    if not bool(all_feasible):
        raise RuntimeError("no feasible reserve set for a live grid cell")
    return chosen


def _to_host(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """Per-step device tensors back to numpy in one transfer."""
    if not tensors:
        return []
    sizes = [t.shape[0] for t in tensors]
    flat = torch.cat(tensors, dim=0).cpu().numpy()
    return np.split(flat, np.cumsum(sizes)[:-1])


def _chain_grid_decisions(
    st: _GridState, rollout_horizon: int
) -> list[Decisions]:
    """Materialize CHAIN-mode grid Decisions (host epilogue)."""
    b = len(st.cells)
    with_bypass = st.bypass_depth >= 2
    chosen = _chain_grid_chosen(st, rollout_horizon)
    split_h = _to_host([c[1] for c in chosen])
    byph_h = _to_host([c[2] for c in chosen])
    splits: list[list[dict[int, float]]] = [[] for _ in range(b)]
    bypass_steps: list[list[tuple[BypassRoute, ...]]] = [
        [] for _ in range(b)
    ]
    for (live_insts, _, _), split, byph in zip(chosen, split_h, byph_h):
        for bi, srow, hrow in zip(
            live_insts.tolist(), split.tolist(), byph.tolist()
        ):
            n_p = int(st.n_p_host[bi])
            splits[bi].append(
                {
                    j: srow[j]
                    for j in range(n_p)
                    if srow[j] > 0.0 and hrow[j] < 2
                }
            )
            bypass_steps[bi].append(
                tuple(
                    BypassRoute(planes=(j,) * hrow[j], volume=srow[j])
                    for j in range(n_p)
                    if srow[j] > 0.0 and hrow[j] >= 2
                )
            )
    return [
        Decisions(
            tuple(s),
            bypass=tuple(bp) if with_bypass else None,
        )
        for s, bp in zip(splits, bypass_steps)
    ]


def _independent_grid_decisions(st: _GridState) -> list[Decisions]:
    """Batched INDEPENDENT-mode step packing (least-finish-time).

    Every live instance's argmin-packing decision for step ``i`` comes
    from one (batch, planes) finish-time computation on the device;
    padded planes are masked to +inf.  ``torch.argmin`` returns the first
    minimal index, as ``np.argmin`` does.
    """
    b = len(st.cells)
    chosen: list[tuple[np.ndarray, torch.Tensor, torch.Tensor]] = []
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=st.device)
    rows_h = rows = None
    for i in range(st.s_max):
        live = i < st.n_s_host
        if not live.any():
            break
        if rows_h is None or len(rows_h) != int(live.sum()):
            # Live cells only ever drop out: rebuild the index on a change.
            rows_h = np.nonzero(live)[0]
            rows = torch.as_tensor(rows_h, device=st.device)
        cfg_i = st.step_cfg[:, i][:, None]
        extra = torch.where(st.config == cfg_i, 0.0, st.t_recfg[:, None])
        finish = st.free + extra + st.step_vol[:, i][:, None] / st.bw
        finish = torch.where(st.real, finish, inf)
        j = torch.argmin(finish, dim=1)
        jl = j[rows]
        st.free[rows, jl] = finish[rows, jl]
        st.config[rows, jl] = st.step_cfg[rows, i]
        chosen.append((rows_h, jl, st.step_vol[rows, i]))
    planes = _to_host([c[1] for c in chosen])
    vols = _to_host([c[2] for c in chosen])
    splits: list[list[dict[int, float]]] = [[] for _ in range(b)]
    for (rows_h, _, _), jl, vl in zip(chosen, planes, vols):
        for bi, j, v in zip(rows_h.tolist(), jl.tolist(), vl.tolist()):
            splits[bi].append({j: v})
    return [
        Decisions(tuple(s), mode=DependencyMode.INDEPENDENT)
        for s in splits
    ]


def _independent_split_grid_decisions(st: _GridState) -> list[Decisions]:
    """Batched INDEPENDENT-mode water-fill splitting.

    Every live instance's step splits across its planes in ONE
    ``waterfill_batch`` call with per-row volumes; padded planes are
    masked to ``_BIG`` ready times.
    """
    b = len(st.cells)
    chosen: list[tuple[np.ndarray, torch.Tensor]] = []
    rows_h = live_t = None
    for i in range(st.s_max):
        live = i < st.n_s_host
        if not live.any():
            break
        if rows_h is None or len(rows_h) != int(live.sum()):
            rows_h = np.nonzero(live)[0]
            live_t = torch.as_tensor(live, device=st.device)
        cfg_i = st.step_cfg[:, i][:, None]
        extra = torch.where(st.config == cfg_i, 0.0, st.t_recfg[:, None])
        ready = torch.where(st.real, st.free + extra, _BIG)
        vol_i = torch.where(live_t, st.step_vol[:, i], 0.0)
        level, split = waterfill_batch(ready, st.bw, vol_i)
        active = (split > 0.0) & live_t[:, None]
        st.free = torch.where(active, level[:, None], st.free)
        st.config = torch.where(active, cfg_i, st.config)
        chosen.append((rows_h, split))
    split_h = _to_host([c[1] for c in chosen])
    splits: list[list[dict[int, float]]] = [[] for _ in range(b)]
    for (rows, _), split in zip(chosen, split_h):
        rows_split = split.tolist()
        for bi in rows.tolist():
            srow = rows_split[bi]
            splits[bi].append(
                {
                    j: srow[j]
                    for j in range(int(st.n_p_host[bi]))
                    if srow[j] > 0.0
                }
            )
    return [
        Decisions(tuple(s), mode=DependencyMode.INDEPENDENT)
        for s in splits
    ]


def swot_greedy_grid(
    cells: Sequence[tuple[OpticalFabric, Pattern]],
    rollout_horizon: int = 24,
    max_enumerated_planes: int = 8,
    backend: "TimingBackend | None" = None,
    mode: DependencyMode = DependencyMode.CHAIN,
    bypass_depth: int = 0,
    independent_split: bool = False,
    planner: str | None = None,
    attribution: bool = False,
    device: str | None = None,
) -> list[GridPlan]:
    """Plan a whole grid of (fabric, pattern) cells in one batched pass.

    The per-step loop runs on ``device`` (the card unless ``"cpu"``); the
    final CCT/utilization scoring runs through ``batch_evaluate`` on
    ``backend`` (``None``: a ``TorchBackend`` on ``device``).  Per-cell
    decisions are bitwise equal to the reference package's
    ``swot_greedy_grid(..., planner="step", backend="numpy")``.

    ``bypass_depth >= 2`` (CHAIN mode) plans a Topology-Bypassing twin
    grid and keeps, per cell, whichever decisions score the strictly
    better CCT on ``backend`` (whose CCTs are bitwise those of the
    reference's numpy backend, so the pick is the reference's).

    ``planner`` is ``"step"`` or ``None`` (the same loop); ``"fused"``,
    the one-program planner, is not ported yet and raises
    ``NotImplementedError``.  ``attribution=True`` attaches each cell's
    (S, P) `repro_torch.obs.attribution.Attribution` slice.  LP polish is
    per-instance only, so the grid path has none.
    """
    dev = resolve_device(device)
    if planner == "fused":
        raise NotImplementedError(_FUSED_NOT_PORTED)
    if planner not in (None, "step"):
        raise ValueError(
            f"unknown planner {planner!r}; choose 'step' or None"
        )
    if not cells:
        return []
    if independent_split and mode is DependencyMode.CHAIN:
        raise ValueError(
            "independent_split=True requires mode=INDEPENDENT"
        )
    backend = backend_on(backend, dev)
    st = _GridState(
        cells, mode=mode, max_enumerated_planes=max_enumerated_planes,
        device=dev,
    )
    if mode is DependencyMode.CHAIN:
        decisions = _chain_grid_decisions(st, rollout_horizon)
        st_byp = (
            _GridState(
                cells, mode=mode,
                max_enumerated_planes=max_enumerated_planes,
                bypass_depth=bypass_depth, device=dev,
            )
            if bypass_depth >= 2
            else None
        )
        # A grid with no self-relay opportunity anywhere (e.g. all xor
        # pairings) skips the twin pass and its two scoring passes.
        if st_byp is not None and st_byp.any_relay:
            byp_decisions = _chain_grid_decisions(st_byp, rollout_horizon)
            base_cct = batch_evaluate(
                [
                    BatchInstance(fabric, pattern, dec)
                    for (fabric, pattern), dec in zip(cells, decisions)
                ],
                backend=backend,
            ).cct
            byp_cct = batch_evaluate(
                [
                    BatchInstance(fabric, pattern, dec)
                    for (fabric, pattern), dec in zip(cells, byp_decisions)
                ],
                backend=backend,
            ).cct
            decisions = [
                byp
                if (
                    byp.bypass is not None
                    and any(byp.bypass)
                    and byp_cct[bi] < base_cct[bi]
                )
                else base
                for bi, (base, byp) in enumerate(
                    zip(decisions, byp_decisions)
                )
            ]
    elif independent_split:
        decisions = _independent_split_grid_decisions(st)
    else:
        decisions = _independent_grid_decisions(st)
    result = batch_evaluate(
        [
            BatchInstance(fabric, pattern, dec)
            for (fabric, pattern), dec in zip(st.cells, decisions)
        ],
        backend=backend,
        attribution=attribution,
    )
    return [
        GridPlan(
            fabric=fabric,
            pattern=pattern,
            decisions=dec,
            cct=float(result.cct[bi]),
            n_reconfigurations=int(result.n_reconfigurations[bi]),
            utilization=float(result.utilization[bi]),
            attribution=(
                _slice_attribution(result.attribution, bi)
                if attribution
                else None
            ),
        )
        for bi, ((fabric, pattern), dec) in enumerate(
            zip(st.cells, decisions)
        )
    ]


def _slice_attribution(att, bi: int):
    """One cell's (S, P) Attribution view from the batch decomposition."""
    return dataclasses.replace(
        att,
        t_xmit=att.t_xmit[bi],
        t_bypass=att.t_bypass[bi],
        t_recfg_wait=att.t_recfg_wait[bi],
        t_recfg_hidden=att.t_recfg_hidden[bi],
        t_idle=att.t_idle[bi],
        cct=att.cct[bi],
        step_mask=att.step_mask[bi],
        plane_mask=att.plane_mask[bi],
    )
