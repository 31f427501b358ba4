"""PyTorch port, grid planner and facade, against the reference (CPU).

``repro_torch.core.greedy.swot_greedy_grid(..., device="cpu")`` must make
bitwise the decisions of ``repro.core.greedy.swot_greedy_grid(...,
planner="step", backend="numpy")`` -- splits and bypass routes -- and
report bitwise the same CCT, reconfiguration count and utilization, in
every mode x bypass x split combination; the ``plan()`` facade likewise.
"""

import numpy as np
import pytest
from torch_parity import bits_equal, port_cells

from repro.core import OpticalFabric as RefFabric
from repro.core import get_pattern as ref_get_pattern
from repro.core import prestage_for as ref_prestage_for
from repro.core.api import PlannerOptions as RefOptions
from repro.core.api import PlanRequest as RefRequest
from repro.core.api import plan as ref_plan
from repro.core.fabric import FIG5_LINK_BANDWIDTH as REF_FIG5_BW
from repro.core.greedy import swot_greedy_grid as ref_swot_greedy_grid
from repro.core.schedule import DependencyMode as RefMode
from repro_torch.core import (
    FIG5_LINK_BANDWIDTH,
    DependencyMode,
    OpticalFabric,
    PlannerOptions,
    PlanRequest,
    convert,
    plan,
    prestage_for,
    swot_greedy_grid,
)
from repro_torch.core.patterns import rabenseifner_allreduce


def _cells(specs, prestage=True, scale=None):
    cells = []
    for alg, n, size, planes, t_recfg in specs:
        pattern = ref_get_pattern(alg, n, size)
        fabric = RefFabric(
            n, planes, t_recfg=t_recfg,
            plane_bandwidth_scale=scale(planes) if scale else None,
        )
        if prestage:
            fabric = ref_prestage_for(fabric, pattern)
        cells.append((fabric, pattern))
    return cells


_CHAIN = (
    ("rabenseifner_allreduce", 8, 8e6, 4, 2e-4),
    ("pairwise_alltoall", 6, 8e6, 2, 0.0),
    ("bruck_alltoall", 5, 8e6, 3, 2e-4),
    ("ring_allreduce", 6, 12e6, 1, 5e-5),
    ("pairwise_alltoall", 8, 16e6, 8, 4e-4),
)
_BYPASS = (
    ("pairwise_alltoall", 8, 8e6, 4, 3.2e-3),
    ("pairwise_alltoall", 8, 4e6, 4, 8e-4),
    ("ring_allreduce", 6, 8e6, 2, 3.2e-3),
    ("bruck_alltoall", 8, 8e6, 2, 2e-4),
)
_MIXED = (  # mixed shapes, incl. a dynamic-row cell (10 planes > cap 8)
    ("rabenseifner_allreduce", 8, 40e6, 1, 0.0),
    ("pairwise_alltoall", 10, 3e6, 4, 2e-4),
    ("bruck_alltoall", 5, 7e6, 3, 1e-4),
    ("rabenseifner_allreduce", 4, 1e6, 8, 4e-4),
    ("ring_allreduce", 6, 12e6, 10, 5e-5),
)
_DYNAMIC = (  # 10 planes with an enumeration cap of 4
    ("rabenseifner_allreduce", 8, 16e6, 10, 2e-4),
    ("pairwise_alltoall", 6, 8e6, 3, 2e-4),
    ("ring_allreduce", 4, 8e6, 10, 5e-5),
)


def _straggler(planes):
    return tuple(1.0 if j % 2 == 0 else 0.25 for j in range(planes))


_GRIDS = {
    # name: (cells, swot_greedy_grid kwargs)
    "chain": (lambda: _cells(_CHAIN), {}),
    "chain_unstaged": (lambda: _cells(_CHAIN, prestage=False), {}),
    "chain_bypass2": (lambda: _cells(_BYPASS), {"bypass_depth": 2}),
    "chain_bypass3": (lambda: _cells(_BYPASS), {"bypass_depth": 3}),
    "independent": (
        lambda: _cells(_CHAIN, prestage=False),
        {"mode": "independent"},
    ),
    "independent_split": (
        lambda: _cells(_CHAIN[:3] + _CHAIN[4:], scale=_straggler),
        {"mode": "independent", "independent_split": True},
    ),
    "dynamic_rows": (
        lambda: _cells(_DYNAMIC, prestage=False),
        {"max_enumerated_planes": 4},
    ),
    "mixed_shapes": (lambda: _cells(_MIXED, prestage=False), {}),
    "short_horizon": (lambda: _cells(_CHAIN), {"rollout_horizon": 2}),
}


def _run_both(name, attribution=False):
    make, kwargs = _GRIDS[name]
    ref_cells = make()
    ref_kwargs = dict(kwargs)
    port_kwargs = dict(kwargs)
    if "mode" in kwargs:
        ref_kwargs["mode"] = RefMode(kwargs["mode"])
        port_kwargs["mode"] = DependencyMode(kwargs["mode"])
    want = ref_swot_greedy_grid(
        ref_cells, backend="numpy", planner="step",
        attribution=attribution, **ref_kwargs,
    )
    got = swot_greedy_grid(
        port_cells(ref_cells), device="cpu", attribution=attribution,
        **port_kwargs,
    )
    return got, want


@pytest.mark.parametrize("name", sorted(_GRIDS))
def test_grid_decisions_and_scores_bitwise(name):
    got, want = _run_both(name)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.decisions == convert.decisions_from(w.decisions), k
        assert bits_equal(np.float64(g.cct), np.float64(w.cct)), k
        assert g.n_reconfigurations == w.n_reconfigurations, k
        assert bits_equal(np.float64(g.utilization), np.float64(w.utilization)), k
    if name.startswith("chain_bypass"):
        assert any(
            g.decisions.bypass and any(g.decisions.bypass) for g in got
        ), "the bypass grid chose no relay; the fixture regressed"


@pytest.mark.parametrize("name", ["chain", "chain_bypass2", "independent"])
def test_grid_attribution_bitwise(name):
    got, want = _run_both(name, attribution=True)
    for g, w in zip(got, want):
        for field in (
            "t_xmit", "t_bypass", "t_recfg_wait", "t_recfg_hidden",
            "t_idle", "cct",
        ):
            assert bits_equal(
                getattr(g.attribution, field), getattr(w.attribution, field)
            ), field


def _fig5_cells(port):
    if port:
        pattern = rabenseifner_allreduce(8, 40e6)
        fabric = OpticalFabric(8, 2, bandwidth=FIG5_LINK_BANDWIDTH, t_recfg=200e-6)
        return [(prestage_for(fabric, pattern), pattern)]
    pattern = ref_get_pattern("rabenseifner_allreduce", 8, 40e6)
    fabric = RefFabric(8, 2, bandwidth=REF_FIG5_BW, t_recfg=200e-6)
    return [(ref_prestage_for(fabric, pattern), pattern)]


def test_fig5_anchor():
    want = ref_plan(
        RefRequest.grid(_fig5_cells(False), options=RefOptions(backend="numpy", planner="step"))
    )
    got = plan(
        PlanRequest.grid(_fig5_cells(True), options=PlannerOptions(device="cpu"))
    )
    assert got.ccts[0] == 1300e-6 == want.ccts[0]
    assert got.grid[0].strawman_cct == 1500.0000000000002e-6
    assert bits_equal(
        np.float64(got.grid[0].strawman_cct), np.float64(want.grid[0].strawman_cct)
    )
    got.schedule(0).validate()


@pytest.mark.parametrize(
    "name", ["chain", "chain_bypass2", "independent_split", "mixed_shapes"]
)
def test_plan_facade_matches_reference(name):
    make, kwargs = _GRIDS[name]
    ref_cells = make()
    opts = {k: v for k, v in kwargs.items() if k != "max_enumerated_planes"}
    ref_opts = dict(opts)
    if "mode" in opts:
        ref_opts["mode"] = RefMode(opts["mode"])
        opts["mode"] = DependencyMode(opts["mode"])
    want = ref_plan(
        RefRequest.grid(
            ref_cells,
            options=RefOptions(backend="numpy", planner="step", **ref_opts),
        )
    )
    got = plan(
        PlanRequest.grid(
            port_cells(ref_cells), options=PlannerOptions(device="cpu", **opts)
        )
    )
    assert got.methods == want.methods
    assert bits_equal(np.array(got.ccts), np.array(want.ccts))
    for i, (g, w) in enumerate(zip(got.grid, want.grid)):
        assert bits_equal(np.float64(g.strawman_cct), np.float64(w.strawman_cct))
        assert g.plan.decisions == convert.decisions_from(w.plan.decisions)
        sched = got.schedule(i)
        sched.validate()
        assert sched.cct == g.cct


def test_per_instance_strawman_matches_reference():
    ref_cells = _cells(_CHAIN[:2])
    for (rf, rp), (f, p) in zip(ref_cells, port_cells(ref_cells)):
        want = ref_plan(
            RefRequest.single(rf, rp, plane_ready=[1e-5] * rf.n_planes,
                              options=RefOptions(method="strawman"))
        )
        got = plan(
            PlanRequest.single(f, p, plane_ready=[1e-5] * f.n_planes,
                               options=PlannerOptions(method="strawman", device="cpu"))
        )
        assert got.method == want.method == "strawman"
        assert got.cct == want.cct
        assert got.schedule().cct == got.cct


def test_unported_paths_raise():
    (f, p), = port_cells(_cells(_CHAIN[:1]))
    with pytest.raises(NotImplementedError, match="Queue 1 #4"):
        plan(PlanRequest.grid(
            [(f, p)] * 2, options=PlannerOptions(planner="fused", device="cpu")
        ))
    for method in ("auto", "greedy", "milp"):
        with pytest.raises(NotImplementedError, match="not ported"):
            plan(PlanRequest.single(
                f, p, options=PlannerOptions(method=method, device="cpu")
            ))


def test_attribution_matches_reference_where_conservation_misses():
    """On this sweep cell (30 MB, 12.5 us; cell 928 of the 1024-cell grid)
    the reference's closing-idle refinement leaves two planes one ulp
    short of the CCT.  The port reproduces it bitwise, miss included."""
    ref_cells = [(RefFabric(128, 8, t_recfg=12.5e-6),
                  ref_get_pattern("pairwise_alltoall", 128, 30e6))]
    want = ref_swot_greedy_grid(
        ref_cells, backend="numpy", planner="step", attribution=True
    )[0].attribution
    got = swot_greedy_grid(
        port_cells(ref_cells), device="cpu", attribution=True
    )[0].attribution
    for field in (
        "t_xmit", "t_bypass", "t_recfg_wait", "t_recfg_hidden", "t_idle", "cct"
    ):
        assert bits_equal(getattr(got, field), getattr(want, field)), field
    miss = got.plane_total != got.cct
    assert miss.any()
    assert (abs(got.plane_total - got.cct)[miss] <= np.spacing(got.cct)).all()


def test_baselines_match_reference():
    from repro.core.baselines import ideal_cct as ref_ideal_cct
    from repro.core.baselines import strawman_cct as ref_strawman_cct
    from repro.core.baselines import strawman_icr as ref_strawman_icr

    from repro_torch.core import ideal_cct, strawman_cct, strawman_icr

    ref_cells = _cells(_CHAIN, prestage=False)
    for (rf, rp), (f, p) in zip(ref_cells, port_cells(ref_cells)):
        assert strawman_cct(f, p, device="cpu") == ref_strawman_cct(rf, rp)
        assert ideal_cct(f, p) == ref_ideal_cct(rf, rp)
        assert strawman_icr(f, p).cct == ref_strawman_icr(rf, rp).cct
