"""PyTorch port, array-IR engine: water-fill, rollout, packing, IR round trip.

Each port function gets the same seeded numpy inputs as its reference
counterpart in ``repro.core.ir.engine`` and must agree bitwise (float64 bit
patterns), on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import bits_equal

from repro.core import (
    BatchInstance as RefBatchInstance,
    OpticalFabric as RefFabric,
    get_pattern as ref_get_pattern,
    prestage_for as ref_prestage_for,
    strawman_decisions as ref_strawman_decisions,
)
from repro.core.greedy import _stable_ranks as ref_stable_ranks
from repro.core.greedy import swot_greedy_grid as ref_swot_greedy_grid
from repro.core.ir import engine as ref_engine
from repro.core.simulator import execute as ref_execute
from repro_torch.core import convert, execute
from repro_torch.core.greedy import _stable_ranks
from repro_torch.core.ir import engine

_BIG = ref_engine._BIG


def _waterfill_inputs(seed, rows, p):
    """The input distribution of the reference's fused water-fill test:
    random ready times with ~30% of lanes masked to _BIG (>= 1 live),
    heterogeneous bandwidths, ~20% zero-volume rows."""
    rng = np.random.default_rng(seed)
    ready = rng.uniform(0.0, 1e-2, size=(rows, p))
    mask = rng.random((rows, p)) < 0.3
    mask[mask.all(axis=1), 0] = False
    ready = np.where(mask, _BIG, ready)
    bw = rng.uniform(0.5, 2.0, size=(rows, p))
    vol = rng.uniform(0.0, 1e7, size=rows)
    vol[rng.random(rows) < 0.2] = 0.0
    return ready, bw, vol


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("seed,rows", [(0, 1), (1, 5), (2, 17), (3, 64)])
def test_waterfill_batch_bitwise(seed, rows, p):
    ready, bw, vol = _waterfill_inputs(seed, rows, p)
    want_level, want_split = ref_engine.waterfill_batch(ready, bw, vol)
    level, split = engine.waterfill_batch(
        torch.from_numpy(ready), torch.from_numpy(bw), torch.from_numpy(vol)
    )
    assert bits_equal(level, want_level)
    assert bits_equal(split, want_split)


def test_waterfill_batch_all_zero_and_scalar_volume():
    """All-zero rows (the reference's early return) and a scalar volume
    broadcast over rows with shared (P,) bandwidths."""
    ready, bw, _ = _waterfill_inputs(7, 9, 4)
    zeros = np.zeros(9)
    for vol in (zeros, 3.5e6):
        want = ref_engine.waterfill_batch(ready, bw[0], vol)
        got = engine.waterfill_batch(
            torch.from_numpy(ready),
            torch.from_numpy(bw[0]),
            torch.from_numpy(np.asarray(vol)),
        )
        assert bits_equal(got[0], want[0])
        assert bits_equal(got[1], want[1])


@pytest.mark.parametrize("start,horizon", [(0, 24), (2, 3), (5, 1), (9, 24)])
def test_rollout_batch_bitwise(start, horizon):
    pattern = ref_get_pattern("pairwise_alltoall", 12, 9e6)
    rng = np.random.default_rng(start + 31 * horizon)
    n_planes, rows = 4, 11
    bw = rng.uniform(0.5e9, 2e9, size=n_planes)
    configs = np.asarray(pattern.configs, dtype=np.int64)
    volumes = np.asarray(pattern.volumes, dtype=np.float64)
    cfg = rng.integers(-1, 5, size=(rows, n_planes)).astype(np.int64)
    free = rng.uniform(0.0, 1e-3, size=(rows, n_planes))
    barrier = rng.uniform(0.0, 1e-3, size=rows)
    want = ref_engine.rollout_batch(
        bw, 2e-4, configs, volumes, cfg, free, barrier, start, horizon
    )
    got = engine.rollout_batch(
        torch.from_numpy(bw), 2e-4, torch.from_numpy(configs),
        torch.from_numpy(volumes), torch.from_numpy(cfg),
        torch.from_numpy(free), torch.from_numpy(barrier), start, horizon,
    )
    assert bits_equal(got, want)


@pytest.mark.parametrize("p", [2, 5, 8])
def test_stable_ranks_bitwise(p):
    rng = np.random.default_rng(p)
    key = rng.integers(0, 3, size=(13, p)).astype(np.float64)
    key[rng.random((13, p)) < 0.2] = np.inf  # ties and +inf, as in use
    assert bits_equal(_stable_ranks(torch.from_numpy(key)), ref_stable_ranks(key))


def _ref_instances():
    """Strawman, greedy and bypass decisions of mixed shapes."""
    out = []
    for alg, n, size, planes, t_recfg in (
        ("ring_allreduce", 8, 10e6, 1, 50e-6),
        ("pairwise_alltoall", 10, 3e6, 4, 200e-6),
        ("rabenseifner_allreduce", 8, 40e6, 2, 0.0),
        ("bruck_alltoall", 5, 7e6, 3, 100e-6),
    ):
        pattern = ref_get_pattern(alg, n, size)
        fabric = ref_prestage_for(RefFabric(n, planes, t_recfg=t_recfg), pattern)
        out.append(
            RefBatchInstance(fabric, pattern, ref_strawman_decisions(fabric, pattern))
        )
    pattern = ref_get_pattern("pairwise_alltoall", 8, 8e6)
    cells = [
        (RefFabric(8, 4, t_recfg=t).prestaged(pattern.steps[0].config), pattern)
        for t in (8e-4, 3.2e-3)
    ]
    plans = ref_swot_greedy_grid(
        cells, bypass_depth=2, backend="numpy", planner="step"
    )
    out += [RefBatchInstance(p.fabric, p.pattern, p.decisions) for p in plans]
    return out


@pytest.mark.parametrize("with_ready", [False, True])
def test_pack_instances_matches_reference(with_ready):
    ref = _ref_instances()
    ready = (
        [tuple(1e-5 * (j + k) for j in range(i.fabric.n_planes))
         for k, i in enumerate(ref)]
        if with_ready
        else None
    )
    want = ref_engine.pack_instances(ref, ready)
    got = engine.pack_instances([convert.instance_from(i) for i in ref], ready)
    assert set(got) == set(want)
    for key in want:
        assert bits_equal(got[key], want[key]), key
    assert want["byp_vol"].shape[2] > 0  # the bypass rows are really there


def test_ir_round_trip_and_metrics_match_reference():
    for inst in _ref_instances():
        port = convert.instance_from(inst)
        ref_sched = ref_execute(inst.fabric, inst.pattern, inst.decisions)
        sched = execute(port.fabric, port.pattern, port.decisions)
        ir = engine.to_ir(sched)
        engine.validate_ir(ir)
        assert engine.from_ir(ir) == sched
        want = ref_engine.execute_ir(ref_engine.to_ir(ref_sched))
        got = engine.execute_ir(ir)
        assert got.cct == want.cct
        assert got.n_reconfigurations == want.n_reconfigurations
        assert bits_equal(got.plane_busy, want.plane_busy)
        assert got.utilization == want.utilization


def test_validate_ir_rejects_like_reference():
    inst = _ref_instances()[1]
    port = convert.instance_from(inst)
    ir = engine.to_ir(execute(port.fabric, port.pattern, port.decisions))
    ref_ir = ref_engine.to_ir(
        ref_execute(inst.fabric, inst.pattern, inst.decisions)
    )
    for validate, base in ((engine.validate_ir, ir), (ref_engine.validate_ir, ref_ir)):
        bad = base.volume.copy()
        bad[0] *= 0.5
        with pytest.raises(ValueError, match="volume"):
            validate(dataclasses.replace(base, volume=bad))


def test_object_walk_attribution_and_validator_match_reference():
    from repro.obs.attribution import attribute as ref_attribute

    from repro_torch.core.schedule import validate_object
    from repro_torch.obs import attribute

    for inst in _ref_instances():
        port = convert.instance_from(inst)
        sched = execute(port.fabric, port.pattern, port.decisions)
        validate_object(sched)
        want = ref_attribute(ref_execute(inst.fabric, inst.pattern, inst.decisions))
        got = attribute(sched)
        for field in (
            "t_xmit", "t_bypass", "t_recfg_wait", "t_recfg_hidden",
            "t_idle", "cct",
        ):
            assert bits_equal(getattr(got, field), getattr(want, field)), field
