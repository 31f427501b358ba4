"""PyTorch port, timing recurrence: plain version and TorchBackend (CPU).

Two oracles from the reference package, both fed the same packed batch:

* the numpy recurrence ``repro.core.ir.backends._timing_numpy`` (through
  the shared ``finalize_result`` epilogue, attribution included);
* the Pallas kernel ``repro.kernels.timing_scan.timing_scan`` in interpret
  mode under ``jax.enable_x64(True)``, on the reference's bucket-padded
  batch (the port pads the same way with its copy of ``pad_packed``).

Every output must agree bitwise.  Reference decisions reach the port
through ``repro_torch.core.convert``.  The CUDA kernel itself is held to
the plain version on the card (``chip_smoke.py`` and
``tests/test_torch_kernel.py``).
"""

import jax
import numpy as np
import pytest
import torch
from torch_parity import assert_conserved, assert_results_equal, bits_equal

from repro.core import (
    BatchInstance as RefBatchInstance,
    OpticalFabric as RefFabric,
    get_pattern as ref_get_pattern,
    prestage_for as ref_prestage_for,
    strawman_decisions as ref_strawman_decisions,
)
from repro.core.greedy import swot_greedy_grid as ref_swot_greedy_grid
from repro.core.ir.backends import _bucket, _timing_numpy
from repro.core.ir.backends import pad_packed as ref_pad_packed
from repro.core.ir.engine import pack_instances as ref_pack_instances
from repro.core.schedule import DependencyMode as RefMode
from repro.kernels.timing_scan import timing_scan as pallas_timing_scan
from repro_torch.core import convert
from repro_torch.core.ir import TorchBackend, pack_instances, pad_packed
from repro_torch.kernels.timing_scan import timing_scan, timing_scan_plain

_MIXED = (
    ("ring_allreduce", 8, 10e6, 1, 50e-6),
    ("pairwise_alltoall", 10, 3e6, 4, 200e-6),
    ("rabenseifner_allreduce", 8, 40e6, 2, 0.0),
    ("bruck_alltoall", 5, 7e6, 3, 100e-6),
    ("rabenseifner_allreduce", 4, 1e6, 4, 400e-6),
)
_BYPASS_RECFGS = (3.2e-3, 8e-4, 1.6e-3, 2.4e-3, 4e-3)


def _mixed_cells():
    cells = []
    for alg, n, size, planes, t_recfg in _MIXED:
        pattern = ref_get_pattern(alg, n, size)
        fabric = ref_prestage_for(RefFabric(n, planes, t_recfg=t_recfg), pattern)
        cells.append((fabric, pattern))
    return cells


def _case(name):
    """(reference instances, plane_ready) of one named batch."""
    if name == "strawman_chain":
        # Heterogeneous step and plane counts: padding differs per row.
        return [
            RefBatchInstance(f, p, ref_strawman_decisions(f, p))
            for f, p in _mixed_cells()
        ], None
    if name == "plane_ready":
        insts, _ = _case("strawman_chain")
        ready = [
            tuple(2.5e-5 * (j + 1 + k) for j in range(i.fabric.n_planes))
            for k, i in enumerate(insts)
        ]
        return insts, ready
    if name in ("greedy_chain", "greedy_independent"):
        mode = RefMode.CHAIN if name == "greedy_chain" else RefMode.INDEPENDENT
        plans = ref_swot_greedy_grid(
            _mixed_cells(), mode=mode, backend="numpy", planner="step"
        )
        return [RefBatchInstance(p.fabric, p.pattern, p.decisions) for p in plans], None
    # "bypass<k>": k relay-carrying cells (batch buckets 1, 4, 8).
    k = int(name.removeprefix("bypass"))
    pattern = ref_get_pattern("pairwise_alltoall", 8, 8e6)
    cells = [
        (RefFabric(8, 4, t_recfg=t).prestaged(pattern.steps[0].config), pattern)
        for t in _BYPASS_RECFGS[:k]
    ]
    plans = ref_swot_greedy_grid(
        cells, bypass_depth=2, backend="numpy", planner="step"
    )
    insts = [RefBatchInstance(p.fabric, p.pattern, p.decisions) for p in plans]
    assert any(i.decisions.bypass and any(i.decisions.bypass) for i in insts)
    return insts, None


_CASES = (
    "strawman_chain", "plane_ready", "greedy_chain", "greedy_independent",
    "bypass1", "bypass3", "bypass5",
)


def _packs(name):
    ref, ready = _case(name)
    port = [convert.instance_from(i) for i in ref]
    return ref_pack_instances(ref, ready), pack_instances(port, ready)


@pytest.mark.parametrize("attribution", [False, True])
@pytest.mark.parametrize("name", _CASES)
def test_backend_matches_numpy_oracle(name, attribution):
    ref_packed, packed = _packs(name)
    want = _timing_numpy(ref_packed, attribution=attribution)
    got = TorchBackend(device="cpu").derive_timing(packed, attribution=attribution)
    assert_results_equal(got, want)
    if attribution:
        assert_conserved(got)


@pytest.mark.parametrize("attribution", [False, True])
@pytest.mark.parametrize("name", ["strawman_chain", "greedy_independent", "bypass1", "bypass3", "bypass5"])
def test_plain_matches_pallas_oracle(name, attribution):
    ref_packed, packed = _packs(name)
    b, s, p = ref_packed["vol"].shape
    b_pad, p_pad = _bucket(b), _bucket(p)
    with jax.enable_x64(True):
        want = pallas_timing_scan(
            ref_pad_packed(ref_packed, b_pad, s, p_pad),
            interpret=True,
            attribution=attribution,
        )
    padded = convert.packed_from_numpy(pad_packed(packed, b_pad, s, p_pad), "cpu")
    got = timing_scan_plain(padded, attribution=attribution)
    assert len(got) == len(want)
    cct, n_recfg, busy, feasible, volume_ok = (np.asarray(w) for w in want[:5])
    assert bits_equal(got[0], cct)
    assert bits_equal(got[1], n_recfg.astype(np.int64))
    assert bits_equal(got[2], busy)
    assert bits_equal(got[3], feasible.astype(bool))
    assert bits_equal(got[4], volume_ok.astype(bool))
    for g, w in zip(got[5:], want[5:]):
        assert bits_equal(g, np.asarray(w))
    # Padding is inert: the real slice equals the unpadded run.
    plain = timing_scan_plain(
        convert.packed_from_numpy(packed, "cpu"), attribution=attribution
    )
    assert bits_equal(got[0][:b], plain[0].numpy())
    assert bits_equal(got[2][:b, :p], plain[2].numpy())
    assert not got[2][:, p:].any() and not got[2][b:].any()
    for g, u in zip(got[5:], plain[5:]):
        assert bits_equal(g[:b, :, :p], u.numpy())


def test_pad_packed_matches_reference():
    ref_packed, packed = _packs("bypass3")
    b, s, p = packed["vol"].shape
    want = ref_pad_packed(ref_packed, b + 2, s + 1, p + 3)
    got = pad_packed(packed, b + 2, s + 1, p + 3)
    for key in want:
        assert bits_equal(got[key], want[key]), key


def test_wrapper_runs_plain_version_on_cpu():
    _, packed = _packs("greedy_chain")
    tensors = convert.packed_from_numpy(packed, "cpu")
    before = timing_scan.launches
    got = timing_scan(tensors, attribution=True)
    want = timing_scan_plain(tensors, attribution=True)
    assert timing_scan.launches == before  # no kernel launch on the CPU
    for g, w in zip(got, want):
        assert torch.equal(g, w)

