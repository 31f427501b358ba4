"""Shared helpers for the PyTorch port's parity tests (``test_torch_*``).

Both packages get the same seeded inputs; results are compared bitwise
(float64 bit patterns, not values), the reference's own contract.
"""

import numpy as np
import torch

from repro_torch.core import convert


def bits_equal(got, want) -> bool:
    """Same shape, same dtype kind, same bits (NaN- and signed-zero-exact)."""
    got = np.asarray(got.cpu().numpy() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    if got.shape != want.shape:
        return False
    if want.dtype.kind == "f":
        return got.dtype == want.dtype and np.array_equal(
            got.view(np.int64), want.view(np.int64)
        )
    return np.array_equal(got.astype(want.dtype), want)


def assert_results_equal(got, want) -> None:
    """Port ``BatchResult`` == reference ``BatchResult``, bitwise."""
    for field in (
        "cct", "n_reconfigurations", "plane_busy", "utilization",
        "feasible", "volume_ok",
    ):
        assert bits_equal(getattr(got, field), getattr(want, field)), field
    if want.attribution is None:
        assert got.attribution is None
        return
    for field in (
        "t_xmit", "t_bypass", "t_recfg_wait", "t_recfg_hidden", "t_idle",
        "cct", "step_mask", "plane_mask",
    ):
        assert bits_equal(
            getattr(got.attribution, field), getattr(want.attribution, field)
        ), field


def port_cells(cells):
    """Reference (fabric, pattern) cells as the port's types."""
    return [convert.cell_from(f, p) for f, p in cells]


def assert_conserved(result) -> None:
    """Components + idle sum bitwise to CCT; masked cells carry no time."""
    att = result.attribution
    total = np.where(att.plane_mask, att.plane_total, 0.0)
    want = np.where(att.plane_mask, result.cct[..., None], 0.0)
    assert np.array_equal(total, want)
    step_live = att.step_mask[..., :, None] & att.plane_mask[..., None, :]
    for comp in (
        att.t_xmit, att.t_bypass, att.t_recfg_wait, att.t_recfg_hidden
    ):
        assert not np.any(np.where(step_live, 0.0, comp))
