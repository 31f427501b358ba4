"""Shared numeric tolerances for scheduling, simulation, and the IR.

One module owns every float-comparison constant the scheduling stack uses,
so the object path (`repro_torch.core.schedule`), the executor
(`repro_torch.core.simulator`), the grid greedy (`repro_torch.core.greedy`),
and the array IR (`repro_torch.core.ir`) agree bit-for-bit on what "legal"
means.  The values are those of the reference package: the port's
bitwise parity with it depends on them.

* ``TOL``        -- absolute slack on time comparisons (seconds).
* ``REL_TOL``    -- relative slack on time/volume comparisons.
* ``EPS``        -- generic tiny threshold for water-filling / tie logic.
* ``EPS_VOLUME`` -- bytes below which a split is treated as idle.
"""

from __future__ import annotations

import numpy as np

TOL = 1e-9
REL_TOL = 1e-6
EPS = 1e-12
EPS_VOLUME = 1e-6  # bytes


def times_close(a: float, b: float) -> bool:
    """``a <= b`` up to the shared absolute + relative slack."""
    return a <= b + TOL + REL_TOL * max(abs(a), abs(b), 1e-6)


def times_close_arr(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized ``times_close`` (the exact same formula, elementwise)."""
    slack = TOL + REL_TOL * np.maximum(
        np.maximum(np.abs(a), np.abs(b)), 1e-6
    )
    return a <= b + slack
