"""Timing backends of the port: the batched per-step timing recurrence.

``batch_evaluate`` packs a batch of (fabric, pattern, decisions) cells
into flat padded numpy arrays (`repro_torch.core.ir.engine.pack_instances`);
a *timing backend* consumes that packed dict and runs the max-plus update

    start   = max(step barrier, plane free)        (CHAIN mode)
    end     = start + volume / bandwidth
    barrier = max over active planes of end

with lazy per-plane reconfiguration across the whole batch.  The port has
one backend, ``TorchBackend(device=)``: it moves the packed arrays to its
device and runs `repro_torch.kernels.timing_scan` -- the CUDA kernel for a
CUDA device, the plain torch recurrence for the CPU -- then hands the
outputs to the shared numpy epilogue ``finalize_result``.  Callers pass a
backend instance (or ``None`` for a ``TorchBackend`` on their device);
there is no name registry and no selection by batch size.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ir.engine import NO_CONFIG, BatchResult, finalize_result
from repro_torch.device import resolve_device


class TimingBackend:
    """One implementation of the batched per-step timing recurrence.

    ``attribution=True`` asks for the per-(instance, step, plane) CCT
    component arrays (`repro_torch.obs.attribution`) alongside the scalar
    outputs; backends hand the raw arrays to the shared ``finalize_result``
    epilogue, which closes the decomposition with the idle term so
    conservation is bitwise everywhere.
    """

    name: str = "abstract"
    device: torch.device

    def derive_timing(
        self, packed: dict[str, np.ndarray], attribution: bool = False
    ) -> BatchResult:
        raise NotImplementedError


def _bucket(n: int) -> int:
    """Next power of two >= n (the reference's static-shape buckets)."""
    return 1 << max(0, int(n - 1).bit_length())


def pad_packed(
    packed: dict[str, np.ndarray], b_pad: int, s_pad: int, p_pad: int
) -> dict[str, np.ndarray]:
    """Pad a packed batch to ``(b_pad, s_pad, p_pad)`` bucket shapes.

    The kernel needs no padding; this copy of the reference's padding is
    kept to show that padded cells stay inert in the port's recurrence
    too, and to feed the reference's bucketed kernels the same batch.
    Padded batch rows / steps / planes carry zero volume and False masks,
    so the recurrence leaves them inert; padded bandwidth is 1.0 (never
    used, but keeps ``volume / bw`` NaN-free).
    """
    b, s, p = packed["vol"].shape
    if (b, s, p) == (b_pad, s_pad, p_pad):
        return packed
    out: dict[str, np.ndarray] = {}
    fill = {
        "vol": 0.0,
        "step_vol": 0.0,
        "step_cfg": NO_CONFIG,
        "step_mask": False,
        "plane_mask": False,
        "bw": 1.0,
        "init": NO_CONFIG,
        "t_recfg": 0.0,
        "chain": False,
        "ready": 0.0,
        "byp_vol": 0.0,
        "byp_plane": -1,
    }
    r_h = packed["byp_vol"].shape[2:] + packed["byp_plane"].shape[3:]
    tgt_shape = {
        "vol": (b_pad, s_pad, p_pad),
        "step_vol": (b_pad, s_pad),
        "step_cfg": (b_pad, s_pad),
        "step_mask": (b_pad, s_pad),
        "plane_mask": (b_pad, p_pad),
        "bw": (b_pad, p_pad),
        "init": (b_pad, p_pad),
        "t_recfg": (b_pad,),
        "chain": (b_pad,),
        "ready": (b_pad, p_pad),
        # Route/hop counts are decision-determined (like the step count):
        # only batch/steps pad, so bypass-free sweeps keep R = H = 0.
        "byp_vol": (b_pad, s_pad) + r_h[:1],
        "byp_plane": (b_pad, s_pad) + r_h,
    }
    for key, arr in packed.items():
        padded = np.full(tgt_shape[key], fill[key], dtype=arr.dtype)
        padded[tuple(slice(0, d) for d in arr.shape)] = arr
        out[key] = padded
    return out


class TorchBackend(TimingBackend):
    """The timing recurrence on one torch device.

    ``device=None`` means the card (`repro_torch.device`).  On a CUDA
    device every call launches the ``timing_scan`` kernel once; on the CPU
    it runs the kernel's plain torch version.
    """

    name = "torch"

    def __init__(self, device: str | None = None) -> None:
        self.device = resolve_device(device)

    def derive_timing(
        self, packed: dict[str, np.ndarray], attribution: bool = False
    ) -> BatchResult:
        from repro_torch.core.convert import packed_from_numpy
        from repro_torch.kernels.timing_scan import timing_scan

        out = timing_scan(
            packed_from_numpy(packed, self.device), attribution=attribution
        )
        cct, n_recfg, busy, feasible, volume_ok, *att = (
            t.cpu().numpy() for t in out
        )
        return finalize_result(
            cct,
            n_recfg,
            busy,
            feasible,
            volume_ok,
            packed["plane_mask"],
            attribution=tuple(att) if attribution else None,
            step_mask=packed["step_mask"] if attribution else None,
        )


def backend_on(
    backend: TimingBackend | None, device: torch.device
) -> TimingBackend:
    """``backend``, or a ``TorchBackend`` on ``device`` when it is ``None``.

    Raises ``ValueError`` when a given backend runs on another kind of
    device than ``device``, so the planner and its scoring cannot split
    between the card and the host.
    """
    if backend is None:
        return TorchBackend(device=device)
    if backend.device.type != device.type:
        raise ValueError(
            f"backend runs on {backend.device} but the planner on {device}"
        )
    return backend
