"""The schedule-IR timing recurrence: CUDA kernel, plain version, wrapper.

``timing_scan(packed)`` runs the batched earliest-start recurrence over a
``pack_instances`` array set held as tensors (`repro_torch.core.convert.
packed_from_numpy`).  Per step it runs, in this order: bypass relay hops
on installed configs, the lazy ``+t_recfg`` on planes whose config
changes, ``start = chain ? max(barrier, free) : free`` and
``end = start + vol / bw``, the barrier/CCT max, the feasibility and
volume-conservation flags and, when asked, the four attribution cubes.

* ``timing_scan_cuda`` launches ``csrc/timing_scan.cu`` (built at first
  use, `repro_torch.kernels._build`), the port of the reference's Pallas
  kernel ``src/repro/kernels/timing_scan.py::_kernel``.  It takes CUDA
  tensors only.
* ``timing_scan_plain`` is the same recurrence in plain torch, one step
  per loop turn, vectorized over the batch.  It is the kernel's yardstick
  on the card and what runs on the CPU.
* ``timing_scan`` dispatches on the tensors' device: the plain version for
  CPU tensors, the kernel for CUDA tensors (never the plain version on a
  card).  ``timing_scan.launches`` counts kernel launches.

Outputs: ``cct`` (B,) float64, ``n_recfg`` (B,) int64, ``busy`` (B, P)
float64, ``feasible`` and ``volume_ok`` (B,) bool, then, with
``attribution=True``, the (B, S, P) float64 cubes ``t_xmit``,
``t_bypass``, ``t_recfg_wait`` and ``t_recfg_hidden``.  Padded rows, steps
and planes (false masks, zero volume) stay inert.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.tolerances import EPS_VOLUME, REL_TOL, TOL
from repro_torch.kernels import _build

MAX_PLANES = 128  # the kernel's largest plane-count template

_DTYPES = {
    "vol": torch.float64,
    "step_vol": torch.float64,
    "step_cfg": torch.int64,
    "step_mask": torch.bool,
    "plane_mask": torch.bool,
    "bw": torch.float64,
    "init": torch.int64,
    "t_recfg": torch.float64,
    "chain": torch.bool,
    "ready": torch.float64,
    "byp_vol": torch.float64,
    "byp_plane": torch.int64,
}


def check_packed(packed: dict[str, torch.Tensor]) -> tuple[int, ...]:
    """Validate a packed batch; return ``(B, S, P, R, H)``.

    Raises ``ValueError`` on a missing or extra key, a dtype, shape or
    device mismatch, or a non-contiguous tensor.
    """
    if set(packed) != set(_DTYPES):
        raise ValueError(
            f"packed keys {sorted(packed)} != {sorted(_DTYPES)}"
        )
    for key, dtype in _DTYPES.items():
        t = packed[key]
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"packed[{key!r}] is not a tensor")
        if t.dtype != dtype:
            raise ValueError(f"packed[{key!r}] is {t.dtype}, want {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"packed[{key!r}] is not contiguous")
    if packed["vol"].dim() != 3 or packed["byp_vol"].dim() != 3:
        raise ValueError("vol and byp_vol must be 3-D")
    b, s, p = packed["vol"].shape
    r = packed["byp_vol"].shape[2]
    if packed["byp_plane"].dim() != 4:
        raise ValueError("byp_plane must be 4-D")
    h = packed["byp_plane"].shape[3]
    want = {
        "vol": (b, s, p),
        "step_vol": (b, s),
        "step_cfg": (b, s),
        "step_mask": (b, s),
        "plane_mask": (b, p),
        "bw": (b, p),
        "init": (b, p),
        "t_recfg": (b,),
        "chain": (b,),
        "ready": (b, p),
        "byp_vol": (b, s, r),
        "byp_plane": (b, s, r, h),
    }
    for key, shape in want.items():
        if tuple(packed[key].shape) != shape:
            raise ValueError(
                f"packed[{key!r}] has shape {tuple(packed[key].shape)}, "
                f"want {shape}"
            )
    devices = {t.device for t in packed.values()}
    if len(devices) != 1:
        raise ValueError(
            f"packed tensors span devices {sorted(map(str, devices))}"
        )
    if p < 1:
        raise ValueError("packed batch has no planes")
    return b, s, p, r, h


def timing_scan_plain(
    packed: dict[str, torch.Tensor], attribution: bool = False
) -> tuple[torch.Tensor, ...]:
    """The recurrence in plain torch, one step per loop turn.

    Op for op the reference's numpy recurrence, on any device.  A hop
    touches one plane per row, so its plane update is a gather and a
    scatter with no duplicate index (no atomics).  Routes with no live
    row are not skipped: their updates add exact zeros.
    """
    b, s_max, n_p, n_routes, n_hops = check_packed(packed)
    vol, bw, chain = packed["vol"], packed["bw"], packed["chain"]
    step_vol, step_cfg = packed["step_vol"], packed["step_cfg"]
    step_mask, plane_mask = packed["step_mask"], packed["plane_mask"]
    byp_vol, byp_plane = packed["byp_vol"], packed["byp_plane"]
    f64 = dict(dtype=torch.float64, device=vol.device)
    free = packed["ready"].clone()
    held = packed["init"].clone()
    barrier = torch.zeros(b, **f64)
    cct = torch.zeros(b, **f64)
    busy = torch.zeros((b, n_p), **f64)
    n_recfg = torch.zeros(b, dtype=torch.int64, device=vol.device)
    feasible = torch.ones(b, dtype=torch.bool, device=vol.device)
    volume_ok = torch.ones(b, dtype=torch.bool, device=vol.device)
    t_recfg = packed["t_recfg"][:, None]
    chain_c = chain[:, None]
    att = (
        tuple(torch.zeros((b, s_max, n_p), **f64) for _ in range(4))
        if attribution
        else ()
    )
    for i in range(s_max):
        v = vol[:, i, :]
        live = step_mask[:, i]
        active = (v > EPS_VOLUME) & plane_mask & live[:, None]
        has = active.any(dim=1)
        byp_end = torch.full((b,), float("-inf"), **f64)
        has_byp = torch.zeros(b, dtype=torch.bool, device=vol.device)
        sent_byp = torch.zeros(b, **f64)
        for r in range(n_routes):
            rv = byp_vol[:, i, r]
            route_live = (rv > EPS_VOLUME) & live
            has_byp = has_byp | route_live
            sent_byp = sent_byp + torch.where(route_live, rv, 0.0)
            prev_end = torch.where(chain, barrier, 0.0)
            for h in range(n_hops):
                j = byp_plane[:, i, r, h]
                upd = route_live & (j >= 0)
                jj = j.clamp(0, n_p - 1)[:, None]
                free_j = free.gather(1, jj)[:, 0]
                start = torch.maximum(prev_end, free_j)
                end = start + rv / bw.gather(1, jj)[:, 0]
                free = free.scatter(
                    1, jj, torch.where(upd, end, free_j)[:, None]
                )
                carry = torch.where(upd, end - start, 0.0)
                busy = busy.scatter(
                    1, jj, (busy.gather(1, jj)[:, 0] + carry)[:, None]
                )
                if attribution:
                    row = att[1][:, i, :]
                    row.scatter_(
                        1, jj, (row.gather(1, jj)[:, 0] + carry)[:, None]
                    )
                prev_end = torch.where(upd, end, prev_end)
            byp_end = torch.maximum(
                byp_end, torch.where(route_live, prev_end, float("-inf"))
            )
        feasible = feasible & ~(
            live & (step_vol[:, i] > EPS_VOLUME) & ~has & ~has_byp
        )
        # Plane order, as the kernel adds (only a tolerance test reads it).
        direct = torch.where(active, v, 0.0)
        sent = torch.zeros(b, **f64)
        for p in range(n_p):
            sent = sent + direct[:, p]
        sent = sent + sent_byp
        cons_tol = torch.clamp(
            REL_TOL * torch.clamp(step_vol[:, i], min=1.0), min=TOL
        )
        volume_ok = volume_ok & (
            ~live | ((sent - step_vol[:, i]).abs() <= cons_tol)
        )
        cfg = step_cfg[:, i][:, None]
        need = active & (held != cfg)
        free_before = free
        free = torch.where(need, free + t_recfg, free)
        held = torch.where(need, cfg, held)
        busy = busy + torch.where(need, t_recfg, 0.0)
        n_recfg = n_recfg + need.sum(dim=1)
        start = torch.where(
            chain_c, torch.maximum(barrier[:, None], free), free
        )
        end = start + v / bw
        if attribution:
            start_nr = torch.where(
                chain_c, torch.maximum(barrier[:, None], free_before),
                free_before,
            )
            wait = torch.where(need, start - start_nr, 0.0)
            att[0][:, i, :] = torch.where(active, end - start, 0.0)
            att[2][:, i, :] = wait
            att[3][:, i, :] = torch.where(need, t_recfg - wait, 0.0)
        free = torch.where(active, end, free)
        busy = busy + torch.where(active, end - start, 0.0)
        step_end = torch.where(active, end, float("-inf")).amax(dim=1)
        step_end = torch.maximum(step_end, byp_end)
        has_any = has | has_byp
        barrier = torch.where(
            has_any, torch.maximum(barrier, step_end), barrier
        )
        cct = torch.where(has_any, torch.maximum(cct, step_end), cct)
    return (cct, n_recfg, busy, feasible, volume_ok) + att


def _library() -> ctypes.CDLL:
    lib = _build.load("timing_scan")
    fn = lib.timing_scan_launch
    # Every pointer and the stream as c_void_p: left undeclared, ctypes
    # would pass them as 32-bit ints.
    fn.argtypes = (
        [ctypes.c_void_p] * 21 + [ctypes.c_int64] * 5
        + [ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def timing_scan_cuda(
    packed: dict[str, torch.Tensor], attribution: bool = False
) -> tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel on PyTorch's current stream.

    Takes CUDA tensors only (raises ``ValueError`` otherwise) and at most
    ``MAX_PLANES`` planes; raises ``RuntimeError`` if the launch fails.
    """
    b, s, p, r, h = check_packed(packed)
    dev = packed["vol"].device
    if dev.type != "cuda":
        raise ValueError(
            f"timing_scan_cuda takes CUDA tensors, got tensors on {dev}"
        )
    if p > MAX_PLANES:
        raise ValueError(
            f"timing_scan_cuda handles at most {MAX_PLANES} planes, got {p}"
        )
    f64 = dict(dtype=torch.float64, device=dev)
    cct = torch.empty(b, **f64)
    n_recfg = torch.empty(b, dtype=torch.int64, device=dev)
    busy = torch.empty((b, p), **f64)
    feasible = torch.empty(b, dtype=torch.bool, device=dev)
    volume_ok = torch.empty(b, dtype=torch.bool, device=dev)
    att = (
        tuple(torch.empty((b, s, p), **f64) for _ in range(4))
        if attribution
        else ()
    )
    if b:
        lib = _library()
        ins = [packed[key].data_ptr() for key in _DTYPES]
        outs = [t.data_ptr() for t in (cct, n_recfg, busy, feasible, volume_ok)]
        atts = [t.data_ptr() for t in att] if att else [None] * 4
        index = torch.cuda.current_device() if dev.index is None else dev.index
        stream = torch.cuda.current_stream(index).cuda_stream
        err = lib.timing_scan_launch(
            *ins, *outs, *atts, b, s, p, r, h, index, stream
        )
        if err:
            raise RuntimeError(
                f"timing_scan kernel launch failed: CUDA error {err}"
            )
        timing_scan.launches += 1
    return (cct, n_recfg, busy, feasible, volume_ok) + att


def timing_scan(
    packed: dict[str, torch.Tensor], attribution: bool = False
) -> tuple[torch.Tensor, ...]:
    """The recurrence on the packed tensors' device.

    CPU tensors run ``timing_scan_plain``; CUDA tensors launch the kernel
    (``timing_scan_cuda``) or raise.
    """
    check_packed(packed)
    if packed["vol"].device.type == "cpu":
        return timing_scan_plain(packed, attribution=attribution)
    return timing_scan_cuda(packed, attribution=attribution)


timing_scan.launches = 0
