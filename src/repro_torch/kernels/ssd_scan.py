"""The Mamba2 SSD chunked scan: CUDA kernel, plain version, wrappers.

``ssd_scan_bhsp(xdt, logd, b, c, n_heads=, chunk=, init_state=)`` runs the
state-space-dual chunked scan on head-major, pre-scaled inputs: ``xdt``
(BH, S, P) = ``x * dt``, ``logd`` (BH, S, 1) = ``dt * A`` (<= 0), ``b`` and
``c`` (B, S, N), row ``bh`` reading batch row ``bh // n_heads`` (nothing is
broadcast over heads in memory).  Per chunk of ``Q = min(chunk, S)``
positions, with ``cum`` the prefix sum of ``logd`` within the chunk and
``S`` the (P, N) state entering it:

    y = ((C B^T) o exp(cum_i - cum_j), masked to j <= i) @ xdt
        + (C * exp(cum)) @ S^T
    S <- exp(cum_Q) * S + (B * exp(cum_Q - cum))^T @ xdt

The masked entries are 0 and their exponent is never evaluated (an
acausal ``cum_i - cum_j`` is positive and may overflow).  Positions past
``S`` act as the reference's zero padding (log-decay 0, ``xdt`` 0), so the
final state is the state after position ``S - 1``.  Everything is float32;
``y`` has ``xdt``'s dtype, the final state is (BH, P, N) float32.

* ``ssd_scan_bhsp_cuda`` launches ``csrc/ssd_scan.cu`` (built at first
  use, `repro_torch.kernels._build`), the port of the reference's Pallas
  kernel ``src/repro/kernels/ssd_scan.py`` (``_kernel``).  It takes CUDA
  tensors only.
* ``ssd_scan_bhsp_plain`` is the same chunk loop in plain torch,
  vectorized over batch and heads.  It is the kernel's yardstick on the
  card and what runs on the CPU.
* ``ssd_scan_bhsp`` dispatches on the tensors' device: the plain version
  for CPU tensors, the kernel for CUDA tensors (never the plain version on
  a card).  ``ssd_scan_bhsp.launches`` counts kernel launches.
* ``ssd_scan`` is the model-layout wrapper of the reference's
  ``src/repro/kernels/ops.py`` (``ssd_scan``): x (B, S, H, P), dt (B, S, H)
  post-softplus, ``a_log`` (H,), b and c (B, S, N), an optional initial
  state (B, H, P, N); it returns y (B, S, H, P) in x's dtype and the final
  state (B, H, P, N) float32.

Beyond the Pallas kernel, which keeps its state in scratch and starts it
at zero, both versions take an initial state and return the final one:
the model's ``ssd_chunked`` (the reference's ``models/ssm.py``) does, and
the port routes it here.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

MAX_CHUNK = 128  # the kernel's chunk tile
MAX_STATE = 128  # the kernel's largest state dim N (shared-memory budget)


def check_inputs(
    xdt: torch.Tensor,
    logd: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    n_heads: int,
    init_state: torch.Tensor | None,
) -> tuple[int, int, int, int]:
    """Validate head-major inputs; return ``(BH, S, P, N)``.

    Raises ``ValueError`` on a rank, shape, dtype or device mismatch, or a
    row count that is not ``B * n_heads``.
    """
    if xdt.dim() != 3 or logd.dim() != 3 or b.dim() != 3 or c.dim() != 3:
        raise ValueError("xdt, logd, b and c must be 3-D")
    bh, s, p = xdt.shape
    bsz, sb, n = b.shape
    if n_heads < 1 or bh != bsz * n_heads:
        raise ValueError(f"{bh} rows != {bsz} batch rows x {n_heads} heads")
    if tuple(logd.shape) != (bh, s, 1):
        raise ValueError(f"logd {tuple(logd.shape)} != {(bh, s, 1)}")
    if sb != s or tuple(c.shape) != tuple(b.shape):
        raise ValueError(
            f"b {tuple(b.shape)} and c {tuple(c.shape)} do not fit S = {s}"
        )
    tensors = [xdt, logd, b, c]
    if init_state is not None:
        if tuple(init_state.shape) != (bh, p, n):
            raise ValueError(
                f"init_state {tuple(init_state.shape)} != {(bh, p, n)}"
            )
        tensors.append(init_state)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("the scan's inputs must be float32")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the scan's inputs lie on different devices")
    return bh, s, p, n


def ssd_scan_bhsp_plain(
    xdt: torch.Tensor,
    logd: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    *,
    n_heads: int,
    chunk: int = MAX_CHUNK,
    init_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunk loop in plain torch, on any device; returns (y, state)."""
    bh, s, p, n = check_inputs(xdt, logd, b, c, n_heads, init_state)
    bsz = bh // n_heads
    chunk = min(chunk, s)
    pad = -s % chunk
    # Zero padding: log-decay 0 and xdt 0 leave the state as it is.
    x = F.pad(xdt, (0, 0, 0, pad)).view(bsz, n_heads, s + pad, p)
    ld = F.pad(logd[..., 0], (0, pad)).view(bsz, n_heads, s + pad)
    bb = F.pad(b, (0, 0, 0, pad))
    cc = F.pad(c, (0, 0, 0, pad))
    state = (
        xdt.new_zeros((bsz, n_heads, p, n))
        if init_state is None
        else init_state.view(bsz, n_heads, p, n)
    )
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=xdt.device).tril()
    ys = []
    for c0 in range(0, s + pad, chunk):
        xq = x[:, :, c0 : c0 + chunk]  # (B, H, Q, P)
        cum = ld[:, :, c0 : c0 + chunk].cumsum(-1)  # (B, H, Q)
        total = cum[..., -1:]  # (B, H, 1)
        bq, cq = bb[:, c0 : c0 + chunk], cc[:, c0 : c0 + chunk]  # (B, Q, N)
        cb = cq @ bq.transpose(1, 2)  # (B, Q, Q), shared by the heads
        exponent = cum[..., :, None] - cum[..., None, :]
        ratio = torch.exp(torch.where(causal, exponent, -math.inf))
        y = (cb[:, None] * ratio) @ xq
        y = y + (cq[:, None] * torch.exp(cum)[..., None]) @ state.transpose(-1, -2)
        ys.append(y)
        b_decayed = bq[:, None] * torch.exp(total - cum)[..., None]  # (B, H, Q, N)
        state = state * torch.exp(total)[..., None] + (
            b_decayed.transpose(-1, -2) @ xq
        ).transpose(-1, -2)
    y = torch.cat(ys, dim=2)[:, :, :s].reshape(bh, s, p)
    return y.to(xdt.dtype), state.reshape(bh, p, n)


def _library() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    # Every pointer and the stream as c_void_p: left undeclared, ctypes
    # would pass them as 32-bit ints.
    fn.argtypes = (
        [ctypes.c_void_p] * 7
        + [ctypes.c_int64] * 6
        + [ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def ssd_scan_bhsp_cuda(
    xdt: torch.Tensor,
    logd: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    *,
    n_heads: int,
    chunk: int = MAX_CHUNK,
    init_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream.

    Takes CUDA tensors only (raises ``ValueError`` otherwise), chunks up to
    ``MAX_CHUNK`` and state dims up to ``MAX_STATE``; raises
    ``RuntimeError`` if the launch fails.
    """
    bh, s, p, n = check_inputs(xdt, logd, b, c, n_heads, init_state)
    dev = xdt.device
    if dev.type != "cuda":
        raise ValueError(
            f"ssd_scan_bhsp_cuda takes CUDA tensors, got tensors on {dev}"
        )
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state dim {n} outside 1..{MAX_STATE}")
    chunk = min(chunk, s)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside 1..{MAX_CHUNK}")
    xdt, logd, b, c = (t.contiguous() for t in (xdt, logd, b, c))
    if init_state is not None:
        init_state = init_state.contiguous()
    y = torch.empty_like(xdt)
    state = torch.empty((bh, p, n), dtype=torch.float32, device=dev)
    if bh and p:
        index = torch.cuda.current_device() if dev.index is None else dev.index
        stream = torch.cuda.current_stream(index).cuda_stream
        err = _library().ssd_scan_launch(
            xdt.data_ptr(), logd.data_ptr(), b.data_ptr(), c.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), state.data_ptr(),
            bh, n_heads, s, p, n, chunk,
            index, stream,
        )
        if err:
            raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
        ssd_scan_bhsp.launches += 1
    return y, state


def ssd_scan_bhsp(
    xdt: torch.Tensor,
    logd: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    *,
    n_heads: int,
    chunk: int = MAX_CHUNK,
    init_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan on the tensors' device.

    CPU tensors run ``ssd_scan_bhsp_plain``; CUDA tensors launch the kernel
    (``ssd_scan_bhsp_cuda``) or raise.
    """
    fn = ssd_scan_bhsp_plain if xdt.device.type == "cpu" else ssd_scan_bhsp_cuda
    return fn(xdt, logd, b, c, n_heads=n_heads, chunk=chunk, init_state=init_state)


ssd_scan_bhsp.launches = 0


def head_major(
    x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan's pre-scaled inputs from the model's: ``xdt = x * dt``
    (B*H, S, P) and ``logd = dt * A`` (B*H, S, 1), ``A = -exp(a_log)``,
    in float32."""
    bsz, s, h, p = x.shape
    a = -torch.exp(a_log.float())  # (H,)
    dt32 = dt.float()
    xdt = (x.float() * dt32[..., None]).transpose(1, 2).reshape(bsz * h, s, p)
    logd = (dt32 * a).transpose(1, 2).reshape(bsz * h, s, 1)
    return xdt, logd


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) post-softplus
    a_log: torch.Tensor,  # (H,)
    b: torch.Tensor,  # (B, S, N)
    c: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = MAX_CHUNK,
    init_state: torch.Tensor | None = None,  # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Model-layout SSD: returns y (B, S, H, P) in x's dtype and the final
    state (B, H, P, N) float32."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    xdt, logd = head_major(x, dt, a_log)
    if init_state is not None:
        init_state = init_state.float().reshape(bsz * h, p, n)
    y, state = ssd_scan_bhsp(
        xdt, logd, b.float(), c.float(),
        n_heads=h, chunk=chunk, init_state=init_state,
    )
    y = y.reshape(bsz, h, s, p).transpose(1, 2).to(x.dtype)
    return y, state.reshape(bsz, h, p, n)
