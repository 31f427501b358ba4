"""Row RMSNorm over the last dimension: CUDA kernel, plain version, wrappers.

``rmsnorm_2d(x, w, eps=, offset=)`` normalizes each row of x (T, D) in
float32, in the reference's order of operations: ``x32 = float(x)``,
``mean(x32²)`` over D, ``normed = x32 * rsqrt(mean + eps)``, then
``normed * w`` or, with ``offset`` (the Gemma convention),
``normed * (1 + w)``, cast back to x's dtype.

* ``rmsnorm_2d_cuda`` launches ``csrc/rmsnorm.cu`` (built at first use,
  `repro_torch.kernels._build`), the port of the reference's Pallas kernel
  ``src/repro/kernels/rmsnorm.py`` (``_kernel``).  It takes CUDA tensors
  only: x bfloat16, float16 or float32, w (D,) float32, bfloat16 or
  float16, ``1 <= D <= MAX_D``; anything else raises.  The kernel reads a
  float32 or bfloat16 w; the wrapper casts a float16 w to float32 first
  (``kernel_weight``), which is exact, and the kernel computes in float32
  anyway.
* ``rmsnorm_2d_plain`` is the same arithmetic in plain torch, on any
  device.  It is the kernel's yardstick on the card and what runs on the
  CPU.
* ``rmsnorm_2d`` dispatches on the tensors' device: the plain version for
  CPU tensors, the kernel for CUDA tensors (never the plain version on a
  card).  ``rmsnorm_2d.launches`` counts kernel launches.
* ``rmsnorm`` is the (..., D) wrapper of the reference's
  ``src/repro/kernels/ops.py`` (``rmsnorm``); the models' ``rms_norm``
  (`repro_torch.models.common`) calls it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_D = 16384  # the kernel's widest row (4 vectors a thread, 1024 threads)
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_W_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # what the kernel reads


def rmsnorm_2d_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    eps: float = 1e-6,
    offset: bool = False,
) -> torch.Tensor:
    """RMSNorm over the last dim in plain torch, on any device."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    w32 = w.float()
    out = normed * (1.0 + w32) if offset else normed * w32
    return out.to(x.dtype)


def kernel_weight(w: torch.Tensor) -> torch.Tensor:
    """w as the kernel reads it: float16 cast to float32 (exact), float32
    and bfloat16 as they are."""
    return w.float() if w.dtype == torch.float16 else w


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("rmsnorm")
    fn = lib.rmsnorm_launch
    # Every pointer and the stream as c_void_p: left undeclared, ctypes
    # would pass them as 32-bit ints.
    fn.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_int64] * 2
        + [ctypes.c_float]
        + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def rmsnorm_2d_cuda(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    eps: float = 1e-6,
    offset: bool = False,
) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.

    Raises ``ValueError`` on tensors that are not on one CUDA device, a
    rank, shape or dtype the kernel does not take, and ``RuntimeError`` if
    the launch fails.
    """
    if x.dim() != 2 or w.dim() != 1:
        raise ValueError(
            f"x must be (T, D) and w (D,), got {tuple(x.shape)} and {tuple(w.shape)}"
        )
    rows, d = x.shape
    dev = x.device
    if dev.type != "cuda" or w.device != dev:
        raise ValueError(
            f"rmsnorm_2d_cuda takes CUDA tensors on one device, got x on {dev} "
            f"and w on {w.device}"
        )
    if w.shape[0] != d:
        raise ValueError(f"w has {w.shape[0]} entries, x rows {d}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"row width {d} outside 1..{MAX_D}")
    if x.dtype not in _X_DTYPES or w.dtype not in (*_W_DTYPES, torch.float16):
        raise ValueError(
            f"rmsnorm kernel takes an x dtype in {list(_X_DTYPES)} and a w dtype in "
            f"{[*_W_DTYPES, torch.float16]}, got {x.dtype} and {w.dtype}"
        )
    w = kernel_weight(w)
    x, w = x.contiguous(), w.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel's vector split needs a 16-byte aligned base
    out = torch.empty_like(x)
    if rows:
        index = torch.cuda.current_device() if dev.index is None else dev.index
        stream = torch.cuda.current_stream(index).cuda_stream
        err = _library().rmsnorm_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(),
            rows, d, eps, int(offset),
            _X_DTYPES[x.dtype], _W_DTYPES[w.dtype],
            index, stream,
        )
        if err:
            raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err}")
        rmsnorm_2d.launches += 1
    return out


def rmsnorm_2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    eps: float = 1e-6,
    offset: bool = False,
) -> torch.Tensor:
    """RMSNorm of x (T, D) on the tensors' device.

    CPU tensors run ``rmsnorm_2d_plain``; CUDA tensors launch the kernel
    (``rmsnorm_2d_cuda``) or raise.
    """
    fn = rmsnorm_2d_plain if x.device.type == "cpu" else rmsnorm_2d_cuda
    return fn(x, w, eps=eps, offset=offset)


rmsnorm_2d.launches = 0


def rmsnorm(
    x: torch.Tensor,  # (..., D)
    w: torch.Tensor,  # (D,)
    *,
    eps: float = 1e-6,
    offset: bool = False,
) -> torch.Tensor:
    """RMSNorm over the last dim of x (..., D), in x's shape and dtype."""
    shape = x.shape
    out = rmsnorm_2d(x.reshape(-1, shape[-1]), w, eps=eps, offset=offset)
    return out.reshape(shape)
