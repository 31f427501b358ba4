"""Elementwise a + b in float32: CUDA kernel, plain version, wrapper.

``fused_reduce_flat(a, b, out_dtype=)`` adds two buffers of one shape
elementwise in float32 and casts the sum to ``out_dtype`` (default a's
dtype): the local combine of a reduce-scatter step, where a node adds the
chunk received from its peer into its partial buffer.

* ``fused_reduce_flat_cuda`` launches ``csrc/fused_reduce.cu`` (built at
  first use, `repro_torch.kernels._build`), the port of the reference's
  Pallas kernel ``src/repro/kernels/fused_reduce.py`` (``_kernel``).  It
  takes CUDA tensors only and every dtype bfloat16, float16 or float32;
  anything else raises.  The kernel reads a and b in one dtype: where
  they differ, the wrapper casts both to float32 first
  (``kernel_operands``), which is exact, and the kernel adds in float32
  anyway.
* ``fused_reduce_flat_plain`` is ``(a.float() + b.float()).to(out_dtype)``
  on any device: one float32 add and one rounding, so the kernel equals
  it bitwise.  It is the kernel's yardstick on the card and what runs on
  the CPU.
* ``fused_reduce_flat`` dispatches on the tensors' device: the plain
  version for CPU tensors, the kernel for CUDA tensors (never the plain
  version on a card).  ``fused_reduce_flat.launches`` counts kernel
  launches.

Every version raises ``ValueError`` on a shape mismatch, as the
reference does.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")


def fused_reduce_flat_plain(
    a: torch.Tensor, b: torch.Tensor, *, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """a + b in float32, cast to ``out_dtype``, in plain torch."""
    _check_shapes(a, b)
    return (a.float() + b.float()).to(out_dtype or a.dtype)


def kernel_operands(
    a: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """a and b as the kernel reads them, in one dtype: as they are where
    their dtypes agree, else both cast to float32 (exact for every dtype
    the kernel takes, so the float32 sum and its rounding do not move)."""
    if a.dtype == b.dtype:
        return a, b
    return a.float(), b.float()


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("fused_reduce")
    fn = lib.fused_reduce_launch
    # Every pointer and the stream as c_void_p: left undeclared, ctypes
    # would pass them as 32-bit ints.
    fn.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_int64]
        + [ctypes.c_int] * 3
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def fused_reduce_flat_cuda(
    a: torch.Tensor, b: torch.Tensor, *, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.

    Raises ``ValueError`` on a shape mismatch, tensors that are not on one
    CUDA device or dtypes the kernel does not take, and ``RuntimeError``
    if the launch fails.
    """
    _check_shapes(a, b)
    out_dtype = out_dtype or a.dtype
    dev = a.device
    if dev.type != "cuda" or b.device != dev:
        raise ValueError(
            f"fused_reduce_flat_cuda takes CUDA tensors on one device, got a "
            f"on {dev} and b on {b.device}"
        )
    if any(t not in _DTYPES for t in (a.dtype, b.dtype, out_dtype)):
        raise ValueError(
            f"fused_reduce kernel takes every dtype in {list(_DTYPES)}, got "
            f"{a.dtype}, {b.dtype} -> {out_dtype}"
        )
    a, b = (t.contiguous() for t in kernel_operands(a, b))
    out = torch.empty(a.shape, dtype=out_dtype, device=dev)
    n = math.prod(a.shape)
    if n:
        index = torch.cuda.current_device() if dev.index is None else dev.index
        stream = torch.cuda.current_stream(index).cuda_stream
        err = _library().fused_reduce_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
            _DTYPES[a.dtype], _DTYPES[out_dtype], index, stream,
        )
        if err:
            raise RuntimeError(f"fused_reduce kernel launch failed: CUDA error {err}")
        fused_reduce_flat.launches += 1
    return out


def fused_reduce_flat(
    a: torch.Tensor, b: torch.Tensor, *, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """a + b in float32, cast to ``out_dtype``, on the tensors' device.

    CPU tensors run ``fused_reduce_flat_plain``; CUDA tensors launch the
    kernel (``fused_reduce_flat_cuda``) or raise.
    """
    fn = fused_reduce_flat_plain if a.device.type == "cpu" else fused_reduce_flat_cuda
    return fn(a, b, out_dtype=out_dtype)


fused_reduce_flat.launches = 0
