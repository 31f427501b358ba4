"""Kernel microbenchmarks of the port, at the reference bench's shapes.

    python -m repro_torch.benchmarks.kernel_bench [--device cpu]

The counterpart of the reference's ``benchmarks/kernel_bench.py``, with
its six rows, printed as ``name,us,note``:

* blocked attention (the models' plain torch path), (2, 1024, 8, 64) bf16;
* flash attention, (2, 256, 8, 64) bf16, causal;
* the SSD scan, (2, 512, 4, 64), state 64, chunk 128;
* fused reduce, 2^20 bf16 elements;
* RMSNorm, (2048, 1024) bf16, float32 weight;
* the timing scan over 32 strawman ``rabenseifner_allreduce`` cells on
  ``OpticalFabric(8, 4)``.

Each row is named after the port's route.  On the card (the default) every
kernel row runs the model-layout wrapper of `repro_torch.kernels.ops` once
and holds it against the kernel's plain torch version on the same inputs;
``us`` is the kernel's warm median of CUDA-event-timed launches, and the
note gives the plain version's time, the time of one PyTorch call that
computes the same function where there is one, the H100 bound
(`repro_torch.benchmarks.roofline`) and the error with its limit (for the
timing scan, the CCT error against the port's CPU path).  With
``--device cpu`` the rows run the plain versions on the host, as the
reference runs interpret mode: ``us`` is a host time, and the notes carry
no device figure.

Inputs are drawn from a ``torch.Generator`` seeded with 0 on the device.
"""

from __future__ import annotations

import argparse
import math
import statistics
import time
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.benchmarks import roofline
from repro_torch.device import resolve_device

KERNEL_REPS, PLAIN_REPS = 20, 5
SAMPLE_MS, MAX_BATCH = 1.0, 200  # a timed sample's least span, its most calls
# Limits of each row's error against its plain version on the card: one
# bf16 ulp of the output's magnitude for bf16 kernels (other summation
# order), 3e-4 of the output's scale for the SSD scan, bitwise for the
# fused reduce and the timing scan; the blocked attention is held to the
# flash attention's plain version at the reference's bf16 tolerance of its
# blocked attention (2e-2).
BLOCKED_TOL, SSD_TOL = 2e-2, 3e-4


class Row(NamedTuple):
    name: str
    us: float
    note: str
    err: float | None = None  # against the row's yardstick
    tol: float | None = None  # the limit of ``err``


def bf16_ulp(want: torch.Tensor) -> float:
    """One bf16 ulp at the magnitude of ``want``."""
    return 2.0 ** (math.floor(math.log2(float(want.float().abs().max()))) - 7)


def _max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def _bitwise_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """0 when ``got`` equals ``want`` bitwise, else their max abs error
    (inf where that is 0: a signed zero or a NaN differs)."""
    if torch.equal(got, want):
        return 0.0
    return _max_err(got, want) or math.inf


def device_us(fn: Callable[[], object], reps: int) -> float:
    """Warm median of ``reps`` CUDA-event-timed samples of ``fn``, in us a
    call.  A sample is a batch of back-to-back calls that spans at least
    ``SAMPLE_MS`` on the card (a single call for a kernel that long), so a
    short kernel is timed by the card's clock rather than by the host's
    time to launch it, as long as the host keeps ahead of the card."""

    def sample(batch: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e3 / batch

    fn()
    torch.cuda.synchronize()
    batch = min(MAX_BATCH, max(1, math.ceil(SAMPLE_MS * 1e3 / sample(1))))
    return statistics.median(sample(batch) for _ in range(reps))


def host_us(fn: Callable[[], object], reps: int) -> float:
    """Warm median of ``reps`` host-clock calls of ``fn``, in us."""
    fn()
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        fn()
        times.append((time.perf_counter() - start) * 1e6)
    return statistics.median(times)


def _card_note(
    plain_us: float,
    library_us: float | None,
    bound: tuple[float, str],
    err: float,
    tol: float,
) -> str:
    lib = "none" if library_us is None else f"{library_us:.1f}"
    return (
        f"plain_us={plain_us:.1f} library_us={lib} "
        f"bound_us={bound[0] * 1e3:.2f}({bound[1]};H100 SXM) "
        f"err={err:.3g}<={tol:.3g}"
    )


def _timing_cells():
    from repro_torch.core import OpticalFabric, get_pattern

    return [
        (
            OpticalFabric(8, 4, t_recfg=25e-6 * (1 + k)),
            get_pattern("rabenseifner_allreduce", 8, 1e6 * (1 + k)),
        )
        for k in range(32)
    ]


def run(device: "str | torch.device | None" = None) -> list[Row]:
    """The six rows on ``device`` (None: the card)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    from repro_torch.core import prestage_for, strawman_icr, strawman_instance
    from repro_torch.core.convert import packed_from_numpy
    from repro_torch.core.ir import pack_instances
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_reduce as fr
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import timing_scan as ts
    from repro_torch.models.attention import blocked_attention

    rows = []
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False

    # Blocked attention: the models' plain torch path (no kernel).
    b, s, h, d = 2, 1024, 8, 64
    q, k, v = (draw(b, s, h, d, dtype=torch.bfloat16) for _ in range(3))
    blocked = lambda: blocked_attention(q, k, v, q_block=256, kv_block=256)  # noqa: E731
    heads = lambda t: t.transpose(1, 2).reshape(b * h, s, d)  # noqa: E731
    qm, km, vm = heads(q), heads(k), heads(v)
    want = fa.flash_attention_bhsd_plain(qm, km, vm, causal=True)
    err = _max_err(heads(blocked()), want)
    flops = roofline.attention_flops(b * h, s, s, d, True, None)
    if on_card:
        us = device_us(blocked, PLAIN_REPS)
        sdpa = lambda: F.scaled_dot_product_attention(qm, km, vm, is_causal=True)  # noqa: E731
        note = (
            f"{flops / us / 1e6:.1f}TFLOP/s "
            + _card_note(us, device_us(sdpa, KERNEL_REPS),
                         roofline.attention_bound(qm, km, True, None), err, BLOCKED_TOL)
        )
    else:
        us = host_us(blocked, 1)
        note = f"plain torch on the cpu err={err:.3g}<={BLOCKED_TOL:.3g} vs flash plain"
    rows.append(Row("kernel_blocked_attention_torch", us, note, err, BLOCKED_TOL))

    # Flash attention at (2, 256, 8, 64).
    qs, ks, vs = q[:, :256], k[:, :256], v[:, :256]
    got = ops.flash_attention(qs, ks, vs, causal=True)
    qm, km, vm = (t.transpose(1, 2).reshape(b * h, 256, d) for t in (qs, ks, vs))
    plain = lambda: fa.flash_attention_bhsd_plain(qm, km, vm, causal=True)  # noqa: E731
    want = plain().reshape(b, h, 256, d).transpose(1, 2)
    if on_card:
        err, tol = _max_err(got, want), bf16_ulp(want)
        us = device_us(lambda: fa.flash_attention_bhsd_cuda(qm, km, vm, causal=True), KERNEL_REPS)
        sdpa = lambda: F.scaled_dot_product_attention(qm, km, vm, is_causal=True)  # noqa: E731
        note = _card_note(device_us(plain, PLAIN_REPS), device_us(sdpa, KERNEL_REPS),
                          roofline.attention_bound(qm, km, True, None), err, tol)
        rows.append(Row("kernel_flash_attention_cuda", us, note, err, tol))
    else:
        rows.append(Row("kernel_flash_attention_plain", host_us(plain, 1),
                        "plain torch on the cpu (functional)"))

    # SSD scan.
    bsz, s, h, p, n, chunk = 2, 512, 4, 64, 64, 128
    x = draw(bsz, s, h, p)
    dt = F.softplus(draw(bsz, s, h))
    a_log = 0.5 * draw(h)
    bb, cc = draw(bsz, s, n), draw(bsz, s, n)
    y = ops.ssd_scan(x, dt, a_log, bb, cc, chunk=chunk)
    xdt, logd = ssd.head_major(x, dt, a_log)
    kw = dict(n_heads=h, chunk=chunk)
    plain = lambda: ssd.ssd_scan_bhsp_plain(xdt, logd, bb, cc, **kw)  # noqa: E731
    if on_card:
        want = plain()[0].reshape(bsz, h, s, p).transpose(1, 2)
        err = _max_err(y, want)
        tol = SSD_TOL * float(want.abs().max())
        us = device_us(lambda: ssd.ssd_scan_bhsp_cuda(xdt, logd, bb, cc, **kw), KERNEL_REPS)
        note = _card_note(device_us(plain, PLAIN_REPS), None,
                          roofline.ssd_bound(bsz, h, s, p, n, chunk, False), err, tol)
        rows.append(Row("kernel_ssd_scan_cuda", us, note, err, tol))
    else:
        rows.append(Row("kernel_ssd_scan_plain", host_us(plain, 1),
                        "plain torch on the cpu (functional)"))

    # Fused reduce (the collective's local combine).
    a, a2 = draw(1 << 20, dtype=torch.bfloat16), draw(1 << 20, dtype=torch.bfloat16)
    got = ops.fused_reduce(a, a2)
    plain = lambda: fr.fused_reduce_flat_plain(a, a2)  # noqa: E731
    if on_card:
        err = _bitwise_err(got, plain())
        us = device_us(lambda: fr.fused_reduce_flat_cuda(a, a2), KERNEL_REPS)
        note = _card_note(device_us(plain, PLAIN_REPS),
                          device_us(lambda: torch.add(a, a2), KERNEL_REPS),
                          roofline.reduce_bound(a, a.dtype), err, 0.0)
        rows.append(Row("kernel_fused_reduce_cuda", us, note, err, 0.0))
    else:
        us = host_us(plain, 3)
        rows.append(Row("kernel_fused_reduce_plain", us,
                        f"{3 * a.numel() * 2 / us / 1e3:.2f}GB/s host"))

    # RMSNorm.
    x, w = draw(2048, 1024, dtype=torch.bfloat16), draw(1024)
    got = ops.rmsnorm(x, w)
    plain = lambda: rn.rmsnorm_2d_plain(x, w)  # noqa: E731
    if on_card:
        want = plain()
        err, tol = _max_err(got, want), bf16_ulp(want)
        us = device_us(lambda: rn.rmsnorm_2d_cuda(x, w), KERNEL_REPS)
        library = device_us(lambda: F.rms_norm(x, (1024,), w, 1e-6), KERNEL_REPS)
        note = _card_note(device_us(plain, PLAIN_REPS), library,
                          roofline.rmsnorm_bound(x, w), err, tol)
        rows.append(Row("kernel_rmsnorm_cuda", us, note, err, tol))
    else:
        rows.append(Row("kernel_rmsnorm_plain", host_us(plain, 3),
                        "plain torch on the cpu (functional)"))

    # Schedule-IR timing scan over 32 strawman cells.
    cells = _timing_cells()
    packed = pack_instances(
        [strawman_instance(f, pat, prestage=True) for f, pat in cells], None
    )
    tensors = packed_from_numpy(packed, dev)
    cct = ts.timing_scan(tensors)[0]
    if on_card:
        want = ts.timing_scan(packed_from_numpy(packed, "cpu"))[0]
        what = "cpu path"
    else:
        want = torch.tensor(
            [strawman_icr(prestage_for(f, pat), pat).cct for f, pat in cells],
            dtype=torch.float64,
        )
        what = "host executor"
    err = _bitwise_err(cct.cpu(), want)
    if on_card:
        us = device_us(lambda: ts.timing_scan_cuda(tensors), KERNEL_REPS)
        plain = lambda: ts.timing_scan_plain(tensors)  # noqa: E731
        note = f"{len(cells)} cells " + _card_note(
            device_us(plain, PLAIN_REPS), None,
            roofline.timing_scan_bound(tensors, ts.timing_scan_cuda(tensors)), err, 0.0,
        )
        rows.append(Row("kernel_timing_scan_cuda", us, note, err, 0.0))
    else:
        us = host_us(lambda: ts.timing_scan_plain(tensors), 1)
        rows.append(Row("kernel_timing_scan_plain", us,
                        f"{len(cells)} cells max_cct_err={err:.1e} vs {what}", err, 0.0))
    return rows


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    for name, us, note, *_ in run(args.device):
        print(f"{name},{us:.1f},{note}")


if __name__ == "__main__":
    main()
