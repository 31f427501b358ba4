"""The port's CUDA kernels against their plain torch versions, on a card.

Run on a machine with a CUDA device:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel.py

This file imports only the port (no JAX, no reference package), so it runs
where the reference cannot.  Each test decides inside itself whether a
card is present and skips without one.

* ``timing_scan``: outputs bitwise equal (``torch.equal``), attribution
  cubes and flags included, and the card's plans bitwise equal to the
  CPU's.
* ``flash_attention_bhsd``: within 2e-5 of the plain version in float32
  and within one ulp of the output magnitude in bfloat16 and float16, on
  the shapes ``chip_smoke.py``'s ``attention_vs_plain`` phase checks (a
  padded head dim of 36 among them); at the serving shape at most 2% of
  the 16-bit outputs differ bitwise from the plain version's (P.V at
  float32 accuracy); every call on CUDA tensors launches the kernel once,
  and a call without keys gives zeros without a launch.
* ``ssd_scan_bhsp``: y and the final state within 3e-4 of their own scale
  of the plain version (the reference's kernel tolerance; a bf16 y also
  within one bf16 ulp of its magnitude, the cast's rounding), on the
  serving shapes of mamba2-130m and zamba2-1.2b and the edge cases of
  ``chip_smoke.py``'s ``ssd_vs_plain`` phase; the model-layout wrapper
  and the model's ``ssd_chunked`` launch the kernel and never run the
  plain version on a card.
* ``rmsnorm_2d``: within one ulp of the output magnitude of the plain
  version in bf16 and float16 and within 1e-5 of it in float32 (only the
  order of the sum of squares differs), on the serving shapes of
  qwen2-1.5B, mamba2-130m, zamba2-1.2b and gemma-2b, a decode shape, a
  bf16 and a float16 weight, D off the vector width and a misaligned
  view; the models' ``rms_norm`` launches it and never runs the plain
  version on a card; unsupported dtypes and widths raise.
* ``fused_reduce_flat``: bitwise equal to the plain version
  (``torch.equal``) for every dtype pair on aligned, odd and misaligned
  buffers and for a and b of different dtypes; a dtype it does not take
  raises.
"""

import math

import pytest
import torch

from repro_torch.core import (
    BatchInstance,
    DependencyMode,
    OpticalFabric,
    PlannerOptions,
    PlanRequest,
    get_pattern,
    plan,
    prestage_for,
    strawman_instance,
)
from repro_torch.core.convert import packed_from_numpy
from repro_torch.core.ir import pack_instances
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bhsd,
    flash_attention_bhsd_plain,
)
from repro_torch.kernels import fused_reduce as fr
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ssd_lib
from repro_torch.models import common, ssm
from repro_torch.kernels.timing_scan import (
    timing_scan,
    timing_scan_cuda,
    timing_scan_plain,
)

_SPECS = (
    ("ring_allreduce", 8, 10e6, 1, 50e-6),
    ("pairwise_alltoall", 10, 3e6, 4, 200e-6),
    ("rabenseifner_allreduce", 8, 40e6, 2, 0.0),
    ("bruck_alltoall", 5, 7e6, 3, 100e-6),
    ("pairwise_alltoall", 8, 8e6, 4, 3.2e-3),
)


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _cells():
    cells = []
    for alg, n, size, planes, t_recfg in _SPECS:
        pattern = get_pattern(alg, n, size)
        fabric = OpticalFabric(n, planes, t_recfg=t_recfg)
        cells.append((prestage_for(fabric, pattern), pattern))
    return cells


def _batches():
    cells = _cells()
    greedy = plan(PlanRequest.grid(
        cells, options=PlannerOptions(device="cpu", bypass_depth=2)
    ))
    ready = [
        tuple(2.5e-5 * (j + 1) for j in range(f.n_planes)) for f, _ in cells
    ]
    return {
        "strawman": ([strawman_instance(f, p) for f, p in cells], None),
        "plane_ready": ([strawman_instance(f, p) for f, p in cells], ready),
        "greedy_bypass": (
            [
                BatchInstance(c.plan.fabric, c.plan.pattern, c.plan.decisions)
                for c in greedy.grid
            ],
            None,
        ),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("attribution", [False, True])
def test_kernel_matches_plain_bitwise(attribution):
    _require_card()
    for name, (instances, ready) in _batches().items():
        tensors = packed_from_numpy(pack_instances(instances, ready), "cuda")
        before = timing_scan.launches
        got = timing_scan(tensors, attribution=attribution)
        assert timing_scan.launches == before + 1
        want = timing_scan_plain(tensors, attribution=attribution)
        torch.cuda.synchronize()
        assert len(got) == len(want) == (9 if attribution else 5)
        for k, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype and torch.equal(g, w), (name, k)


@pytest.mark.cuda
def test_kernel_rejects_too_many_planes():
    _require_card()
    pattern = get_pattern("ring_allreduce", 4, 1e6)
    inst = strawman_instance(OpticalFabric(4, 129), pattern)
    tensors = packed_from_numpy(pack_instances([inst], None), "cuda")
    with pytest.raises(ValueError, match="planes"):
        timing_scan_cuda(tensors)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "mode,split",
    [
        (DependencyMode.CHAIN, False),
        (DependencyMode.INDEPENDENT, False),
        (DependencyMode.INDEPENDENT, True),
    ],
)
def test_card_plans_match_cpu_plans(mode, split):
    _require_card()
    cells = _cells()
    opts = dict(mode=mode, independent_split=split)
    if mode is DependencyMode.CHAIN:
        opts["bypass_depth"] = 2
    card = plan(PlanRequest.grid(cells, options=PlannerOptions(device="cuda", **opts)))
    cpu = plan(PlanRequest.grid(cells, options=PlannerOptions(device="cpu", **opts)))
    for a, b in zip(card.grid, cpu.grid):
        assert a.plan.decisions == b.plan.decisions
        assert a.cct == b.cct and a.strawman_cct == b.strawman_cct
        assert a.plan.utilization == b.plan.utilization


# (name, BHq, BHkv, Sq, Skv, D, dtype, causal, window): the serving path's
# shape (qwen2-1.5B, 8 requests of 2048 tokens) in bf16 and float16, then
# head dims 120, 256, 16 and 36 (both padded to a multiple of 16 by the
# wrapper), a float32 case with Sq != Skv, and a ragged S.
ATTENTION_CASES = [
    ("main_path", 96, 16, 2048, 2048, 128, "bfloat16", True, None),
    ("float16", 96, 16, 2048, 2048, 128, "float16", True, None),
    ("d36_pad", 32, 8, 700, 700, 36, "bfloat16", True, None),
    ("d120_window", 32, 8, 1024, 1024, 120, "bfloat16", True, 512),
    ("d256_group1", 8, 8, 1024, 1024, 256, "bfloat16", True, None),
    ("d16", 12, 4, 300, 300, 16, "bfloat16", True, None),
    ("float32", 24, 12, 500, 777, 64, "float32", False, None),
    ("ragged_2000", 24, 4, 2000, 2000, 128, "bfloat16", True, None),
]


def _attention_tolerance(dtype: str, want: torch.Tensor) -> float:
    """2e-5 in float32; one ulp of the output's magnitude in bf16 and
    float16."""
    if dtype == "float32":
        return 2e-5
    magnitude = float(want.float().abs().max())
    mantissa = 7 if dtype == "bfloat16" else 10
    return 2.0 ** (math.floor(math.log2(magnitude)) - mantissa)


def _differ_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """The share of outputs not bitwise equal to the plain version's."""
    return float((got != want).float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,bhq,bhkv,sq,skv,d,dtype,causal,window",
    ATTENTION_CASES,
    ids=[c[0] for c in ATTENTION_CASES],
)
def test_flash_attention_kernel_matches_plain(
    name, bhq, bhkv, sq, skv, d, dtype, causal, window
):
    _require_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (
        torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dtype))
        for shape in ((bhq, sq, d), (bhkv, skv, d), (bhkv, skv, d))
    )
    before = flash_attention_bhsd.launches
    got = flash_attention_bhsd(q, k, v, causal=causal, window=window)
    assert flash_attention_bhsd.launches == before + 1
    want = flash_attention_bhsd_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= _attention_tolerance(dtype, want), (name, err)
    if name in ("main_path", "float16"):
        # P.V at float32 accuracy: only outputs within float32 noise of a
        # 16-bit rounding boundary may differ from the plain version's.
        assert _differ_share(got, want) <= 0.02, (name, _differ_share(got, want))


@pytest.mark.cuda
def test_flash_attention_kernel_without_keys_gives_zeros():
    _require_card()
    q = torch.randn((4, 10, 64), device="cuda").bfloat16()
    k = torch.zeros((2, 0, 64), device="cuda").bfloat16()
    before = flash_attention_bhsd.launches
    got = flash_attention_bhsd(q, k, k, causal=False)
    assert flash_attention_bhsd.launches == before
    assert got.shape == q.shape and not got.any()


@pytest.mark.cuda
def test_model_layout_wrapper_launches_the_kernel():
    _require_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((2, 70, 6, 64), generator=gen, device="cuda").bfloat16()
    k = torch.randn((2, 70, 2, 64), generator=gen, device="cuda").bfloat16()
    before = flash_attention_bhsd.launches
    got = flash_attention(q, k, k, causal=True, window=None)
    assert flash_attention_bhsd.launches == before + 1
    want = flash_attention(q.cpu(), k.cpu(), k.cpu(), causal=True, window=None)
    assert flash_attention_bhsd.launches == before + 1
    err = float((got.cpu().float() - want.float()).abs().max())
    assert err <= _attention_tolerance("bfloat16", want)


# (name, batch, heads, S, P, N, chunk, with an initial state, x dtype): the
# serving shapes (8 requests of 1895 tokens through mamba2-130m and
# zamba2-1.2b), S shorter than a chunk, S a multiple of the chunk, an
# initial state, a bf16 x through the model-layout wrapper, and P and N off
# the kernel's tiles with a small chunk.
SSD_CASES = [
    ("mamba2_130m", 8, 24, 1895, 64, 128, 128, False, "float32"),
    ("zamba2_1_2b", 8, 64, 1895, 64, 64, 128, False, "float32"),
    ("short_37", 2, 3, 37, 64, 128, 128, False, "float32"),
    ("multiple_256", 2, 4, 256, 64, 128, 128, False, "float32"),
    ("init_state", 2, 4, 300, 64, 64, 128, True, "float32"),
    ("bf16_x", 2, 4, 500, 64, 128, 128, False, "bfloat16"),
    ("p80_n18_chunk48", 3, 2, 200, 80, 18, 48, True, "float32"),
]


def ssd_inputs(gen, batch, heads, s, p, n, with_init, dtype, device):
    """Model-layout inputs as a Mamba2 layer makes them: x, dt > 0
    (softplus), a_log, b, c, and an optional initial state."""
    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device)

    x = draw(batch, s, heads, p).to(getattr(torch, dtype))
    dt = torch.nn.functional.softplus(draw(batch, s, heads) - 1.0)
    a_log = 0.5 * draw(heads)
    b, c = draw(batch, s, n), draw(batch, s, n)
    init = draw(batch, heads, p, n) if with_init else None
    return x, dt, a_log, b, c, init


def ssd_error(got, want, dtype):
    """Max abs error and its tolerance: 3e-4 of the output's own scale,
    plus one bf16 ulp of that scale for a bf16 output."""
    scale = float(want.float().abs().max())
    tol = 3e-4 * scale
    if dtype == "bfloat16":
        tol += 2.0 ** (math.floor(math.log2(scale)) - 7)
    return float((got.float() - want.float()).abs().max()), tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES, ids=[c[0] for c in SSD_CASES])
def test_ssd_scan_kernel_matches_plain(case, monkeypatch):
    _require_card()
    name, batch, heads, s, p, n, chunk, with_init, dtype = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, dt, a_log, b, c, init = ssd_inputs(
        gen, batch, heads, s, p, n, with_init, dtype, "cuda"
    )
    before = ssd_lib.ssd_scan_bhsp.launches
    y, state = ssd_lib.ssd_scan(x, dt, a_log, b, c, chunk=chunk, init_state=init)
    assert ssd_lib.ssd_scan_bhsp.launches == before + 1
    with monkeypatch.context() as m:  # the plain version, on the card
        m.setattr(ssd_lib, "ssd_scan_bhsp_cuda", ssd_lib.ssd_scan_bhsp_plain)
        want_y, want_state = ssd_lib.ssd_scan(
            x, dt, a_log, b, c, chunk=chunk, init_state=init
        )
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and y.shape == x.shape
    assert state.dtype == torch.float32 and state.shape == (batch, heads, p, n)
    err, tol = ssd_error(y, want_y, dtype)
    assert err <= tol, (name, "y", err, tol)
    err, tol = ssd_error(state, want_state, "float32")
    assert err <= tol, (name, "state", err, tol)


@pytest.mark.cuda
def test_ssd_chunked_on_the_card_launches_the_kernel(monkeypatch):
    """The model's chunked SSD reaches the kernel on CUDA tensors and never
    the plain version; its result equals the CPU's within tolerance."""
    _require_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    args = ssd_inputs(gen, 2, 3, 150, 64, 128, True, "float32", "cuda")
    x, dt, a_log, b, c, init = args
    want_y, want_state = ssm.ssd_chunked(
        *(t.cpu() for t in (x, dt, a_log, b, c)), chunk=128, init_state=init.cpu()
    )

    def refuse(*a, **k):
        raise AssertionError("the plain scan ran on a card")

    monkeypatch.setattr(ssd_lib, "ssd_scan_bhsp_plain", refuse)
    before = ssd_lib.ssd_scan_bhsp.launches
    y, state = ssm.ssd_chunked(x, dt, a_log, b, c, chunk=128, init_state=init)
    torch.cuda.synchronize()
    assert ssd_lib.ssd_scan_bhsp.launches == before + 1
    for got, want in ((y, want_y), (state, want_state)):
        err, tol = ssd_error(got.cpu(), want, "float32")
        assert err <= tol, (err, tol)


@pytest.mark.cuda
def test_ssd_kernel_refuses_what_it_does_not_take():
    _require_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    x, dt, a_log, b, c, _ = ssd_inputs(gen, 1, 2, 10, 8, 132, False, "float32", "cuda")
    with pytest.raises(ValueError, match="state dim"):
        ssd_lib.ssd_scan(x, dt, a_log, b, c)
    x, dt, a_log, b, c, _ = ssd_inputs(gen, 1, 2, 300, 8, 16, False, "float32", "cuda")
    with pytest.raises(ValueError, match="chunk"):
        ssd_lib.ssd_scan(x, dt, a_log, b, c, chunk=256)


# (name, T, D, x dtype, w dtype, offset): the serving paths' prefill norms
# (8 requests of 1895 tokens: qwen2-1.5B's layer norm and mamba2-130m's
# gated norm at 1536, zamba2-1.2b's gated norm at 4096, gemma-2b's (1 + w)
# norm at 2048), a decode step, float32 and float16 x, a bf16 weight, D off
# the vector width, T = 7 and the widest row.
RMSNORM_CASES = [
    ("qwen2_prefill", 15160, 1536, "bfloat16", "float32", False),
    ("zamba2_gated", 15160, 4096, "bfloat16", "float32", False),
    ("gemma_prefill", 15160, 2048, "bfloat16", "float32", True),
    ("decode", 8, 2048, "bfloat16", "float32", True),
    ("float32", 4096, 1536, "float32", "float32", False),
    ("float16", 1000, 1024, "float16", "float32", False),
    ("bf16_weight", 4096, 2048, "bfloat16", "bfloat16", True),
    ("d48", 1024, 48, "bfloat16", "float32", False),
    ("d1234", 300, 1234, "bfloat16", "float32", True),
    ("t7", 7, 2048, "float32", "float32", True),
    ("d16384", 64, 16384, "float32", "bfloat16", False),
    ("f16_weight", 4096, 2048, "bfloat16", "float16", True),
]


def rmsnorm_tolerance(dtype: str, want: torch.Tensor) -> float:
    """One ulp of the output's magnitude (bf16, float16), 1e-5 of it in
    float32."""
    scale = float(want.float().abs().max())
    if dtype == "float32":
        return 1e-5 * scale
    mantissa = 7 if dtype == "bfloat16" else 10
    return 2.0 ** (math.floor(math.log2(scale)) - mantissa)


@pytest.mark.cuda
@pytest.mark.parametrize("case", RMSNORM_CASES, ids=[c[0] for c in RMSNORM_CASES])
def test_rmsnorm_kernel_matches_plain(case):
    _require_card()
    name, t, d, x_dtype, w_dtype, offset = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (3 * torch.randn((t, d), generator=gen, device="cuda")).to(getattr(torch, x_dtype))
    w = torch.randn((d,), generator=gen, device="cuda").to(getattr(torch, w_dtype))
    before = rn.rmsnorm_2d.launches
    got = rn.rmsnorm_2d(x, w, offset=offset)
    assert rn.rmsnorm_2d.launches == before + 1
    want = rn.rmsnorm_2d_plain(x, w, offset=offset)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= rmsnorm_tolerance(x_dtype, want), (name, err)


@pytest.mark.cuda
def test_rmsnorm_kernel_on_a_misaligned_view():
    _require_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    flat = torch.randn((1 + 33 * 100,), generator=gen, device="cuda").bfloat16()
    x = flat[1:].view(33, 100)  # base 2 bytes past a 16-byte boundary
    w = torch.randn((100,), generator=gen, device="cuda")
    got = rn.rmsnorm_2d(x, w)
    want = rn.rmsnorm_2d_plain(x, w)
    assert float((got.float() - want.float()).abs().max()) <= rmsnorm_tolerance("bfloat16", want)


@pytest.mark.cuda
def test_model_rms_norm_on_the_card_launches_the_kernel(monkeypatch):
    _require_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((2, 5, 3, 64), generator=gen, device="cuda").bfloat16()
    w = torch.randn((64,), generator=gen, device="cuda")
    want = common.rms_norm(x.cpu(), w.cpu(), eps=1e-5, offset=True)

    def refuse(*a, **k):
        raise AssertionError("the plain RMSNorm ran on a card")

    monkeypatch.setattr(rn, "rmsnorm_2d_plain", refuse)
    before = rn.rmsnorm_2d.launches
    got = common.rms_norm(x, w, eps=1e-5, offset=True)
    torch.cuda.synchronize()
    assert rn.rmsnorm_2d.launches == before + 1
    assert got.shape == x.shape
    err = float((got.cpu().float() - want.float()).abs().max())
    assert err <= rmsnorm_tolerance("bfloat16", want)


@pytest.mark.cuda
def test_rmsnorm_kernel_refuses_what_it_does_not_take():
    _require_card()
    x = torch.zeros((4, 64), device="cuda")
    w = torch.ones((64,), device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        rn.rmsnorm_2d(x.double(), w)
    with pytest.raises(ValueError, match="dtype"):
        rn.rmsnorm_2d(x, w.double())
    with pytest.raises(ValueError, match="entries"):
        rn.rmsnorm_2d(x, w[:63])
    with pytest.raises(ValueError, match="row width"):
        rn.rmsnorm_2d(torch.zeros((2, rn.MAX_D + 1), device="cuda"),
                      torch.ones((rn.MAX_D + 1,), device="cuda"))


# (shape, in dtype, out dtype): the bench's 2^20 bf16, 8 M float32, a bf16
# sum kept in float32, float16, and odd sizes.
REDUCE_CASES = [
    ((1 << 20,), "bfloat16", "bfloat16"),
    ((8388608,), "float32", "float32"),
    ((8388608,), "bfloat16", "float32"),
    ((1000, 999), "float16", "float16"),
    ((3, 5, 7), "float32", "bfloat16"),
    ((17,), "bfloat16", "float16"),
    ((100000,), "float16", "float32"),
]
# (shape, a dtype, b dtype, out dtype): mixed dtypes, which the wrapper
# casts to float32 before the launch.
MIXED_REDUCE_CASES = [
    ((8388608,), "bfloat16", "float32", "float32"),
    ((1000, 999), "float32", "bfloat16", "bfloat16"),
    ((100001,), "float16", "bfloat16", "float16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,in_dtype,out_dtype", REDUCE_CASES)
def test_fused_reduce_kernel_matches_plain_bitwise(shape, in_dtype, out_dtype):
    _require_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    a, b = (
        (50 * torch.randn(shape, generator=gen, device="cuda")).to(getattr(torch, in_dtype))
        for _ in range(2)
    )
    out_dtype = getattr(torch, out_dtype)
    before = fr.fused_reduce_flat.launches
    got = fr.fused_reduce_flat(a, b, out_dtype=out_dtype)
    assert fr.fused_reduce_flat.launches == before + 1
    want = fr.fused_reduce_flat_plain(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and torch.equal(got, want)
    # Misaligned views take the scalar loop.
    flat_a, flat_b = a.reshape(-1), b.reshape(-1)
    got = fr.fused_reduce_flat(flat_a[1:], flat_b[1:], out_dtype=out_dtype)
    assert torch.equal(got, fr.fused_reduce_flat_plain(flat_a[1:], flat_b[1:], out_dtype=out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,a_dtype,b_dtype,out_dtype", MIXED_REDUCE_CASES)
def test_fused_reduce_kernel_mixed_dtypes_match_plain_bitwise(shape, a_dtype, b_dtype, out_dtype):
    _require_card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    a, b = (
        (50 * torch.randn(shape, generator=gen, device="cuda")).to(getattr(torch, dt))
        for dt in (a_dtype, b_dtype)
    )
    out_dtype = getattr(torch, out_dtype)
    before = fr.fused_reduce_flat.launches
    got = fr.fused_reduce_flat(a, b, out_dtype=out_dtype)
    assert fr.fused_reduce_flat.launches == before + 1
    want = fr.fused_reduce_flat_plain(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_fused_reduce_kernel_refuses_what_it_does_not_take():
    _require_card()
    a = torch.zeros(8, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        fr.fused_reduce_flat(a, a.double())
    with pytest.raises(ValueError, match="dtype"):
        fr.fused_reduce_flat(a.double(), a.double())
    with pytest.raises(ValueError, match="shape mismatch"):
        fr.fused_reduce_flat(a, a[:4])
