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
  and within one bf16 ulp of the output magnitude in bfloat16, on the
  shapes ``chip_smoke.py``'s ``attention_vs_plain`` phase checks; every
  call on CUDA tensors launches the kernel once.
* ``ssd_scan_bhsp``: y and the final state within 3e-4 of their own scale
  of the plain version (the reference's kernel tolerance; a bf16 y also
  within one bf16 ulp of its magnitude, the cast's rounding), on the
  serving shapes of mamba2-130m and zamba2-1.2b and the edge cases of
  ``chip_smoke.py``'s ``ssd_vs_plain`` phase; the model-layout wrapper
  and the model's ``ssd_chunked`` launch the kernel and never run the
  plain version on a card.
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
from repro_torch.kernels import ssd_scan as ssd_lib
from repro_torch.models import ssm
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
# shape (qwen2-1.5B, 8 requests of 2048 tokens), then head dims 120, 256
# and 16, a float32 case with Sq != Skv, and a ragged S.
ATTENTION_CASES = [
    ("main_path", 96, 16, 2048, 2048, 128, "bfloat16", True, None),
    ("d120_window", 32, 8, 1024, 1024, 120, "bfloat16", True, 512),
    ("d256_group1", 8, 8, 1024, 1024, 256, "bfloat16", True, None),
    ("d16", 12, 4, 300, 300, 16, "bfloat16", True, None),
    ("float32", 24, 12, 500, 777, 64, "float32", False, None),
    ("ragged_2000", 24, 4, 2000, 2000, 128, "bfloat16", True, None),
]


def _attention_tolerance(dtype: str, want: torch.Tensor) -> float:
    if dtype == "float32":
        return 2e-5
    magnitude = float(want.float().abs().max())
    return 2.0 ** (math.floor(math.log2(magnitude)) - 7)  # one bf16 ulp


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
