"""The port's kernel entry points against the reference's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages.

* ``rmsnorm_2d_plain`` (the CUDA kernel's plain version) against the
  reference's Pallas ``rmsnorm_2d`` in interpret mode and its oracle
  ``ref_rmsnorm``: x bf16 and float32, w float32 and bf16, offset off and
  on, D in {48, 1234, 2048}, T in {7, 300, 513}.  Both take the same
  operations in the same order; only the order of the sum of squares
  differs, so a bf16 output is held within one bf16 ulp of the output's
  magnitude and a float32 one within 1e-5 of it.
* ``fused_reduce_flat_plain`` bitwise against the reference's Pallas
  ``fused_reduce_flat`` in interpret mode: one float32 add and one
  rounding, for each (input, output) dtype pair on odd sizes.
* The port's ``kernels.ops`` wrappers against the reference's
  ``kernels.ops`` with ``interpret=True``: rmsnorm and fused_reduce as
  above, flash attention within 2e-5 (float32) and 1e-2 (bf16), the SSD
  scan's y within 3e-4 (the reference's kernel tolerance).
* The models' ``rms_norm`` goes through the kernel's dispatcher: a
  ``generate`` of each served family's smoke config reaches it exactly
  norms-per-forward x (prefill + decode steps) times.
* ``repro_torch.benchmarks.kernel_bench`` gives its six rows on the CPU,
  and raises where CUDA is absent and the caller did not name the CPU.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_reduce import fused_reduce_flat as pallas_fused_reduce
from repro.kernels.rmsnorm import rmsnorm_2d as pallas_rmsnorm_2d
from repro_torch.benchmarks import kernel_bench
from repro_torch.configs.registry import smoke_config
from repro_torch.kernels import fused_reduce as fr
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models.lm import build_model
from repro_torch.serve.engine import Request, ServeEngine

def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bits(x) -> np.ndarray:
    """The raw bits of a torch or JAX array, for a bitwise comparison."""
    if isinstance(x, torch.Tensor):
        view = {1: torch.int8, 2: torch.int16, 4: torch.int32}[x.element_size()]
        return x.view(view).numpy()
    a = np.asarray(x)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _norm_tol(dtype: str, want: np.ndarray) -> float:
    """One bf16 ulp of the output's magnitude, or 1e-5 of it in float32."""
    scale = float(np.abs(want).max())
    if dtype == "bfloat16":
        return 2.0 ** (math.floor(math.log2(scale)) - 7)
    return 1e-5 * scale


# ---------------------------------------------------------------------------
# RMSNorm.

RMSNORM_SHAPES = [(7, 48), (300, 1234), (513, 2048), (7, 2048), (513, 48)]


@pytest.mark.parametrize("t,d", RMSNORM_SHAPES, ids=[f"{t}x{d}" for t, d in RMSNORM_SHAPES])
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [False, True], ids=["w", "offset"])
def test_rmsnorm_plain_matches_reference(t, d, w_dtype, x_dtype, offset):
    x, w = _draw(t * d, (t, d), (d,))
    x = 3.0 * x
    got = rn.rmsnorm_2d_plain(_torch(x, x_dtype), _torch(w, w_dtype), offset=offset)
    assert got.dtype == getattr(torch, x_dtype) and got.shape == (t, d)
    jx, jw = _jax(x, x_dtype), _jax(w, w_dtype)
    for what, want in (
        ("pallas", pallas_rmsnorm_2d(jx, jw, offset=offset, interpret=True)),
        ("oracle", jref.ref_rmsnorm(jx, jw, offset=offset)),
    ):
        want = _f32(want)
        np.testing.assert_allclose(
            _f32(got), want, rtol=0, atol=_norm_tol(x_dtype, want), err_msg=what
        )


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("offset", [False, True], ids=["w", "offset"])
def test_rmsnorm_float16_weight_through_the_kernel_cast(x_dtype, offset):
    """A float16 weight: the CUDA wrapper's cast (``kernel_weight``, to
    float32) gives bitwise what the plain version gives, and both are
    within the norm's tolerance of the reference's Pallas kernel."""
    x, w = _draw(10, (300, 160), (160,))
    tx, tw = _torch(3.0 * x, x_dtype), _torch(w, "float16")
    kw = rn.kernel_weight(tw)
    assert kw.dtype == torch.float32 and torch.equal(kw.half(), tw)
    got = rn.rmsnorm_2d_plain(tx, kw, offset=offset)
    assert torch.equal(got, rn.rmsnorm_2d_plain(tx, tw, offset=offset))
    want = _f32(pallas_rmsnorm_2d(_jax(3.0 * x, x_dtype), _jax(w, "float16"),
                                  offset=offset, interpret=True))
    tol_dtype = "float32" if x_dtype == "float32" else "bfloat16"
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=_norm_tol(tol_dtype, want))
    for w_dtype in ("float32", "bfloat16"):
        same = _torch(w, w_dtype)
        assert rn.kernel_weight(same) is same


def test_rmsnorm_dispatch_on_the_cpu_is_the_plain_version():
    x, w = _draw(1, (4, 5, 96), (96,))
    tx, tw = _torch(x, "bfloat16"), _torch(w, "float32")
    before = rn.rmsnorm_2d.launches
    got = rn.rmsnorm(tx, tw, eps=1e-5, offset=True)
    assert rn.rmsnorm_2d.launches == before
    want = rn.rmsnorm_2d_plain(tx.reshape(-1, 96), tw, eps=1e-5, offset=True)
    assert torch.equal(got, want.reshape(4, 5, 96))


def test_rmsnorm_cuda_wrapper_refuses_cpu_tensors():
    x, w = _draw(2, (3, 8), (8,))
    before = rn.rmsnorm_2d.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        rn.rmsnorm_2d_cuda(torch.from_numpy(x), torch.from_numpy(w))
    with pytest.raises(ValueError, match="x must be"):
        rn.rmsnorm_2d_cuda(torch.from_numpy(x)[None], torch.from_numpy(w))
    assert rn.rmsnorm_2d.launches == before


# ---------------------------------------------------------------------------
# Fused reduce.

REDUCE_SHAPES = [(17,), (3, 5, 7), (100000,)]
REDUCE_PAIRS = [
    ("float32", "float32"),
    ("bfloat16", "bfloat16"),
    ("bfloat16", "float32"),
    ("float32", "bfloat16"),
    ("float16", "float16"),
    ("float16", "float32"),
]


@pytest.mark.parametrize("shape", REDUCE_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("in_dtype,out_dtype", REDUCE_PAIRS, ids=lambda d: d)
def test_fused_reduce_plain_matches_reference_bitwise(shape, in_dtype, out_dtype):
    a, b = _draw(len(shape) + 7, shape, shape)
    a, b = 50.0 * a, 50.0 * b
    got = fr.fused_reduce_flat_plain(
        _torch(a, in_dtype), _torch(b, in_dtype), out_dtype=getattr(torch, out_dtype)
    )
    want = pallas_fused_reduce(
        _jax(a, in_dtype), _jax(b, in_dtype),
        out_dtype=getattr(jnp, out_dtype), interpret=True,
    )
    assert got.dtype == getattr(torch, out_dtype) and tuple(got.shape) == want.shape
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize(
    "a_dtype,b_dtype,out_dtype",
    [("bfloat16", "float32", None), ("float32", "bfloat16", "bfloat16"),
     ("float16", "bfloat16", "float32"), ("bfloat16", "float16", None)],
    ids=str,
)
def test_fused_reduce_mixed_dtypes_through_the_kernel_cast(a_dtype, b_dtype, out_dtype):
    """Mixed dtypes, as the reference takes them: the CUDA wrapper's cast
    (``kernel_operands``, both to float32) gives bitwise what the plain
    version and the reference's Pallas kernel give."""
    a, b = _draw(9, (3, 1001), (3, 1001))
    ta, tb = _torch(50.0 * a, a_dtype), _torch(50.0 * b, b_dtype)
    out = getattr(torch, out_dtype) if out_dtype else None
    ka, kb = fr.kernel_operands(ta, tb)
    assert ka.dtype == kb.dtype == torch.float32
    got = fr.fused_reduce_flat_plain(ka, kb, out_dtype=out or ta.dtype)
    plain = fr.fused_reduce_flat_plain(ta, tb, out_dtype=out)
    want = pallas_fused_reduce(
        _jax(50.0 * a, a_dtype), _jax(50.0 * b, b_dtype),
        out_dtype=getattr(jnp, out_dtype) if out_dtype else None, interpret=True,
    )
    assert got.dtype == plain.dtype == getattr(torch, out_dtype or a_dtype)
    assert torch.equal(got, plain)
    assert np.array_equal(_bits(plain), _bits(want))
    same = fr.kernel_operands(ta, ta)
    assert same[0] is ta and same[1] is ta  # one dtype: no copy


def test_reduce_bound_counts_each_operand_in_its_own_dtype():
    from repro_torch.benchmarks import roofline

    a, b = torch.zeros(1000, dtype=torch.bfloat16), torch.zeros(1000)
    ms, by = roofline.reduce_bound(a, torch.float32, b)
    assert by == "bytes"
    assert ms == pytest.approx((2000 + 4000 + 4000) / roofline.HBM_BYTES_PER_S * 1e3)
    assert roofline.reduce_bound(a, torch.bfloat16) == roofline.reduce_bound(a, torch.bfloat16, a)


def test_fused_reduce_rejects_a_shape_mismatch():
    a, b = torch.zeros(4), torch.zeros(5)
    for fn in (fr.fused_reduce_flat_plain, fr.fused_reduce_flat, ops.fused_reduce):
        with pytest.raises(ValueError, match="shape mismatch"):
            fn(a, b)
    with pytest.raises(ValueError, match="shape mismatch"):
        pallas_fused_reduce(jnp.zeros(4), jnp.zeros(5), interpret=True)


def test_fused_reduce_cuda_wrapper_refuses_cpu_tensors():
    before = fr.fused_reduce_flat.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fr.fused_reduce_flat_cuda(torch.zeros(4), torch.zeros(4))
    assert fr.fused_reduce_flat.launches == before


# ---------------------------------------------------------------------------
# The ops wrappers against the reference's.


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_rmsnorm_matches_reference(dtype):
    x, w = _draw(3, (2, 37, 160), (160,))
    for offset in (False, True):
        got = ops.rmsnorm(_torch(x, dtype), _torch(w, "float32"), eps=1e-5, offset=offset)
        want = _f32(jops.rmsnorm(
            _jax(x, dtype), jnp.asarray(w), eps=1e-5, offset=offset, interpret=True
        ))
        assert got.shape == x.shape
        np.testing.assert_allclose(_f32(got), want, rtol=0, atol=_norm_tol(dtype, want))


@pytest.mark.parametrize("in_dtype,out_dtype", [("bfloat16", None), ("bfloat16", "float32"), ("float32", None)])
def test_ops_fused_reduce_matches_reference(in_dtype, out_dtype):
    a, b = _draw(4, (128, 64), (128, 64))
    got = ops.fused_reduce(
        _torch(a, in_dtype), _torch(b, in_dtype),
        out_dtype=getattr(torch, out_dtype) if out_dtype else None,
    )
    want = jops.fused_reduce(
        _jax(a, in_dtype), _jax(b, in_dtype),
        out_dtype=getattr(jnp, out_dtype) if out_dtype else None, interpret=True,
    )
    assert tuple(got.shape) == want.shape
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 1e-2)])
def test_ops_flash_attention_matches_reference(dtype, tol):
    q, k, v = _draw(5, (2, 96, 4, 32), (2, 96, 2, 32), (2, 96, 2, 32))
    got = ops.flash_attention(*(_torch(a, dtype) for a in (q, k, v)), causal=True)
    want = jops.flash_attention(
        *(_jax(a, dtype) for a in (q, k, v)),
        causal=True, q_block=32, kv_block=32, interpret=True,
    )
    assert got.shape == q.shape and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_ops_ssd_scan_matches_reference():
    rng = np.random.default_rng(6)
    b, s, h, p, n = 2, 100, 3, 16, 8
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0.0).astype(np.float32)
    a_log = (0.5 * rng.standard_normal(h)).astype(np.float32)
    bb, cc = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    y = ops.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, a_log, bb, cc)), chunk=32)
    want = _f32(jops.ssd_scan(*(jnp.asarray(a) for a in (x, dt, a_log, bb, cc)),
                              chunk=32, interpret=True))
    assert isinstance(y, torch.Tensor) and y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(_f32(y), want, rtol=0, atol=3e-4 * max(1.0, np.abs(want).max()))


def test_ops_ssd_scan_returns_y_alone_in_x_dtype():
    rng = np.random.default_rng(7)
    b, s, h, p, n = 2, 70, 2, 16, 8
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0.0).astype(np.float32)
    a_log = (0.5 * rng.standard_normal(h)).astype(np.float32)
    bb, cc = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    rest = [torch.from_numpy(a) for a in (dt, a_log, bb, cc)]
    y = ops.ssd_scan(_torch(x, "bfloat16"), *rest, chunk=32)
    want = _f32(jops.ssd_scan(_jax(x, "bfloat16"), *(jnp.asarray(a) for a in (dt, a_log, bb, cc)),
                              chunk=32, interpret=True))
    assert isinstance(y, torch.Tensor) and y.dtype == torch.bfloat16 and y.shape == x.shape
    # The reference's scan tolerance plus the bf16 cast's rounding.
    scale = float(np.abs(want).max())
    atol = 3e-4 * scale + 2.0 ** (math.floor(math.log2(scale)) - 7)
    np.testing.assert_allclose(_f32(y), want, rtol=0, atol=atol)


def test_ops_reexports_the_kernel_wrappers():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    assert ops.flash_attention is fa.flash_attention
    assert ops.rmsnorm is rn.rmsnorm
    assert ops.fused_reduce is fr.fused_reduce_flat
    # ops.ssd_scan is the y-only wrapper of the models' scan, which also
    # returns the final state.
    x, dt, bb, cc = _draw(8, (1, 40, 2, 8), (1, 40, 2), (1, 40, 4), (1, 40, 4))
    args = [torch.from_numpy(a) for a in (x, np.logaddexp(dt, 0.0), np.zeros(2, np.float32), bb, cc)]
    y, _ = ssd.ssd_scan(*args, chunk=16)
    assert torch.equal(ops.ssd_scan(*args, chunk=16), y)


# ---------------------------------------------------------------------------
# The models' RMSNorm through the kernel's dispatcher.


def norms_per_forward(cfg) -> int:
    """RMSNorms of one forward: two per decoder or Mamba2 layer (the
    layer norm and the Mamba2 gated norm), two per shared-block call of
    the hybrid, two more per attention layer with qk-norm, and the final
    norm."""
    attn_layers = {"dense": cfg.n_layers, "vlm": cfg.n_layers, "ssm": 0,
                   "hybrid": cfg.n_layers // max(cfg.hybrid_period, 1)}[cfg.family]
    mamba_layers = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    per_attn = 4 if cfg.qk_norm else 2
    return 2 * mamba_layers + per_attn * attn_layers + 1


@pytest.mark.parametrize(
    "arch", ["qwen2_1_5b", "gemma_2b", "mamba2_130m", "zamba2_1_2b", "qwen3_4b"]
)
def test_generate_reaches_the_rmsnorm_dispatcher(arch, monkeypatch):
    calls = []
    plain = rn.rmsnorm_2d

    def spy(x, w, **kw):
        calls.append((tuple(x.shape), kw["offset"]))
        return plain(x, w, **kw)

    monkeypatch.setattr(rn, "rmsnorm_2d", spy)
    cfg = smoke_config(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    new = 3
    ServeEngine(model, params, max_len=32).generate(
        [Request(prompt=[5, 6, 7, 8], max_new_tokens=new), Request(prompt=[9] * 6, max_new_tokens=2)]
    )
    assert len(calls) == norms_per_forward(cfg) * (1 + new)
    assert {offset for _, offset in calls} == {cfg.rms_offset}


# ---------------------------------------------------------------------------
# The kernel bench.


def test_kernel_bench_gives_six_rows_on_the_cpu(capsys):
    rows = kernel_bench.run(device="cpu")
    assert [r.name for r in rows] == [
        "kernel_blocked_attention_torch",
        "kernel_flash_attention_plain",
        "kernel_ssd_scan_plain",
        "kernel_fused_reduce_plain",
        "kernel_rmsnorm_plain",
        "kernel_timing_scan_plain",
    ]
    assert all(math.isfinite(r.us) and r.us > 0 for r in rows)
    for r in rows:
        if r.err is not None:
            assert r.err <= r.tol, r
    assert rows[-1].err == 0.0  # the timing scan's CCTs equal the host executor's
    kernel_bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(",")[0] for line in lines] == [r.name for r in rows]
    assert all(len(line.split(",")) == 3 for line in lines)


def test_kernel_bench_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kernel_bench.run()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kernel_bench.main([])
