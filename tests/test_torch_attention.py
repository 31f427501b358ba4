"""The port's attention against the reference's, on the CPU.

* ``repro_torch.kernels.flash_attention.flash_attention`` (its plain
  version on CPU tensors) against ``repro.kernels.ops.flash_attention`` --
  the Pallas kernel in interpret mode -- on the parameter grid of
  ``tests/test_kernels.py`` plus ragged Sq != Skv cases;
* ``blocked_attention`` (both ``skip_blocks``) and ``decode_attention``
  against their JAX counterparts;
* the wrapper's dispatch and input checks.

Inputs are drawn with numpy and handed to both.  Tolerances: atol = rtol
= 2e-5 in float32 (the two sum in different orders), 1e-2 in bfloat16
(one bf16 ulp of outputs of magnitude about 1), 1e-3 in float16 (one
float16 ulp there: both compute in float32 and round once).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bhsd,
    flash_attention_bhsd_cuda,
    flash_attention_bhsd_plain,
    kernel_head_dim,
    pad_head_dim,
)
from repro_torch.models import attention as tattn

TOL = {"float32": 2e-5, "bfloat16": 1e-2, "float16": 1e-3}

# (b, sq, skv, hq, hkv, d, causal, window)
FLASH_CASES = [
    (1, 128, 128, 2, 2, 32, True, None),
    (2, 96, 96, 4, 2, 16, True, None),  # GQA + ragged blocks
    (1, 64, 64, 4, 1, 32, True, None),  # MQA
    (1, 128, 128, 2, 2, 16, True, 48),  # sliding window
    (1, 80, 80, 2, 2, 16, False, None),  # bidirectional
    (1, 40, 72, 4, 2, 16, False, None),  # ragged Sq != Skv
    (2, 72, 40, 2, 1, 24, True, None),  # ragged, causal, odd head dim
]


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _pair(arrays, dtype):
    """The same values as JAX and torch arrays of ``dtype``."""
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    th = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, th


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize(
    "b,sq,skv,hq,hkv,d,causal,window", FLASH_CASES, ids=str
)
def test_flash_attention_matches_pallas_interpret(
    b, sq, skv, hq, hkv, d, causal, window, dtype
):
    arrays = _draw(0, (b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))
    (jq, jk, jv), (tq, tk, tv) = _pair(arrays, dtype)
    want = ops.flash_attention(
        jq, jk, jv, causal=causal, window=window,
        q_block=32, kv_block=32, interpret=True,
    )
    before = flash_attention_bhsd.launches
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert flash_attention_bhsd.launches == before  # CPU: the plain version
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize(
    "d,causal,window", [(36, True, None), (120, True, 40), (20, False, None)], ids=str
)
def test_head_dim_padding_with_the_true_scale_keeps_the_plain_result(d, causal, window):
    """The CUDA wrapper's zero padding of a 16-bit head dim to a multiple
    of 16, with the scale of the true D, leaves the result as it is."""
    q, k, v = (torch.from_numpy(a) for a in _draw(6, (6, 90, d), (3, 90, d), (3, 90, d)))
    dg = kernel_head_dim(d, torch.bfloat16)
    assert dg % 16 == 0 and 0 < dg - d < 16
    assert kernel_head_dim(d, torch.float32) == d
    assert kernel_head_dim(dg, torch.float16) == dg and pad_head_dim(q, d) is q
    padded = [pad_head_dim(t, dg) for t in (q, k, v)]
    assert padded[0].shape == (6, 90, dg) and not padded[0][..., d:].any()
    got = flash_attention_bhsd_plain(
        *padded, causal=causal, window=window, scale=1.0 / math.sqrt(d)
    )
    want = flash_attention_bhsd_plain(q, k, v, causal=causal, window=window)
    assert not got[..., d:].any()
    np.testing.assert_allclose(got[..., :d].numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("skip_blocks", [False, True])
@pytest.mark.parametrize(
    "sq,skv,causal,window,q_offset,dtype",
    [
        (96, 96, True, None, 0, "bfloat16"),
        (96, 96, True, 24, 0, "float32"),
        (40, 72, False, None, 0, "float32"),
        (16, 48, True, None, 32, "bfloat16"),  # prefill continuation
    ],
    ids=str,
)
def test_blocked_attention_matches_reference(
    sq, skv, causal, window, q_offset, dtype, skip_blocks
):
    arrays = _draw(2, (2, sq, 4, 16), (2, skv, 2, 16), (2, skv, 2, 16))
    (jq, jk, jv), (tq, tk, tv) = _pair(arrays, dtype)
    kw = dict(
        causal=causal, window=window, q_offset=q_offset,
        q_block=32, kv_block=32, skip_blocks=skip_blocks,
    )
    want = jax.jit(functools.partial(jattn.blocked_attention, **kw))(jq, jk, jv)
    got = tattn.blocked_attention(tq, tk, tv, **kw)
    _close(got, want, TOL[dtype])


def test_reference_attention_matches_reference():
    arrays = _draw(4, (2, 24, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16))
    (jq, jk, jv), (tq, tk, tv) = _pair(arrays, "float32")
    kw = dict(causal=True, window=9, q_offset=16)
    want = jax.jit(functools.partial(jattn.reference_attention, **kw))(
        jq, jk, jv
    )
    _close(tattn.reference_attention(tq, tk, tv, **kw), want, TOL["float32"])


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_reference(window):
    arrays = _draw(3, (3, 1, 6, 16), (3, 24, 2, 16), (3, 24, 2, 16))
    lengths = np.array([1, 13, 24], np.int32)
    for dtype in ("float32", "bfloat16"):
        (jq, jk, jv), (tq, tk, tv) = _pair(arrays, dtype)
        want = jax.jit(
            functools.partial(jattn.decode_attention, window=window)
        )(jq, jk, jv, jnp.asarray(lengths))
        got = tattn.decode_attention(
            tq, tk, tv, torch.from_numpy(lengths), window=window
        )
        _close(got, want, TOL[dtype])


def test_cuda_launcher_refuses_cpu_tensors():
    q, k, v = (torch.zeros(2, 8, 16) for _ in range(3))
    before = flash_attention_bhsd.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bhsd_cuda(q, k, v)
    assert flash_attention_bhsd.launches == before


@pytest.mark.parametrize(
    "corrupt", ["rank", "group", "head_dim", "dtype", "mixed_dtype", "window"]
)
def test_wrapper_rejects_malformed_inputs(corrupt):
    q, k, v = torch.zeros(4, 8, 16), torch.zeros(2, 8, 16), torch.zeros(2, 8, 16)
    window = None
    if corrupt == "rank":
        q = q[None]
    elif corrupt == "group":
        q = torch.zeros(3, 8, 16)
    elif corrupt == "head_dim":
        k = torch.zeros(2, 8, 8)
    elif corrupt == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif corrupt == "mixed_dtype":
        k = k.bfloat16()
    else:
        window = 0
    with pytest.raises(ValueError):
        flash_attention_bhsd(q, k, v, window=window)
