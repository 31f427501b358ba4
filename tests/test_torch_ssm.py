"""The port's SSD scan and Mamba2 blocks against the reference's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages.

* ``ssd_scan_bhsp_plain`` (the CUDA kernel's plain version) against the
  reference's Pallas ``ssd_scan_bhsp`` in interpret mode, on the
  chunk x length grid of ``tests/test_kernels.py`` and with S < chunk,
  within atol 3e-4 (the reference's own kernel tolerance); its final state
  against the sequential oracle's.
* ``ssd_chunked`` against the reference's ``ssd_chunked`` and
  ``ssd_reference``: ``y`` and the final state, whole and split in two
  calls with the state carried over (``tests/test_ssm.py``).
* ``causal_conv1d`` with its carried state, ``mamba2_forward`` (with its
  returned states) and ``mamba2_decode_step`` against the reference with
  the same params, and the port's own forward-vs-decode equivalence
  (atol 2e-4, as ``tests/test_ssm.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan_bhsp as pallas_ssd_scan_bhsp
from repro.models import ssm as jax_ssm
from repro_torch.kernels import ssd_scan as ssd_lib
from repro_torch.models import ssm

ATOL = 3e-4


def _inputs(seed, b, s, h, p, n):
    """x, dt (post-softplus), a_log, b, c as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0.0)
    a_log = rng.standard_normal(h) * 0.5
    bb = rng.standard_normal((b, s, n))
    cc = rng.standard_normal((b, s, n))
    return tuple(v.astype(np.float32) for v in (x, dt, a_log, bb, cc))


def _head_major(x, dt, a_log):
    """The kernel's pre-scaled (BH, S, *) inputs, as ``ops.ssd_scan``."""
    b, s, h, p = x.shape
    a = -np.exp(a_log)
    xdt = (x * dt[..., None]).transpose(0, 2, 1, 3).reshape(b * h, s, p)
    logd = (dt * a).transpose(0, 2, 1).reshape(b * h, s, 1)
    return xdt.astype(np.float32), logd.astype(np.float32)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, err_msg=what)


@pytest.mark.parametrize("chunk", [16, 32, 128])
@pytest.mark.parametrize("s", [64, 100])
def test_plain_scan_matches_pallas_kernel(chunk, s):
    b, h, p, n = 2, 3, 8, 16
    x, dt, a_log, bb, cc = _inputs(2, b, s, h, p, n)
    xdt, logd = _head_major(x, dt, a_log)
    # The Pallas kernel takes B and C broadcast over heads; the port's
    # plain version reads row bh // n_heads.
    bbm = np.broadcast_to(bb[:, None], (b, h, s, n)).reshape(b * h, s, n)
    ccm = np.broadcast_to(cc[:, None], (b, h, s, n)).reshape(b * h, s, n)
    want = pallas_ssd_scan_bhsp(
        jnp.asarray(xdt), jnp.asarray(logd), jnp.asarray(bbm), jnp.asarray(ccm),
        chunk=chunk, interpret=True,
    )
    y, state = ssd_lib.ssd_scan_bhsp_plain(
        *_t(xdt, logd, bb, cc), n_heads=h, chunk=chunk
    )
    assert y.shape == (b * h, s, p) and y.dtype == torch.float32
    _close(y, want, what="y")
    _, want_state = jax_ssm.ssd_reference(*map(jnp.asarray, (x, dt, a_log, bb, cc)))
    _close(state.reshape(b, h, p, n), want_state, what="final state")


@pytest.mark.parametrize("s,chunk", [(37, 128), (5, 16)])
def test_plain_scan_shorter_than_a_chunk(s, chunk):
    b, h, p, n = 1, 2, 8, 16
    x, dt, a_log, bb, cc = _inputs(3, b, s, h, p, n)
    xdt, logd = _head_major(x, dt, a_log)
    bbm = np.broadcast_to(bb[:, None], (b, h, s, n)).reshape(b * h, s, n)
    ccm = np.broadcast_to(cc[:, None], (b, h, s, n)).reshape(b * h, s, n)
    want = pallas_ssd_scan_bhsp(
        *map(jnp.asarray, (xdt, logd, bbm, ccm)), chunk=chunk, interpret=True
    )
    y, _ = ssd_lib.ssd_scan_bhsp_plain(*_t(xdt, logd, bb, cc), n_heads=h, chunk=chunk)
    _close(y, want)


@pytest.mark.parametrize("chunk", [4, 16, 37, 128])
def test_ssd_chunked_matches_reference(chunk):
    """y and the final state against the reference's chunked form and its
    sequential oracle (the shapes of ``tests/test_ssm.py``)."""
    arrays = _inputs(0, 2, 37, 3, 8, 16)
    jargs = tuple(map(jnp.asarray, arrays))
    y, state = ssm.ssd_chunked(*_t(*arrays), chunk=chunk)
    jy, jstate = jax_ssm.ssd_chunked(*jargs, chunk=chunk)
    ry, rstate = jax_ssm.ssd_reference(*jargs)
    assert y.shape == (2, 37, 3, 8) and state.shape == (2, 3, 8, 16)
    for want, what in ((jy, "chunked y"), (ry, "oracle y")):
        _close(y, want, what=what)
    for want, what in ((jstate, "chunked state"), (rstate, "oracle state")):
        _close(state, want, what=what)
    oy, ostate = ssm.ssd_reference(*_t(*arrays))
    _close(oy, ry, what="port oracle y")
    _close(ostate, rstate, what="port oracle state")


@pytest.mark.parametrize("impl", ["chunked", "reference"])
def test_initial_state_carryover(impl):
    """Splitting a sequence across two calls == one call, and the second
    call's y and state equal the reference's given the same init state."""
    x, dt, a_log, bb, cc = _inputs(1, 1, 32, 2, 4, 8)
    if impl == "chunked":
        fn = lambda *a, init_state=None: ssm.ssd_chunked(  # noqa: E731
            *a, chunk=8, init_state=init_state
        )
    else:
        fn = ssm.ssd_reference
    full_y, full_state = fn(*_t(x, dt, a_log, bb, cc))
    y1, st1 = fn(*_t(x[:, :16], dt[:, :16], a_log, bb[:, :16], cc[:, :16]))
    y2, st2 = fn(
        *_t(x[:, 16:], dt[:, 16:], a_log, bb[:, 16:], cc[:, 16:]), init_state=st1
    )
    _close(torch.cat([y1, y2], dim=1), full_y, atol=2e-4)
    _close(st2, full_state, atol=2e-4)
    jy2, jst2 = jax_ssm.ssd_chunked(
        *map(jnp.asarray, (x[:, 16:], dt[:, 16:], a_log, bb[:, 16:], cc[:, 16:])),
        chunk=8, init_state=jnp.asarray(st1.numpy()),
    )
    _close(y2, jy2, atol=2e-4)
    _close(st2, jst2, atol=2e-4)


@pytest.mark.parametrize("with_bias", [True, False])
def test_causal_conv_state_continuation(with_bias):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 20, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32) if with_bias else None
    tx, tw = _t(x, w)
    tb = None if bias is None else torch.from_numpy(bias)
    jb = None if bias is None else jnp.asarray(bias)
    y_full, st_full = ssm.causal_conv1d(tx, tw, tb)
    y1, st = ssm.causal_conv1d(tx[:, :11], tw, tb)
    y2, st2 = ssm.causal_conv1d(tx[:, 11:], tw, tb, state=st)
    _close(torch.cat([y1, y2], dim=1), y_full, atol=1e-5)
    _close(st2, st_full, atol=0)
    jy, jst = jax_ssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jb)
    _close(y_full, jy, atol=1e-5)
    _close(st_full, jst, atol=0)
    jy2, _ = jax_ssm.causal_conv1d(
        jnp.asarray(x[:, 11:]), jnp.asarray(w), jb, state=jnp.asarray(st.numpy())
    )
    _close(y2, jy2, atol=1e-5)


D_MODEL, N_HEADS, HEAD_DIM, D_STATE = 32, 4, 8, 16


@pytest.fixture(scope="module")
def block():
    """Mamba2 block params (numpy, from a seed, with nonzero biases and
    decay rates), the same as JAX arrays and torch tensors, and an input."""
    specs = jax_ssm.mamba2_param_specs(
        D_MODEL, N_HEADS * HEAD_DIM, N_HEADS, D_STATE, 4
    )
    rng = np.random.default_rng(5)
    params = {
        k: (rng.standard_normal(s.shape) / np.sqrt(max(s.shape[0], 1))).astype(np.float32)
        for k, s in specs.items()
    }
    params["d_skip"] = params["d_skip"] + 1.0
    params["norm_w"] = params["norm_w"] + 1.0
    x = rng.standard_normal((2, 12, D_MODEL)).astype(np.float32)
    return (
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: torch.from_numpy(v) for k, v in params.items()},
        x,
    )


DIMS = dict(n_heads=N_HEADS, head_dim=HEAD_DIM, d_state=D_STATE)


@pytest.mark.parametrize("chunk", [4, 128])
def test_mamba2_forward_matches_reference(block, chunk):
    jparams, tparams, x = block
    want, jconv, jssm = jax_ssm.mamba2_forward(
        jnp.asarray(x), jparams, chunk=chunk, return_states=True, **DIMS
    )
    got, conv, state = ssm.mamba2_forward(
        torch.from_numpy(x), tparams, chunk=chunk, return_states=True, **DIMS
    )
    _close(got, want, atol=1e-4, what="y")
    _close(conv, jconv, atol=1e-6, what="conv state")
    _close(state, jssm, atol=1e-4, what="ssm state")
    assert ssm.mamba2_forward(torch.from_numpy(x), tparams, chunk=chunk, **DIMS).shape == got.shape


def test_mamba2_decode_step_matches_reference(block):
    jparams, tparams, x = block
    rng = np.random.default_rng(6)
    conv0 = rng.standard_normal((2, 3, N_HEADS * HEAD_DIM + 2 * D_STATE)).astype(np.float32)
    ssm0 = rng.standard_normal((2, N_HEADS, HEAD_DIM, D_STATE)).astype(np.float32)
    want = jax_ssm.mamba2_decode_step(
        jnp.asarray(x[:, :1]), jparams, jnp.asarray(conv0), jnp.asarray(ssm0), **DIMS
    )
    got = ssm.mamba2_decode_step(
        torch.from_numpy(x[:, :1]), tparams, *_t(conv0, ssm0), **DIMS
    )
    for g, w, what in zip(got, want, ("y", "conv state", "ssm state")):
        _close(g, w, atol=1e-5, what=what)


def test_block_forward_decode_equivalence(block):
    """The port's prefill block == its token-by-token decode recurrence."""
    _, tparams, x = block
    tx = torch.from_numpy(x)
    y_full = ssm.mamba2_forward(tx, tparams, chunk=4, **DIMS)
    conv_state = torch.zeros((2, 3, N_HEADS * HEAD_DIM + 2 * D_STATE))
    ssm_state = torch.zeros((2, N_HEADS, HEAD_DIM, D_STATE))
    ys = []
    for t in range(12):
        y_t, conv_state, ssm_state = ssm.mamba2_decode_step(
            tx[:, t : t + 1], tparams, conv_state, ssm_state, **DIMS
        )
        ys.append(y_t)
    _close(torch.cat(ys, dim=1), y_full, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_layout_wrapper(dtype):
    """``ssd_scan`` folds heads, keeps x's dtype for y and returns a float32
    (B, H, P, N) state, equal to the head-major scan it wraps."""
    x, dt, a_log, bb, cc = _inputs(4, 2, 50, 3, 8, 16)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    y, state = ssd_lib.ssd_scan(tx, *_t(dt, a_log, bb, cc), chunk=16)
    assert y.dtype == tx.dtype and y.shape == tx.shape
    assert state.dtype == torch.float32 and state.shape == (2, 3, 8, 16)
    xdt, logd = _head_major(tx.float().numpy(), dt, a_log)
    want_y, want_state = ssd_lib.ssd_scan_bhsp_plain(
        *_t(xdt, logd, bb, cc), n_heads=3, chunk=16
    )
    want_y = want_y.reshape(2, 3, 50, 8).transpose(1, 2).to(tx.dtype)
    _close(y, want_y, atol=1e-5 if dtype == "float32" else 0.05)
    _close(state, want_state.reshape(2, 3, 8, 16), atol=1e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, dt, a_log, bb, cc = _inputs(0, 1, 8, 2, 4, 4)
    xdt, logd = _head_major(x, dt, a_log)
    args = _t(xdt, logd, bb, cc)
    with pytest.raises(ValueError, match="heads"):
        ssd_lib.ssd_scan_bhsp(*args, n_heads=3)
    with pytest.raises(ValueError, match="float32"):
        ssd_lib.ssd_scan_bhsp(args[0].double(), *args[1:], n_heads=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_lib.ssd_scan_bhsp_cuda(*args, n_heads=2)
    before = ssd_lib.ssd_scan_bhsp.launches
    ssd_lib.ssd_scan_bhsp(*args, n_heads=2)
    assert ssd_lib.ssd_scan_bhsp.launches == before  # CPU: the plain version
