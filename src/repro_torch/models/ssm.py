"""Mamba2 (state-space duality) blocks: chunked SSD scan + decode recurrence.

The port of ``src/repro/models/ssm.py``.  The SSD recurrence per head
(state S in R^{P x N}, head dim P, state N):

    S_t = a_t * S_{t-1} + dt_t * x_t (x) B_t        a_t = exp(dt_t * A)
    y_t = C_t . S_t + D * x_t

``ssd_chunked`` evaluates it in the dual chunked form through
`repro_torch.kernels.ssd_scan` (the hand-written CUDA kernel on CUDA
tensors, its plain torch version on CPU tensors), where the reference
evaluates the same chunked form in jnp; ``ssd_reference`` is the
sequential oracle.  The decode recurrence stays plain torch, as the
reference's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_scan as ssd_lib
from repro_torch.models.common import ParamSpec, rms_norm


def ssd_reference(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)  (post-softplus)
    a_log: torch.Tensor,  # (H,) log of -A
    b: torch.Tensor,  # (B, S, N)   (single group)
    c: torch.Tensor,  # (B, S, N)
    init_state: torch.Tensor | None = None,  # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSD oracle: returns (y (B,S,H,P), final_state)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    a = -torch.exp(a_log.float())  # (H,)
    state = (
        torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
        if init_state is None
        else init_state.float()
    )
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * a)  # (B, H)
        update = torch.einsum(
            "bhp,bn->bhpn", xf[:, t] * dtf[:, t, :, None], bf[:, t]
        )
        state = state * decay[..., None, None] + update
        ys.append(torch.einsum("bhpn,bn->bhp", state, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state


# The reference's name for the chunked SSD, (y, final_state): the model
# layers call the kernel's model-layout wrapper under it.
ssd_chunked = ssd_lib.ssd_scan


def causal_conv1d(
    x: torch.Tensor,  # (B, S, C)
    weight: torch.Tensor,  # (W, C) depthwise
    bias: torch.Tensor | None = None,
    state: torch.Tensor | None = None,  # (B, W-1, C) left context
) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv; returns (y, new_state)."""
    w = weight.shape[0]
    weight = weight.to(x.dtype)
    left = (
        x.new_zeros((x.shape[0], w - 1, x.shape[2]))
        if state is None
        else state.to(x.dtype)
    )
    xp = torch.cat([left, x], dim=1)
    y = sum(xp[:, i : i + x.shape[1]] * weight[i] for i in range(w))
    if bias is not None:
        y = y + bias.to(x.dtype)
    new_state = xp[:, -(w - 1) :] if w > 1 else left
    return y, new_state


def mamba2_param_specs(
    d_model: int,
    d_inner: int,
    n_heads: int,
    d_state: int,
    d_conv: int,
) -> dict[str, ParamSpec]:
    conv_ch = d_inner + 2 * d_state
    return {
        "w_zx": ParamSpec((d_model, 2 * d_inner), ("embed", "ssm_inner2")),
        "w_bc": ParamSpec((d_model, 2 * d_state), ("embed", None)),
        "w_dt": ParamSpec((d_model, n_heads), ("embed", "ssm_heads")),
        "dt_bias": ParamSpec((n_heads,), ("ssm_heads",), init="zeros"),
        "a_log": ParamSpec((n_heads,), ("ssm_heads",), init="zeros"),
        "d_skip": ParamSpec((n_heads,), ("ssm_heads",), init="ones"),
        "conv_w": ParamSpec((d_conv, conv_ch), (None, "ssm_conv_ch")),
        "conv_b": ParamSpec((conv_ch,), ("ssm_conv_ch",), init="zeros"),
        "norm_w": ParamSpec((d_inner,), ("ssm_inner",), init="ones"),
        "w_out": ParamSpec((d_inner, d_model), ("ssm_inner", "embed")),
    }


def _split_proj(x, params, d_inner, d_state):
    zx = x @ params["w_zx"].to(x.dtype)
    z, xin = zx.chunk(2, dim=-1)
    bc = x @ params["w_bc"].to(x.dtype)
    dt_raw = x @ params["w_dt"].to(x.dtype)
    return z, xin, bc, dt_raw


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``x * (1 / (1 + exp(-x)))``, one rounding per op in x's dtype.

    The reference's ``jax.nn.silu`` on bf16, as XLA evaluates it: in bf16
    ``F.silu`` (one rounding) differs from it in ~40% of elements by one
    ulp, and the recurrent state carries such differences to the logits.
    """
    return x * (1 / (1 + torch.exp(-x)))


def _dt(dt_raw: torch.Tensor, dt_bias: torch.Tensor) -> torch.Tensor:
    """softplus(dt_raw + dt_bias) in float32."""
    return F.softplus(dt_raw.float() + dt_bias)


def mamba2_forward(
    x: torch.Tensor,  # (B, S, d_model)
    params: dict[str, torch.Tensor],
    *,
    n_heads: int,
    head_dim: int,
    d_state: int,
    chunk: int = 128,
    norm_eps: float = 1e-6,
    return_states: bool = False,
):
    """Full-sequence Mamba2 block (prefill).

    Returns ``y`` or, with ``return_states``, ``(y, conv_state,
    ssm_state)`` for handoff to the decode recurrence.
    """
    bsz, s, _ = x.shape
    d_inner = n_heads * head_dim
    z, xin, bc, dt_raw = _split_proj(x, params, d_inner, d_state)
    conv_in = torch.cat([xin, bc], dim=-1)
    conv_out, conv_state = causal_conv1d(
        conv_in, params["conv_w"], params["conv_b"]
    )
    conv_out = _silu(conv_out)
    xin = conv_out[..., :d_inner]
    b, c = conv_out[..., d_inner:].chunk(2, dim=-1)
    dt = _dt(dt_raw, params["dt_bias"])
    xh = xin.reshape(bsz, s, n_heads, head_dim)
    y, ssm_state = ssd_chunked(xh, dt, params["a_log"], b, c, chunk=chunk)
    y = y + xh * params["d_skip"].to(x.dtype)[:, None]
    y = y.reshape(bsz, s, d_inner)
    y = rms_norm(y * _silu(z), params["norm_w"], eps=norm_eps)
    out = y @ params["w_out"].to(x.dtype)
    if return_states:
        return out, conv_state, ssm_state
    return out


def mamba2_decode_step(
    x: torch.Tensor,  # (B, 1, d_model)
    params: dict[str, torch.Tensor],
    conv_state: torch.Tensor,  # (B, W-1, conv_ch)
    ssm_state: torch.Tensor,  # (B, H, P, N) fp32
    *,
    n_heads: int,
    head_dim: int,
    d_state: int,
    norm_eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token recurrence: returns (y, conv_state, ssm_state)."""
    bsz = x.shape[0]
    d_inner = n_heads * head_dim
    z, xin, bc, dt_raw = _split_proj(x, params, d_inner, d_state)
    conv_in = torch.cat([xin, bc], dim=-1)
    conv_out, conv_state = causal_conv1d(
        conv_in, params["conv_w"], params["conv_b"], state=conv_state
    )
    conv_out = _silu(conv_out)
    xin = conv_out[..., :d_inner]
    b, c = conv_out[..., d_inner:].chunk(2, dim=-1)
    dt = _dt(dt_raw, params["dt_bias"])  # (B, 1, H)
    a = -torch.exp(params["a_log"].float())
    decay = torch.exp(dt[:, 0] * a)  # (B, H)
    xh = xin.reshape(bsz, n_heads, head_dim).float()
    update = torch.einsum(
        "bhp,bn->bhpn", xh * dt[:, 0, :, None], b[:, 0].float()
    )
    ssm_state = ssm_state * decay[..., None, None] + update
    y = torch.einsum("bhpn,bn->bhp", ssm_state, c[:, 0].float())
    y = y + xh * params["d_skip"].float()[:, None]
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    y = rms_norm(y * _silu(z), params["norm_w"], eps=norm_eps)
    return y @ params["w_out"].to(x.dtype), conv_state, ssm_state
