"""The port's models against the reference's, on the CPU.

Both models get the same weights: the reference's ``init_params`` draws
them and ``repro_torch.models.convert.params_from_jax`` hands them to the
port.  On 2-layer smoke configs of ``qwen2_1_5b`` (GQA, QKV bias, tied
embeddings) and of ``h2o_danube3_4b`` (sliding window 16, untied head),
with ``attention_impl`` ``xla`` and ``pallas`` (the reference's Pallas
kernel in interpret mode, the port's plain flash attention), prefill
logits and KV cache agree, then 4 teacher-forced ``decode_step``s agree at
every step.  The same holds for the smoke configs of ``mamba2_130m`` (2
Mamba2 layers) and ``zamba2_1_2b`` (2 groups of 2 Mamba2 layers around the
shared attention block, then 1), the hybrid with both attentions, their
conv and SSM state caches included.

Tolerances.  In bf16 compute (the models' own) the two frameworks round
products and sums at different places.  Logits are held to atol = rtol =
0.05 -- the reference's own prefill/decode tolerance
(``tests/test_models_smoke.py``) -- scaled by the logits' magnitude where
that exceeds 1: the untied head gives logits up to ~3.5, where one bf16
ulp is 0.0156 and the two frameworks differ by up to ~0.12.  The KV
caches hold values up to ~20 (one bf16 ulp: 0.125); the first layer's are
equal, the later layers' are held within 0.05 of the cache's own scale.
With the compute dtype set to float32 in both packages the models agree
to 1e-4, which pins the semantics independently of bf16 rounding.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import common as jax_common
from repro.models import lm as jax_lm
from repro.models import transformer as jax_tfm
from repro.models.lm import build_model as jax_build_model
from repro.sharding.rules import set_mesh_compat, single_device_context
from repro_torch.configs.registry import smoke_config
from repro_torch.models.common import param_count, tree_leaves, tree_map
from repro_torch.models.convert import params_from_jax
from repro_torch.models import common, lm
from repro_torch.models import transformer as tfm
from repro_torch.models.lm import build_model

CTX = single_device_context()
ARCHS = ("qwen2_1_5b", "h2o_danube3_4b")
BATCH, PROMPT, N_DECODE = 2, 40, 4
TOL = 0.05


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, what, scale=1.0, tol=TOL):
    np.testing.assert_allclose(
        _f32(got), _f32(want), atol=tol * scale, rtol=tol, err_msg=what
    )


def _scale(logits) -> float:
    return max(1.0, float(np.abs(_f32(logits)).max()))


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    """(arch, JAX params, the same params as the port's tree)."""
    cfg = jax_smoke_config(request.param)
    params = jax_build_model(cfg, CTX).init(jax.random.PRNGKey(0))
    return request.param, params, params_from_jax(
        jax.tree.map(np.asarray, params)
    )


def test_params_from_jax_gives_the_port_tree(weights):
    arch, jparams, tparams = weights
    specs = build_model(smoke_config(arch), device="cpu").specs
    shapes = tree_map(lambda s: s.shape, specs)
    assert tree_map(lambda t: tuple(t.shape), tparams) == shapes
    assert all(t.dtype == torch.float32 for t in tree_leaves(tparams))
    assert sum(t.numel() for t in tree_leaves(tparams)) == param_count(specs)
    for got, want in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
        assert np.array_equal(got.numpy(), np.asarray(want))


def _grow(cache: dict, slots: int, pad):
    """Pad prefill-sized KV caches to ``slots`` (a ring cache has them)."""
    out = dict(cache)
    for name in ("k", "v"):
        extra = slots - cache[name].shape[2]
        if extra > 0:
            out[name] = pad(cache[name], extra)
    return out


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_and_decode_match_reference(weights, impl):
    arch, jparams, tparams = weights
    jcfg = jax_smoke_config(arch).replace(attention_impl=impl)
    tcfg = smoke_config(arch).replace(attention_impl=impl)
    jmodel = jax_build_model(jcfg, CTX)
    tmodel = build_model(tcfg, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(2, jcfg.vocab_size, (BATCH, PROMPT + N_DECODE))
    tokens = tokens.astype(np.int32)

    with set_mesh_compat(CTX.mesh):
        jlogits, jcache = jax.jit(jmodel.prefill)(
            jparams, {"tokens": jnp.asarray(tokens[:, :PROMPT])}
        )
    with torch.inference_mode():
        tlogits, tcache = tmodel.prefill(
            tparams, {"tokens": torch.from_numpy(tokens[:, :PROMPT])}
        )
    assert tlogits.dtype == torch.bfloat16
    _close(tlogits, jlogits, f"{arch}/{impl} prefill logits", _scale(jlogits))
    for name in ("k", "v"):
        assert tuple(tcache[name].shape) == jcache[name].shape
        want = _f32(jcache[name])
        assert np.array_equal(_f32(tcache[name][0]), want[0]), name
        _close(
            tcache[name], want, f"{arch}/{impl} prefill cache {name}",
            scale=float(np.abs(want).max()),
        )
    assert np.array_equal(tcache["length"].numpy(), np.asarray(jcache["length"]))

    slots = tmodel.cache_specs(BATCH, PROMPT + N_DECODE)["k"].shape[2]
    jcache = _grow(
        jcache, slots,
        lambda x, n: jnp.pad(x, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0))),
    )
    tcache = _grow(
        tcache, slots,
        lambda x, n: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n)),
    )
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(PROMPT, PROMPT + N_DECODE):
        step = tokens[:, t : t + 1]
        with set_mesh_compat(CTX.mesh):
            jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(step))
        with torch.inference_mode():
            tlogits, tcache = tmodel.decode_step(
                tparams, tcache, torch.from_numpy(step)
            )
        _close(tlogits, jlogits, f"{arch}/{impl} decode at {t}", _scale(jlogits))
        assert np.array_equal(
            tcache["length"].numpy(), np.asarray(jcache["length"])
        )


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_float32_compute_matches_reference(weights, impl, monkeypatch):
    arch, jparams, tparams = weights
    monkeypatch.setattr(jax_lm, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(lm, "COMPUTE_DTYPE", torch.float32)
    jmodel = jax_build_model(jax_smoke_config(arch).replace(attention_impl=impl), CTX)
    tmodel = build_model(smoke_config(arch).replace(attention_impl=impl), device="cpu")
    tokens = np.random.default_rng(1).integers(2, 256, (BATCH, PROMPT + 2))
    tokens = tokens.astype(np.int32)
    with set_mesh_compat(CTX.mesh):
        jlogits, jcache = jax.jit(jmodel.prefill)(
            jparams, {"tokens": jnp.asarray(tokens[:, :PROMPT])}
        )
    with torch.inference_mode():
        tlogits, tcache = tmodel.prefill(
            tparams, {"tokens": torch.from_numpy(tokens[:, :PROMPT])}
        )
    assert tlogits.dtype == torch.float32
    _close(tlogits, jlogits, "f32 prefill logits", tol=1e-4)
    for name in ("k", "v"):
        want = _f32(jcache[name])
        _close(tcache[name], want, name, float(np.abs(want).max()), tol=1e-4)
    slots = tmodel.cache_specs(BATCH, PROMPT + 2)["k"].shape[2]
    jcache = _grow(
        jcache, slots,
        lambda x, n: jnp.pad(x, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0))),
    )
    tcache = _grow(
        tcache, slots,
        lambda x, n: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n)),
    )
    for t in range(PROMPT, PROMPT + 2):
        step = tokens[:, t : t + 1]
        with set_mesh_compat(CTX.mesh):
            jlogits, jcache = jax.jit(jmodel.decode_step)(
                jparams, jcache, jnp.asarray(step)
            )
        with torch.inference_mode():
            tlogits, tcache = tmodel.decode_step(
                tparams, tcache, torch.from_numpy(step)
            )
        _close(tlogits, jlogits, f"f32 decode at {t}", tol=1e-4)


def _arrays_as(convert, tree):
    if isinstance(tree, dict):
        return {k: _arrays_as(convert, v) for k, v in tree.items()}
    return convert(tree) if isinstance(tree, np.ndarray) else tree


def _block_inputs():
    rng = np.random.default_rng(5)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    cfg = smoke_config("qwen2_1_5b")
    return {
        "x": draw(2, 24, 48), "w": draw(48), "b": draw(48),
        "qk": draw(2, 24, 3, 16), "pos": np.arange(24, dtype=np.int32),
        "mlp": {
            "w_in": draw(48, 96), "b_in": draw(96),
            "w_out": draw(96, 48), "b_out": draw(48),
        },
        "attn": {
            "wq": draw(48, 3, 16), "wk": draw(48, 1, 16), "wv": draw(48, 1, 16),
            "wo": draw(3, 16, 48), "bq": draw(3, 16), "bk": draw(1, 16),
            "bv": draw(1, 16), "q_norm": draw(16), "k_norm": draw(16),
        },
        "cfg": cfg.replace(qk_norm=True),
    }


BLOCKS = {
    "rms_norm_offset": lambda m, a: m.rms_norm(a["x"], a["w"], offset=True),
    "layer_norm": lambda m, a: m.layer_norm(a["x"], a["w"], a["b"]),
    "gelu": lambda m, a: m.activation("gelu")(a["x"]),
    "silu": lambda m, a: m.activation("silu")(a["x"]),
    "rope": lambda m, a: m.apply_rope(
        a["qk"], *m.rope_frequencies(16, 1e4, a["pos"])
    ),
}
TRANSFORMER_BLOCKS = {
    "mlp_fwd": lambda t, a: t.mlp_fwd(a["mlp"], a["x"], "gelu"),
    "self_attention_bidirectional": lambda t, a: t.self_attention_fwd(
        a["attn"], a["x"], a["cfg"], causal=False
    ),
}


@pytest.mark.parametrize("name", sorted(BLOCKS) + sorted(TRANSFORMER_BLOCKS))
def test_building_blocks_match_reference(name):
    """Float32 numerics of common.py / transformer.py pieces no decoder
    test reaches (layer norm, GeGLU MLP, offset RMSNorm, qk-norm,
    bidirectional attention), within 1e-5."""
    arrays = _block_inputs()
    jargs, targs = _arrays_as(jnp.asarray, arrays), _arrays_as(torch.from_numpy, arrays)
    if name in BLOCKS:
        want = BLOCKS[name](jax_common, jargs)
        got = BLOCKS[name](common, targs)
    else:
        jargs["cfg"] = jax_smoke_config("qwen2_1_5b").replace(qk_norm=True)
        want = TRANSFORMER_BLOCKS[name](jax_tfm, jargs)
        got = TRANSFORMER_BLOCKS[name](tfm, targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "arch,what",
    [
        ("qwen2_moe_a2_7b", "moe"),
        ("llama4_scout_17b_16e", "moe"),
        ("whisper_small", "audio"),
    ],
)
def test_families_not_ported_raise(arch, what):
    with pytest.raises(NotImplementedError, match=what):
        build_model(smoke_config(arch), device="cpu")


def test_sequence_parallel_raises():
    cfg = smoke_config("qwen2_1_5b").replace(sequence_parallel=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        build_model(cfg, device="cpu")


# ---------------------------------------------------------------------------
# The ssm (Mamba2) and hybrid (Zamba2) families: the smoke configs of
# ``mamba2_130m`` (2 Mamba2 layers) and ``zamba2_1_2b`` (5 Mamba2 layers in
# 2 groups of 2 around the shared attention block, then 1 trailing layer).
# Prefill logits and caches, then 4 teacher-forced decode steps, at the
# tolerances above; the hybrid with ``xla`` and ``pallas`` attention.

SSM_CASES = [
    ("mamba2_130m", "xla"),
    ("zamba2_1_2b", "xla"),
    ("zamba2_1_2b", "pallas"),
]


@functools.cache
def _ssm_weights(arch):
    """(JAX params, the same params as the port's tree)."""
    params = jax_build_model(jax_smoke_config(arch), CTX).init(jax.random.PRNGKey(0))
    return params, params_from_jax(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("arch", ["mamba2_130m", "zamba2_1_2b"])
def test_params_from_jax_carries_ssm_trees(arch):
    """Mamba2 leaves, and the hybrid's doubly stacked ``groups``, its
    ``trailing`` stack and its ``shared`` block, convert leaf for leaf."""
    jparams, tparams = _ssm_weights(arch)
    cfg = smoke_config(arch)
    specs = build_model(cfg, device="cpu").specs
    assert tree_map(lambda t: tuple(t.shape), tparams) == tree_map(
        lambda s: s.shape, specs
    )
    assert sum(t.numel() for t in tree_leaves(tparams)) == param_count(specs)
    for got, want in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.asarray(want))
    d_inner, heads = cfg.d_inner, cfg.n_ssm_heads
    if arch == "mamba2_130m":
        mamba = tparams["layers"]["mamba"]
        assert tuple(mamba["w_zx"].shape) == (cfg.n_layers, cfg.d_model, 2 * d_inner)
    else:
        groups, trailing = lm._hybrid_layout(cfg)
        mamba = tparams["groups"]["mamba"]
        assert tuple(mamba["w_zx"].shape) == (
            groups, cfg.hybrid_period, cfg.d_model, 2 * d_inner
        )
        assert tuple(tparams["trailing"]["mamba"]["a_log"].shape) == (trailing, heads)
        assert set(tparams["shared"]) == {"ln1", "attn", "ln2", "ffn"}
    assert tuple(mamba["a_log"].shape[-1:]) == (heads,)


def _grow_shared(cache: dict, slots: int, pad):
    out = dict(cache)
    for name in ("shared_k", "shared_v"):
        if name in cache:
            out[name] = pad(cache[name], slots - cache[name].shape[2])
    return out


def _jax_pad_seq(x, n):
    return jnp.pad(x, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0)))


def _torch_pad_seq(x, n):
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n))


def _run_ssm_models(arch, impl, jparams, tparams, tokens, prompt, n_decode):
    """Prefill ``tokens[:, :prompt]`` and teacher-force ``n_decode`` steps
    through both models; returns the per-step (port, reference) logits
    and the two prefill caches."""
    jmodel = jax_build_model(jax_smoke_config(arch).replace(attention_impl=impl), CTX)
    tmodel = build_model(smoke_config(arch).replace(attention_impl=impl), device="cpu")
    with set_mesh_compat(CTX.mesh):
        jlogits, jcache = jax.jit(jmodel.prefill)(
            jparams, {"tokens": jnp.asarray(tokens[:, :prompt])}
        )
    with torch.inference_mode():
        tlogits, tcache = tmodel.prefill(
            tparams, {"tokens": torch.from_numpy(tokens[:, :prompt])}
        )
    # Copies: the port's decode steps update its cache in place.
    caches = (
        {k: np.array(_f32(v)) for k, v in tcache.items()},
        {k: np.array(_f32(v)) for k, v in jcache.items()},
    )
    steps = [(tlogits, jlogits)]
    slots = prompt + n_decode
    jcache = _grow_shared(jcache, slots, _jax_pad_seq)
    tcache = _grow_shared(tcache, slots, _torch_pad_seq)
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(prompt, prompt + n_decode):
        step = tokens[:, t : t + 1]
        with set_mesh_compat(CTX.mesh):
            jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(step))
        with torch.inference_mode():
            tlogits, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(step))
        assert np.array_equal(tcache["length"].numpy(), np.asarray(jcache["length"]))
        steps.append((tlogits, jlogits))
    return steps, caches


@pytest.mark.parametrize("arch,impl", SSM_CASES, ids=[f"{a}-{i}" for a, i in SSM_CASES])
def test_ssm_prefill_and_decode_match_reference(arch, impl):
    jparams, tparams = _ssm_weights(arch)
    tokens = np.random.default_rng(0).integers(2, 256, (BATCH, PROMPT + N_DECODE))
    tokens = tokens.astype(np.int32)
    steps, (tcache, jcache) = _run_ssm_models(
        arch, impl, jparams, tparams, tokens, PROMPT, N_DECODE
    )
    assert steps[0][0].dtype == torch.bfloat16
    for i, (tl, jl) in enumerate(steps):
        _close(tl, jl, f"{arch}/{impl} step {i} logits", _scale(jl))
    assert set(tcache) == set(jcache)
    for name in sorted(set(tcache) - {"length"}):
        assert tcache[name].shape == jcache[name].shape, name
        _close(
            tcache[name], jcache[name], f"{arch}/{impl} prefill cache {name}",
            scale=max(1.0, float(np.abs(jcache[name]).max())),
        )
    assert np.array_equal(tcache["length"], jcache["length"])


@pytest.mark.parametrize("arch,impl", SSM_CASES, ids=[f"{a}-{i}" for a, i in SSM_CASES])
def test_ssm_float32_compute_matches_reference(arch, impl, monkeypatch):
    """With the compute dtype float32 in both packages: logits and caches
    within 1e-4, prefill and 2 decode steps."""
    jparams, tparams = _ssm_weights(arch)
    monkeypatch.setattr(jax_lm, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(lm, "COMPUTE_DTYPE", torch.float32)
    tokens = np.random.default_rng(1).integers(2, 256, (BATCH, PROMPT + 2))
    tokens = tokens.astype(np.int32)
    steps, (tcache, jcache) = _run_ssm_models(
        arch, impl, jparams, tparams, tokens, PROMPT, 2
    )
    assert steps[0][0].dtype == torch.float32
    for i, (tl, jl) in enumerate(steps):
        _close(tl, jl, f"f32 {arch}/{impl} step {i}", tol=1e-4)
    for name in sorted(set(tcache) - {"length"}):
        want = jcache[name]
        _close(tcache[name], want, name, max(1.0, float(np.abs(want).max())), tol=1e-4)
