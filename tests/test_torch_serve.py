"""The port's serving engine against the reference's, on the CPU.

Same weights (``params_from_jax``), same ragged requests (left-padded with
token 1, as both engines do), greedy decoding.  The reference's
``ServeEngine.generate`` gives the tokens; both models then re-run them
teacher-forced (prefill, then one ``decode_step`` per generated token) so
that every step's logits can be compared within atol = rtol = 0.05, and
the port's tokens must equal the reference's wherever the reference's
top-2 logit margin at that step exceeds 0.1 (below that, bf16 rounding may
flip the argmax; a request is followed only up to its first such flip).

The decoder (qwen2-1.5B smoke config) and the ssm and hybrid families
(mamba2-130m and zamba2-1.2b smoke configs, the hybrid with ``xla`` and
``pallas`` attention) are served; the launcher serves each family on the
CPU, and the ssm family reaches no attention code.

The tied embedding of the smoke model is scaled by 10, in both models
alike, so that its logits spread as a trained model's do (about +-5);
with the init's 0.02 scale they stay within +-0.5 and nearly every step
is a near-tie.  Logits are then held to 0.05 of their own scale, as in
``tests/test_torch_models.py``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models.lm import build_model as jax_build_model
from repro.serve import engine as jax_engine
from repro.sharding.rules import set_mesh_compat, single_device_context
from repro_torch.configs.registry import smoke_config
from repro_torch.launch import serve as serve_launch
from repro_torch.models.convert import params_from_jax
from repro_torch.models.lm import build_model
from repro_torch.serve.engine import Request, ServeEngine

CTX = single_device_context()
MAX_LEN = 48
MARGIN = 0.1
TOL = 0.05
EMBED_SCALE = 10.0


def _requests(vocab: int) -> list[tuple[list[int], int]]:
    rng = np.random.default_rng(7)
    return [
        (rng.integers(2, vocab, n).tolist(), new)
        for n, new in ((12, 6), (5, 4), (20, 6), (9, 5))
    ]


def _teacher_forced_logits(prefill, decode, tokens, n_steps, grow):
    """Logits before each generated token: prefill, then decode steps."""
    logits, cache = prefill({"tokens": tokens[:, : tokens.shape[1] - n_steps + 1]})
    out = [logits]
    cache = grow(cache)
    for t in range(tokens.shape[1] - n_steps + 1, tokens.shape[1]):
        logits, cache = decode(cache, tokens[:, t : t + 1])
        out.append(logits)
    return out


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_generate_matches_reference_engine(impl):
    _check_generate("qwen2_1_5b", impl)


# The ssm (Mamba2) and hybrid (Zamba2, shared attention block) families.
SSM_CASES = [
    ("mamba2_130m", "xla"),
    ("zamba2_1_2b", "xla"),
    ("zamba2_1_2b", "pallas"),
]


@pytest.mark.parametrize("arch,impl", SSM_CASES, ids=[f"{a}-{i}" for a, i in SSM_CASES])
def test_ssm_generate_matches_reference_engine(arch, impl):
    _check_generate(arch, impl)


def _check_generate(arch, impl):
    """Generate through both engines; teacher-force the reference's tokens
    through both models and compare every step."""
    jcfg = jax_smoke_config(arch).replace(attention_impl=impl)
    tcfg = smoke_config(arch).replace(attention_impl=impl)
    jmodel = jax_build_model(jcfg, CTX)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jparams = {**jparams, "embedding": jparams["embedding"] * EMBED_SCALE}
    tmodel = build_model(tcfg, device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    reqs = _requests(jcfg.vocab_size)

    jeng = jax_engine.ServeEngine(jmodel, jparams, max_len=MAX_LEN)
    with set_mesh_compat(CTX.mesh):
        want = jeng.generate(
            [jax_engine.Request(prompt=p, max_new_tokens=n) for p, n in reqs]
        )
    got = ServeEngine(tmodel, tparams, max_len=MAX_LEN).generate(
        [Request(prompt=p, max_new_tokens=n) for p, n in reqs]
    )
    assert [c.prompt for c in got] == [p for p, _ in reqs]
    assert [len(c.tokens) for c in got] == [n for _, n in reqs]

    # The reference's generated batch, teacher-forced through both models.
    max_new = max(n for _, n in reqs)
    padded = np.asarray(jeng._pad_batch(
        [jax_engine.Request(prompt=p, max_new_tokens=n) for p, n in reqs]
    )[0])
    # Requests shorter than max_new continue with token 0 in both models.
    columns = np.array([c.tokens + [0] * (max_new - len(c.tokens)) for c in want])
    full = np.concatenate([padded, columns], axis=1).astype(np.int32)
    n_steps = max_new
    with set_mesh_compat(CTX.mesh):
        jlogits = _teacher_forced_logits(
            lambda b: jax.jit(jmodel.prefill)(jparams, b),
            lambda c, t: jax.jit(jmodel.decode_step)(jparams, c, t),
            jnp.asarray(full), n_steps, lambda c: jeng._grow(c, len(reqs)),
        )
    with torch.inference_mode():
        teng = ServeEngine(tmodel, tparams, max_len=MAX_LEN)
        tlogits = _teacher_forced_logits(
            lambda b: tmodel.prefill(tparams, b),
            lambda c, t: tmodel.decode_step(tparams, c, t),
            torch.from_numpy(full), n_steps, lambda c: teng._grow(c, len(reqs)),
        )
    for step, (tl, jl) in enumerate(zip(tlogits, jlogits)):
        want_step = np.asarray(jl, np.float32)
        scale = max(1.0, float(np.abs(want_step).max()))
        np.testing.assert_allclose(
            tl.float().numpy(), want_step,
            atol=TOL * scale, rtol=TOL, err_msg=f"step {step}",
        )

    compared = 0
    for i, (g, w) in enumerate(zip(got, want)):
        for step, (gt, wt) in enumerate(zip(g.tokens, w.tokens)):
            top2 = np.sort(np.asarray(jlogits[step][i], np.float32))[-2:]
            if top2[1] - top2[0] > MARGIN:
                assert gt == wt, (i, step)
                compared += 1
            elif gt != wt:
                break  # a near-tie flipped: the continuations differ
    assert compared >= sum(n for _, n in reqs) // 2, compared


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(smoke_config("qwen2_1_5b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_launch.main([])


def test_recorder_is_not_ported():
    model = build_model(smoke_config("qwen2_1_5b"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        ServeEngine(model, {}, recorder=object())


def test_launcher_serves_on_the_cpu(capsys):
    serve_launch.main(
        ["--device", "cpu", "--requests", "3", "--max-new-tokens", "5"]
    )
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert all("prompt tokens -> [" in line for line in lines)


@pytest.mark.parametrize("arch", ["mamba2_130m", "zamba2_1_2b"])
def test_launcher_serves_ssm_families_on_the_cpu(arch, capsys):
    serve_launch.main(
        ["--arch", arch, "--device", "cpu", "--requests", "2", "--max-new-tokens", "4"]
    )
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    assert all("prompt tokens -> [" in line for line in lines)


def test_grow_keeps_states_and_grows_shared_kv():
    """``_grow`` leaves the recurrent states as they are and pads each
    shared-block invocation's KV cache to ``max_len``."""
    cfg = smoke_config("zamba2_1_2b")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with torch.inference_mode():
        _, cache = model.prefill(params, {"tokens": torch.full((2, 7), 3, dtype=torch.int32)})
    grown = ServeEngine(model, params, max_len=20)._grow(cache, 2)
    assert grown["conv"] is cache["conv"] and grown["ssm"] is cache["ssm"]
    for name in ("shared_k", "shared_v"):
        assert grown[name].shape[2] == 20
        assert torch.equal(grown[name][:, :, :7], cache[name])
        assert not grown[name][:, :, 7:].any()


def test_ssm_family_reaches_no_attention(monkeypatch):
    """mamba2 (``n_heads=0``) serves without touching any attention code."""
    from repro_torch.kernels import flash_attention as flash_lib
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import lm

    def refuse(*args, **kwargs):
        raise AssertionError("the ssm family reached attention code")

    monkeypatch.setattr(flash_lib, "flash_attention", refuse)
    monkeypatch.setattr(attn_lib, "blocked_attention", refuse)
    monkeypatch.setattr(lm, "decode_attention", refuse)
    cfg = smoke_config("mamba2_130m")
    assert cfg.n_heads == 0
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    out = ServeEngine(model, params, max_len=32).generate(
        [Request(prompt=[5, 6, 7], max_new_tokens=3), Request(prompt=[9] * 20, max_new_tokens=2)]
    )
    assert [len(c.tokens) for c in out] == [3, 2]


def test_serving_loads_neither_jax_nor_reference():
    code = """
import json, sys
from repro_torch.launch import serve
serve.main(["--device", "cpu", "--requests", "2", "--max-new-tokens", "2"])
print(json.dumps(sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "repro")
)))
"""
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, env=env, timeout=300, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
