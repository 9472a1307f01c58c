"""PyTorch port, model: paddle_tpu_torch.models.gpt_decode held against
paddle_tpu.models.gpt_decode on the CPU at tiny size.

The JAX side builds the tiny GPT through build_lm_program, runs its
startup program and reads the weights with params_from_scope, as
tests/test_pallas_kernels.py does; the port gets the same arrays through
params_from_numpy.

Tolerances: f32 logits and caches atol 1e-5 (different summation orders
in the two frameworks' matmuls); greedy tokens identical; bf16 first-step
logits atol 5e-2 (bf16 activations carry 8 bits of mantissa through two
blocks; logits of the tiny model are O(1)).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as fluid

from paddle_tpu_torch.models import gpt_decode as port_decode
from paddle_tpu_torch.models.gpt import GPTConfig as PortGPTConfig


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, jax params, port cfg, numpy arrays)."""
    from paddle_tpu.models.gpt import GPTConfig, build_lm_program
    from paddle_tpu.models import gpt_decode
    from paddle_tpu.testing import reset_programs
    reset_programs(seed=0)
    cfg = GPTConfig.tiny()
    build_lm_program(cfg)
    exe = fluid.Executor()
    exe.run(fluid.default_startup_program())
    params = gpt_decode.params_from_scope(cfg)
    port_cfg = PortGPTConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(PortGPTConfig)})
    arrays = {n: np.asarray(a) for n, a in params.items()}
    return cfg, params, port_cfg, arrays


def _port_params(tiny, dtype=None):
    _, _, port_cfg, arrays = tiny
    return port_decode.params_from_numpy(port_cfg, arrays, dtype=dtype,
                                         device="cpu")


def _prompt(cfg, b, s, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_params_from_numpy_names_and_dtypes(tiny):
    _, params, port_cfg, arrays = tiny
    p32 = _port_params(tiny)
    assert set(p32) == set(params)
    for n, t in p32.items():
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), arrays[n])
    p16 = _port_params(tiny, "bfloat16")
    assert p16["wte"].dtype == torch.bfloat16
    assert p16["dec0_ln1_scale"].dtype == torch.float32   # LN stays f32
    missing = dict(arrays)
    del missing["wpe"]
    with pytest.raises(KeyError, match="wpe"):
        port_decode.params_from_numpy(port_cfg, missing, device="cpu")


def test_prefill_matches_jax(tiny):
    """Padded prompt (prompt_len < Sp): caches hold the real positions,
    pad positions are zero, last-position logits agree."""
    from paddle_tpu.models import gpt_decode as jax_decode
    cfg, params, port_cfg, _ = tiny
    prompt = _prompt(cfg, 2, 7)
    jk, jv, jlog = jax_decode.prefill(params, cfg, jnp.asarray(prompt),
                                      jnp.int32(5), 16)
    tk, tv, tlog = port_decode.prefill(
        _port_params(tiny), port_cfg, torch.from_numpy(prompt).long(), 5,
        16)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5,
                               rtol=0)
    for i in range(cfg.num_layers):
        np.testing.assert_allclose(tk[i].numpy(), np.asarray(jk[i]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(tv[i].numpy(), np.asarray(jv[i]),
                                   atol=1e-5, rtol=0)
        assert not tk[i][:, :, 5:].any()


def test_decode_step_matches_jax(tiny):
    from paddle_tpu.models import gpt_decode as jax_decode
    cfg, params, port_cfg, _ = tiny
    prompt = _prompt(cfg, 2, 6, seed=1)
    p = _port_params(tiny)
    jk, jv, _ = jax_decode.prefill(params, cfg, jnp.asarray(prompt),
                                   jnp.int32(6), 12)
    tk, tv, _ = port_decode.prefill(p, port_cfg,
                                    torch.from_numpy(prompt).long(), 6, 12)
    tok = np.array([3, 11], np.int32)
    for step in range(3):
        jk, jv, jlog = jax_decode.decode_step(params, cfg, jk, jv,
                                              jnp.asarray(tok), 6 + step)
        tk, tv, tlog = port_decode.decode_step(
            p, port_cfg, tk, tv, torch.from_numpy(tok).long(), 6 + step)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-5, rtol=0, err_msg=f"step {step}")
        tok = np.asarray(jlog).argmax(-1).astype(np.int32)
    for i in range(cfg.num_layers):
        np.testing.assert_allclose(tk[i].numpy(), np.asarray(jk[i]),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("eos", [None, 7])
def test_generate_greedy_matches_jax(tiny, eos):
    from paddle_tpu.models import gpt_decode as jax_decode
    cfg, params, port_cfg, _ = tiny
    prompt = _prompt(cfg, 2, 5, seed=2)
    want = np.asarray(jax_decode.generate(params, cfg, prompt, 10,
                                          eos_token=eos))
    got = port_decode.generate(_port_params(tiny), port_cfg, prompt, 10,
                               eos_token=eos, device="cpu")
    assert got.shape == (2, 15)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_bf16_first_logits_close(tiny):
    from paddle_tpu.models import gpt_decode as jax_decode
    cfg, params, port_cfg, _ = tiny
    prompt = _prompt(cfg, 2, 8, seed=3)
    # params_from_scope(dtype="bfloat16")'s cast: LN params stay f32
    jparams = {n: a if "_ln" in n else a.astype(jnp.bfloat16)
               for n, a in params.items()}
    _, _, jlog = jax_decode.prefill(jparams, cfg, jnp.asarray(prompt),
                                    jnp.int32(8), 16)
    _, _, tlog = port_decode.prefill(
        _port_params(tiny, "bfloat16"), port_cfg,
        torch.from_numpy(prompt).long(), 8, 16)
    assert tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=5e-2,
                               rtol=0)


def test_generate_seeded_sampling_is_reproducible(tiny):
    """Seeded top-k: the same seed draws the same tokens, another seed
    draws others; the draws are the port's own (JAX's fold_in stream is
    not reproducible in torch)."""
    cfg, _, port_cfg, _ = tiny
    p = _port_params(tiny)
    prompt = _prompt(cfg, 1, 4, seed=4)
    kw = dict(temperature=1.0, top_k=50, device="cpu")
    a = port_decode.generate(p, port_cfg, prompt, 12, seed=5, **kw)
    b = port_decode.generate(p, port_cfg, prompt, 12, seed=5, **kw)
    c = port_decode.generate(p, port_cfg, prompt, 12, seed=6, **kw)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_generate_validates_and_defaults_to_cuda(tiny, monkeypatch):
    cfg, _, port_cfg, _ = tiny
    p = _port_params(tiny)
    prompt = _prompt(cfg, 1, 4)
    with pytest.raises(ValueError, match="max_position"):
        port_decode.generate(p, port_cfg, prompt, cfg.max_position,
                             device="cpu")
    with pytest.raises(ValueError):
        port_decode.generate(p, port_cfg, prompt, -1, device="cpu")
    assert port_decode.generate(p, port_cfg, prompt, 0,
                                device="cpu").shape == (1, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_decode.generate(p, port_cfg, prompt, 2)
