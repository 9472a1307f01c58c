"""PyTorch port, the int8-weight serving arm as the reference computes it:
the matrices dequantized to bf16, the biases f32, so the activations are
f32 and B4 reads the bf16 KV pool with an f32 query.

* Logits: GPT-tiny's int8 arm in both packages (`prepare_params("int8")`
  then `dequant_params`), a dense prefill of a 9-token prompt and 4
  greedy decode steps against a bf16 KV cache (the engine's pool dtype):
  the port's logits at every step within atol 1e-5 of the reference's
  (|logits| <= 0.61 here; the frameworks sum in other orders, and the
  largest difference seen is 1.8e-7), the same greedy tokens; the port's
  activations f32. With the biases cast to bf16, as the port computed the
  arm before, the logits are off by up to 2.5e-3, over 100 times the
  tolerance.
* The engine: the int8 arm's prefill buffers are f32, and every B4 call of
  its decode window reads a bf16 pool with an f32 query.
* B4's <bf16 KV, f32 Q> instance: the kernel's split over positions,
  emulated through its launch path, against the reference's Pallas kernel
  (interpret mode) and both paged oracles on the same f32 query and bf16
  pools: within atol 1e-2 (the context is bf16: one ulp of an O(1) value
  is 2**-8..2**-7, and the kernel weighs V by unrounded probabilities).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as fluid
from paddle_tpu.ops import paged_ops as jax_ops
from paddle_tpu.ops.pallas.paged_attention import (
    fused_paged_attention as jax_fused)

from paddle_tpu_torch.models import gpt_decode as port_decode
from paddle_tpu_torch.models.gpt import GPTConfig as PortGPTConfig
from paddle_tpu_torch.ops import paged_ops as port_ops
from paddle_tpu_torch.ops.kernels import paged_attention as port_kernel
from paddle_tpu_torch import serving as port_serving
from paddle_tpu_torch.serving import weights as port_weights

from test_torch_paged_attention import _edge_case, _split, _t


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, jax params, port cfg, numpy arrays)."""
    from paddle_tpu.models.gpt import GPTConfig, build_lm_program
    from paddle_tpu.models import gpt_decode
    from paddle_tpu.testing import reset_programs
    reset_programs(seed=0)
    cfg = GPTConfig.tiny()
    cfg.max_position = 64
    build_lm_program(cfg)
    exe = fluid.Executor()
    exe.run(fluid.default_startup_program())
    params = gpt_decode.params_from_scope(cfg)
    port_cfg = PortGPTConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(PortGPTConfig)})
    return cfg, params, port_cfg, {n: np.asarray(a)
                                   for n, a in params.items()}


def _ref_logits(cfg, params, prompt, steps):
    from paddle_tpu.models import gpt_decode as ref_decode
    from paddle_tpu.serving import weights as ref_weights
    payloads, scales, cd = ref_weights.prepare_params(params, "int8")
    p = ref_weights.dequant_params(payloads, scales, cd)
    ck, cv, logits = ref_decode.prefill(p, cfg, jnp.asarray(prompt[None]),
                                        len(prompt), len(prompt) + steps)
    ck = [c.astype(jnp.bfloat16) for c in ck]
    cv = [c.astype(jnp.bfloat16) for c in cv]
    out = [np.asarray(logits)]
    for t in range(steps - 1):
        tok = jnp.argmax(logits, axis=-1)
        ck, cv, logits = ref_decode.decode_step(p, cfg, ck, cv, tok,
                                                len(prompt) + t)
        out.append(np.asarray(logits))
    return out


def _port_logits(cfg, arrays, prompt, steps, bias_dtype=None):
    payloads, scales, cd = port_weights.prepare_params(arrays, "int8",
                                                       torch.device("cpu"))
    if bias_dtype is not None:        # the port's arm before: bf16 biases
        payloads = {n: t.to(bias_dtype) if n not in scales and "_ln" not in n
                    and t.is_floating_point() else t
                    for n, t in payloads.items()}
    p = port_weights.dequant_params(payloads, scales, cd)
    ck, cv, logits = port_decode.prefill(
        p, cfg, torch.as_tensor(prompt[None]), len(prompt),
        len(prompt) + steps)
    dtypes = {c.dtype for c in ck}
    ck = [c.to(torch.bfloat16) for c in ck]
    cv = [c.to(torch.bfloat16) for c in cv]
    out = [logits.numpy()]
    for t in range(steps - 1):
        tok = torch.argmax(logits, dim=-1)
        ck, cv, logits = port_decode.decode_step(p, cfg, ck, cv, tok,
                                                 len(prompt) + t)
        out.append(logits.numpy())
    return out, dtypes


def test_int8_arm_logits_match_the_reference(tiny):
    cfg, params, port_cfg, arrays = tiny
    prompt = np.random.RandomState(3).randint(0, cfg.vocab_size, (9,))
    want = _ref_logits(cfg, params, prompt, 5)
    got, act_dtypes = _port_logits(port_cfg, arrays, prompt, 5)
    assert act_dtypes == {torch.float32}
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0,
                                   err_msg=f"decode step {step}")
        assert (g.argmax(-1) == w.argmax(-1)).all()
    before, dtypes = _port_logits(port_cfg, arrays, prompt, 5,
                                  bias_dtype=torch.bfloat16)
    assert dtypes == {torch.bfloat16}
    err = max(np.abs(b - w).max() for b, w in zip(before, want))
    assert err > 100 * 1e-5, err


def test_int8_engine_computes_in_f32_against_a_bf16_pool(tiny, monkeypatch):
    _, _, port_cfg, arrays = tiny
    eng = port_serving.DecodeEngine(
        arrays, port_cfg, device="cpu", dtype="int8", max_slots=2,
        block_size=8, num_blocks=16, max_len=32, window=4)
    pairs = set()
    real = port_kernel.fused_paged_attention

    def recording(q, k_pool, *a, **kw):
        pairs.add((k_pool.dtype, q.dtype))
        return real(q, k_pool, *a, **kw)

    monkeypatch.setattr(port_kernel, "fused_paged_attention", recording)
    try:
        assert eng.params["dec0_ffn_in_b"].dtype == torch.float32
        assert eng.cache.k_pool.dtype == torch.bfloat16
        prompt = np.random.RandomState(5).randint(0, port_cfg.vocab_size,
                                                  (7,))
        k, v, _ = eng._prefill_fn(prompt, 7, 0.0, 0, 0)
        assert k.dtype == v.dtype == torch.float32
        comps = eng.generate([port_serving.Request(prompt=prompt,
                                                   max_new_tokens=6)],
                             timeout=120)
    finally:
        eng.stop()
    assert comps[0].ok and len(comps[0].tokens) == 6
    assert pairs == {(torch.bfloat16, torch.float32)}


def test_b4_bf16_pool_f32_query_matches_the_reference_kernel():
    rng = np.random.RandomState(21)
    q, kp, vp, pt, pos = _edge_case(rng)
    jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (kp, vp))
    tq = torch.from_numpy(q)
    tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (kp, vp))
    port_kernel.reset_launches()
    got = _split(tq, tk, tv, *_t(pt, pos), 16)
    assert got.dtype == torch.bfloat16
    assert port_kernel.launches["paged_decode_bf16"] == 1
    plain = port_kernel.fused_paged_attention(tq, tk, tv, *_t(pt, pos),
                                              block_size=16)
    assert plain.dtype == torch.bfloat16
    for tag, want in (
            ("jax kernel", jax_fused(jnp.asarray(q), jk, jv, pt, pos,
                                     block_size=16)),
            ("jax oracle", jax_ops.paged_attend(jnp.asarray(q), jk, jv, pt,
                                                pos, 16)),
            ("port plain", plain),
            ("port oracle", port_ops.paged_attend(tq, tk, tv, *_t(pt, pos),
                                                  16))):
        want = want.float().numpy() if isinstance(want, torch.Tensor) \
            else np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                                   rtol=0, err_msg=tag)
    with pytest.raises(TypeError, match="query dtype"):
        _split(tq.bfloat16().float().to(torch.float16), tk, tv,
               *_t(pt, pos), 16)
    port_kernel.reset_launches()
