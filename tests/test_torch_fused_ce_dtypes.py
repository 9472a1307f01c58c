"""PyTorch port, the fused LM head's GEMM dtypes (`ops/fused_ce.py`), as
the reference's `paddle_tpu/ops/fused_ce.py` computes them: the logits
GEMM and its backward recompute take x and w in the dtype they arrive in
and accumulate and return f32 (`preferred_element_type=f32`); dx and dw
are f32 GEMMs.

* Under AMP (bf16 x and w), every logits GEMM of the forward scan and of
  the backward recompute sees the bf16 operands (the dtypes are observed
  at the call, `_logits_mm`), one per vocab chunk each; on the CPU the
  call computes in f32, so the loss and the gradients equal those of f32
  copies of the same bf16 values bit for bit.
* Off the CPU, two bf16 operands go to one GEMM with f32 output
  (`torch.mm(..., out_dtype=torch.float32)`, observed on the meta device,
  which takes that call without a card); f32 operands and mixed ones take
  f32 copies.
* Through the registered `fused_lm_head_ce` lowering under the AMP cast
  of a training step, the same: bf16 operands at the call.
The fused-CE parity cases against the reference stay where they are
(tests/test_torch_program.py, tests/test_torch_gpt_lm.py).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import fused_ce


def _case(v=300, h=16, b=2, s=5, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, s, h).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.randn(v, h) * 0.1).astype(np.float32)) \
        .bfloat16()
    bias = torch.from_numpy(rng.randn(v).astype(np.float32) * 0.01)
    labels = torch.from_numpy(rng.randint(0, v, (b, s)))
    labels[0, 0] = -100
    return x, w, bias, labels


def _loss_and_grads(x, w, bias, labels, chunk):
    x, w, bias = (t.clone().requires_grad_() for t in (x, w, bias))
    loss, _ = fused_ce.ChunkedLMCE.apply(x, w, bias, labels, chunk, -100)
    loss.sum().backward()
    return loss.detach(), x.grad, w.grad, bias.grad


@pytest.mark.parametrize("chunk", [64, 300])
def test_logits_gemms_see_the_incoming_bf16_operands(monkeypatch, chunk):
    x, w, bias, labels = _case()
    seen = []
    real = fused_ce._logits_mm

    def observe(a, w_c):
        seen.append((a.dtype, w_c.dtype))
        return real(a, w_c)

    monkeypatch.setattr(fused_ce, "_logits_mm", observe)
    loss, dx, dw, db = _loss_and_grads(x, w, bias, labels, chunk)
    n_chunks = -(-300 // chunk)
    assert seen == [(torch.bfloat16, torch.bfloat16)] * (2 * n_chunks)
    assert loss.dtype == torch.float32 and loss[0, 0, 0] == 0
    assert (dx.dtype, dw.dtype, db.dtype) == (torch.bfloat16,
                                              torch.bfloat16, torch.float32)
    # the CPU computes the bf16 products in f32: f32 copies of the same
    # values give the same bits
    seen.clear()
    want = _loss_and_grads(x.float(), w.float(), bias, labels, chunk)
    assert seen == [(torch.float32, torch.float32)] * (2 * n_chunks)
    assert torch.equal(loss, want[0])
    for got, ref in zip((dx, dw, db), want[1:]):
        assert torch.equal(got, ref.to(got.dtype))


def test_off_the_cpu_two_bf16_operands_take_one_f32_output_gemm(
        monkeypatch):
    calls = []
    real_mm = torch.mm

    def mm(*args, **kw):
        calls.append(({a.dtype for a in args}, kw.get("out_dtype")))
        return real_mm(*args, **kw)

    monkeypatch.setattr(torch, "mm", mm)
    a = torch.empty((8, 16), dtype=torch.bfloat16, device="meta")
    w_c = torch.empty((32, 16), dtype=torch.bfloat16, device="meta")
    out = fused_ce._logits_mm(a, w_c)
    assert (out.dtype, tuple(out.shape)) == (torch.float32, (8, 32))
    assert calls == [({torch.bfloat16}, torch.float32)]
    calls.clear()
    fused_ce._logits_mm(a.float(), w_c.float())
    fused_ce._logits_mm(a, w_c.float())
    assert calls == [({torch.float32}, None)] * 2
    calls.clear()
    fused_ce._logits_mm(torch.zeros((8, 16), dtype=torch.bfloat16),
                        torch.zeros((32, 16), dtype=torch.bfloat16))
    assert calls == [({torch.float32}, None)]


def test_amp_lowering_hands_the_head_bf16_operands(monkeypatch):
    """The registered lowering, given what fleet AMP's cast gives a
    white-listed fused_lm_head_ce (X and W bf16, Bias kept f32)."""
    from paddle_tpu_torch.amp.auto_cast import keep_f32_slots, white_list
    from paddle_tpu_torch.ops import registry
    assert "fused_lm_head_ce" in white_list
    assert keep_f32_slots["fused_lm_head_ce"] == {"Bias"}
    x, w, bias, labels = _case()
    seen = []
    real = fused_ce._logits_mm
    monkeypatch.setattr(fused_ce, "_logits_mm", lambda a, w_c: (
        seen.append((a.dtype, w_c.dtype)), real(a, w_c))[1])
    ins = {"X": [x], "W": [w], "Bias": [bias], "Label": [labels[..., None]]}
    out = registry.get("fused_lm_head_ce").lower(None, ins, {"chunk": 128})
    assert out["Loss"][0].dtype == torch.float32
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 3
