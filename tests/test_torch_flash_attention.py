"""PyTorch port, kernel module: paddle_tpu_torch.ops.kernels.flash_attention
held against the JAX reference on the CPU.

The port's CUDA kernels B1-B3 are held against `flash_attention_plain` on
the card by chip_smoke.py. Here the plain version (and the wrapper, which
runs it on CPU tensors) is held against the reference's Pallas
`flash_attention` in interpret mode (as tests/test_flash_attention.py runs
it), on the same numpy inputs: B 2, nh 3, S 256, hd 64, blocks 128.

Tolerances: f32 at the reference suite's own (O atol=rtol 2e-5, grads
atol=rtol 5e-4, tests/test_flash_attention.py:46,59); bf16 compared in f32
with atol 3e-2 for O and 6e-2 for grads (outputs round to bf16, and the
two versions round the probabilities at different points). The dropout
keep-mask is compared bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as jax_fa

from paddle_tpu_torch.ops.kernels import flash_attention as port_fa

B, NH, S, HD = 2, 3, 256, 64
SCALE = 1.0 / np.sqrt(HD)


def _inputs(dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, NH, S, HD).astype(np.float32) for _ in range(4)]


def _mask(mode, rows, seed=1):
    """Additive mask of head-mapping `mode` with `rows` query rows."""
    rng = np.random.RandomState(seed)
    shape = {"1": (1, 1), "b": (B, 1), "h": (1, NH), "bh": (B, NH)}[mode]
    m = np.where(rng.rand(*shape, rows, S) < 0.2, -1e9, 0.0)
    return m.astype(np.float32)


def _jax_run(q, k, v, do, dtype, **kw):
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    q, k, v, do = (jnp.asarray(a).astype(jd) for a in (q, k, v, do))
    mask = kw.pop("mask", None)
    if mask is not None:
        mask = jnp.asarray(mask)

    def f(q, k, v):
        return jax_fa.flash_attention(q, k, v, SCALE, block_q=128,
                                      block_k=128, mask=mask, **kw)

    out, vjp = jax.vjp(f, q, k, v)
    grads = vjp(do)
    return [np.asarray(x.astype(jnp.float32)) for x in (out,) + grads]


def _port_run(q, k, v, do, dtype, fn=port_fa.flash_attention, **kw):
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v = (torch.from_numpy(a).to(td).requires_grad_() for a in (q, k, v))
    do = torch.from_numpy(do).to(td)
    if kw.get("mask") is not None:
        kw["mask"] = torch.from_numpy(kw["mask"])
    out = fn(q, k, v, scale=SCALE, **kw)
    grads = torch.autograd.grad(out, (q, k, v), do)
    return [x.detach().float().numpy() for x in (out,) + grads]


def _assert_close(got, want, dtype, what):
    o_tol, g_tol = (2e-5, 5e-4) if dtype == "f32" else (3e-2, 6e-2)
    rtol = (2e-5, 5e-4) if dtype == "f32" else (0.0, 0.0)
    for i, (g, w, name) in enumerate(zip(got, want, ("O", "dQ", "dK", "dV"))):
        np.testing.assert_allclose(
            g, w, atol=o_tol if i == 0 else g_tol,
            rtol=rtol[0] if i == 0 else rtol[1],
            err_msg=f"{name} mismatch ({what}, {dtype})")


ARMS = [
    ("none", {}),
    ("causal", {"causal": True}),
    ("dropout", {"dropout": 0.1, "seed": 7}),
    ("causal_dropout", {"causal": True, "dropout": 0.1, "seed": -3}),
] + [(f"mask_{mode}_rows{rows}", {"mask": (mode, rows)})
     for mode in ("1", "b", "h", "bh") for rows in (1, S)] + [
    ("mask_b_dropout", {"mask": ("b", 1), "dropout": 0.1, "seed": 11}),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,kw", ARMS, ids=[a[0] for a in ARMS])
def test_plain_matches_reference_kernel(name, kw, dtype):
    kw = dict(kw)
    if "mask" in kw:
        kw["mask"] = _mask(*kw["mask"])
    q, k, v, do = _inputs()
    want = _jax_run(q, k, v, do, dtype, **dict(kw))
    got = _port_run(q, k, v, do, dtype, **dict(kw))
    _assert_close(got, want, dtype, name)


@pytest.mark.parametrize("seed", [0, 1, 123456789, -1, -2 ** 31, 2 ** 31 - 1])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_mask_bit_exact(seed, rate):
    """The port's counter hash equals the reference's _keep_mask for every
    (q, k) of a grid, at several heads and block offsets."""
    for head, q_off, k_off in ((0, 0, 0), (5, 128, 256), (191, 384, 0),
                               (65535, 4096, 8192)):
        want = np.asarray(jax_fa._keep_mask(
            jnp.asarray(seed, jnp.int32), jnp.asarray(head, jnp.int32),
            q_off, k_off, 64, 128, rate))
        qp = torch.arange(q_off, q_off + 64).view(64, 1)
        kp = torch.arange(k_off, k_off + 128).view(1, 128)
        got = port_fa.keep_mask(seed, torch.tensor(head), qp, kp, rate)
        assert np.array_equal(got.numpy(), want), (seed, head, rate)
        assert 0.0 < want.mean() < 1.0


def test_wrapper_cpu_runs_plain_without_counting():
    q, k, v, do = _inputs()
    port_fa.reset_launches()
    kw = dict(mask=_mask("b", 1), dropout=0.1, seed=5)
    got = _port_run(q, k, v, do, "f32", **dict(kw))
    want = _port_run(q, k, v, do, "f32", fn=port_fa.flash_attention_plain,
                     **dict(kw))
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert all(n == 0 for n in port_fa.launches.values())


def test_wrapper_meta_returns_shape_without_launching():
    port_fa.reset_launches()
    q = torch.empty((B, NH, S, HD), device="meta", dtype=torch.bfloat16)
    out = port_fa.flash_attention(q, q, q, mask=torch.empty(
        (B, 1, 1, S), device="meta"), dropout=0.1, seed=1)
    assert out.device.type == "meta" and out.shape == q.shape
    assert out.dtype == torch.bfloat16
    assert all(n == 0 for n in port_fa.launches.values())


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros((1, 1, 8, 64))
    with pytest.raises(ValueError, match="requires a seed"):
        port_fa.flash_attention(q, q, q, dropout=0.1)
    with pytest.raises(ValueError, match="matching q/k/v dtypes"):
        port_fa.flash_attention(q, q, q.double())
    with pytest.raises(ValueError, match="not broadcastable"):
        port_fa.flash_attention(q, q, q, mask=torch.zeros(1, 1, 1, 7))


def test_normalize_mask_modes_match_reference():
    for mode in ("1", "b", "h", "bh"):
        for rows in (1, S):
            m = _mask(mode, rows)
            want, want_mode = jax_fa._normalize_mask(jnp.asarray(m), B, NH, S)
            got, got_mode = port_fa.normalize_mask(torch.from_numpy(m), B,
                                                   NH, S)
            assert got_mode == want_mode
            assert np.array_equal(got.numpy(), np.asarray(want))


def test_dropout_threshold_matches_reference():
    for rate in (0.0, 0.1, 0.5, 0.999999999):
        want = min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)
        assert port_fa.dropout_threshold(rate) == want


def _expand_mask(m3, mode, b, nh):
    if m3 is None:
        return None
    if mode == "bh":
        return m3.reshape(b, nh, m3.shape[1], m3.shape[2])
    if mode == "h":
        return m3.unsqueeze(0)
    return m3.unsqueeze(1)


def _fake_launchers(monkeypatch):
    """Stand-ins for the three CUDA launches, computed on the CPU with the
    plain version. Each takes the device pointer of every tensor it gets,
    as the real launches do, so a wrapped tensor without storage fails
    here as it would on the card."""
    def ptrs(*ts):
        for t in ts:
            if t is not None:
                t.data_ptr()

    def fwd(q, k, v, mask, mode, seed, scale, causal, dropout):
        ptrs(q, k, v, mask)
        b, nh, s, _ = q.shape
        kw = dict(scale=scale, causal=causal, dropout=dropout,
                  seed=seed if dropout else None,
                  mask=_expand_mask(mask, mode, b, nh))
        port_fa.launches["flash_fwd"] += 1
        lse = torch.zeros((b * nh, s))
        return port_fa.flash_attention_plain(q, k, v, **kw), lse

    def grads(q, k, v, o, lse, do, mask, mode, seed, scale, causal,
              dropout):
        ptrs(q, k, v, o, lse, do, mask)
        b, nh, _, _ = q.shape
        with torch.enable_grad():
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            out = port_fa.flash_attention_plain(
                qq, kk, vv, scale=scale, causal=causal, dropout=dropout,
                seed=seed if dropout else None,
                mask=_expand_mask(mask, mode, b, nh))
            return torch.autograd.grad(out, (qq, kk, vv), do)

    def dq(*a):
        port_fa.launches["flash_bwd_dq"] += 1
        return grads(*a)[0]

    def dkdv(*a):
        port_fa.launches["flash_bwd_dkdv"] += 1
        return grads(*a)[1:]

    monkeypatch.setattr(port_fa, "launch_fwd", fwd)
    monkeypatch.setattr(port_fa, "launch_bwd_dq", dq)
    monkeypatch.setattr(port_fa, "launch_bwd_dkdv", dkdv)


def test_autograd_function_under_func_vjp(monkeypatch):
    """The CUDA path's autograd.Function (B1 forward, B2 then B3 backward)
    traced by torch.func.vjp, as the executor's __vjp__ runs it: launches
    counted once each, gradients equal to the plain version's autograd
    (tolerance: f32 bit-identical, the stand-ins compute the same ops)."""
    _fake_launchers(monkeypatch)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs())
    mask = torch.from_numpy(_mask("b", 1))
    m3, mode = port_fa.normalize_mask(mask, B, NH, S)
    port_fa.reset_launches()

    def f(q, k, v):
        return port_fa.FlashAttention.apply(q, k, v, m3, mode, 9, SCALE,
                                            False, 0.1)[0]

    out, pull = torch.func.vjp(f, q, k, v)
    got = (out,) + pull(do)
    assert port_fa.launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                "flash_bwd_dkdv": 1}

    def g(q, k, v):
        return port_fa.flash_attention_plain(q, k, v, scale=SCALE,
                                             dropout=0.1, seed=9, mask=mask)

    out, pull = torch.func.vjp(g, q, k, v)
    want = (out,) + pull(do)
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


def _nested_func_grad(f, q, do):
    return torch.func.grad(
        lambda x: torch.func.grad(lambda y: (f(y) * do).sum())(x).sum())(q)


def _nested_func_vjp(f, q, do):
    def dq(x):
        return torch.func.vjp(f, x)[1](do)[0]
    return torch.func.vjp(dq, q)[1](do)


def _autograd_double_backward(f, q, do):
    qq, dd = q.clone().requires_grad_(), do.clone().requires_grad_()
    g, = torch.autograd.grad(f(qq), qq, dd, create_graph=True)
    g.sum().backward()


@pytest.mark.parametrize("nested", [_nested_func_grad, _nested_func_vjp,
                                    _autograd_double_backward])
def test_autograd_function_is_first_order_only(monkeypatch, nested):
    """The kernels' gradients are not differentiable again: a second-order
    transform over the CUDA path's Function raises instead of treating
    them as constants."""
    _fake_launchers(monkeypatch)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs())

    def f(q):
        return port_fa.FlashAttention.apply(q, k, v, None, None, 9, SCALE,
                                            False, 0.1)[0]

    with pytest.raises((NotImplementedError, RuntimeError),
                       match="first-order only|differentiate twice"):
        nested(f, q, do)
