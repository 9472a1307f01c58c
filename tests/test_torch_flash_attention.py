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
import contextlib
import ctypes

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
    here as it would on the card. B2's stand-in returns (dQ, delta) as the
    kernel does; B3's receives that delta where it once took O. Returns
    the list of (O, dO, delta) that B3's stand-in was handed."""
    handed = []
    def ptrs(*ts):
        for t in ts:
            if t is not None:
                t.data_ptr()

    def fwd(q, k, v, mask, mode, seed, scale, causal, dropout, keying):
        ptrs(q, k, v, mask)
        b, nh, s, _ = q.shape
        kw = dict(scale=scale, causal=causal, dropout=dropout,
                  seed=seed if dropout else None,
                  mask=_expand_mask(mask, mode, b, nh), keying=keying)
        port_fa.launches["flash_fwd"] += 1
        lse = torch.zeros((b * nh, s))
        return port_fa.flash_attention_plain(q, k, v, **kw), lse

    def grads(q, k, v, o, lse, do, mask, mode, seed, scale, causal,
              dropout, keying):
        ptrs(q, k, v, o, lse, do, mask)
        b, nh, _, _ = q.shape
        with torch.enable_grad():
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            out = port_fa.flash_attention_plain(
                qq, kk, vv, scale=scale, causal=causal, dropout=dropout,
                seed=seed if dropout else None,
                mask=_expand_mask(mask, mode, b, nh), keying=keying)
            return torch.autograd.grad(out, (qq, kk, vv), do)

    def dq(*a):
        port_fa.launches["flash_bwd_dq"] += 1
        o, do = a[3], a[5]
        delta = port_fa.bwd_delta_plain(o, do)
        handed.append([o, do, delta])
        return grads(*a)[0], delta

    def dkdv(*a):
        port_fa.launches["flash_bwd_dkdv"] += 1
        delta = a[3]
        assert handed and handed[-1][2] is delta    # B2's buffer, as is
        return grads(*a)[1:]

    monkeypatch.setattr(port_fa, "launch_fwd", fwd)
    monkeypatch.setattr(port_fa, "launch_bwd_dq", dq)
    monkeypatch.setattr(port_fa, "launch_bwd_dkdv", dkdv)
    return handed


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
                                            False, 0.1, None)[0]

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


def test_delta_handed_from_b2_to_b3(monkeypatch):
    """The delta B2 hands to B3 is [B*nh, S] f32 and equals the reference's
    sum(dO * O) (flash_attention.py:301) over the same O and dO, through the
    CUDA path's Function as the backward runs it (tolerance: f32 1e-6
    absolute, sums of 64 products in another order)."""
    handed = _fake_launchers(monkeypatch)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs())
    m3, mode = port_fa.normalize_mask(torch.from_numpy(_mask("b", 1)), B,
                                      NH, S)
    out, pull = torch.func.vjp(
        lambda q, k, v: port_fa.FlashAttention.apply(
            q, k, v, m3, mode, 9, SCALE, False, 0.1, None)[0], q, k, v)
    pull(do)
    assert len(handed) == 1
    o, got_do, delta = handed[0]
    assert delta.shape == (B * NH, S) and delta.dtype == torch.float32
    o_np, do_np = o.numpy(), got_do.numpy()
    want = jnp.sum(jnp.asarray(do_np).astype(jnp.float32)
                   * jnp.asarray(o_np).astype(jnp.float32), axis=-1)
    np.testing.assert_allclose(delta.numpy(),
                               np.asarray(want).reshape(B * NH, S),
                               atol=1e-6, rtol=0)


def test_aligned16_copies_only_misaligned_views():
    """The backward kernels copy rows 16 bytes at a time: an operand that
    does not start on 16 bytes (a view into a larger buffer) is copied,
    one that does is passed as it is."""
    buf = torch.zeros(4 * 64 + 1)
    ok = buf[:256].view(4, 64)
    assert port_fa._aligned16(ok) is ok
    off = buf[1:].view(4, 64)
    assert off.data_ptr() % 16 != 0
    got = port_fa._aligned16(off)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, off)


def _tf32_rna(x):
    """cvt.rna.tf32.f32 in torch: round to 10 mantissa bits, ties away
    from zero (add half an ulp of TF32 to the magnitude bits, cut 13)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_rz(x):
    """x rounded toward zero to TF32: the low 13 bits cut."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, passes, small_round=_tf32_rna):
    """a @ b as the kernels' mma.sync runs it: passes 1 = plain TF32
    operands; passes 3 = 3xTF32, each operand split into big = rna(x) and
    small = small_round(x - big), small*big + big*small + big*big in f32."""
    ab, bb = _tf32_rna(a), _tf32_rna(b)
    if passes == 1:
        return ab @ bb
    sa, sb = small_round(a - ab), small_round(b - bb)
    return sa @ bb + ab @ sb + ab @ bb


def _bwd_with_products(q, k, v, do, mask, rate, seed, mm):
    """B2 and B3's arithmetic (delta, P, dropout-upscaled dP, dS, the five
    backward products) with every product through `mm`; lse and O from an
    exact f32 forward."""
    sc = q @ k.transpose(-1, -2) * SCALE + mask
    lse = torch.logsumexp(sc, -1, keepdim=True)
    keep = port_fa._dense_keep(seed, B, NH, S, rate, "cpu")
    probs = torch.where(keep, torch.exp(sc - lse) / (1 - rate), 0.0)
    o = probs @ v
    delta = (do * o).sum(-1, keepdim=True)
    s2 = mm(q, k.transpose(-1, -2)) * SCALE + mask
    p = torch.exp(s2 - lse)
    p_drop = torch.where(keep, p / (1 - rate), 0.0)
    dp = torch.where(keep, mm(do, v.transpose(-1, -2)) / (1 - rate), 0.0)
    ds = p * (dp - delta) * SCALE
    return (mm(ds, k), mm(ds.transpose(-1, -2), q),
            mm(p_drop.transpose(-1, -2), do))


@pytest.mark.parametrize("small_round", [_tf32_rna, _tf32_rz],
                         ids=["small_rna", "small_toward_zero"])
def test_3xtf32_products_hold_f32_gradient_tolerance(record_property,
                                                     small_round):
    """The f32 backward kernels multiply in 3xTF32 on the tensor cores.
    Emulated here at the test shapes (key-padding mask, dropout 0.1), with
    `small` rounded toward zero (as the kernels hand it to the tensor core)
    or to nearest (ties away), their dQ/dK/dV
    stay within the f32 gradient tolerance (5e-4 absolute) of the plain
    version's autograd. Plain 1xTF32 is recorded beside it (not asserted):
    it shows why the split is needed."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs())
    mask = torch.from_numpy(_mask("b", 1))
    plain = _port_run(*_inputs(), "f32", fn=port_fa.flash_attention_plain,
                      mask=_mask("b", 1), dropout=0.1, seed=5)[1:]
    worst = {}
    for passes in (3, 1):
        got = _bwd_with_products(
            q, k, v, do, mask, 0.1, 5,
            lambda a, b: _mm_tf32(a, b, passes, small_round))
        worst[passes] = max((g - torch.from_numpy(w)).abs().max().item()
                            for g, w in zip(got, plain))
    record_property("max_abs_err_3xtf32", worst[3])
    record_property("max_abs_err_1xtf32", worst[1])
    assert worst[3] <= 5e-4, worst
    exact = _bwd_with_products(q, k, v, do, mask, 0.1, 5, torch.matmul)
    assert max((g - torch.from_numpy(w)).abs().max().item()
               for g, w in zip(exact, plain)) <= 5e-4


def test_tf32_rounding_is_round_half_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -11 - 2 ** -23, 3.0e-3, -7.5], )
    got = _tf32_rna(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0,
                         float(np.float32(3.0e-3)), -7.5])
    assert torch.equal(got[:3], want[:3]) and got[3] == 1.0
    assert abs(got[4].item() - 3.0e-3) <= 3.0e-3 * 2 ** -11
    assert got[5] == -7.5
    big = _tf32_rna(x)
    assert torch.equal(big.view(torch.int32) & 0x1FFF,
                       torch.zeros(6, dtype=torch.int32))


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
                                            False, 0.1, None)[0]

    with pytest.raises((NotImplementedError, RuntimeError),
                       match="first-order only|differentiate twice"):
        nested(f, q, do)


# ---------------------------------------------------------------------------
# B1's arithmetic, emulated
# ---------------------------------------------------------------------------

_LOG2E, _LN2 = float(np.float32(1.4426950408889634)), \
    float(np.float32(0.6931471805599453))


def _fwd_emulated(q, k, v, mask, causal, rate, seed, bn=32, mm=None):
    """B1's arithmetic in torch (f32, [B, nh, S, hd]): an online softmax over
    bn-key tiles in log2 units (scores scaled by scale * log2 e, exp2), the
    reference's finite guards, the row sum before dropout, dropout as a
    multiply by 1/keep_prob, unnormalised P rounded to V's dtype, both
    products through `mm` (default: 3xTF32, small toward zero, as the
    kernel hands it to the tensor core). Returns (O, lse [B*nh, S])."""
    mm = mm or (lambda a, b: _mm_tf32(a, b, 3, _tf32_rz))
    b, nh, s, hd = q.shape
    sl2 = float(np.float32(SCALE) * np.float32(_LOG2E))
    m = torch.full((b, nh, s, 1), float("-inf"))
    l = torch.zeros((b, nh, s, 1))
    acc = torch.zeros((b, nh, s, hd))
    pos = torch.arange(s)
    keep = port_fa._dense_keep(seed or 0, b, nh, s, rate, "cpu") \
        if rate else None
    inv_keep = float(np.float32(1) / np.float32(1 - rate))
    for k0 in range(0, s, bn):
        cols = slice(k0, min(k0 + bn, s))
        sc = mm(q.float(), k[:, :, cols].float().transpose(-1, -2)) * sl2
        if mask is not None:
            sc = sc + mask[..., cols] * _LOG2E
        if causal:
            sc = sc.masked_fill(pos[cols].view(1, -1) > pos.view(-1, 1),
                                float("-inf"))
        mx = torch.maximum(m, sc.amax(-1, keepdim=True))
        ms = torch.where(torch.isfinite(mx), mx, torch.zeros(()))
        alpha = torch.where(torch.isfinite(m), torch.exp2(m - ms),
                            torch.zeros(()))
        pr = torch.exp2(sc - ms)
        l = alpha * l + pr.sum(-1, keepdim=True)
        if rate:
            pr = torch.where(keep[..., cols], pr * inv_keep, torch.zeros(()))
        pr = pr.to(v.dtype).float()
        acc = acc * alpha + mm(pr, v[:, :, cols].float())
        m = mx
    den = l.clamp_min(1e-30)
    lse = torch.where(torch.isfinite(m), m * _LN2 + torch.log(den),
                      torch.full((), float("-inf")))
    return (acc / den).to(q.dtype), lse.reshape(b * nh, s)


def _fwd_case(s, mask_kind, seed=0):
    """numpy q, k, v [B, NH, s, HD] and an additive mask: none, key padding
    [B, 1, 1, s] (lengths in [s/2, s]) or a row per query [B, NH, s, s]."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, NH, s, HD).astype(np.float32) for _ in range(3))
    if mask_kind == "none":
        return q, k, v, None
    if mask_kind == "key_padding":
        lens = rng.randint(s // 2, s + 1, size=(B, 1))
        keep = (np.arange(s)[None, :] < lens).astype(np.float32)
        return q, k, v, (keep * 1e9 - 1e9).reshape(B, 1, 1, s)
    m = np.where(rng.rand(B, NH, s, s) < 0.2, -1e9, 0.0).astype(np.float32)
    return q, k, v, m


FWD_ARMS = [(s, mask, causal, rate)
            for s in (256, 200)
            for mask in ("none", "key_padding", "per_query")
            for causal in (False, True)
            for rate in (0.0, 0.1)]


@pytest.mark.parametrize(
    "s,mask_kind,causal,rate", FWD_ARMS,
    ids=[f"S{s}-{m}-{'causal' if c else 'full'}-p{r}"
         for s, m, c, r in FWD_ARMS])
def test_b1_arithmetic_matches_plain_and_reference(s, mask_kind, causal,
                                                   rate):
    """B1's arithmetic (emulated in torch) against `flash_attention_plain`
    and, where S is a multiple of 128, against the reference's Pallas
    forward in interpret mode: O within 2e-5 absolute (f32, the reference
    suite's own), lse within 1e-5 of the reference's lse and of logsumexp
    of the plain scores. S 200 leaves a tail tile of 8 keys (32-key tiles)
    and of 8 query rows (64-row tiles)."""
    q, k, v, mask = _fwd_case(s, mask_kind)
    seed = 77 if rate else None
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    got_o, got_lse = _fwd_emulated(tq, tk, tv, tm, causal, rate, seed)
    plain = port_fa.flash_attention_plain(tq, tk, tv, scale=SCALE,
                                          causal=causal, dropout=rate,
                                          seed=seed, mask=tm)
    np.testing.assert_allclose(got_o.numpy(), plain.numpy(), atol=2e-5,
                               rtol=0)
    sc = tq @ tk.transpose(-1, -2) * SCALE
    if tm is not None:
        sc = sc + tm
    if causal:
        pos = torch.arange(s)
        sc = sc.masked_fill(pos.view(1, s) > pos.view(s, 1), float("-inf"))
    want_lse = torch.logsumexp(sc, -1).reshape(B * NH, s)
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=1e-5,
                               rtol=0)
    if s % 128:
        return
    jm, mode = (None, None) if mask is None else \
        jax_fa._normalize_mask(jnp.asarray(mask), B, NH, s)
    ref_o, ref_lse = jax_fa._flash_fwd(
        *(jnp.asarray(a) for a in (q, k, v)),
        jnp.asarray(seed or 0, jnp.int32).reshape((1,)), jm, SCALE, causal,
        rate, 128, 128, mode)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(ref_o), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(ref_lse)[..., 0], atol=1e-5,
                               rtol=0)


def test_b1_arithmetic_bf16_within_the_bf16_tolerance():
    """The same arithmetic on bf16 operands (exact f32 products of bf16
    values, P rounded to bf16 unnormalised) against the plain version: O
    within the file's bf16 tolerance (3e-2 absolute)."""
    q, k, v, mask = _fwd_case(256, "key_padding")
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    tm = torch.from_numpy(mask)
    got, _ = _fwd_emulated(tq, tk, tv, tm, False, 0.1, 3, mm=torch.matmul)
    want = port_fa.flash_attention_plain(tq, tk, tv, scale=SCALE,
                                         dropout=0.1, seed=3, mask=tm)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=3e-2, rtol=0)


def test_launch_fwd_hands_the_library_16_byte_aligned_operands(monkeypatch):
    """B1 copies Q, K and V rows into shared memory 16 bytes at a time:
    `launch_fwd` hands the library a 16-byte-aligned copy of an operand
    that is a view off 16 bytes, with the view's values, and an aligned
    operand as it is. Driven on the CPU through a stand-in library."""
    handed = []
    q, k, v = (torch.from_numpy(a) for a in _fwd_case(64, "none")[:3])
    n = q.numel()

    class Lib:
        def flash_fwd(self, q, k, v, mask, o, lse, *cfg):
            # the values behind the Q pointer, read during the call
            seen = np.ctypeslib.as_array(
                (ctypes.c_float * n).from_address(q)).copy()
            handed.append((q, k, v, mask, o, lse, cfg, seen))
            return 0

    monkeypatch.setattr(port_fa, "_library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda _d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda _d=None: type("St", (), {"cuda_stream": 5}))
    buf = torch.zeros(n + 1)
    buf[1:] = q.flatten()
    q_off = buf[1:].view(q.shape)
    assert q_off.data_ptr() % 16 != 0
    port_fa.reset_launches()
    port_fa.launch_fwd(q_off, k, v, None, None, 0, SCALE, False, 0.0)
    (pq, pk, pv, pmask, po, plse, cfg, seen), = handed
    assert all(ptr % 16 == 0 for ptr in (pq, pk, pv))
    assert pq != q_off.data_ptr() and pk == k.data_ptr() \
        and pv == v.data_ptr()
    assert np.array_equal(seen, q.numpy().ravel())
    assert pmask is None and cfg[-1] == 5
    assert port_fa.launches["flash_fwd"] == 1
