"""Sequence parallelism in the port (parallel/ring_attention.py, the
`fused_attention` op on an sp mesh) and the flash kernels' global-head
dropout keying (ops/kernels/flash_attention.py `keying`).

* Tiny GPT with ring and with Ulysses attention at sp 2 (a gloo gang of
  2, tests/torch_tp_ranks.py `sp_suite`), 3 Adam steps from seeded numpy
  weights, against the reference at sp 2 (a `cpu_mesh_env(2)`
  subprocess, tests/torch_tp_reference.py) and against the port's dense
  run: losses within the reference's 2e-4 (its
  `test_gpt_sequence_parallel_matches_dense` bound).
* `ring_attention` / `ulysses_attention` alone, causal, with a
  key-padding mask and dropout 0.1 (the same counter hash), against the
  reference's: outputs and the q, k, v gradients within 1e-5 (f32).
* A full [S, S] mask raises.
* The keying: the plain `keep_mask` over `keyed_heads(b_off, nh_total,
  h_off)` bit-equal to the reference's `_global_head_ids` + `_keep_mask`;
  the plain B1-B3 over a head slice with the slice's keying equal to that
  slice of the full run, bit for bit.
"""
import importlib
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import cpu_mesh_env

import torch_mesh_ranks as mesh_ranks
import torch_tp_ranks as ranks
from paddle_tpu.ops.pallas import flash_attention as ref_fa
from paddle_tpu_torch.ops.kernels import flash_attention as port_fa
from paddle_tpu_torch.testing import gloo_gang

# the packages export functions of the modules' names
ref_ra = importlib.import_module("paddle_tpu.parallel.ring_attention")
port_ra = importlib.import_module("paddle_tpu_torch.parallel.ring_attention")

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_tp_reference.py")
MODES = ("ring", "ulysses")


def _attn_inputs():
    rng = np.random.RandomState(11)
    b, nh, s, hd = 2, 4, 16, 8
    out = {n: rng.randn(b, nh, s, hd).astype(np.float32)
           for n in ("q", "k", "v", "do")}
    lens = np.array([s, s - 5])
    out["mask"] = np.where(np.arange(s)[None] < lens[:, None], 0.0,
                           -1e9).astype(np.float32).reshape(b, 1, 1, s)
    out["full_mask"] = np.zeros((b, 1, s, s), np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from test_torch_tp import _model_init
    tmp = tmp_path_factory.mktemp("sp")
    init, feeds = _model_init("gpt", 6)
    attn = _attn_inputs()
    arrays = {f"gpt/{n}": v for n, v in init.items()}
    arrays["gpt_tokens"] = np.stack([f["tokens"] for f in feeds])
    arrays.update(attn)
    src, dst = str(tmp / "sp_in.npz"), str(tmp / "sp_out.npz")
    np.savez(src, __json__=json.dumps({"modes": list(MODES)}), **arrays)
    proc = subprocess.Popen([sys.executable, REF, "sp", src, dst],
                            env=cpu_mesh_env(2), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        port = gloo_gang(ranks.sp_suite, 2, args=(init, feeds, attn))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            dense = ranks.model_run("gpt", init, feeds)[0]
            dense_dropout = mesh_ranks.sp_activations(init, feeds, None,
                                                      dropout=0.1)
            dense_fused = mesh_ranks.sp_activations({}, feeds, None,
                                                    vocab=16384)[0]
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    with np.load(dst) as f:
        ref_arrays = {n: f[n] for n in f.files}
    ref = json.loads(str(ref_arrays.pop("__json__")))
    return {"ref": ref, "ref_arrays": ref_arrays, "port": port,
            "dense": dense, "dense_dropout": dense_dropout,
            "dense_fused": dense_fused}


@pytest.mark.parametrize("mode", MODES)
def test_gpt_sp2_matches_reference_and_dense(runs, mode):
    ref = runs["ref"]
    assert ref["devices"] == 2
    for r in runs["port"]:
        got = r[mode]["losses"]
        np.testing.assert_allclose(got, ref[mode], rtol=2e-4, atol=0)
        np.testing.assert_allclose(got, runs["dense"], rtol=2e-4, atol=0)


@pytest.mark.parametrize("mode", MODES)
def test_sp2_activations_after_attention_are_sequence_sharded(runs, mode):
    """Each rank holds [B, S/2, H] of every residual sum after the first
    attention (the embedding sum before it is whole: the token feeds are
    sharded over dp alone, as the reference's batch_axes)."""
    b, s, h = 4, 32, 64
    for r in runs["port"]:
        _, adds, _ = r[mode]["dropout"]
        # a step: the embedding sum, then two residual sums a layer
        assert len(adds) == 3 * (1 + 2 * 2)
        for step in range(3):
            first, *rest = adds[5 * step:5 * step + 5]
            assert first == (b, s, h)
            assert rest == [(b, s // 2, h)] * 4, adds


@pytest.mark.parametrize("mode", MODES)
def test_sp2_dropout_masks_equal_sp1_bitwise(runs, mode):
    """Dropout 0.1: each dropout op's keep mask, keyed on global element
    indices on each rank's block, equals the sp-1 run's bit for bit; the
    losses stay within the reference's 2e-4 of sp 1."""
    losses1, _, masks1 = runs["dense_dropout"]
    assert len(masks1) == 5 * 3
    for r in runs["port"]:
        losses, _, masks = r[mode]["dropout"]
        assert len(masks) == len(masks1)
        assert all(np.array_equal(a, b) for a, b in zip(masks, masks1))
        np.testing.assert_allclose(losses, losses1, rtol=2e-4, atol=0)


@pytest.mark.parametrize("mode", MODES)
def test_sp2_fused_head_matches_sp1(runs, mode):
    """The fused LM head on the sequence-sharded rows (the shifted rows
    [0, S-1) split 16 / 15): losses within 2e-4 of sp 1."""
    for r in runs["port"]:
        np.testing.assert_allclose(r[mode]["fused_head"],
                                   runs["dense_fused"], rtol=2e-4, atol=0)


def test_sp2_collectives_per_attention_call(runs):
    """Tiny GPT (2 layers), 3 steps: the ring permutes K and V once a
    layer forward and their gradients once backward; Ulysses runs four
    all-to-alls a layer forward (q, k, v, back) and four backward."""
    steps, layers = 3, 2
    for r in runs["port"]:
        assert r["ring"]["calls"].get("ppermute.calls") == 4 * layers * steps
        assert "all_to_all.calls" not in r["ring"]["calls"]
        assert r["ulysses"]["calls"].get("all_to_all.calls") \
            == 8 * layers * steps
        assert "ppermute.calls" not in r["ulysses"]["calls"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("what", ["out", "dq", "dk", "dv"])
def test_attention_alone_matches_reference(runs, mode, what):
    """Causal, key-padding mask, dropout 0.1, seed 5, f32: within 1e-5."""
    want = runs["ref_arrays"][f"{mode}/{what}"]
    for r in runs["port"]:
        np.testing.assert_allclose(r[f"{mode}/{what}"], want, atol=1e-5,
                                   rtol=0)


def test_full_mask_raises(runs):
    assert all(r["full_mask_raised"] for r in runs["port"])
    q = torch.zeros(2, 4, 16, 8)
    with pytest.raises(ValueError, match="KEY-PADDING"):
        port_ra._check_mask(torch.zeros(2, 1, 16, 16), q)
    assert port_ra._check_mask(torch.zeros(1, 1, 1, 16), q).shape \
        == (2, 1, 1, 16)


@pytest.mark.parametrize("b_off,nh_total,h_off", [(0, 4, 0), (2, 8, 4),
                                                  (3, 12, 6)])
def test_keyed_heads_match_the_reference_hash(b_off, nh_total, h_off):
    """keep_mask over keyed_heads == the reference's _global_head_ids +
    _keep_mask, bit for bit, at a query/key offset."""
    b, nh, sq, sk, rate, seed = 2, 3, 8, 16, 0.1, 77
    heads = port_fa.keyed_heads(b, nh, (b_off, nh_total, h_off), "cpu")
    qp = (5 + torch.arange(sq)).view(sq, 1)
    kp = (9 + torch.arange(sk)).view(1, sk)
    got = port_fa.keep_mask(seed, heads, qp, kp, rate).numpy()
    gb = b_off + jnp.arange(b, dtype=jnp.int32)
    ids = gb[:, None] * nh_total + (h_off + jnp.arange(nh, dtype=jnp.int32))
    want = np.stack([np.stack([np.asarray(ref_fa._keep_mask(
        jnp.int32(seed), ids[i, j], 5, 9, sq, sk, rate))
        for j in range(nh)]) for i in range(b)])
    assert np.array_equal(got, want)
    ref_ids = np.asarray(jax.jit(
        lambda: ref_ra._global_head_ids(b, h_off + jnp.arange(
            nh, dtype=jnp.int32), nh_total, None) + b_off * nh_total)())
    assert np.array_equal(heads[:, :, 0, 0].numpy(), ref_ids)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_flash_on_a_head_slice_equals_the_full_run(causal):
    """Heads 2-3 of a 4-head launch, keyed (0, 4, 2): output and the
    q, k, v gradients bit-equal to those heads of the full launch at
    dropout 0.3; keyed on their own heads instead they differ."""
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(2, 4, 16, 8, generator=g) for _ in range(4))
    kw = dict(causal=causal, dropout=0.3, seed=9)

    def run(q, k, v, do, **extra):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = port_fa.flash_attention_plain(qq, kk, vv, **kw, **extra)
        return (o.detach(),) + torch.autograd.grad(o, (qq, kk, vv), do)

    full = run(q, k, v, do)
    sl = [t[:, 2:] for t in (q, k, v, do)]
    part = run(*sl, keying=(0, 4, 2))
    assert all(torch.equal(a[:, 2:], b) for a, b in zip(full, part))
    own = run(*sl)
    assert not torch.equal(full[0][:, 2:], own[0])


def test_keying_reaches_all_three_launchers(monkeypatch):
    """On the CUDA path (stand-in launchers on CPU tensors) the autograd
    Function hands a launch's keying to B1, B2 and B3 alike, the identity
    (None) too."""
    seen = []

    def fwd(q, k, v, mask, mode, seed, scale, causal, dropout, keying):
        seen.append(("fwd", keying))
        return q * 1.0, torch.zeros(q.shape[0] * q.shape[1], q.shape[2])

    def dq(q, k, v, o, lse, do, mask, mode, seed, scale, causal, dropout,
           keying):
        seen.append(("dq", keying))
        return do * 1.0, None

    def dkdv(q, k, v, delta, lse, do, mask, mode, seed, scale, causal,
             dropout, keying):
        seen.append(("dkdv", keying))
        return do * 0.0, do * 0.0

    monkeypatch.setattr(port_fa, "launch_fwd", fwd)
    monkeypatch.setattr(port_fa, "launch_bwd_dq", dq)
    monkeypatch.setattr(port_fa, "launch_bwd_dkdv", dkdv)
    q = torch.randn(2, 2, 8, 8, requires_grad=True)
    for want in ((0, 4, 2), None):
        seen.clear()
        o, _ = port_fa.FlashAttention.apply(q, q, q, None, None, 9, 0.3,
                                            False, 0.1, want)
        o.sum().backward()
        assert seen == [("fwd", want), ("dq", want), ("dkdv", want)]
