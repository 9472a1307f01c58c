"""PyTorch port, kernel module: paddle_tpu_torch.ops.kernels.paged_attention
and ops.paged_ops held against the JAX reference on the CPU.

The port's fused_paged_attention runs its plain version on CPU tensors (the
CUDA kernel is held against that plain version on the card by
chip_smoke.py). Here the plain version is held against the JAX Pallas
kernel (interpret mode, as tests/test_pallas_kernels.py runs it) and
against the JAX oracle paged_attend, on the same numpy inputs.

Tolerances: f32 atol 1e-6 / rtol 1e-5 (the two frameworks sum in different
orders); bf16 compared in f32 with atol 1e-2 (one bf16 ulp of an O(1)
context is 2**-8..2**-7); int8 arm rtol 2e-5; int8 payloads bitwise (both
sides round half to even).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import paged_ops as jax_ops
from paddle_tpu.ops.pallas.paged_attention import (
    fused_paged_attention as jax_fused)

from paddle_tpu_torch.ops import paged_ops as port_ops
from paddle_tpu_torch.ops.kernels import paged_attention as port_kernel


def _decode_case(rng, bs, b=3, nh=2, hd=16, mb=4, dtype=np.float32):
    nb = b * mb + 2
    pt = rng.permutation(nb)[: b * mb].reshape(b, mb).astype(np.int32)
    pos = rng.randint(0, mb * bs, (b,)).astype(np.int32)
    q = rng.randn(b, nh, 1, hd).astype(dtype)
    kp = rng.randn(2, nb, nh, bs, hd).astype(dtype)
    vp = rng.randn(2, nb, nh, bs, hd).astype(dtype)
    return q, kp, vp, pt, pos


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _port(q, kp, vp, pt, pos, bs, **kw):
    out = port_kernel.fused_paged_attention(*_t(q, kp, vp, pt, pos),
                                            block_size=bs, **kw)
    return out.float().numpy() if out.dtype == torch.bfloat16 \
        else out.numpy()


def _close_f32(got, want, tag):
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=1e-5,
                               err_msg=tag)


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_plain_matches_jax_kernel_and_oracle_f32(bs, layer):
    rng = np.random.RandomState(bs)
    q, kp, vp, pt, pos = _decode_case(rng, bs)
    got = _port(q, kp, vp, pt, pos, bs, layer=layer)
    assert got.shape == q.shape and got.dtype == np.float32
    _close_f32(got, jax_fused(q, kp, vp, pt, pos, block_size=bs,
                              layer=layer), f"kernel bs={bs} l={layer}")
    _close_f32(got, jax_ops.paged_attend(q, kp, vp, pt, pos, bs,
                                         layer=layer),
               f"oracle bs={bs} l={layer}")


def test_ragged_pos_every_sufficient_hint():
    """Positions 0, the last row of a block and the last row of the table;
    every max_blocks hint that covers the frontier gives the full-walk
    result."""
    rng = np.random.RandomState(3)
    bs, mb = 8, 4
    q, kp, vp, pt, pos = _decode_case(rng, bs, mb=mb)
    pos = np.array([0, bs * 2 - 1, mb * bs - 1], np.int32)
    want = jax_ops.paged_attend(q, kp, vp, pt, pos, bs)
    need = int(pos.max()) // bs + 1
    for hint in range(need, mb + 1):
        _close_f32(_port(q, kp, vp, pt, pos, bs, max_blocks=hint), want,
                   f"hint={hint}")
    _close_f32(_port(q, kp, vp, pt, pos, bs, max_blocks=need),
               jax_fused(q, kp, vp, pt, pos, block_size=bs,
                         max_blocks=need), "kernel at the frontier hint")


def test_aliased_and_scratch_page_tables():
    """Slots whose tables alias one block (a parked slot) or another slot's
    whole row read the same as the reference."""
    rng = np.random.RandomState(4)
    bs, mb = 8, 4
    q, kp, vp, pt, pos = _decode_case(rng, bs, mb=mb)
    pt[1, :] = pt[0, 0]
    pt[2, :] = pt[0, :]
    got = _port(q, kp, vp, pt, pos, bs)
    _close_f32(got, jax_fused(q, kp, vp, pt, pos, block_size=bs), "kernel")
    _close_f32(got, jax_ops.paged_attend(q, kp, vp, pt, pos, bs), "oracle")
    pt[:] = port_ops.SCRATCH_BLOCK     # every slot parked on scratch
    _close_f32(_port(q, kp, vp, pt, pos, bs),
               jax_ops.paged_attend(q, kp, vp, pt, pos, bs), "scratch")


def test_plain_matches_jax_bf16():
    rng = np.random.RandomState(2)
    q, kp, vp, pt, pos = _decode_case(rng, 16)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp))
    out = port_kernel.fused_paged_attention(
        tq, tk, tv, *_t(pt, pos), block_size=16)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    for tag, want in (
            ("kernel", jax_fused(jq, jk, jv, pt, pos, block_size=16)),
            ("oracle", jax_ops.paged_attend(jq, jk, jv, pt, pos, 16))):
        np.testing.assert_allclose(
            got, np.asarray(want.astype(jnp.float32)), atol=1e-2, rtol=0,
            err_msg=tag)


def test_plain_matches_jax_int8():
    rng = np.random.RandomState(5)
    bs, scale = 16, 8.0
    q, kp, vp, pt, pos = _decode_case(rng, bs)
    ki = np.asarray(jax_ops.quantize_kv(kp, scale))
    vi = np.asarray(jax_ops.quantize_kv(vp, scale))
    got = _port(q, ki, vi, pt, pos, bs, kv_scale=scale)
    assert got.dtype == np.float32
    for tag, want in (
            ("kernel", jax_fused(q, ki, vi, pt, pos, block_size=bs,
                                 kv_scale=scale)),
            ("oracle", jax_ops.paged_attend(q, ki, vi, pt, pos, bs,
                                            kv_scale=scale))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=1e-6, err_msg=tag)


@pytest.mark.parametrize("kv_scale", [8.0, 3.0])
def test_quantize_kv_bitwise(kv_scale):
    """Half-way cases included: x * 127 / kv_scale lands on .5 exactly."""
    rng = np.random.RandomState(9)
    x = (rng.randn(4, 3, 16) * kv_scale / 2).astype(np.float32)
    x.reshape(-1)[:8] = (np.arange(8) + 0.5) * kv_scale / 127.0
    got = port_ops.quantize_kv(torch.from_numpy(x), kv_scale).numpy()
    want = np.asarray(jax_ops.quantize_kv(x, kv_scale))
    assert got.dtype == np.int8
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(
        port_ops.dequant_kv(torch.from_numpy(got), kv_scale).numpy(),
        np.asarray(jax_ops.dequant_kv(want, kv_scale)))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_paged_update_matches_jax(dtype):
    """The port writes in place; the JAX reference returns new pools. Both
    must hold the same bytes, with frozen rows redirected to scratch."""
    rng = np.random.RandomState(6)
    b, nh, bs, hd, nb = 3, 2, 8, 4, 8
    kp = np.zeros((2, nb, nh, bs, hd), dtype)
    vp = np.zeros((2, nb, nh, bs, hd), dtype)
    pt = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
    pos = np.array([1, bs + 3, 2 * bs], np.int32)    # row 2: one past
    active = np.array([True, True, False])
    k1 = rng.randn(b, nh, hd).astype(np.float32)
    v1 = rng.randn(b, nh, hd).astype(np.float32)
    kw = {"kv_scale": 8.0} if dtype == "int8" else {}
    jk, jv = jax_ops.paged_update(*map(jnp.asarray, (kp, vp, k1, v1, pt,
                                                     pos)), bs, 1,
                                  active=jnp.asarray(active), **kw)
    tk, tv = _t(kp, vp)
    port_ops.paged_update(tk, tv, *_t(k1, v1, pt, pos), bs, 1,
                          active=torch.from_numpy(active), **kw)
    assert tk.numpy().tobytes() == np.asarray(jk).tobytes()
    assert tv.numpy().tobytes() == np.asarray(jv).tobytes()
    if dtype == "int8":
        with pytest.raises(ValueError):
            port_ops.paged_update(tk, tv, *_t(k1, v1, pt, pos), bs, 0)


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    rng = np.random.RandomState(7)
    q, kp, vp, pt, pos = _decode_case(rng, 8)
    port_kernel.reset_launches()
    got = _port(q, kp, vp, pt, pos, 8)
    want = port_kernel.paged_attention_plain(*_t(q, kp, vp, pt, pos),
                                             block_size=8).numpy()
    assert got.tobytes() == want.tobytes()
    assert set(port_kernel.launches.values()) == {0}
    assert port_kernel.kv_dequant_scale(8.0) == 8.0 / 127.0


def test_kernel_build_needs_nvcc(tmp_path, monkeypatch):
    """The CUDA sources are built at first use; a host without the CUDA
    toolkit gets a clear error, and nothing is built at import."""
    import os
    import shutil
    from paddle_tpu_torch.ops.kernels import _build
    assert [s.name for s in _build.sources()] == ["flash_attention.cu",
                                                  "paged_attention.cu",
                                                  "zero_update.cu"]
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(os.path, "isfile", lambda p: False)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    with pytest.raises(FileNotFoundError):
        _build.build(["no_such_kernel"])


def test_wrapper_rejects_bad_inputs():
    rng = np.random.RandomState(8)
    q, kp, vp, pt, pos = _decode_case(rng, 8)
    bad = [
        dict(q=np.concatenate([q, q], axis=2)),        # two query tokens
        dict(bs=16),                                    # wrong block size
        dict(layer=2),                                  # no such layer
        dict(pos=pos[:2]),                              # batch mismatch
        dict(kv_scale=8.0),                             # scale on f32 pools
    ]
    for case in bad:
        args = dict(q=q, kp=kp, vp=vp, pt=pt, pos=pos, bs=8, layer=0,
                    kv_scale=None)
        args.update(case)
        with pytest.raises(ValueError):
            port_kernel.fused_paged_attention(
                *_t(args["q"], args["kp"], args["vp"], args["pt"],
                    args["pos"]),
                block_size=args["bs"], layer=args["layer"],
                kv_scale=args["kv_scale"])
