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
import ctypes
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import paged_ops as jax_ops
from paddle_tpu.ops.pallas.paged_attention import (
    fused_paged_attention as jax_fused)

from paddle_tpu_torch.ops import paged_ops as port_ops
from paddle_tpu_torch.ops.kernels import _build
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


# ---------------------------------------------------------------------------
# The kernel's split over positions, emulated through its launch path
# ---------------------------------------------------------------------------
#
# `_SplitLibrary` stands in for the built library on CPU tensors: it takes
# the launch's pointers and redoes csrc/paged_attention.cu's two passes in
# torch, at the kernel's chunk P (read from the source) and in its order.
# Pass 1 runs the grid (B·nh, ceil(walk·bs / P)): a block past its slot's
# frontier returns; a live one writes its chunk's (o_c, m_c, l_c) to the
# scratch buffer the wrapper allocated. Pass 2 merges the live chunks in
# chunk order: m = max m_c, l = sum l_c e^(m_c - m), out = sum o_c
# e^(m_c - m) / l * ctx_scale, cast to the pool dtype. The f32 weight
# multiplies V unrounded, as in the kernel (the plain version rounds the
# normalised probability to bf16 first).
#
# Tolerances against the JAX kernel (interpret mode) and the oracles: f32
# atol 1e-6 / rtol 1e-5 and int8 atol 1e-6 / rtol 2e-5 (sums in another
# order); bf16 compared in f32 with atol 1e-2 (one bf16 ulp of an O(1)
# context is 2**-8..2**-7, plus the unrounded weights).

# a launch pointer's element type by the library's kind code (0 f32, 1 bf16,
# 2 int8) or "i32" for the page table and positions
_POINTER_TYPES = {0: (ctypes.c_float, torch.float32),
                  1: (ctypes.c_int16, torch.bfloat16),
                  2: (ctypes.c_int8, torch.int8),
                  "i32": (ctypes.c_int32, torch.int32)}


def _kernel_chunk():
    """P: the kernel's positions per chunk, as the CUDA source sets it."""
    src = (_build.CSRC_DIR / "paged_attention.cu").read_text()
    return int(re.search(r"constexpr int kChunk = (\d+);", src).group(1))


def _at(ptr, kind, n):
    """The memory behind a launch pointer as a torch tensor (shared)."""
    ct, dt = _POINTER_TYPES[kind]
    t = torch.from_numpy(np.ctypeslib.as_array((ct * n).from_address(ptr)))
    return t.view(dt) if dt == torch.bfloat16 else t


class _SplitLibrary:
    def __init__(self, chunk, rc=0):
        self.chunk, self.rc, self.calls = chunk, rc, []

    def paged_decode_chunk(self):
        return self.chunk

    def paged_decode_error_string(self, rc):
        return b"an illegal memory access was encountered"

    def paged_decode(self, q, kp, vp, pt, pos, part, out, kv_kind, q_kind,
                     batch, nh, hd, nb, bs, mb, layer, walk, score_scale,
                     ctx_scale, stream):
        P = self.chunk
        n_chunks = -(-walk * bs // P)
        self.calls.append(dict(batch=batch, walk=walk, n_chunks=n_chunks,
                               layer=layer, stream=stream))
        if self.rc:
            return self.rc
        f32 = torch.float32
        Q = _at(q, q_kind, batch * nh * hd).view(batch * nh, hd).to(f32)
        pool = (layer + 1) * nb * nh * bs * hd
        K = _at(kp, kv_kind, pool).view(layer + 1, nb, nh, bs, hd)[layer]
        V = _at(vp, kv_kind, pool).view(layer + 1, nb, nh, bs, hd)[layer]
        PT = _at(pt, "i32", batch * mb).view(batch, mb)
        POS = _at(pos, "i32", batch)
        PART = _at(part, 0, batch * nh * n_chunks * (hd + 2)).view(
            batch * nh, n_chunks, hd + 2)
        out_kind = 0 if kv_kind == 2 else kv_kind
        OUT = _at(out, out_kind, batch * nh * hd).view(batch * nh, hd)
        sscale, cscale = torch.tensor(score_scale), torch.tensor(ctx_scale)
        live = []
        for bh in range(batch * nh):
            b, h = divmod(bh, nh)
            p = int(POS[b])
            n_walk = min(walk, p // bs + 1)
            live.append(min(p + 1, n_walk * bs))
        # pass 1: one block per (slot-head, chunk)
        for bh in range(batch * nh):
            b, h = divmod(bh, nh)
            for c in range(n_chunks):
                t0 = c * P
                if t0 >= live[bh]:
                    continue
                t = torch.arange(t0, min(t0 + P, live[bh]))
                blk = PT[b, t // bs].long()
                k = K[blk, h, t % bs].to(f32)
                v = V[blk, h, t % bs].to(f32)
                s = (k @ Q[bh]) * sscale
                m = s.max()
                e = torch.exp(s - m)
                PART[bh, c, :hd] = e @ v
                PART[bh, c, hd] = m
                PART[bh, c, hd + 1] = e.sum()
        # pass 2: the live chunks merged in chunk order
        for bh in range(batch * nh):
            n_live = -(-live[bh] // P)
            m = PART[bh, :n_live, hd].max()
            l, o = torch.zeros((), dtype=f32), torch.zeros(hd, dtype=f32)
            for c in range(n_live):
                w = torch.exp(PART[bh, c, hd] - m)
                l = l + PART[bh, c, hd + 1] * w
                o = o + PART[bh, c, :hd] * w
            OUT[bh] = (o / l * cscale).to(OUT.dtype)
        return 0


def _split(q, kp, vp, pt, pos, bs, lib=None, **kw):
    """The CUDA branch of the wrapper on CPU tensors, through `lib` (by
    default a `_SplitLibrary` at the kernel's P)."""
    lib = lib or _SplitLibrary(_kernel_chunk())
    return port_kernel.launch(lib, q, kp, vp, pt, pos, stream=7,
                              block_size=bs, **kw)


def _edge_case(rng, dtype=np.float32, nh=2, hd=64, bs=16):
    """Slots at positions 0, P-1, P, max_len-1 and max_len (a frozen row one
    past its last block), max_len = 2P + bs."""
    P = _kernel_chunk()
    mb = 2 * P // bs + 1
    max_len = mb * bs
    pos = np.array([0, P - 1, P, max_len - 1, max_len], np.int32)
    q, kp, vp, pt, _ = _decode_case(rng, bs, b=len(pos), nh=nh, hd=hd,
                                    mb=mb, dtype=dtype)
    return q, kp, vp, pt, pos


def test_split_emulation_f32_matches_jax_kernel_and_oracles():
    rng = np.random.RandomState(11)
    q, kp, vp, pt, pos = _edge_case(rng)
    got = _split(*_t(q, kp, vp, pt, pos), 16, layer=1)
    assert got.dtype == torch.float32 and got.shape == q.shape
    for tag, want in (
            ("jax kernel", jax_fused(q, kp, vp, pt, pos, block_size=16,
                                     layer=1)),
            ("jax oracle", jax_ops.paged_attend(q, kp, vp, pt, pos, 16,
                                                layer=1)),
            ("port plain", port_ops.paged_attend(*_t(q, kp, vp, pt, pos), 16,
                                                 layer=1))):
        _close_f32(got.numpy(), np.asarray(want), tag)


def test_split_emulation_bf16_matches_jax_kernel_and_oracles():
    rng = np.random.RandomState(12)
    q, kp, vp, pt, pos = _edge_case(rng)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp))
    got = _split(tq, tk, tv, *_t(pt, pos), 16)
    assert got.dtype == torch.bfloat16
    for tag, want in (
            ("jax kernel", jax_fused(jq, jk, jv, pt, pos, block_size=16)),
            ("jax oracle", jax_ops.paged_attend(jq, jk, jv, pt, pos, 16)),
            ("port plain", port_ops.paged_attend(tq, tk, tv, *_t(pt, pos),
                                                 16))):
        want = np.asarray(want.astype(jnp.float32)) if tag != "port plain" \
            else want.float().numpy()
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                                   rtol=0, err_msg=tag)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_split_emulation_int8_matches_jax_kernel_and_oracles(q_dtype):
    rng = np.random.RandomState(13)
    scale = 8.0
    q, kp, vp, pt, pos = _edge_case(rng)
    ki = np.asarray(jax_ops.quantize_kv(kp, scale))
    vi = np.asarray(jax_ops.quantize_kv(vp, scale))
    tq = torch.from_numpy(q).to(getattr(torch, q_dtype))
    got = _split(tq, *_t(ki, vi, pt, pos), 16, kv_scale=scale)
    assert got.dtype == torch.float32
    jq = jnp.asarray(tq.float().numpy()).astype(getattr(jnp, q_dtype))
    for tag, want in (
            ("jax kernel", jax_fused(jq, ki, vi, pt, pos, block_size=16,
                                     kv_scale=scale)),
            ("jax oracle", jax_ops.paged_attend(jq, ki, vi, pt, pos, 16,
                                                kv_scale=scale)),
            ("port plain", port_ops.paged_attend(tq, *_t(ki, vi, pt, pos),
                                                 16, kv_scale=scale))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=1e-6, err_msg=tag)


def test_split_emulation_aliased_and_scratch_page_tables():
    """Slots whose tables alias one block (a parked slot) or another slot's
    whole row, then every slot parked on the scratch block."""
    rng = np.random.RandomState(14)
    q, kp, vp, pt, pos = _edge_case(rng)
    pt[1, :] = pt[0, 0]
    pt[2, :] = pt[4, :]
    got = _split(*_t(q, kp, vp, pt, pos), 16)
    _close_f32(got.numpy(), jax_fused(q, kp, vp, pt, pos, block_size=16),
               "kernel")
    _close_f32(got.numpy(), jax_ops.paged_attend(q, kp, vp, pt, pos, 16),
               "oracle")
    pt[:] = port_ops.SCRATCH_BLOCK
    _close_f32(_split(*_t(q, kp, vp, pt, pos), 16).numpy(),
               jax_ops.paged_attend(q, kp, vp, pt, pos, 16), "scratch")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_every_sufficient_hint_gives_the_same_bits(dtype):
    """Chunk boundaries depend on the position only: every max_blocks hint
    that covers the frontier gives the full walk's bits, while the scratch
    buffer follows the hint."""
    rng = np.random.RandomState(15)
    q, kp, vp, pt, pos = _edge_case(rng)
    pos = np.minimum(pos, 2 * _kernel_chunk() + 3).astype(np.int32)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, kp, vp))
    mb = pt.shape[1]
    need = int(pos.max()) // 16 + 1
    lib = _SplitLibrary(_kernel_chunk())
    full = _split(tq, tk, tv, *_t(pt, pos), 16, lib=lib)
    for hint in range(need, mb + 1):
        got = _split(tq, tk, tv, *_t(pt, pos), 16, lib=lib, max_blocks=hint)
        assert torch.equal(got, full), hint
    assert [c["walk"] for c in lib.calls] == [mb] + list(range(need, mb + 1))
    assert [c["n_chunks"] for c in lib.calls] == [
        -(-w * 16 // lib.chunk) for w in [mb] + list(range(need, mb + 1))]


def test_split_slot_alone_equals_slot_in_a_batch_of_8():
    rng = np.random.RandomState(16)
    P, bs = _kernel_chunk(), 16
    mb = 2 * P // bs + 1
    pos = np.array([0, P - 1, P, 3, mb * bs - 1, mb * bs, P + 5, 2 * P],
                   np.int32)
    q, kp, vp, pt, _ = _decode_case(rng, bs, b=8, nh=2, hd=64, mb=mb)
    args = _t(q, kp, vp, pt, pos)
    batch = _split(*args, bs)
    for i in range(8):
        tq, tk, tv, tpt, tpos = args
        alone = _split(tq[i:i + 1].contiguous(), tk, tv,
                       tpt[i:i + 1].contiguous(), tpos[i:i + 1], bs)
        assert torch.equal(alone[0], batch[i]), i


def test_launch_path_counts_and_passes_the_stream():
    rng = np.random.RandomState(17)
    q, kp, vp, pt, pos = _edge_case(rng)
    lib = _SplitLibrary(_kernel_chunk())
    port_kernel.reset_launches()
    _split(*_t(q, kp, vp, pt, pos), 16, lib=lib, layer=1)
    (call,) = lib.calls
    assert call["stream"] == 7 and call["layer"] == 1
    assert port_kernel.launches == {"paged_decode_f32": 1,
                                    "paged_decode_bf16": 0,
                                    "paged_decode_int8": 0}
    with pytest.raises(RuntimeError, match="paged_decode launch failed: an "
                       "illegal memory access.*cudaError 700"):
        _split(*_t(q, kp, vp, pt, pos), 16, lib=_SplitLibrary(64, rc=700))
    assert port_kernel.launches["paged_decode_f32"] == 1


def test_launch_path_refuses_what_the_kernel_does_not_take():
    """The CUDA branch raises, and launches nothing, on a head dim other
    than 64 or 128, on pools that do not start on 16 bytes, and on dtypes
    the kernel has no instance for."""
    rng = np.random.RandomState(18)
    lib = _SplitLibrary(_kernel_chunk())
    q, kp, vp, pt, pos = _decode_case(rng, 8, hd=16)
    with pytest.raises(ValueError, match="head dims"):
        _split(*_t(q, kp, vp, pt, pos), 8, lib=lib)
    q, kp, vp, pt, pos = _decode_case(rng, 8, hd=64)
    buf = torch.zeros(kp.size + 1)
    off = buf[1:].view(kp.shape)
    off.copy_(torch.from_numpy(kp))
    with pytest.raises(ValueError, match="16 bytes"):
        _split(torch.from_numpy(q), off, *_t(vp, pt, pos), 8, lib=lib)
    with pytest.raises(TypeError, match="query dtype"):
        _split(torch.from_numpy(q).bfloat16(), *_t(kp, vp, pt, pos), 8,
               lib=lib)
    with pytest.raises(TypeError, match="int32"):
        _split(*_t(q, kp, vp, pt.astype(np.int64), pos), 8, lib=lib)
    assert lib.calls == []
