"""Paged (block-granular) KV-cache ops for the decode service
(counterpart of paddle_tpu/ops/paged_ops.py).

The KV cache lives in ONE preallocated pool per k/v,
[L, num_blocks, nh, block_size, hd], and each sequence owns a page-table
row mapping its positions onto pool blocks (PagedAttention, Kwon et al.,
SOSP '23). Position p lives in block page_table[b, p // bs] at row p % bs.

Unlike the JAX reference, whose arrays are immutable and whose pools are
donated into each dispatch, the port writes the pools IN PLACE
(`paged_update` returns nothing): the pool is the largest buffer on the
card and a functional update would copy it every token.

Block 0 of the pool is the SCRATCH block: empty page-table entries point
at it and frozen slots' writes land there, so a stale row can never
corrupt a live sequence's blocks.

Two decode-read implementations, one contract:

* `paged_gather` + `paged_attend` — the plain PyTorch oracle (a dense
  gather of each slot's blocks, then `models.gpt_decode._attend`);
* `fused_attend` — the hand-written CUDA kernel
  (ops/kernels/paged_attention.py), which walks the page table inside the
  kernel; on CPU tensors it runs the oracle.

int8 pools store abs-max-quantized values (`quantize_kv`); both read paths
fold the dequant multiplier kv_scale/127 outside the two contractions.
"""
from __future__ import annotations

import math

import torch

SCRATCH_BLOCK = 0
_KV_MAX_RANGE = 127.0   # int8 abs-max range


def quantize_kv(x: torch.Tensor, kv_scale) -> torch.Tensor:
    """Abs-max int8 KV quantization with a STATIC scale: values are clipped
    to [-kv_scale, kv_scale] and rounded (half to even) onto the 255-level
    grid."""
    q = torch.round(x.float() * (_KV_MAX_RANGE / float(kv_scale)))
    return q.clamp(-_KV_MAX_RANGE, _KV_MAX_RANGE).to(torch.int8)


def dequant_kv(x: torch.Tensor, kv_scale) -> torch.Tensor:
    """Materialized int8-KV dequant — the reference form for tests; the
    attention paths fold the multiplier after the dots instead."""
    return x.float() * (float(kv_scale) / _KV_MAX_RANGE)


def paged_update(k_pool, v_pool, k_new, v_new, page_table, pos,
                 block_size: int, layer: int, active=None, kv_scale=None):
    """Write one new position's k/v for every slot into the pools, in place.

    k_pool/v_pool: [L, NB, nh, bs, hd]; k_new/v_new: [B, nh, hd];
    page_table: [B, MB] int32 block ids; pos: [B] write positions.
    `active` ([B] bool, optional) redirects frozen rows' writes to the
    scratch block. int8 pools quantize on write with the static
    `kv_scale`."""
    b, mb = page_table.shape
    # a frozen row may sit one past its last block (pos == max_len); the
    # reference's gather clamps there, and the write goes to scratch anyway
    col = (pos // block_size).clamp(max=mb - 1).long()
    rows = torch.arange(b, device=page_table.device)
    blk = page_table[rows, col].long()
    if active is not None:
        blk = torch.where(active, blk, torch.full_like(blk, SCRATCH_BLOCK))
    off = (pos % block_size).long()
    if k_pool.dtype == torch.int8:
        if kv_scale is None:
            raise ValueError("int8 KV pools need a static kv_scale")
        k_new = quantize_kv(k_new, kv_scale)
        v_new = quantize_kv(v_new, kv_scale)
    k_pool[layer, blk, :, off] = k_new.to(k_pool.dtype)
    v_pool[layer, blk, :, off] = v_new.to(v_pool.dtype)


def paged_gather(pool, page_table, layer: int, max_blocks=None):
    """Reassemble each slot's dense [nh, max_len, hd] cache view from its
    blocks: pool [L, NB, nh, bs, hd], page_table [B, MB] ->
    [B, nh, MB*bs, hd]. `max_blocks` bounds the gather to the first
    max_blocks page columns."""
    if max_blocks is not None:
        page_table = page_table[:, :int(max_blocks)]
    blocks = pool[layer][page_table.long()]        # [B, MB', nh, bs, hd]
    b, mb, nh, bs, hd = blocks.shape
    return blocks.permute(0, 2, 1, 3, 4).reshape(b, nh, mb * bs, hd)


def paged_attend(q, k_pool, v_pool, page_table, pos, block_size: int,
                 layer: int = 0, scale=None, max_blocks=None,
                 kv_scale=None):
    """Single-token paged attention, the plain oracle: q [B, nh, 1, hd]
    against each slot's gathered cache, masked to positions <= pos. The
    score/softmax/context math IS models.gpt_decode._attend, so paged
    decode computes what a dense cache holding the same values computes.
    int8 pools take the folded-dequant read and return an f32 context."""
    from ..models.gpt_decode import _attend   # lazy: avoid an import cycle
    k = paged_gather(k_pool, page_table, layer, max_blocks=max_blocks)
    v = paged_gather(v_pool, page_table, layer, max_blocks=max_blocks)
    max_len = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kpos = torch.arange(max_len, device=q.device)
    mask = torch.zeros((q.shape[0], max_len), dtype=torch.float32,
                       device=q.device)
    mask = mask.masked_fill(kpos[None, :] > pos.long()[:, None],
                            float("-inf"))[:, None, None, :]
    if k_pool.dtype == torch.int8:
        if kv_scale is None:
            raise ValueError("int8 KV pools need a static kv_scale")
        # folded int8 contract: exact convert, dequant multiplier applied
        # after the dots (scores via the scale argument, context after)
        c = float(kv_scale) / _KV_MAX_RANGE
        return _attend(q, k.float(), v.float(), mask, scale * c) * c
    return _attend(q, k, v, mask, scale)


def fused_attend(q, k_pool, v_pool, page_table, pos, block_size: int,
                 layer: int = 0, scale=None, max_blocks=None,
                 kv_scale=None):
    """The fused-kernel twin of `paged_attend` (same signature): one CUDA
    kernel walking the page table, no dense view. On CPU tensors the
    wrapper runs `paged_attend`."""
    from .kernels.paged_attention import fused_paged_attention
    return fused_paged_attention(
        q.contiguous(), k_pool, v_pool, page_table, pos,
        block_size=block_size, layer=layer, scale=scale,
        max_blocks=max_blocks, kv_scale=kv_scale)
