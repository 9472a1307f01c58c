"""Sequence-parallel attention over the mesh's sp axis (counterpart of
paddle_tpu/parallel/ring_attention.py): ring attention and Ulysses.

Both take Q/K/V as DTensors of the global [B, nh, S, hd] on the mesh
(parallel/mesh.py), lay them out with the batch over dp, the heads over tp
and the sequence over sp (`_qkv_placements`, the reference's `_qkv_spec`),
run a body on this rank's local blocks (parallel/gspmd.py `local_call`)
and return the output in that layout.

* `ring_attention`: each rank keeps its query block and walks the sp - 1
  other K/V blocks around the ring, each step one counted `ppermute` of K
  and one of V (and of the key-padding mask block) to the next rank, as the
  reference's `jax.lax.ppermute`. The local body is the reference's
  online softmax (`_online_update`, plain torch in f32); its backward goes
  through the permutes, whose backward is the inverse permute (`_Permute`).
* `ulysses_attention`: an all-to-all turns the sequence blocks into head
  blocks ([B, nh_l, S/sp, hd] -> [B, nh_l/sp, S, hd]), the flash kernels
  B1-B3 run over the full sequence for this rank's heads (the dropout keyed
  on their global heads), and an all-to-all turns them back. The
  all-to-all's backward is the inverse all-to-all (`_AllToAll`).

Masks: key-padding masks [B|1, 1, 1, S] only; a full [*, S, S] mask
raises (`_check_mask`), as in the reference. Dropout: the flash kernels'
counter hash keyed on the GLOBAL head (`_global_head_ids`), so sp and tp
draw the mask the unsharded kernels draw.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..distributed import collective
from ..ops.kernels import flash_attention as fa
from . import gspmd

__all__ = ["ring_attention", "ulysses_attention"]


# ---------------------------------------------------------------------------
# Helpers (reference :40-145)
# ---------------------------------------------------------------------------

def _dropout_keep(seed, head_ids, sq, sk, q_off, k_off, rate):
    """[B, nh, sq, sk] keep mask of the flash kernels' counter hash;
    `head_ids` [B, nh] are the GLOBAL flat heads."""
    dev = head_ids.device
    qp = (q_off + torch.arange(sq, dtype=torch.int64, device=dev)).view(sq, 1)
    kp = (k_off + torch.arange(sk, dtype=torch.int64, device=dev)).view(1, sk)
    return fa.keep_mask(seed, head_ids.long()[..., None, None], qp, kp, rate)


def _global_head_ids(b_l, nh_l, b_off, nh_global, h_off, device):
    """[b_l, nh_l] global flat heads (global batch * nh_global + global
    head) of this rank's block."""
    return fa.keyed_heads(b_l, nh_l, (b_off, nh_global, h_off),
                          device)[:, :, 0, 0]


def _online_update(carry, q, k, v, q_off, k_off, scale, causal,
                   mask_blk=None, dropout=0.0, seed=None, head_ids=None):
    """One K/V block's contribution by online softmax (f32)."""
    m_prev, l_prev, acc = carry
    sl_q, sl_k = q.shape[2], k.shape[2]
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if mask_blk is not None:
        s = s + mask_blk.float()
    if causal:
        qp = q_off + torch.arange(sl_q, device=q.device).view(sl_q, 1)
        kp = k_off + torch.arange(sl_k, device=q.device).view(1, sl_k)
        s = s.masked_fill(qp < kp, float("-inf"))
    zero = torch.zeros((), device=q.device)
    m_new = torch.maximum(m_prev, s.amax(-1, keepdim=True))
    m_safe = torch.where(torch.isfinite(m_new), m_new, zero)
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe), zero)
    alpha = torch.where(torch.isfinite(m_prev), torch.exp(m_prev - m_safe),
                        zero)
    l_new = alpha * l_prev + p.sum(-1, keepdim=True)
    if dropout > 0.0:
        keep = _dropout_keep(seed, head_ids, sl_q, sl_k, q_off, k_off,
                             dropout)
        p = torch.where(keep, p / (1.0 - dropout), zero)
    acc_new = acc * alpha + torch.matmul(p, v.float())
    return m_new, l_new, acc_new


def _check_mask(mask, q):
    """A key-padding mask [B|1, 1, 1, S] broadcast to [B, 1, 1, S]; any
    other mask raises."""
    if mask is None:
        return None
    b, _, s, _ = q.shape
    shp = tuple(mask.shape)
    if len(shp) != 4 or shp[1] != 1 or shp[2] != 1 or shp[3] != s \
            or shp[0] not in (1, b):
        raise ValueError(
            f"sequence-parallel attention supports KEY-PADDING masks "
            f"[B|1, 1, 1, S] only (got {shp}); full [*, S, S] masks would "
            f"need 2-D sequence sharding")
    return mask.expand(b, 1, 1, s)


def _qkv_spec(mesh, seq_axis="sp"):
    """[B, nh, S, hd]: batch over dp, heads over tp, sequence over sp."""
    from .mesh import P
    return P("dp" if mesh.shape.get("dp", 1) > 1 else None,
             "tp" if mesh.shape.get("tp", 1) > 1 else None,
             seq_axis if seq_axis and mesh.shape.get(seq_axis, 1) > 1
             else None, None)


def _layout(mesh, seq_axis="sp"):
    from .mesh import P, placements
    spec = _qkv_spec(mesh, seq_axis)
    return (placements(mesh, spec),
            placements(mesh, P(spec[0], None, None, spec[2])))


def _keying(mesh, b_l, nh_l):
    """(b_off, nh_total, h_off) of this rank's [b_l, nh_l] block."""
    tp = mesh.shape.get("tp", 1)
    return (mesh.coordinate("dp") * b_l, nh_l * tp,
            mesh.coordinate("tp") * nh_l)


def _prepare(q, k, v, mask, mesh, scale, dropout, seed, axis):
    if mesh is None:
        from .mesh import get_mesh
        mesh = get_mesh()
    if mesh is None or not mesh.mixed:
        raise ValueError("sequence-parallel attention needs a tp/sp mesh "
                         "(parallel/mesh.py)")
    if dropout > 0.0 and seed is None:
        raise ValueError("sequence-parallel attention dropout requires a "
                         "seed")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    mask = _check_mask(mask, q)
    qkv_pl, mask_pl = _layout(mesh, axis)
    q, k, v = (t.redistribute(mesh.device_mesh, qkv_pl) for t in (q, k, v))
    if mask is not None:
        from torch.distributed.tensor import distribute_tensor
        mask = mask.float().contiguous()
        mask = mask.redistribute(mesh.device_mesh, mask_pl) \
            if gspmd.is_dtensor(mask) else distribute_tensor(
                mask, mesh.device_mesh, mask_pl, src_data_rank=None)
    return q, k, v, mask, mesh, float(scale), qkv_pl


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------

class _Permute(torch.autograd.Function):
    """ppermute to the next rank of `group` (shift +1); backward: the
    inverse permute of the cotangent (setup_context style)."""

    @staticmethod
    def forward(x, group, shift):
        return collective.ppermute(x, group, shift)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.shift = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return collective.ppermute(g, ctx.group, -ctx.shift), None, None


def _seq2head(x, group, p):
    """[B, H, Sl, D] -> [B, H/p, p*Sl, D] by one all-to-all."""
    b, h, sl, d = x.shape
    xs = x.reshape(b, p, h // p, sl, d).permute(1, 0, 2, 3, 4)
    y = collective.all_to_all_single(xs, group)     # [p(src), B, H/p, Sl, D]
    return y.permute(1, 2, 0, 3, 4).reshape(b, h // p, p * sl, d)


def _head2seq(y, group, p):
    """[B, H/p, p*Sl, D] -> [B, H, Sl, D]: the inverse of `_seq2head`."""
    b, hl, s, d = y.shape
    ys = y.reshape(b, hl, p, s // p, d).permute(2, 0, 1, 3, 4)
    x = collective.all_to_all_single(ys, group)     # [p(src), B, H/p, Sl, D]
    return x.permute(1, 0, 2, 3, 4).reshape(b, p * hl, s // p, d)


def _all_gather(t, group, p):
    """Every rank's `t` of `group`, in rank order (counted)."""
    import torch.distributed as dist
    out = [torch.empty_like(t) for _ in range(p)]
    collective.count_call("all_gather", t.numel() * t.element_size() * p)
    dist.all_gather(out, t, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """`_seq2head` (forward=True) or `_head2seq`; backward: the other."""

    @staticmethod
    def forward(x, group, p, to_heads):
        return (_seq2head if to_heads else _head2seq)(x, group, p)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.p, ctx.to_heads = inputs[1], inputs[2], inputs[3]

    @staticmethod
    def backward(ctx, g):
        fn = _head2seq if ctx.to_heads else _seq2head
        return fn(g.contiguous(), ctx.group, ctx.p), None, None, None


# ---------------------------------------------------------------------------
# Ring attention (reference :100-170)
# ---------------------------------------------------------------------------

def _ring_local(q, k, v, mask, seed, *, group, p_size, rank, scale, causal,
                dropout, keying):
    b, nh, sl, hd = q.shape
    qf = q.float()
    head_ids = None
    if dropout > 0.0:
        head_ids = _global_head_ids(b, nh, keying[0], keying[1], keying[2],
                                    q.device)
    m = torch.full((b, nh, sl, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, nh, sl, 1), device=q.device)
    acc = torch.zeros((b, nh, sl, hd), device=q.device)
    k_cur, v_cur, m_cur = k, v, mask
    for step in range(p_size):
        k_rank = (rank - step) % p_size
        m, l, acc = _online_update(
            (m, l, acc), qf, k_cur.float(), v_cur, rank * sl, k_rank * sl,
            scale, causal, mask_blk=m_cur, dropout=dropout, seed=seed,
            head_ids=head_ids)
        if step + 1 < p_size:
            k_cur = _Permute.apply(k_cur, group, 1)
            v_cur = _Permute.apply(v_cur, group, 1)
            if m_cur is not None:
                m_cur = collective.ppermute(m_cur, group, 1)
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def ring_attention(q, k, v, mesh=None, axis: str = "sp",
                   scale: Optional[float] = None, causal: bool = False,
                   mask=None, dropout: float = 0.0, seed=None):
    """Exact attention with Q/K/V sharded over `axis` along the sequence.
    q, k, v: DTensors of the global [B, nh, S, hd]; returns the output as
    a DTensor in the same layout (batch over dp, heads over tp, sequence
    over sp). Differentiable; the backward is a ring too."""
    q, k, v, mask, mesh, scale, pl = _prepare(q, k, v, mask, mesh, scale,
                                              dropout, seed, axis)
    ql = q.to_local()
    body_kw = dict(group=mesh.group(axis), p_size=mesh.shape[axis],
                   rank=mesh.coordinate(axis), scale=scale, causal=causal,
                   dropout=float(dropout),
                   keying=_keying(mesh, ql.shape[0], ql.shape[1]))

    def body(q, k, v, mask):
        return _ring_local(q, k, v, mask, seed, **body_kw)

    return gspmd.local_call(body, (q, k, v, mask), [pl])


# ---------------------------------------------------------------------------
# Ulysses (reference :198-275)
# ---------------------------------------------------------------------------

def ulysses_attention(q, k, v, mesh=None, axis: str = "sp",
                      scale: Optional[float] = None, causal: bool = False,
                      mask=None, dropout: float = 0.0, seed=None):
    """All-to-all sequence parallelism: sequence blocks -> head blocks, the
    flash kernels B1-B3 over the full sequence for this rank's heads, and
    back. Same arguments and layout as `ring_attention`."""
    q, k, v, mask, mesh, scale, pl = _prepare(q, k, v, mask, mesh, scale,
                                              dropout, seed, axis)
    p_size, rank = mesh.shape[axis], mesh.coordinate(axis)
    group = mesh.group(axis)
    b_l, nh_l = q.to_local().shape[:2]
    if nh_l % p_size:
        raise ValueError(f"ulysses needs the heads of a tp shard ({nh_l}) "
                         f"divisible by |{axis}|={p_size}")
    b_off, nh_total, h_off = _keying(mesh, b_l, nh_l)
    keying = (b_off, nh_total, h_off + rank * (nh_l // p_size))

    def body(q, k, v, mask):
        qh, kh, vh = (_AllToAll.apply(t, group, p_size, True)
                      for t in (q, k, v))
        full = None
        if mask is not None:
            # the key-padding bias of the whole sequence, in rank order
            full = torch.cat(_all_gather(mask.contiguous(), group, p_size),
                             dim=3)
        o = fa.flash_attention(qh, kh, vh, scale=scale, causal=causal,
                               dropout=dropout, seed=seed, mask=full,
                               keying=keying)
        return _AllToAll.apply(o, group, p_size, False)

    return gspmd.local_call(body, (q, k, v, mask), [pl])
