"""LoD rank-table and dynamic-RNN memory ops: the ragged-sequence bridge
(counterpart of paddle_tpu/ops/lod_ops.py).

The reference's contract, with static shapes:

* A rank table is an int32 tensor [B, 2]: column 0 the original sequence
  index sorted by length descending (stable), column 1 that sequence's
  length.
* Sequences are padded [B, T, ...] with an explicit length vector (the
  convention of ops/sequence_ops.py) instead of LoD offsets.
* Where the reference's C++ ops shrink a tensor step by step to the alive
  prefix of the rank order, these keep the full height and zero the dead
  rows.
* split / merge route rows by a boolean mask with stable front
  compaction; merge recomputes the positions from the same mask, so
  split + merge round-trips exactly.

Every permutation here is a gather by `index_select` (its gradient is an
`index_add` without collisions, so it is exact on the card).
"""
from __future__ import annotations

import torch

from .registry import register


def _stable_rank_desc(lengths):
    """Indices sorting lengths descending, ties by original order."""
    b = lengths.shape[0]
    # one sort key: -len * B + index (collision-free)
    key = -lengths.to(torch.int64) * b + torch.arange(
        b, dtype=torch.int64, device=lengths.device)
    return torch.argsort(key).to(torch.int32)


def _mask_rows(mask, like):
    """[B] or [T, B] bool mask broadcast over `like`'s trailing dims."""
    return mask.reshape(tuple(mask.shape) + (1,) * (like.dim() - mask.dim()))


def _zero(t):
    return torch.zeros((), dtype=t.dtype, device=t.device)


@register("lod_rank_table", nondiff_slots=("X", "Length"))
def _lod_rank_table(ctx, ins, attrs):
    lengths = ins["Length"][0].reshape(-1).to(torch.int32)
    idx = _stable_rank_desc(lengths)
    table = torch.stack([idx, lengths.index_select(0, idx.long())], dim=1)
    return {"Out": [table]}


@register("max_sequence_len", nondiff_slots=("RankTable",))
def _max_sequence_len(ctx, ins, attrs):
    table = ins["RankTable"][0]
    return {"Out": [table[0, 1].reshape(1).to(torch.int32)]}


@register("lod_tensor_to_array", nondiff_slots=("RankTable",))
def _lod_tensor_to_array(ctx, ins, attrs):
    """x [B, T, ...] -> array whose slot t holds the t-th token of every
    sequence alive at step t, in rank order, dead rows zero: (buffer
    [T, B, ...], length T)."""
    x = ins["X"][0]
    table = ins["RankTable"][0]
    idx, lens = table[:, 0].long(), table[:, 1]
    t = x.shape[1]
    tm = x.index_select(0, idx).movedim(1, 0)         # [T, B, ...]
    steps = torch.arange(t, dtype=torch.int32, device=x.device)
    alive = lens[None, :] > steps[:, None]            # [T, B]
    buf = torch.where(_mask_rows(alive, tm), tm, _zero(tm))
    return {"Out": [(buf, torch.full((), t, dtype=torch.int32,
                                     device=x.device))]}


def _inverse(idx):
    inv = torch.empty_like(idx)
    return inv.scatter_(0, idx, torch.arange(idx.shape[0], dtype=idx.dtype,
                                             device=idx.device))


@register("array_to_lod_tensor", nondiff_slots=("RankTable",))
def _array_to_lod_tensor(ctx, ins, attrs):
    """Inverse: an array buffer [T, B, ...] (rank order) -> padded [B, T,
    ...] in the original order, zeros past each sequence's length."""
    buf, _ = ins["X"][0]
    table = ins["RankTable"][0]
    max_len = attrs.get("max_len")
    if max_len and int(max_len) < buf.shape[0]:
        # an array made by plain array_write carries a larger capacity:
        # trim to the build-time sequence length
        buf = buf[:int(max_len)]
    idx, lens = table[:, 0].long(), table[:, 1]
    inv = _inverse(idx)
    out = buf.movedim(0, 1).index_select(0, inv)      # original order
    t = out.shape[1]
    steps = torch.arange(t, dtype=torch.int32, device=out.device)
    orig_lens = lens.index_select(0, inv)
    valid = steps[None, :] < orig_lens[:, None]       # [B, T]
    return {"Out": [torch.where(_mask_rows(valid, out), out, _zero(out))]}


@register("shrink_rnn_memory", nondiff_slots=("RankTable", "I"))
def _shrink_rnn_memory(ctx, ins, attrs):
    """Memory rows of the sequences alive at step I: the first
    #(len > I) rows of the rank order; the dead rows zeroed (their
    gradient is zero, as ShrinkRNNMemoryGradOp's zero fill)."""
    x = ins["X"][0]
    table = ins["RankTable"][0]
    i = ins["I"][0].reshape(()).to(torch.int32)
    active = (table[:, 1] > i).sum()
    rows = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    return {"Out": [torch.where(_mask_rows(rows < active, x), x, _zero(x))]}


def _mask_positions(mask):
    """Stable front-compaction positions: pos[i] = #True among mask[:i]
    (rows routed to the True output), likewise for False."""
    m = mask.to(torch.int64)
    pos_true = torch.cumsum(m, 0) - m
    inv = 1 - m
    pos_false = torch.cumsum(inv, 0) - inv
    return pos_true, pos_false


@register("split_lod_tensor", nondiff_slots=("Mask",))
def _split_lod_tensor(ctx, ins, attrs):
    """Rows of X routed into (OutTrue, OutFalse) by the bool Mask [B, 1],
    stably front-compacted, zero-padded to the full height."""
    x = ins["X"][0]
    mask = ins["Mask"][0].reshape(-1).to(torch.bool)
    b = x.shape[0]
    pos_t, pos_f = _mask_positions(mask)
    # row i goes to slot pos[i] of its side; the other side's target is
    # the spare row b, cut off after
    big = torch.full_like(pos_t, b)
    spare = x.new_zeros((b + 1,) + tuple(x.shape[1:]))
    out_t = spare.index_copy(0, torch.where(mask, pos_t, big), x)[:b]
    out_f = spare.index_copy(0, torch.where(mask, big, pos_f), x)[:b]
    return {"OutTrue": [out_t], "OutFalse": [out_f]}


@register("merge_lod_tensor", nondiff_slots=("Mask", "X"))
def _merge_lod_tensor(ctx, ins, attrs):
    """Inverse of split: out[i] = InTrue[pos_true(i)] where Mask[i], else
    InFalse[pos_false(i)]. X is unused beyond parity."""
    in_true, in_false = ins["InTrue"][0], ins["InFalse"][0]
    mask = ins["Mask"][0].reshape(-1).to(torch.bool)
    pos_t, pos_f = _mask_positions(mask)
    rows_t = in_true.index_select(0, pos_t)
    rows_f = in_false.index_select(0, pos_f)
    return {"Out": [torch.where(_mask_rows(mask, rows_t), rows_t, rows_f)]}


@register("reorder_lod_tensor_by_rank", nondiff_slots=("RankTable",))
def _reorder_lod_tensor_by_rank(ctx, ins, attrs):
    """Batch rows permuted into the rank table's (desc-length) order: how
    DynamicRNN aligns a batch-ordered init memory or static input."""
    x = ins["X"][0]
    table = ins["RankTable"][0]
    return {"Out": [x.index_select(0, table[:, 0].long())]}


@register("lod_array_length", nondiff_slots=("X",))
def _lod_array_length(ctx, ins, attrs):
    """An array's length as an int32 [1] tensor (int64 lives as int32 on
    the device, framework/dtype.py)."""
    arr = ins["X"][0]
    length = torch.zeros((), dtype=torch.int32, device=ctx.device) \
        if arr is None else arr[1]
    return {"Out": [length.reshape(1).to(torch.int32)]}


@register("tensor_array_to_tensor", nondiff_slots=())
def _tensor_array_to_tensor(ctx, ins, attrs):
    """An array's slots fused into one tensor: stacked on a new `axis`
    (use_stack) or concatenated along `axis`. Every `capacity` slot takes
    part (unwritten slots are zeros); OutIndex is each slot's size along
    the concat axis."""
    buf, _length = ins["X"][0]
    axis = int(attrs.get("axis", 0))
    use_stack = bool(attrs.get("use_stack", False))
    if axis < 0:                     # against the slot's rank
        axis += buf.dim() - 1 if not use_stack else buf.dim()
    t = buf.shape[0]
    if use_stack:
        out = buf.movedim(0, axis) if axis else buf
    else:
        # concat of the T slots along `axis`: a slot-major merge of the
        # (T, axis) dims
        moved = buf.movedim(0, axis)
        shp = list(moved.shape)
        shp[axis:axis + 2] = [shp[axis] * shp[axis + 1]]
        out = moved.reshape(shp)
    sizes = torch.full((t,), 1 if use_stack else buf.shape[1 + axis],
                       dtype=torch.int32, device=buf.device)
    return {"Out": [out], "OutIndex": [sizes]}
