"""Sequence (LoD) and recurrent op lowerings (counterpart of
paddle_tpu/ops/sequence_ops.py).

Sequences are padded-dense [batch, max_len, ...] plus an int32 length
vector (the reference's representation); every op here is a masked
lowering over it. A missing SeqLen input means every row is full length.

Gate conventions, as the reference's kernels:
- LSTM: 4H gate layout {candidate, input, forget, output};
  c_t = act_cand(cand) * sig(i) + c_{t-1} * sig(f); h_t = sig(o) *
  act_cell(c_t).
- GRU (origin_mode False): 3H layout {update, reset, candidate};
  h_t = (1 - u) * h_{t-1} + u * m.

The recurrences run as a Python loop over time, one step's ops a
timestep; rows past their length keep their h / c and emit zeros, and
`is_reverse` reverses each row within its own length. The recurrent
product `h @ w` is `torch.matmul`, as it is outside any Pallas kernel in
the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.dtype import device_dtype
from .registry import register


def _lengths(ins, batch, T, device):
    sl = ins.get("SeqLen", [None])[0]
    if sl is None:
        return torch.full((batch,), T, dtype=torch.int32, device=device)
    return sl.reshape(-1).to(torch.int32)


def _time_mask(lengths, T):
    """[b, T] bool validity mask."""
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def _expand_mask(mask, x):
    """A [b, T] mask broadcast over `x`'s trailing dims."""
    return mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - mask.dim()))


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _gather_time(x, idx):
    """x[i, idx[i, t], ...]: a [b, T'] index along dim 1."""
    full = idx.long().reshape(tuple(idx.shape) + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, full.expand(tuple(idx.shape) + tuple(x.shape[2:])))


def _reverse_index(lengths, T):
    """Each row's positions reversed within its own length."""
    t = torch.arange(T, device=lengths.device)[None, :]
    return torch.where(t < lengths[:, None], lengths[:, None] - 1 - t, t)


# ---------------------------------------------------------------------------
# masked sequence ops
# ---------------------------------------------------------------------------

@register("sequence_mask")
def _sequence_mask(ctx, ins, attrs):
    lengths = ins["X"][0].reshape(-1).to(torch.int32)
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise ValueError("sequence_mask needs a static maxlen attr")
    dtype = device_dtype(attrs.get("out_dtype", "int64"))
    return {"Y": [_time_mask(lengths, int(maxlen)).to(dtype)]}


@register("sequence_pool")
def _sequence_pool(ctx, ins, attrs):
    x = ins["X"][0]                      # [b, T, ...]
    b, T = x.shape[0], x.shape[1]
    lengths = _lengths(ins, b, T, x.device)
    m = _expand_mask(_time_mask(lengths, T), x)
    ptype = attrs.get("pool_type", "average").lower()
    pad_value = attrs.get("pad_value", 0.0)
    denom = lengths.clamp(min=1).reshape((b,) + (1,) * (x.dim() - 2))
    xm = torch.where(m, x, _zero(x))
    if ptype == "sum":
        out = xm.sum(dim=1)
    elif ptype == "average":
        out = xm.sum(dim=1) / denom.to(x.dtype)
    elif ptype == "sqrt":
        out = xm.sum(dim=1) / torch.sqrt(denom.to(x.dtype))
    elif ptype == "max":
        neg = -torch.inf if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        # amax: a gradient shared among tied maxima, as jax's
        out = torch.where(m, x, torch.full((), neg, dtype=x.dtype,
                                           device=x.device)).amax(dim=1)
    elif ptype == "first":
        out = x[:, 0]
    elif ptype == "last":
        idx = (lengths - 1).clamp(min=0).reshape(b, 1)
        out = _gather_time(x, idx).squeeze(1)
    else:
        raise NotImplementedError(f"sequence_pool type {ptype!r}")
    # rows of length 0 take pad_value
    empty = (lengths == 0).reshape((b,) + (1,) * (x.dim() - 2))
    out = torch.where(empty, torch.full((), pad_value, dtype=x.dtype,
                                        device=x.device), out)
    return {"Out": [out]}


@register("sequence_softmax")
def _sequence_softmax(ctx, ins, attrs):
    x = ins["X"][0]                      # [b, T] or [b, T, 1]
    orig_shape = x.shape
    if x.dim() == 3 and x.shape[-1] == 1:
        x = x[..., 0]
    b, T = x.shape
    mask = _time_mask(_lengths(ins, b, T, x.device), T)
    logits = torch.where(mask, x, torch.full((), -1e30, dtype=x.dtype,
                                             device=x.device))
    p = torch.softmax(logits, dim=1)
    p = torch.where(mask, p, _zero(p))
    return {"Out": [p.reshape(orig_shape)]}


@register("sequence_reverse")
def _sequence_reverse(ctx, ins, attrs):
    x = ins["X"][0]
    b, T = x.shape[0], x.shape[1]
    lengths = _lengths(ins, b, T, x.device)
    return {"Y": [_gather_time(x, _reverse_index(lengths, T))]}


@register("sequence_expand_as")
def _sequence_expand_as(ctx, ins, attrs):
    x = ins["X"][0]                      # [b, d...]
    y = ins["Y"][0]                      # [b, T, ...] gives the time axis
    b, T = y.shape[0], y.shape[1]
    lengths = _lengths(ins, b, T, x.device)
    out = x[:, None].expand((b, T) + tuple(x.shape[1:]))
    m = _expand_mask(_time_mask(lengths, T), out)
    return {"Out": [torch.where(m, out, _zero(x))]}


@register("sequence_pad")
def _sequence_pad(ctx, ins, attrs):
    x = ins["X"][0]                      # already padded-dense [b, T, ...]
    b, T = x.shape[0], x.shape[1]
    lengths = _lengths(ins, b, T, x.device)
    pad_value = ins.get("PadValue", [None])[0]
    pv = _zero(x) if pad_value is None else pad_value.reshape(()).to(x.dtype)
    m = _expand_mask(_time_mask(lengths, T), x)
    return {"Out": [torch.where(m, x, pv)],
            "Length": [lengths.to(torch.int32)]}


@register("sequence_unpad")
def _sequence_unpad(ctx, ins, attrs):
    x = ins["X"][0]
    T = x.shape[1]
    lengths = ins["Length"][0].reshape(-1).to(torch.int32)
    m = _expand_mask(_time_mask(lengths, T), x)
    return {"Out": [torch.where(m, x, _zero(x))]}


@register("sequence_concat")
def _sequence_concat(ctx, ins, attrs):
    """Concat along time: row i = [valid(a_i); valid(b_i); ...] then
    padding, by a gather over the inputs laid end to end."""
    xs = ins["X"]
    lens = ins.get("SeqLens", [])
    b = xs[0].shape[0]
    dev = xs[0].device
    starts, lengths_list = [], []
    offset = 0
    for k, x in enumerate(xs):
        T = x.shape[1]
        ln = (lens[k].reshape(-1).to(torch.int32)
              if k < len(lens) and lens[k] is not None
              else torch.full((b,), T, dtype=torch.int32, device=dev))
        starts.append(offset)
        lengths_list.append(ln)
        offset += T
    src = torch.cat(list(xs), dim=1)              # [b, sum(T), ...]
    total_T = src.shape[1]
    out_len = lengths_list[0]
    for ln in lengths_list[1:]:
        out_len = out_len + ln
    t = torch.arange(total_T, device=dev)[None, :].expand(b, total_T)
    idx = torch.zeros((b, total_T), dtype=torch.int64, device=dev)
    cum = torch.zeros((b,), dtype=torch.int32, device=dev)
    for k in range(len(xs)):
        ln = lengths_list[k]
        in_this = (t >= cum[:, None]) & (t < (cum + ln)[:, None])
        idx = torch.where(in_this, starts[k] + (t - cum[:, None]), idx)
        cum = cum + ln
    out = _gather_time(src, idx)
    m = _expand_mask(_time_mask(out_len, total_T), src)
    return {"Out": [torch.where(m, out, _zero(src))], "Length": [out_len]}


@register("sequence_conv")
def _sequence_conv(ctx, ins, attrs):
    """Context-window conv over time: a [context_length] window around
    each step, flattened, times the filter [context_length * d,
    num_filters]."""
    x = ins["X"][0]                      # [b, T, d]
    filt = ins["Filter"][0]              # [cl*d, nf]
    b, T, d = x.shape
    cl = int(attrs.get("context_length", 3))
    cstart = attrs.get("context_start", None)
    if cstart is None:
        cstart = -((cl - 1) // 2)
    mask = _time_mask(_lengths(ins, b, T, x.device), T)
    xm = torch.where(mask[..., None], x, _zero(x))
    t = torch.arange(T, device=x.device)
    cols = []
    for k in range(cl):
        shift = int(cstart) + k
        rolled = torch.roll(xm, -shift, dims=1)
        valid = (t + shift >= 0) & (t + shift < T)
        cols.append(torch.where(valid[None, :, None], rolled, _zero(x)))
    windows = torch.cat(cols, dim=-1)            # [b, T, cl*d]
    out = torch.matmul(windows, filt)
    return {"Out": [torch.where(mask[..., None], out, _zero(out))]}


# ---------------------------------------------------------------------------
# recurrent ops
# ---------------------------------------------------------------------------

_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda v: v,
}


def _steps(x):
    """[b, T, ...] -> the T time slices."""
    return x.unbind(1)


@register("lstm")
def _lstm(ctx, ins, attrs):
    x = ins["Input"][0]                  # [b, T, 4H] pre-projected gates
    w = ins["Weight"][0]                 # [H, 4H]
    bias = ins.get("Bias", [None])[0]    # [4H]
    b, T, H4 = x.shape
    H = H4 // 4
    h = ins.get("H0", [None])[0]
    c = ins.get("C0", [None])[0]
    h = x.new_zeros((b, H)) if h is None else h
    c = x.new_zeros((b, H)) if c is None else c
    lengths = _lengths(ins, b, T, x.device)
    act_gate = _ACTS[attrs.get("gate_activation", "sigmoid")]
    act_cell = _ACTS[attrs.get("cell_activation", "tanh")]
    act_cand = _ACTS[attrs.get("candidate_activation", "tanh")]
    is_reverse = bool(attrs.get("is_reverse", False))
    if is_reverse:
        ridx = _reverse_index(lengths, T)
        x = _gather_time(x, ridx)
    bias4 = None if bias is None else bias.reshape(-1)[:4 * H]
    hs, cs = [], []
    for t, x_t in enumerate(_steps(x)):
        gates = x_t + torch.matmul(h, w)
        if bias4 is not None:
            gates = gates + bias4
        cand = act_cand(gates[:, :H])            # {c, i, f, o} layout
        i = act_gate(gates[:, H:2 * H])
        f = act_gate(gates[:, 2 * H:3 * H])
        o = act_gate(gates[:, 3 * H:])
        c_new = cand * i + c * f
        h_new = o * act_cell(c_new)
        valid = (t < lengths)[:, None]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        hs.append(torch.where(valid, h_new, _zero(h_new)))
        cs.append(torch.where(valid, c_new, _zero(c_new)))
    hidden = torch.stack(hs, dim=1)
    cell = torch.stack(cs, dim=1)
    if is_reverse:
        hidden = _gather_time(hidden, ridx)
        cell = _gather_time(cell, ridx)
    return {"Hidden": [hidden], "Cell": [cell], "LastH": [h], "LastC": [c]}


@register("gru")
def _gru(ctx, ins, attrs):
    x = ins["Input"][0]                  # [b, T, 3H] pre-projected
    w = ins["Weight"][0]                 # [H, 3H]: [:, :2H] gates, [:, 2H:] cand
    bias = ins.get("Bias", [None])[0]
    # a hidden-side bias with the 2.0 API's semantics: its candidate third
    # sits inside the reset-gate product, m = act(cx + r * (h @ w_c +
    # b_hh_c)); the plain Bias adds to the projected input (fluid)
    bias_hh = ins.get("BiasHH", [None])[0]
    b, T, H3 = x.shape
    H = H3 // 3
    h = ins.get("H0", [None])[0]
    h = x.new_zeros((b, H)) if h is None else h
    lengths = _lengths(ins, b, T, x.device)
    act_gate = _ACTS[attrs.get("gate_activation", "sigmoid")]
    act_cand = _ACTS[attrs.get("activation", "tanh")]
    origin_mode = bool(attrs.get("origin_mode", False))
    w_g, w_c = w[:, :2 * H], w[:, 2 * H:]
    hs = []
    for t, x_t in enumerate(_steps(x)):
        gx, cx = x_t[:, :2 * H], x_t[:, 2 * H:]
        if bias is not None:
            flat = bias.reshape(-1)
            gx = gx + flat[:2 * H]
            cx = cx + flat[2 * H:3 * H]
        hg = torch.matmul(h, w_g)
        if bias_hh is not None:
            hh = bias_hh.reshape(-1)
            g = act_gate(gx + hg + hh[:2 * H])
            u, r = g[:, :H], g[:, H:]
            m = act_cand(cx + r * (torch.matmul(h, w_c) + hh[2 * H:3 * H]))
        else:
            # fluid: reset h before projecting it
            g = act_gate(gx + hg)
            u, r = g[:, :H], g[:, H:]
            m = act_cand(cx + torch.matmul(r * h, w_c))
        if origin_mode:
            h_new = u * h + (1.0 - u) * m
        else:
            h_new = (1.0 - u) * h + u * m
        valid = (t < lengths)[:, None]
        h = torch.where(valid, h_new, h)
        hs.append(torch.where(valid, h_new, _zero(h_new)))
    return {"Hidden": [torch.stack(hs, dim=1)], "LastH": [h]}


@register("simple_rnn")
def _simple_rnn(ctx, ins, attrs):
    x = ins["Input"][0]                  # [b, T, H] pre-projected
    w = ins["Weight"][0]                 # [H, H]
    bias = ins.get("Bias", [None])[0]
    b, T, H = x.shape
    h = ins.get("H0", [None])[0]
    h = x.new_zeros((b, H)) if h is None else h
    lengths = _lengths(ins, b, T, x.device)
    act = _ACTS[attrs.get("activation", "tanh")]
    hs = []
    for t, x_t in enumerate(_steps(x)):
        pre = x_t + torch.matmul(h, w)
        if bias is not None:
            pre = pre + bias.reshape(-1)
        h_new = act(pre)
        valid = (t < lengths)[:, None]
        h = torch.where(valid, h_new, h)
        hs.append(torch.where(valid, h_new, _zero(h_new)))
    return {"Hidden": [torch.stack(hs, dim=1)], "LastH": [h]}


# ---------------------------------------------------------------------------
# sequence tail ops on the padded-dense + length-vector representation
# ---------------------------------------------------------------------------

@register("sequence_slice")
def _sequence_slice(ctx, ins, attrs):
    """Per-row crop: out[i] = x[i, offset[i]:offset[i]+length[i]]
    left-packed; the output stays [b, T, ...]; SeqLenOut = length."""
    x = ins["X"][0]                       # [b, T, ...]
    off = ins["Offset"][0].reshape(-1).to(torch.int32)
    ln = ins["Length"][0].reshape(-1).to(torch.int32)
    b, T = x.shape[0], x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    src = (off[:, None] + t).clamp(0, T - 1)         # [b, T]
    gathered = _gather_time(x, src)
    mask = _expand_mask(t < ln[:, None], x)
    return {"Out": [torch.where(mask, gathered, _zero(x))],
            "SeqLenOut": [ln]}


@register("sequence_erase")
def _sequence_erase(ctx, ins, attrs):
    """The listed tokens removed and the survivors left-packed (a stable
    sort)."""
    x = ins["X"][0]                       # [b, T] int tokens
    b, T = x.shape[0], x.shape[1]
    lengths = _lengths(ins, b, T, x.device)
    keep = _time_mask(lengths, T)
    for tok in attrs.get("tokens", []):
        keep = keep & (x != tok)
    # stable left-pack: positions sorted by (dropped, position)
    key = torch.where(keep, 0, 1) * T + torch.arange(T, device=x.device)[None]
    order = torch.argsort(key, dim=1, stable=True)
    packed = torch.gather(x, 1, order)
    new_len = keep.sum(dim=1).to(torch.int32)
    packed = torch.where(_time_mask(new_len, T), packed, _zero(packed))
    return {"Out": [packed], "SeqLenOut": [new_len]}


@register("sequence_scatter")
def _sequence_scatter(ctx, ins, attrs):
    """out[i, ids[i, t]] += updates[i, t] for valid t; an id out of range
    is dropped."""
    x = ins["X"][0]                       # [b, D]
    ids = ins["Ids"][0]                   # [b, T] int positions
    upd = ins["Updates"][0]               # [b, T]
    b, T = ids.shape[0], ids.shape[1]
    D = x.shape[1]
    lengths = _lengths(ins, b, T, x.device)
    vals = torch.where(_time_mask(lengths, T), upd, _zero(upd)).to(x.dtype)
    j = ids.to(torch.int64)
    j = torch.where(j < 0, j + D, j)
    ok = (j >= 0) & (j < D)
    vals = torch.where(ok, vals, _zero(vals))
    return {"Out": [x.scatter_add(1, j.clamp(0, D - 1), vals)]}


@register("sequence_enumerate")
def _sequence_enumerate(ctx, ins, attrs):
    """Sliding windows of win_size ids, pad_value past the end."""
    x = ins["X"][0]                       # [b, T] int ids
    win = attrs.get("win_size", 2)
    pad = attrs.get("pad_value", 0)
    b, T = x.shape[0], x.shape[1]
    lengths = _lengths(ins, b, T, x.device)
    src = (torch.arange(T, device=x.device)[:, None]
           + torch.arange(win, device=x.device)[None, :])   # [T, win]
    gathered = x[:, src.clamp(0, T - 1)]                     # [b, T, win]
    in_seq = src[None] < lengths[:, None, None]
    return {"Out": [torch.where(in_seq, gathered,
                                torch.full((), pad, dtype=x.dtype,
                                           device=x.device))]}


@register("sequence_reshape")
def _sequence_reshape(ctx, ins, attrs):
    """The token width changed: [b, T, D] -> [b, T*D/nd, nd]; lengths
    scale by D/nd."""
    x = ins["X"][0]
    nd = attrs["new_dim"]
    b, T, D = x.shape[0], x.shape[1], int(np.prod(x.shape[2:]))
    lengths = _lengths(ins, b, T, x.device)
    out = x.reshape(b, T * D // nd, nd)
    new_len = torch.div(lengths * D, nd, rounding_mode="floor")
    return {"Out": [out], "SeqLenOut": [new_len.to(torch.int32)]}


@register("sequence_expand")
def _sequence_expand(ctx, ins, attrs):
    """Row i of X tiled to Y's i-th sequence length along time."""
    x = ins["X"][0]                       # [b, Tx, ...] or [b, ...]
    y = ins["Y"][0]                       # only its time axis matters
    b = x.shape[0]
    Ty = y.shape[1]
    ylen = _lengths({"SeqLen": ins.get("YSeqLen", [None])}, b, Ty, x.device)
    if x.dim() == 2:                      # one row per sequence: tile rows
        out = x[:, None, :].expand(b, Ty, x.shape[1])
        mask = _time_mask(ylen, Ty)[..., None]
        return {"Out": [torch.where(mask, out, _zero(x))],
                "SeqLenOut": [ylen]}
    # general: x's valid prefix cycled along time
    xlen = _lengths(ins, b, x.shape[1], x.device)
    idx = torch.arange(Ty, device=x.device)[None, :] % xlen[:, None].clamp(
        min=1)
    out = _gather_time(x, idx)
    mask = _expand_mask(_time_mask(ylen, Ty), out)
    return {"Out": [torch.where(mask, out, _zero(x))], "SeqLenOut": [ylen]}


@register("sequence_topk_avg_pooling")
def _sequence_topk_avg_pooling(ctx, ins, attrs):
    """Pyramid text-match pooling: X a per-pair score pyramid [b, C, R,
    Ccol]; for each (row, channel) the top-k over the valid columns
    averaged, for every k in topks. Output [b, R, C * num_k]."""
    x = ins["X"][0]                       # [b, C, R, Cc]
    topks = list(attrs.get("topks", [1]))
    b, C, Rr, Cc = x.shape
    col_len = _lengths({"SeqLen": ins.get("COLUMN", [None])}, b, Cc,
                       x.device)
    neg = torch.finfo(x.dtype).min
    valid = (torch.arange(Cc, device=x.device)[None, None, None, :]
             < col_len[:, None, None, None])
    masked = torch.where(valid, x, torch.full((), neg, dtype=x.dtype,
                                              device=x.device))
    srt = -torch.sort(-masked, dim=-1).values     # descending over columns
    csum = torch.cumsum(torch.where(srt == neg, _zero(srt), srt), dim=-1)
    outs = []
    for k in topks:
        kk = col_len.clamp(max=k)                 # [b]
        take = kk.clamp(1, Cc)
        at = (take - 1).long()[:, None, None, None].expand(b, C, Rr, 1)
        picked = torch.gather(csum, -1, at)[..., 0]
        avg = picked / kk.clamp(min=1)[:, None, None].to(x.dtype)
        avg = torch.where(col_len[:, None, None] > 0, avg, _zero(avg))
        outs.append(avg)                          # [b, C, R]
    out = torch.stack(outs, dim=-1)               # [b, C, R, nk]
    out = out.movedim(1, 2).reshape(b, Rr, C * len(topks))
    return {"Out": [out], "pos": [None]}
