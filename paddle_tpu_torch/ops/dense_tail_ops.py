"""The dense tail (counterpart of paddle_tpu/ops/dense_tail_ops.py): every
type of the reference file in its section order, with its flags:
hierarchical sigmoid, edit distance, CTC alignment, the sampling and
statistics types, the small math types and the two SelectedRows helpers.
Each is differentiated by the generic `__vjp__` (`torch.func.vjp` over
the lowering).

Where the reference's arithmetic is not torch's nearest function, it is
written out:

* `hierarchical_sigmoid`'s default tree (SimpleCode) walks floor(log2(
  label + num_classes)) levels, counted here by integer compares, so the
  depth is exact on any device (jax's f32 log2 falls one short at the
  codes 2**13 and 2**15, past the label ranges the tests use).
* `edit_distance` advances one ref token for all hyp positions at once:
  with c[j] = min(row[j] + 1, row[j - 1] + sub[j - 1]) and c[0] the row's
  index, the reference's left-to-right recursion new[j] = min(c[j],
  new[j - 1] + 1) is new[j] = j + cummin_{k <= j}(c[k] - k). The values
  are small integers in f32, so the result is exact.
* `histogram` adds ones into bins + 1 slots with `index_add_` and drops
  the last (the reference's out-of-range `mode="drop"`); `bincount` would
  read its maximum on the host and `histc` rounds its edges otherwise.
* The random types (`multinomial`, `seed`) draw on the device from the
  op's key (`ops/tensor_ops.py` `_random_bits`), never from a host
  generator, so a captured step draws anew on each replay. The reference
  draws from jax's RNG, so the values differ; shapes, ranges and the
  formulas given the draws are what the two packages share.
"""
from __future__ import annotations

import math

import torch

from .extra_ops import _max
from .registry import register
from .sparse_grad import SelectedRows, is_selected_rows, sorted_runs
from .tensor_ops import _canonical, _random_bits, _uniform01


def _i32(x):
    return x.to(torch.int32)


# ---------------------------------------------------------------------------
# hierarchical sigmoid
# ---------------------------------------------------------------------------

def _simple_code(labels, num_classes, max_len):
    """SimpleCode: code = label + num_classes; path node j (top-down) is
    (code >> (len-1-j)) - 1, bit j is (code >> (len-1-j-1)) & 1, with len =
    floor(log2(code))."""
    code = labels.long() + num_classes
    pows = torch.tensor([1 << k for k in range(1, 62)], dtype=torch.long,
                        device=code.device)
    length = (code[:, None] >= pows[None, :]).sum(1)
    j = torch.arange(max_len, dtype=torch.long, device=code.device)
    shift = length[:, None] - j[None, :]
    valid = shift > 0
    s = shift.clamp(min=1)
    zero = torch.zeros((), dtype=torch.long, device=code.device)
    node = torch.where(valid, (code[:, None] >> s) - 1, zero)
    bit = torch.where(valid, (code[:, None] >> (s - 1)) & 1, zero)
    return node, bit.float(), valid


@register("hierarchical_sigmoid",
          nondiff_slots=("Label", "PathTable", "PathCode"))
def _hierarchical_sigmoid(ctx, ins, attrs):
    """Binary-tree softmax: one logistic loss a node on the label's
    root-to-leaf path, summed. Default tree: SimpleCode over num_classes
    leaves; a custom tree passes PathTable / PathCode (-1 pads a path).
    PreOut holds the per-node logits (0 off the path); W_Out is W."""
    x = ins["X"][0]                              # [N, D]
    w = ins["W"][0]                              # [num_nodes, D]
    label = ins["Label"][0].reshape(-1)
    bias = ins.get("Bias", [None])[0]
    path_table = ins.get("PathTable", [None])[0]
    path_code = ins.get("PathCode", [None])[0]
    num_classes = int(attrs.get("num_classes", 2))
    if path_table is not None:
        node = path_table.long()
        valid = node >= 0
        node = node.clamp(min=0)
        bit = path_code.float()
    else:
        max_len = max(1, int(math.ceil(math.log2(max(num_classes, 2)))))
        node, bit, valid = _simple_code(label, num_classes, max_len)
    logit = torch.einsum("nd,nld->nl", x.float(), w[node].float())
    if bias is not None:
        logit = logit + bias.reshape(-1)[node]
    zero = torch.zeros((), dtype=logit.dtype, device=logit.device)
    pre = torch.where(valid, logit, zero)
    # BCE with the target bit: log(1 + e^z) - bit * z, stable
    loss = torch.where(valid, _max(logit, 0.0) - logit * bit
                       + torch.log1p(torch.exp(-logit.abs())), zero)
    out = loss.sum(dim=1, keepdim=True).to(x.dtype)
    return {"Out": [out], "PreOut": [pre.to(x.dtype)], "W_Out": [w]}


# ---------------------------------------------------------------------------
# edit distance
# ---------------------------------------------------------------------------

def _lengths(t, b, full, device):
    if t is None:
        return torch.full((b,), full, dtype=torch.long, device=device)
    return t.reshape(-1).long()


@register("edit_distance",
          nondiff_slots=("Hyps", "Refs", "HypsLength", "RefsLength"))
def _edit_distance(ctx, ins, attrs):
    """Levenshtein distance of each (hyp, ref) pair over padded [B, T]
    ids and their lengths: Tr row updates, each over all hyp positions by
    a running minimum (module docstring); rows past a ref's length do not
    advance. `normalized` divides by the ref's length (at least 1)."""
    hyps, refs = ins["Hyps"][0], ins["Refs"][0]
    if hyps.dim() == 1:
        hyps = hyps[None]
    if refs.dim() == 1:
        refs = refs[None]
    b, th = hyps.shape
    tr = refs.shape[1]
    dev = hyps.device
    hlen = _lengths(ins.get("HypsLength", [None])[0], b, th, dev)
    rlen = _lengths(ins.get("RefsLength", [None])[0], b, tr, dev)
    pos = torch.arange(th + 1, device=dev).float()            # [Th+1]
    row = pos.expand(b, th + 1)
    for r in range(tr):
        sub = (hyps != refs[:, r:r + 1]).float()               # [B, Th]
        c = torch.cat([torch.full((b, 1), r + 1.0, device=dev),
                       torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + sub)],
                      dim=1)
        new = pos + torch.cummin(c - pos, dim=1).values
        row = torch.where((r < rlen)[:, None], new, row)
    d = row.gather(1, hlen[:, None].clamp(0, th))[:, 0]
    if attrs.get("normalized", False):
        d = d / torch.clamp(rlen.float(), min=1.0)
    return {"Out": [d[:, None]],
            "SequenceNum": [torch.full((1,), b, dtype=torch.int32,
                                       device=dev)]}


# ---------------------------------------------------------------------------
# ctc_align
# ---------------------------------------------------------------------------

@register("ctc_align", nondiff_slots=("Input", "InputLength"))
def _ctc_align(ctx, ins, attrs):
    """CTC decode: merge repeats (optional), strip blanks, left-compact,
    pad with padding_value; OutputLength = the kept counts."""
    x = ins["Input"][0]
    if x.dim() == 1:
        x = x[None]
    b, t = x.shape
    lens = _lengths(ins.get("InputLength", [None])[0], b, t, x.device)
    blank = int(attrs.get("blank", 0))
    pad = int(attrs.get("padding_value", 0))
    pos = torch.arange(t, device=x.device)[None, :]
    keep = (pos < lens[:, None]) & (x != blank)
    if attrs.get("merge_repeated", True):
        prev = torch.cat([torch.full((b, 1), -1, dtype=x.dtype,
                                     device=x.device), x[:, :-1]], dim=1)
        keep = keep & ((x != prev) | (pos == 0))
    rank = torch.cumsum(keep.long(), dim=1) - 1
    tgt = torch.where(keep, rank, torch.full_like(rank, t))
    # the dropped entries land in a spare last column
    out = torch.full((b, t + 1), pad, dtype=x.dtype, device=x.device)
    out = out.scatter(1, tgt, x)[:, :t]
    counts = _i32(keep.sum(dim=1, keepdim=True))
    return {"Output": [out], "OutputLength": [counts]}


# ---------------------------------------------------------------------------
# sampling / stats
# ---------------------------------------------------------------------------

@register("multinomial", is_random=True, nondiff_slots=("X",))
def _multinomial(ctx, ins, attrs):
    """Categorical draws from unnormalised probabilities: with replacement
    each draw inverts the row's cumulative sum at a uniform of the op's
    bits; without, Gumbel top-k (the reference's design) with the Gumbel
    noise from the op's bits."""
    x = ins["X"][0].float()
    n = int(attrs.get("num_samples", 1))
    squeeze = x.dim() == 1
    probs = x[None] if squeeze else x
    rows = probs.shape[0]
    if attrs.get("replacement", False):
        cdf = torch.cumsum(torch.clamp(probs, min=0.0), dim=-1)
        u = _uniform01(_random_bits(ctx, attrs, (rows, n), 0))
        out = torch.searchsorted(cdf, u * cdf[:, -1:], right=True)
        out = out.clamp(max=probs.shape[1] - 1)
    else:
        logp = torch.log(torch.clamp(probs, min=1e-30))
        # u in (0, 1): the top 24 bits and a half
        u = ((_random_bits(ctx, attrs, probs.shape, 0) >> 8).float()
             + 0.5) * (1.0 / (1 << 24))
        g = -torch.log(-torch.log(u))
        out = torch.sort(-(logp + g), dim=-1, stable=True).indices[:, :n]
    out = _i32(out)
    return {"Out": [out[0] if squeeze else out]}


@register("histogram", nondiff_slots=("X",))
def _histogram(ctx, ins, attrs):
    """Counts over `bins` equal buckets of [min, max]; with min == max ==
    0 the range is the data's own (max forced above min). Values outside
    the range are dropped."""
    x = ins["X"][0].reshape(-1).float()
    bins = int(attrs.get("bins", 100))
    lo = float(attrs.get("min", 0))
    hi = float(attrs.get("max", 0))
    if lo == 0.0 and hi == 0.0:
        lo_v, hi_v = torch.amin(x), torch.amax(x)
        hi_v = torch.where(hi_v > lo_v, hi_v, lo_v + 1.0)
    else:
        lo_v = torch.full((), lo, device=x.device)
        hi_v = torch.full((), hi, device=x.device)
    idx = torch.floor((x - lo_v) / (hi_v - lo_v) * bins).long()
    idx = idx.clamp(0, bins - 1)
    idx = torch.where((x >= lo_v) & (x <= hi_v), idx,
                      torch.full_like(idx, bins))
    counts = torch.zeros((bins + 1,), dtype=torch.int32, device=x.device)
    counts = counts.index_add(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return {"Out": [counts[:bins]]}


@register("seed", is_random=True)
def _seed(ctx, ins, attrs):
    """The dropout seed: the attribute when it is set, else a draw in
    [1, 2**31 - 1) from the op's bits."""
    s = int(attrs.get("seed", 0))
    if s != 0:
        return {"Out": [torch.full((1,), s, dtype=torch.int32,
                                   device=ctx.device)]}
    bits = _random_bits(ctx, attrs, (1,), 0)
    return {"Out": [_i32(bits % (2 ** 31 - 2) + 1)]}


# ---------------------------------------------------------------------------
# small math ops
# ---------------------------------------------------------------------------

@register("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, ins, attrs):
    """out[n, k] = x[n] W[k] y[n]^T + b[k], in f32."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["Weight"][0]   # w [K, Dx, Dy]
    b = ins.get("Bias", [None])[0]
    xw = torch.einsum("nd,kde->nke", x.float(), w.float())
    out = torch.einsum("nke,ne->nk", xw, y.float())
    if b is not None:
        out = out + b.reshape(1, -1)
    return {"Out": [out.to(x.dtype)]}


@register("add_position_encoding")
def _add_position_encoding(ctx, ins, attrs):
    """out[:, j, k] = alpha x + beta pe[j, k], pe's first half sin(j /
    10000^(k / (half - 1))), its second half the cos (a zero column when
    D is odd)."""
    x = ins["X"][0]                            # [B, T, D]
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 1.0))
    _, t, d = x.shape
    half = d // 2
    dev = x.device
    j = torch.arange(t, dtype=torch.float32, device=dev)[:, None]
    k = torch.arange(half, dtype=torch.float32, device=dev)[None, :]
    denom = torch.pow(torch.full((), 10000.0, device=dev),
                      k / max(half - 1, 1))
    val = j / denom
    pe = torch.cat([torch.sin(val), torch.cos(val)], dim=1)
    if d % 2:
        pe = torch.cat([pe, torch.zeros((t, 1), device=dev)], dim=1)
    return {"Out": [(x * alpha + pe[None].to(x.dtype) * beta).to(x.dtype)]}


@register("squared_l2_distance", nondiff_slots=())
def _squared_l2_distance(ctx, ins, attrs):
    """Row-wise ||x - y||^2 (y broadcasts when it has one row);
    sub_result = x - y."""
    sub = ins["X"][0] - ins["Y"][0]
    return {"Out": [(sub * sub).sum(dim=-1, keepdim=True)],
            "sub_result": [sub]}


@register("modified_huber_loss", nondiff_slots=("Y",))
def _modified_huber_loss(ctx, ins, attrs):
    """z = (2y - 1) x; loss 0 where z >= 1, (1 - z)^2 on [-1, 1), -4z
    below."""
    x, y = ins["X"][0], ins["Y"][0]
    z = (2.0 * y.float() - 1.0) * x.float()
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    loss = torch.where(z >= 1.0, zero,
                       torch.where(z >= -1.0, (1.0 - z) ** 2, -4.0 * z))
    return {"Out": [loss.to(x.dtype)], "IntermediateVal": [z]}


@register("grad_add")
def _grad_add(ctx, ins, attrs):
    """The double-grad machinery's plain add (no broadcast axis)."""
    return {"Out": [ins["X"][0] + ins["Y"][0]]}


@register("fill_zeros_like2")
def _fill_zeros_like2(ctx, ins, attrs):
    """fill_zeros_like with a dtype attribute (device ints are int32)."""
    x = ins["X"][0]
    dt = attrs.get("dtype")
    dtype = _canonical(dt) if dt else x.dtype
    if dtype == torch.int64:
        dtype = torch.int32
    return {"Out": [torch.zeros(x.shape, dtype=dtype, device=x.device)]}


# ---------------------------------------------------------------------------
# SelectedRows utilities
# ---------------------------------------------------------------------------

@register("get_tensor_from_selected_rows", nondiff_slots=("X",))
def _get_tensor_from_selected_rows(ctx, ins, attrs):
    """The rows of a SelectedRows as a dense tensor; a dense input as it
    is."""
    x = ins["X"][0]
    return {"Out": [x.rows if is_selected_rows(x) else x]}


@register("merge_selected_rows", nondiff_slots=("X",))
def _merge_selected_rows(ctx, ins, attrs):
    """Sum duplicate ids into the slot of each id's first occurrence; the
    other slots keep their ids with zero rows (the reference's static
    shape). The sums are `merge_rows`' (`sorted_runs`), moved from the
    sorted order back to the input's."""
    x = ins["X"][0]
    if not is_selected_rows(x):
        return {"Out": [x]}
    _, perm, first, slot, sums = sorted_runs(x)
    rows = torch.where(first.unsqueeze(-1), sums[slot],
                       torch.zeros((), dtype=sums.dtype, device=sums.device))
    return {"Out": [SelectedRows(rows=rows[torch.argsort(perm)],
                                 ids=x.ids.reshape(-1))]}
