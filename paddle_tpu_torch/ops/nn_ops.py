"""Neural-net lowerings (counterpart of paddle_tpu/ops/nn_ops.py): the ones
the BERT pretrain program and the fc regression model use."""
from __future__ import annotations

import torch

from .registry import register


@register("softmax_with_cross_entropy", nondiff_slots=("Label",))
def _softmax_with_cross_entropy(ctx, ins, attrs):
    """Hard labels equal to ignore_index get zero loss and zero grads (the
    where() routes their cotangent to the constant branch)."""
    logits, label = ins["Logits"][0], ins["Label"][0]
    axis = attrs.get("axis", -1)
    logp = torch.log_softmax(logits, dim=axis)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        idx = label.long()
        if idx.dim() == logits.dim():
            idx = idx.squeeze(axis)
        keep = idx != attrs.get("ignore_index", -100)
        safe = torch.where(keep, idx, torch.zeros_like(idx))
        picked = torch.take_along_dim(logp, safe.unsqueeze(-1), dim=axis)
        loss = torch.where(keep.unsqueeze(-1), -picked,
                           torch.zeros_like(picked))
    return {"Softmax": [torch.exp(logp)], "Loss": [loss]}


@register("square_error_cost", nondiff_slots=())
def _square_error_cost(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": [torch.square(x - y)]}


@register("layer_norm")
def _layer_norm(ctx, ins, attrs):
    """Normalise over dims >= begin_norm_axis, in f32."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    bna = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(bna, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=axes, keepdim=True)
    y = (xf - mean) / torch.sqrt(var + eps)
    if ins.get("Scale"):
        y = y * ins["Scale"][0].float()
    if ins.get("Bias"):
        y = y + ins["Bias"][0].float()
    return {"Y": [y.to(x.dtype)],
            "Mean": [mean.reshape(x.shape[:bna])],
            "Variance": [var.reshape(x.shape[:bna])]}


# odd multipliers of the dropout hash (murmur3 fmix32 and the flash
# kernels' position mixers) as int32 values: int32 products wrap mod 2**32
_H1, _H2 = 0x85EB_CA6B - (1 << 32), 0xC2B2_AE35 - (1 << 32)
_I32_MIN = -(1 << 31)


def _srl(x, n: int):
    """Logical right shift of int32 bits (torch's >> is arithmetic)."""
    return (x >> n) & ((1 << (32 - n)) - 1)


def keep_mask(key, shape, rate: float, device, block=None):
    """The dropout keep mask: element (r, c) of `shape` viewed as [rows,
    last dim] is kept when fmix32((r * H1) ^ (c * H2) ^ key), as uint32, is
    at least the flash kernels' threshold for `rate` (P(keep) = 1 - rate).
    The layout of the flash kernels' `keep_mask` with one head; int32
    arithmetic that wraps, compared as unsigned by flipping the sign bit.
    `key` is a one-element int32 tensor (ctx.op_seed) or an int. `block`
    ([(start, size)] per dim of `shape`) asks for that block of the mask
    only, keyed on its elements' indices in the whole of `shape` (a
    DTensor's local shard, parallel/gspmd.py `block_offsets`)."""
    from .kernels.flash_attention import dropout_threshold
    if block is None or not len(shape):
        cols = shape[-1] if len(shape) else 1
        rows = max(1, torch.Size(shape).numel() // max(cols, 1))
        r = torch.arange(rows, dtype=torch.int32, device=device)
        c = torch.arange(cols, dtype=torch.int32, device=device)
        out_shape = shape
    else:
        # the global row index of each local row: sum of index * stride
        # over the leading dims of `shape`
        lead = [n for _, n in block[:-1]]
        r = torch.zeros(lead, dtype=torch.int64, device=device)
        stride = 1
        for d in reversed(range(len(lead))):
            view = [1] * len(lead)
            view[d] = lead[d]
            idx = block[d][0] + torch.arange(lead[d], dtype=torch.int64,
                                             device=device)
            r = r + idx.view(view) * stride
            stride *= int(shape[d])
        rows, cols = max(1, r.numel()), block[-1][1]
        r = r.reshape(-1).to(torch.int32)
        c = (block[-1][0] + torch.arange(cols, dtype=torch.int64,
                                         device=device)).to(torch.int32)
        out_shape = tuple(n for _, n in block)
    r = r * _H1
    c = c * _H2
    x = (r.view(rows, 1) ^ c.view(1, cols)) ^ key
    x = x ^ _srl(x, 16)
    x = x * _H1
    x = x ^ _srl(x, 13)
    x = x * _H2
    x = x ^ _srl(x, 16)
    thresh = dropout_threshold(rate) + _I32_MIN
    return ((x ^ _I32_MIN) >= thresh).reshape(out_shape)


@register("dropout", is_random=True)
def _dropout(ctx, ins, attrs):
    """The keep mask is a counter hash of the op's device key
    (ctx.op_seed) and the element index, so the forward and a recomputing
    __vjp__ draw the same mask, and a captured step draws a new one per
    replay from its seed buffer (the reference uses rng.fast_keep_mask on
    its key; the bits differ between the packages)."""
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False) or p == 0.0:
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": [out], "Mask": [torch.ones(x.shape, dtype=torch.uint8,
                                                  device=x.device)]}
    from ..parallel import gspmd
    key = None if ctx.is_eval_shape else ctx.op_seed(attrs)
    block = gspmd.block_offsets(x) if gspmd.is_dtensor(x) else None

    def body(x):
        if key is None:
            keep = torch.empty(x.shape, dtype=torch.bool, device=x.device)
        else:
            keep = keep_mask(key, shape, p, x.device, block)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        if impl == "upscale_in_train":
            out = torch.where(keep, x / (1.0 - p), zero).to(x.dtype)
        else:
            out = torch.where(keep, x, zero).to(x.dtype)
        return out, keep.to(torch.uint8)

    shape = tuple(x.shape)
    if block is None:
        out, mask = body(x)
    else:
        # on a mesh: this rank's block of the mask, keyed on the global
        # element indices, so every layout draws the unsharded mask
        out, mask = gspmd.local_call(body, (x,), [x.placements] * 2,
                                     shapes=[shape] * 2)
    return {"Out": [out], "Mask": [mask]}


@register("lookup_table", nondiff_slots=("Ids",))
def _lookup_table(ctx, ins, attrs):
    """Ids carry a trailing 1-dim."""
    w, ids = ins["W"][0], ins["Ids"][0]
    idx = ids
    if idx.dim() and idx.shape[-1] == 1:
        idx = idx.squeeze(-1)
    if attrs.get("is_sparse", False):
        raise NotImplementedError(
            "lookup_table is_sparse=True (SelectedRows grads) is not "
            "ported yet")
    out = torch.nn.functional.embedding(idx, w)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad >= 0:
        out = torch.where((idx == pad).unsqueeze(-1),
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return {"Out": [out]}
