"""Neural-net lowerings (counterpart of paddle_tpu/ops/nn_ops.py): the ones
the BERT pretrain program uses."""
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


@register("dropout", is_random=True)
def _dropout(ctx, ins, attrs):
    """The keep mask comes from a generator seeded by the op's key, so the
    forward and a recomputing __vjp__ draw the same mask (the reference
    uses rng.fast_keep_mask on the same key; the bits differ between the
    packages)."""
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False) or p == 0.0:
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": [out], "Mask": [torch.ones(x.shape, dtype=torch.uint8,
                                                  device=x.device)]}
    if ctx.is_eval_shape:
        keep = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    else:
        keep = torch.rand(x.shape, generator=ctx.generator(attrs, x.device),
                          device=x.device) < (1.0 - p)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if impl == "upscale_in_train":
        out = torch.where(keep, x / (1.0 - p), zero).to(x.dtype)
    else:
        out = torch.where(keep, x, zero).to(x.dtype)
    return {"Out": [out], "Mask": [keep.to(torch.uint8)]}


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
