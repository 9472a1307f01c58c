"""Tensor creation / manipulation lowerings (counterpart of
paddle_tpu/ops/tensor_ops.py): the ones the BERT pretrain and startup
programs use."""
from __future__ import annotations

import torch

from .registry import register
# on-device dtype policy: int64 ids live as int32 (framework/dtype.py)
from ..framework.dtype import device_dtype as convert_dtype


@register("fill_constant")
def _fill_constant(ctx, ins, attrs):
    shape = attrs.get("shape", [1])
    dtype = convert_dtype(attrs.get("dtype", "float32"))
    value = attrs.get("value", 0.0)
    return {"Out": [torch.full(tuple(shape), value, dtype=dtype,
                               device=ctx.device)]}


@register("truncated_gaussian_random", is_random=True)
def _truncated_gaussian_random(ctx, ins, attrs):
    """Normal(mean, std) cut at two standard deviations, drawn from a
    generator seeded by the op's key (the values differ from the
    reference's jax.random draw; parity tests carry startup arrays
    across instead)."""
    shape = tuple(attrs.get("shape", [1]))
    dtype = convert_dtype(attrs.get("dtype", "float32"))
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    out = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    if not ctx.is_eval_shape:
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                    generator=ctx.generator(attrs))
        out = out * std + mean
    return {"Out": [out.to(dtype)]}


def _xshape(x):
    return torch.zeros((0,), dtype=x.dtype, device=x.device)


@register("reshape2")
def _reshape2(ctx, ins, attrs):
    x = ins["X"][0]
    shape = list(attrs["shape"])
    # fluid semantics: 0 copies the input dim at that position; -1 infers
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    return {"Out": [x.reshape(tuple(shape))], "XShape": [_xshape(x)]}


@register("transpose2")
def _transpose2(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.permute(*attrs["axis"])], "XShape": [_xshape(x)]}


@register("unsqueeze2")
def _unsqueeze2(ctx, ins, attrs):
    x = ins["X"][0]
    out = x
    for a in sorted(attrs["axes"]):
        out = out.unsqueeze(a)
    return {"Out": [out], "XShape": [_xshape(out)]}


@register("split")
def _split(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        outs = torch.split(x, list(sections), dim=axis)
    else:
        num = attrs.get("num", 0)
        outs = torch.split(x, x.shape[axis] // num, dim=axis)
    return {"Out": list(outs)}


@register("slice")
def _slice(ctx, ins, attrs):
    x = ins["Input"][0]
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    out = x[tuple(idx)]
    for a in sorted(attrs.get("decrease_axis", []), reverse=True):
        out = out.squeeze(a)
    return {"Out": [out]}

