"""Math / elementwise / reduce / matmul lowerings (counterpart of
paddle_tpu/ops/math_ops.py): the ones the BERT pretrain program uses, and
the ones gradient clipping and weight-decay regularisation append
(clip.py, regularizer.py). Large matrix products go to `torch.matmul`, as
the reference leaves them to XLA."""
from __future__ import annotations

import math

import torch

from .registry import register


def _bcast_y(x, y, axis):
    """Fluid elementwise broadcasting: Y's shape is a contiguous
    subsequence of X's; `axis` is where it aligns (-1 = trailing)."""
    if x.dim() == y.dim():
        return y
    if axis == -1 or axis is None:
        axis = x.dim() - y.dim()
    new_shape = (1,) * axis + tuple(y.shape) \
        + (1,) * (x.dim() - axis - y.dim())
    return y.reshape(new_shape)


def _elementwise(name, fn):
    @register(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        x, y = ins["X"][0], ins["Y"][0]
        return {"Out": [_fn(x, _bcast_y(x, y, attrs.get("axis", -1)))]}
    return _lower


_elementwise("elementwise_add", torch.add)
_elementwise("elementwise_mul", torch.mul)
_elementwise("elementwise_div", torch.div)
_elementwise("elementwise_max", torch.maximum)


def _unary(name, fn):
    @register(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(ins["X"][0])]}
    return _lower


_unary("sqrt", torch.sqrt)
_unary("square", torch.square)
_unary("sign", torch.sign)


@register("reduce_sum")
def _reduce_sum(ctx, ins, attrs):
    x = ins["X"][0]
    dim = attrs.get("dim", [0])
    keep_dim = attrs.get("keep_dim", False)
    if attrs.get("reduce_all", False) or dim is None:
        axes = tuple(range(x.dim()))
    else:
        dims = dim if isinstance(dim, (list, tuple)) else [dim]
        axes = tuple(d % x.dim() for d in dims)
    return {"Out": [torch.sum(x, dim=axes, keepdim=keep_dim)]}


@register("clip")
def _clip(ctx, ins, attrs):
    return {"Out": [torch.clamp(ins["X"][0], attrs.get("min"),
                                attrs.get("max"))]}


@register("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    x = ins["X"][0]
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones((), dtype=norm.dtype, device=x.device))
    return {"Out": [x * scale.to(x.dtype)]}


@register("gelu")
def _gelu(ctx, ins, attrs):
    approx = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": [torch.nn.functional.gelu(ins["X"][0],
                                             approximate=approx)]}


@register("scale")
def _scale(ctx, ins, attrs):
    x = ins["X"][0]
    s = attrs.get("scale", 1.0)
    b = torch.tensor(attrs.get("bias", 0.0), dtype=x.dtype, device=x.device)
    if "ScaleTensor" in ins and ins["ScaleTensor"]:
        s = ins["ScaleTensor"][0]
    if attrs.get("bias_after_scale", True):
        out = x * s + b
    else:
        out = (x + b) * s
    return {"Out": [out.to(x.dtype)]}


@register("sum")
def _sum(ctx, ins, attrs):
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register("mean")
def _mean(ctx, ins, attrs):
    return {"Out": [torch.mean(ins["X"][0])]}


@register("mul")
def _mul(ctx, ins, attrs):
    """Flatten to 2-D by num_col_dims, then one GEMM."""
    x, y = ins["X"][0], ins["Y"][0]
    xd = attrs.get("x_num_col_dims", 1)
    yd = attrs.get("y_num_col_dims", 1)
    xm = x.reshape(math.prod(x.shape[:xd]), -1)
    ym = y.reshape(math.prod(y.shape[:yd]), -1)
    out = torch.matmul(xm, ym)
    return {"Out": [out.reshape(tuple(x.shape[:xd]) + tuple(y.shape[yd:]))]}
