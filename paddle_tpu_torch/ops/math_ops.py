"""Math / elementwise / reduce / matmul lowerings (counterpart of
paddle_tpu/ops/math_ops.py): the ones the BERT pretrain and GPT LM
programs use, the fc activations `tanh` and `relu`, the ones gradient
clipping and weight-decay regularisation
append (clip.py, regularizer.py), and the ones the static LR schedules
emit (layers/learning_rate_scheduler.py). Large matrix products go to
`torch.matmul`, as the reference leaves them to XLA. Every op here makes
its constants with `torch.full` on the device, so a schedule runs inside a
captured step."""
from __future__ import annotations

import math

import torch

from .registry import register
from ..framework.dtype import device_dtype


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
_elementwise("elementwise_sub", torch.sub)
_elementwise("elementwise_mul", torch.mul)
_elementwise("elementwise_div", torch.div)
_elementwise("elementwise_max", torch.maximum)
_elementwise("elementwise_min", torch.minimum)
_elementwise("elementwise_pow", torch.pow)


def _unary(name, fn):
    @register(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(ins["X"][0])]}
    return _lower


_unary("sqrt", torch.sqrt)
_unary("square", torch.square)
_unary("sign", torch.sign)
_unary("exp", torch.exp)
_unary("floor", torch.floor)
_unary("ceil", torch.ceil)
_unary("cos", torch.cos)
_unary("tanh", torch.tanh)
_unary("relu", torch.relu)


@register("pow")
def _pow(ctx, ins, attrs):
    return {"Out": [torch.pow(ins["X"][0], attrs.get("factor", 1.0))]}


@register("cast", nondiff_slots=("X",))
def _cast(ctx, ins, attrs):
    return {"Out": [ins["X"][0].to(
        device_dtype(attrs.get("out_dtype", "float32")))]}


def _compare(name, fn):
    @register(name, nondiff_slots=("X", "Y"))
    def _lower(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(ins["X"][0], ins["Y"][0])]}
    return _lower


_compare("equal", torch.eq)
_compare("less_than", torch.lt)
_compare("less_equal", torch.le)
_compare("greater_than", torch.gt)
_compare("greater_equal", torch.ge)


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
    # an integer sum keeps its dtype, as jnp.sum does (torch widens to
    # int64)
    dt = None if x.is_floating_point() else x.dtype
    return {"Out": [torch.sum(x, dim=axes, keepdim=keep_dim, dtype=dt)]}


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
    # a fill, not a host-to-device copy: the op runs inside captured steps
    b = torch.full((), attrs.get("bias", 0.0), dtype=x.dtype, device=x.device)
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


@register("matmul")
def _matmul(ctx, ins, attrs):
    """Optional transposes of the last two dims, batched dims broadcast,
    then `alpha` (reference math_ops.py:245)."""
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


@register("matmul_v2")
def _matmul_v2(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("trans_x", False):
        x = x.transpose(-1, -2)
    if attrs.get("trans_y", False):
        y = y.transpose(-1, -2)
    return {"Out": [torch.matmul(x, y)]}
