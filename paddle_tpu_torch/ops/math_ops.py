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
# floor modulo: the result takes the divisor's sign, as jnp.mod
_elementwise("elementwise_mod", torch.remainder)


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
    """Elementwise sum. SelectedRows inputs (reference :175-195): all
    sparse, the rows and ids concatenated; mixed, each sparse one's rows
    added into the dense sum at its ids, in the ids' order."""
    xs = ins["X"]
    from .sparse_grad import SelectedRows, is_selected_rows
    if any(is_selected_rows(x) for x in xs):
        sparse = [x for x in xs if is_selected_rows(x)]
        dense = [x for x in xs if not is_selected_rows(x)]
        if not dense:
            return {"Out": [SelectedRows(
                rows=torch.cat([s.rows for s in sparse], 0),
                ids=torch.cat([s.ids for s in sparse], 0))]}
        out = dense[0]
        for x in dense[1:]:
            out = out + x
        for s in sparse:
            out = out.index_put((s.ids.reshape(-1).long(),),
                                s.rows.to(out.dtype), accumulate=True)
        return {"Out": [out]}
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register("mean")
def _mean(ctx, ins, attrs):
    return {"Out": [torch.mean(ins["X"][0])]}


def _folds_a_shard(x, xd: int) -> bool:
    """`x` is a DTensor [*lead, K] (lead = its first `xd` dims) sharded on
    a lead dim after the first: a flatten to [prod(lead), K] would fold a
    sharded dim into the rows (a sequence-sharded activation), which
    DTensor refuses (torch 2.11) or gathers."""
    from ..parallel.gspmd import is_dtensor
    return (is_dtensor(x) and xd >= 2 and x.dim() == xd + 1
            and any(p.is_shard() and 0 < p.dim % x.dim() < xd
                    for p in x.placements))


def _mesh_mm(x, y, xd: int):
    """x [*lead, K] @ y [K, N] -> [*lead, N] on the local shards
    (parallel/gspmd.py `local_call`): the rows of x stay sharded as they
    are, and each mesh dim's layout follows from the operands'. Rows
    sharded: the output rows too, y's gradient a partial sum (each rank
    holds its rows' part). K sharded on both: the output a partial sum.
    N sharded (y column-parallel): the output's last dim, x's gradient a
    partial sum. A pair that fits none of these is redistributed first."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from ..parallel import gspmd
    x = gspmd.settled(x)
    mesh = x.device_mesh
    if not gspmd.is_dtensor(y):
        y = DTensor.from_local(y, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    y = gspmd.settled(y)

    def lead(p):
        return p.is_shard() and p.dim % x.dim() < xd

    xp, yp = list(x.placements), list(y.placements)
    for i in range(mesh.ndim):
        if lead(xp[i]):
            if not yp[i].is_replicate():
                yp[i] = Replicate()
        elif xp[i].is_shard():                  # the contraction
            if yp[i].is_replicate():
                yp[i] = Shard(0)
            elif yp[i] != Shard(0):
                xp[i] = Replicate()
        elif yp[i] == Shard(0):
            xp[i] = Shard(xd)
    if xp != list(x.placements):
        x = x.redistribute(mesh, xp)
    if yp != list(y.placements):
        y = y.redistribute(mesh, yp)
    out_pl, gx, gy = [], [], []
    for px, py in zip(xp, yp):
        if lead(px):
            out_pl.append(Shard(px.dim % x.dim()))
            gx.append(px)
            gy.append(Partial())
        elif px.is_shard():
            out_pl.append(Partial())
            gx.append(px)
            gy.append(py)
        elif py.is_shard():
            out_pl.append(Shard(xd))
            gx.append(Partial())
            gy.append(py)
        else:
            out_pl.append(Replicate())
            gx.append(px)
            gy.append(py)

    def body(xl, yl):
        out = torch.matmul(xl.reshape(-1, xl.shape[-1]), yl)
        return out.reshape(tuple(xl.shape[:xd]) + (yl.shape[1],))

    shape = tuple(x.shape[:xd]) + (int(y.shape[1]),)
    return gspmd.local_call(body, (x, y), [out_pl], grad_placements=[gx, gy],
                            shapes=[shape])


@register("mul")
def _mul(ctx, ins, attrs):
    """Flatten to 2-D by num_col_dims, then one GEMM; a sequence-sharded
    DTensor on local shards (`_mesh_mm`)."""
    x, y = ins["X"][0], ins["Y"][0]
    xd = attrs.get("x_num_col_dims", 1)
    yd = attrs.get("y_num_col_dims", 1)
    if yd == 1 and y.dim() == 2 and _folds_a_shard(x, xd):
        return {"Out": [_mesh_mm(x, y, xd)]}
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
    if y.dim() == 2 and _folds_a_shard(x, x.dim() - 1):
        out = _mesh_mm(x, y, x.dim() - 1)
    else:
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
    if y.dim() == 2 and _folds_a_shard(x, x.dim() - 1):
        return {"Out": [_mesh_mm(x, y, x.dim() - 1)]}
    return {"Out": [torch.matmul(x, y)]}


# ---------------------------------------------------------------------------
# The rest of the reference's math_ops.py: activations, reductions,
# products, comparisons and predicates.
# ---------------------------------------------------------------------------

_elementwise("elementwise_floordiv", torch.floor_divide)

_unary("sigmoid", torch.sigmoid)
_unary("log", torch.log)
_unary("log2", torch.log2)
_unary("log10", torch.log10)
_unary("log1p", torch.log1p)
_unary("rsqrt", torch.rsqrt)
_unary("abs", torch.abs)
_unary("reciprocal", torch.reciprocal)
# half to even, as jnp.round
_unary("round", torch.round)
_unary("sin", torch.sin)
_unary("tan", torch.tan)
_unary("asin", torch.asin)
_unary("acos", torch.acos)
_unary("atan", torch.atan)
_unary("sinh", torch.sinh)
_unary("cosh", torch.cosh)
_unary("softsign", torch.nn.functional.softsign)
_unary("erf", torch.erf)
_unary("logsigmoid", torch.nn.functional.logsigmoid)


@register("softplus")
def _softplus(ctx, ins, attrs):
    """log(1 + exp(x)) without F.softplus's linear cut-over (jax.nn
    .softplus is logaddexp(x, 0))."""
    x = ins["X"][0]
    return {"Out": [torch.logaddexp(x, torch.zeros_like(x))]}


def _const(x, v):
    return torch.full((), v, dtype=x.dtype, device=x.device)


def _clip(x, lo, hi):
    """jnp.clip as minimum(maximum(x, lo), hi): a value ON a bound gets
    half the gradient, as jax's max/min split ties (torch.clamp gives
    all)."""
    return torch.minimum(torch.maximum(x, _const(x, lo)), _const(x, hi))


@register("leaky_relu")
def _leaky_relu(ctx, ins, attrs):
    """where(x >= 0, x, alpha * x): slope 1 at 0, as jax.nn.leaky_relu
    (F.leaky_relu takes alpha there)."""
    x = ins["X"][0]
    return {"Out": [torch.where(x >= 0, x, x * attrs.get("alpha", 0.02))]}


@register("elu")
def _elu(ctx, ins, attrs):
    x = ins["X"][0]
    pos = x > 0
    neg = torch.where(pos, torch.zeros_like(x), x)
    return {"Out": [torch.where(pos, x, attrs.get("alpha", 1.0)
                                * torch.expm1(neg))]}


@register("hard_sigmoid")
def _hard_sigmoid(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [_clip(x * attrs.get("slope", 0.2)
                          + attrs.get("offset", 0.5), 0.0, 1.0)]}


@register("hard_swish")
def _hard_swish(ctx, ins, attrs):
    x = ins["X"][0]
    t, s, o = (attrs.get("threshold", 6.0), attrs.get("scale", 6.0),
               attrs.get("offset", 3.0))
    return {"Out": [x * _clip(x + o, 0.0, t) / s]}


@register("swish")
def _swish(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x * torch.sigmoid(attrs.get("beta", 1.0) * x)]}


@register("relu6")
def _relu6(ctx, ins, attrs):
    return {"Out": [_clip(ins["X"][0], 0.0, attrs.get("threshold", 6.0))]}


def _reduce_axes(x, attrs):
    dim = attrs.get("dim", [0])
    if attrs.get("reduce_all", False) or dim is None:
        return tuple(range(x.dim()))
    dims = dim if isinstance(dim, (list, tuple)) else [dim]
    return tuple(d % x.dim() for d in dims)


def _reduce(name, fn):
    @register(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        x = ins["X"][0]
        return {"Out": [_fn(x, _reduce_axes(x, attrs),
                            attrs.get("keep_dim", False))]}
    return _lower


def _prod(x, axes, keep):
    """Product over several axes (torch.prod takes one): the reduced axes
    moved last and flattened; an integer product keeps its dtype."""
    if not axes:
        return x
    rest = [d for d in range(x.dim()) if d not in axes]
    flat = x.permute(*rest, *axes).reshape(
        [x.shape[d] for d in rest] + [-1])
    out = torch.prod(flat, dim=-1, dtype=x.dtype)
    if keep:
        out = out.reshape([1 if d in axes else x.shape[d]
                           for d in range(x.dim())])
    return out


def _mean(x, axes, keep):
    """An integer mean is a float32 one, as jnp.mean."""
    if not x.is_floating_point():
        x = x.float()
    return torch.mean(x, dim=axes, keepdim=keep)


# max / min by amax / amin: tied extremes split the gradient, as jnp.max
_reduce("reduce_mean", _mean)
_reduce("reduce_max", lambda x, a, k: torch.amax(x, dim=a, keepdim=k))
_reduce("reduce_min", lambda x, a, k: torch.amin(x, dim=a, keepdim=k))
_reduce("reduce_prod", _prod)
_reduce("reduce_all", lambda x, a, k: torch.all(x.bool(), dim=a,
                                                keepdim=k))
_reduce("reduce_any", lambda x, a, k: torch.any(x.bool(), dim=a,
                                                keepdim=k))


@register("bmm")
def _bmm(ctx, ins, attrs):
    return {"Out": [torch.matmul(ins["X"][0], ins["Y"][0])]}


@register("dot")
def _dot(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": [torch.sum(x * y, dim=-1, keepdim=x.dim() == 1)]}


@register("p_norm")
def _p_norm(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs.get("porder", 2.0)
    s = torch.sum(torch.abs(x) ** p, dim=attrs.get("axis", -1),
                  keepdim=attrs.get("keepdim", False))
    return {"Out": [s ** (1.0 / p)]}


@register("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    return {"Out": [torch.sum(torch.square(ins["X"][0])).reshape(1)]}


@register("cumsum")
def _cumsum(ctx, ins, attrs):
    """As the reference: `exclusive` subtracts x; `reverse` is the
    reversed inclusive sum (it overrides `exclusive`)."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    if attrs.get("flatten", False):
        x, axis = x.reshape(-1), 0
    dt = None if x.is_floating_point() else x.dtype
    out = torch.cumsum(x, dim=axis, dtype=dt)
    if attrs.get("exclusive", False):
        out = out - x
    if attrs.get("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, [axis]), dim=axis,
                                      dtype=dt), [axis])
    return {"Out": [out]}


@register("maximum")
def _maximum(ctx, ins, attrs):
    return {"Out": [torch.maximum(ins["X"][0], ins["Y"][0])]}


@register("minimum")
def _minimum(ctx, ins, attrs):
    return {"Out": [torch.minimum(ins["X"][0], ins["Y"][0])]}


_compare("not_equal", torch.ne)


def _logical(name, fn, unary=False):
    @register(name, nondiff_slots=("X", "Y"))
    def _lower(ctx, ins, attrs, _fn=fn, _unary=unary):
        if _unary:
            return {"Out": [_fn(ins["X"][0])]}
        return {"Out": [_fn(ins["X"][0], ins["Y"][0])]}
    return _lower


_logical("logical_and", torch.logical_and)
_logical("logical_or", torch.logical_or)
_logical("logical_xor", torch.logical_xor)
_logical("logical_not", torch.logical_not, unary=True)


@register("isfinite", nondiff_slots=("X",))
def _isfinite(ctx, ins, attrs):
    return {"Out": [torch.all(torch.isfinite(ins["X"][0]))]}


@register("isfinite_v2", nondiff_slots=("X",))
def _isfinite_v2(ctx, ins, attrs):
    return {"Out": [torch.isfinite(ins["X"][0])]}


@register("isnan_v2", nondiff_slots=("X",))
def _isnan(ctx, ins, attrs):
    return {"Out": [torch.isnan(ins["X"][0])]}


@register("isinf_v2", nondiff_slots=("X",))
def _isinf(ctx, ins, attrs):
    return {"Out": [torch.isinf(ins["X"][0])]}
