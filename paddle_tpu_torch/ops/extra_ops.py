"""The long tail of single-file ops (counterpart of
paddle_tpu/ops/extra_ops.py): losses, linalg, indexing and rearrangement,
3-D convolution and pooling, pooling with index, the activation tail and
the misc tail (`gru_unit`, `lstm_unit`, `warpctc`, `unique_with_counts`,
`unpool`, ...). Every type the reference file registers, in its section
order, with its flags; each is differentiated by the generic `__vjp__`
(`torch.func.vjp` over the lowering).

Where torch's nearest function differs from the reference's, the
reference's arithmetic is written out, and nothing reads a device value
on the host, so a CUDA graph can capture every lowering:

* `jnp.maximum` / `jnp.clip` are `torch.maximum` against a 0-d constant:
  a tie splits the gradient as jax's does (`torch.clamp` gives it all).
* Segment sums (`segment_pool`, `center_loss`, `scatter_nd_add`,
  `scatter_nd`) are `index_put(accumulate=True)`: on CUDA the sort-based
  kernel, no atomics, so a run gives the same bits twice. `segment_pool`'s
  MAX / MIN start from -inf / +inf, jax's fill for an empty segment.
* `unique_with_counts` has the reference's static size (the input's
  length, padded with 0): the stable sort, first-of-run flags and cumsum
  of `sparse_grad.id_runs`, not `torch.unique`.
* `cholesky` / `inverse` use the `_ex` forms (no `info` check on the
  host); `cholesky` symmetrises its input and gives NaN under the
  diagonal and on it for a matrix that is not positive definite, as jax
  does.
* `warpctc` is optax's log-space alpha recursion in torch ops over T on
  [B, T, C] logits (log-softmax inside, log(0) as -1e5): an infeasible
  alignment gives a large finite loss, not `F.ctc_loss`'s inf, and the
  gradient is deterministic.
* `grid_sampler` writes out align_corners=True bilinear sampling with
  clamped gather indices (neither of `F.grid_sample`'s padding modes).
* `max_pool{2,3}d_with_index` keep the first index of a tie (the
  reference's strict `>`), flat in the unpadded plane, padding -inf.
* `conv3d_transpose` pads the dilated input by the attr's paddings, as
  `lax.conv_transpose` with explicit padding does: cuDNN's transposed
  convolution at padding dil*(k-1) - p, and zeros past it.
* Faithful quirks: `data_norm` ignores `epsilon` (the raw second
  moment), `spectral_norm` does not write `U` / `V` back, `lod_reset`
  passes X through, `relu_` never writes into its input.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..framework.dtype import device_dtype
from .math_ops import _const
from .registry import register
from .sparse_grad import id_runs


def _max(x, v):
    """jnp.maximum(x, v) for a scalar v: a tie splits the gradient."""
    return torch.maximum(x, _const(x, v))


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0), without F.softplus's cut-over."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _segment_sum(x, seg, num):
    out = torch.zeros((num,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_put((seg.long(),), x, accumulate=True)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@register("bce_loss")
def _bce_loss(ctx, ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    out = -(label * torch.log(_max(x, 1e-12))
            + (1 - label) * torch.log(_max(1 - x, 1e-12)))
    return {"Out": [out]}


@register("hinge_loss")
def _hinge_loss(ctx, ins, attrs):
    x, y = ins["Logits"][0], ins["Labels"][0]
    sign = 2.0 * y.to(x.dtype) - 1.0      # labels arrive as {0, 1}
    return {"Loss": [_max(1.0 - sign * x, 0.0)]}


@register("rank_loss")
def _rank_loss(ctx, ins, attrs):
    label = ins["Label"][0]
    o = ins["Left"][0] - ins["Right"][0]
    return {"Out": [_softplus(o) - label * o]}


@register("margin_rank_loss")
def _margin_rank_loss(ctx, ins, attrs):
    label = ins["Label"][0]
    x1, x2 = ins["X1"][0], ins["X2"][0]
    act = _max(-label * (x1 - x2) + attrs.get("margin", 0.0), 0.0)
    return {"Out": [act], "Activated": [(act > 0).to(x1.dtype)]}


@register("log_loss")
def _log_loss(ctx, ins, attrs):
    pred, label = ins["Predicted"][0], ins["Labels"][0]
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": [-label * torch.log(pred + eps)
                     - (1 - label) * torch.log(1 - pred + eps)]}


@register("bpr_loss")
def _bpr_loss(ctx, ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    lbl = label.reshape(-1).long()
    xl = torch.gather(x2, 1, lbl[:, None])                  # [N, 1]
    diffs = _softplus(x2 - xl)                              # log(1+e^(xj-xl))
    mask = torch.arange(c, device=x.device)[None, :] != lbl[:, None]
    loss = torch.sum(diffs * mask, dim=1, keepdim=True) / (c - 1)
    return {"Y": [loss.reshape(tuple(x.shape[:-1]) + (1,))]}


@register("nll_loss")
def _nll_loss(ctx, ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]        # x: [N, C(, ...)] log-probs
    weight = ins.get("Weight", [None])[0]
    ignore = attrs.get("ignore_index", -100)
    reduction = attrs.get("reduction", "mean")
    lbl = label.reshape(-1).long()
    logp = torch.movedim(x, 1, -1).reshape(-1, x.shape[1]) if x.dim() > 2 \
        else x
    safe = torch.clamp(lbl, min=0)
    picked = -torch.gather(logp, 1, safe[:, None])[:, 0]
    w = weight[safe] if weight is not None else torch.ones_like(picked)
    valid = lbl != ignore
    zero = _const(picked, 0.0)
    picked = torch.where(valid, picked * w, zero)
    wsum = torch.sum(torch.where(valid, w, zero))
    total = torch.sum(picked)
    if reduction == "mean":
        out = total / _max(wsum, 1e-12)
    elif reduction == "sum":
        out = total
    else:
        out = picked.reshape(label.shape)
    return {"Out": [out], "Total_weight": [wsum]}


@register("kldiv_loss")
def _kldiv_loss(ctx, ins, attrs):
    x, target = ins["X"][0], ins["Target"][0]     # x: log-probabilities
    reduction = attrs.get("reduction", "mean")
    loss = target * (torch.log(_max(target, 1e-12)) - x)
    loss = torch.where(target > 0, loss, _const(loss, 0.0))
    if reduction == "mean":
        out = torch.mean(loss)
    elif reduction == "sum":
        out = torch.sum(loss)
    elif reduction == "batchmean":
        out = torch.sum(loss) / x.shape[0]
    else:
        out = loss
    return {"Loss": [out]}


@register("smooth_l1_loss")
def _smooth_l1_loss(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    inside_w = ins.get("InsideWeight", [None])[0]
    outside_w = ins.get("OutsideWeight", [None])[0]
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    d = x - y
    if inside_w is not None:
        d = d * inside_w
    ad = torch.abs(d)
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * d * d, ad - 0.5 / s2)
    if outside_w is not None:
        loss = loss * outside_w
    out = torch.sum(loss.reshape(x.shape[0], -1), dim=1, keepdim=True)
    return {"Out": [out], "Diff": [d]}


@register("huber_regression_loss")
def _huber_regression(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    delta = attrs.get("delta", 1.0)
    r = torch.abs(x - y)
    return {"Out": [torch.where(r <= delta, 0.5 * r * r,
                                delta * (r - 0.5 * delta))]}


@register("sigmoid_focal_loss")
def _sigmoid_focal_loss(ctx, ins, attrs):
    """Per-class focal loss with int labels (0 = background) and the FgNum
    normaliser (detection/sigmoid_focal_loss_op.cc)."""
    x = ins["X"][0]                                # [N, C]
    label = ins["Label"][0].reshape(-1)            # [N] in [0, C]
    fg = ins["FgNum"][0].reshape(()).to(x.dtype)
    gamma = attrs.get("gamma", 2.0)
    alpha = attrs.get("alpha", 0.25)
    c = x.shape[1]
    classes = torch.arange(1, c + 1, device=x.device)[None, :]
    pos = (label[:, None] == classes).to(x.dtype)
    p = torch.sigmoid(x)
    ce_pos = -torch.log(_max(p, 1e-12))
    ce_neg = -torch.log(_max(1 - p, 1e-12))
    loss = pos * alpha * (1 - p) ** gamma * ce_pos + \
        (1 - pos) * (1 - alpha) * p ** gamma * ce_neg
    return {"Out": [loss / _max(fg, 1.0)]}


@register("center_loss")
def _center_loss(ctx, ins, attrs):
    """Distance to per-class centers; with `need_update` the updated
    centers come out in CentersOut, an ordinary output as in the
    reference (center_loss_op.cc)."""
    x = ins["X"][0]                        # [N, D]
    label = ins["Label"][0].reshape(-1).long()
    centers = ins["Centers"][0]            # [C, D]
    lr = ins.get("CenterUpdateRate", [None])[0]
    alpha = lr.reshape(()) if lr is not None \
        else _const(x, attrs.get("alpha", 0.5))
    picked = centers[label]                # [N, D]
    diff = x - picked
    loss = 0.5 * torch.sum(diff * diff, dim=1, keepdim=True)
    if attrs.get("need_update", True):
        num = _segment_sum(diff, label, centers.shape[0])
        cnt = _segment_sum(torch.ones(x.shape[0], dtype=x.dtype,
                                      device=x.device), label,
                           centers.shape[0])
        centers = centers + alpha * num / (1.0 + cnt[:, None])
    return {"Loss": [loss], "SampleCenterDiff": [diff],
            "CentersOut": [centers]}


# ---------------------------------------------------------------------------
# linalg
# ---------------------------------------------------------------------------

@register("addmm")
def _addmm(ctx, ins, attrs):
    inp, x, y = ins["Input"][0], ins["X"][0], ins["Y"][0]
    return {"Out": [attrs.get("Beta", 1.0) * inp
                    + attrs.get("Alpha", 1.0) * (x @ y)]}


@register("mv")
def _mv(ctx, ins, attrs):
    return {"Out": [ins["X"][0] @ ins["Vec"][0]]}


@register("cholesky")
def _cholesky(ctx, ins, attrs):
    """jnp.linalg.cholesky: the input symmetrised, NaN where it is not
    positive definite (`cholesky_ex`: no host check of `info`)."""
    x = ins["X"][0]
    c, info = torch.linalg.cholesky_ex((x + x.mT) / 2)
    c = torch.tril(torch.where((info == 0)[..., None, None], c,
                               _const(c, math.nan)))
    return {"Out": [c.mT if attrs.get("upper", False) else c]}


@register("inverse")
def _inverse(ctx, ins, attrs):
    return {"Output": [torch.linalg.inv_ex(ins["Input"][0])[0]]}


@register("matrix_power")
def _matrix_power(ctx, ins, attrs):
    x, n = ins["X"][0], int(attrs.get("n", 1))
    if n < 0:
        x, n = torch.linalg.inv_ex(x)[0], -n
    return {"Out": [torch.linalg.matrix_power(x, n)]}


@register("kron")
def _kron(ctx, ins, attrs):
    return {"Out": [torch.kron(ins["X"][0], ins["Y"][0])]}


@register("cross")
def _cross(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    axis = attrs.get("dim", -1)
    if axis in (None, -100):   # paddle's "unset" sentinel: first dim of 3
        axis = next(i for i, d in enumerate(x.shape) if d == 3)
    return {"Out": [torch.linalg.cross(x, y, dim=axis)]}


@register("dist")
def _dist(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    p = attrs.get("p", 2.0)
    d = (x - y).reshape(-1)
    if p == float("inf"):
        out = torch.amax(torch.abs(d))
    elif p == float("-inf"):
        out = torch.amin(torch.abs(d))
    elif p == 0:
        out = torch.sum(d != 0).to(x.dtype)
    else:
        out = torch.sum(torch.abs(d) ** p) ** (1.0 / p)
    return {"Out": [out.reshape(())]}


def _axes(dims, ndim):
    return tuple(dims) if dims not in (None, []) else tuple(range(ndim))


@register("frobenius_norm")
def _frobenius_norm(ctx, ins, attrs):
    x = ins["X"][0]
    dims = None if attrs.get("reduce_all", False) else attrs.get("dim")
    return {"Out": [torch.sqrt(torch.sum(
        x * x, dim=_axes(dims, x.dim()),
        keepdim=attrs.get("keep_dim", False)))]}


@register("logsumexp")
def _logsumexp(ctx, ins, attrs):
    x = ins["X"][0]
    dims = attrs.get("axis", attrs.get("dim", None))
    if attrs.get("reduce_all", False):
        dims = None
    keep = attrs.get("keepdim", attrs.get("keep_dim", False))
    return {"Out": [torch.logsumexp(x, dim=_axes(dims, x.dim()),
                                    keepdim=keep)]}


@register("l1_norm")
def _l1_norm(ctx, ins, attrs):
    return {"Out": [torch.sum(torch.abs(ins["X"][0])).reshape(())]}


@register("norm")
def _norm(ctx, ins, attrs):
    x = ins["X"][0]
    nrm = torch.sqrt(torch.sum(x * x, dim=attrs.get("axis", -1),
                               keepdim=True) + attrs.get("epsilon", 1e-10))
    return {"Out": [x / nrm], "Norm": [nrm]}


@register("trace")
def _trace(ctx, ins, attrs):
    x = ins["Input"][0]
    return {"Out": [torch.diagonal(x, offset=attrs.get("offset", 0),
                                   dim1=attrs.get("axis1", 0),
                                   dim2=attrs.get("axis2", 1)).sum(-1)]}


@register("cos_sim")
def _cos_sim(ctx, ins, attrs):
    """Row-wise cosine similarity [B, 1] and the two rows' norms
    (cos_sim_op.cc)."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=1, keepdim=True))
    dot = torch.sum(x * y, dim=1, keepdim=True)
    return {"Out": [dot / (xn * yn + 1e-12)], "XNorm": [xn], "YNorm": [yn]}


@register("spectral_norm")
def _spectral_norm(ctx, ins, attrs):
    """W / sigma, sigma from `power_iters` power iterations from U and V
    (differentiated through); U and V are not written back."""
    w, u, v = ins["Weight"][0], ins["U"][0], ins["V"][0]
    dim = attrs.get("dim", 0)
    eps = attrs.get("eps", 1e-12)
    perm = (dim,) + tuple(i for i in range(w.dim()) if i != dim)
    mat = w.permute(perm).reshape(w.shape[dim], -1)
    u_, v_ = u.reshape(-1), v.reshape(-1)
    for _ in range(attrs.get("power_iters", 1)):
        v_ = mat.T @ u_
        v_ = v_ / (torch.sqrt(torch.sum(v_ * v_)) + eps)
        u_ = mat @ v_
        u_ = u_ / (torch.sqrt(torch.sum(u_ * u_)) + eps)
    return {"Out": [w / (u_ @ mat @ v_)]}


# ---------------------------------------------------------------------------
# indexing / rearrangement
# ---------------------------------------------------------------------------

@register("index_sample")
def _index_sample(ctx, ins, attrs):
    return {"Out": [torch.gather(ins["X"][0], 1, ins["Index"][0].long())]}


@register("multiplex")
def _multiplex(ctx, ins, attrs):
    xs = torch.stack(ins["X"], dim=0)             # [k, N, D]
    ids = ins["Ids"][0].reshape(-1).long()
    return {"Out": [xs[ids, torch.arange(xs.shape[1], device=xs.device)]]}


@register("reverse")
def _reverse(ctx, ins, attrs):
    axes = attrs.get("axis", [0])
    axes = list(axes) if isinstance(axes, (list, tuple)) else [axes]
    return {"Out": [torch.flip(ins["X"][0], dims=axes)]}


def _nd_index(index):
    """`tuple(moveaxis(index, -1, 0))`: one index tensor a leading dim."""
    return tuple(index.long().unbind(-1))


@register("scatter_nd_add")
def _scatter_nd_add(ctx, ins, attrs):
    """Repeated indices accumulate (the sort-based kernel on CUDA)."""
    x, index, updates = ins["X"][0], ins["Index"][0], ins["Updates"][0]
    return {"Out": [x.index_put(_nd_index(index), updates,
                                accumulate=True)]}


@register("scatter_nd")
def _scatter_nd(ctx, ins, attrs):
    index, updates = ins["Index"][0], ins["Updates"][0]
    zeros = torch.zeros(tuple(attrs["shape"]), dtype=updates.dtype,
                        device=updates.device)
    return {"Out": [zeros.index_put(_nd_index(index), updates,
                                    accumulate=True)]}


@register("unbind")
def _unbind(ctx, ins, attrs):
    return {"Out": list(torch.unbind(ins["X"][0], dim=attrs.get("axis", 0)))}


@register("shard_index")
def _shard_index(ctx, ins, attrs):
    x = ins["X"][0]
    shard_size = (attrs["index_num"] + attrs["nshards"] - 1) \
        // attrs["nshards"]
    in_shard = (x // shard_size) == attrs["shard_id"]
    return {"Out": [torch.where(in_shard, x % shard_size,
                                _const(x, attrs.get("ignore_value", -1)))]}


@register("squeeze")
def _squeeze(ctx, ins, attrs):
    """v1 squeeze (no XShape): the listed axes of size 1, or every size-1
    axis when none is."""
    x = ins["X"][0]
    axes = [a for a in attrs.get("axes", []) if x.shape[a] == 1]
    return {"Out": [torch.squeeze(x, dim=tuple(axes)) if axes
                    else torch.squeeze(x)]}


@register("unsqueeze")
def _unsqueeze(ctx, ins, attrs):
    x = ins["X"][0]
    for a in sorted(attrs.get("axes", [])):
        x = torch.unsqueeze(x, a)
    return {"Out": [x]}


@register("flatten")
def _flatten(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", 1)
    lead = math.prod(x.shape[:axis]) if axis else 1
    return {"Out": [x.reshape(lead, -1)]}


@register("crop_tensor")
def _crop_tensor(ctx, ins, attrs):
    x = ins["X"][0]
    offsets = attrs.get("offsets", [0] * x.dim())
    slices = tuple(slice(o, o + s) for o, s in zip(offsets, attrs["shape"]))
    return {"Out": [x[slices]]}


@register("crop")
def _crop(ctx, ins, attrs):
    return _crop_tensor(ctx, ins, attrs)


def _torch_pads(pairs):
    """[(low, high)] per dim, first dim first -> F.pad's last-dim-first
    flat list."""
    return [p for lo_hi in reversed(pairs) for p in lo_hi]


@register("pad_constant_like")
def _pad_constant_like(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    pads = [(0, xd - yd) for xd, yd in zip(x.shape, y.shape)]
    return {"Out": [F.pad(y, _torch_pads(pads),
                          value=attrs.get("pad_value", 0.0))]}


@register("pad3d")
def _pad3d(ctx, ins, attrs):
    x = ins["X"][0]                      # NCDHW
    p = attrs.get("paddings", [0] * 6)   # [l, r, top, bottom, front, back]
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return {"Out": [F.pad(x, list(p), value=attrs.get("value", 0.0))]}
    mode = {"reflect": "reflect", "replicate": "replicate"}.get(
        mode, "circular")
    return {"Out": [F.pad(x, list(p), mode=mode)]}


@register("pixel_shuffle")
def _pixel_shuffle(ctx, ins, attrs):
    x = ins["X"][0]
    r = attrs.get("upscale_factor", 1)
    n, c, h, w = x.shape
    out = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return {"Out": [out.reshape(n, c // (r * r), h * r, w * r)]}


@register("space_to_depth")
def _space_to_depth(ctx, ins, attrs):
    x = ins["X"][0]
    bs = attrs.get("blocksize", 1)
    n, c, h, w = x.shape
    out = x.reshape(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return {"Out": [out.reshape(n, c * bs * bs, h // bs, w // bs)]}


@register("shuffle_channel")
def _shuffle_channel(ctx, ins, attrs):
    x = ins["X"][0]
    g = attrs.get("group", 1)
    n, c, h, w = x.shape
    out = x.reshape(n, g, c // g, h, w).transpose(1, 2)
    return {"Out": [out.reshape(n, c, h, w)]}


@register("temporal_shift")
def _temporal_shift(ctx, ins, attrs):
    """c*ratio channels one step back in time, the next c*ratio one step
    forward, the rest unshifted (temporal_shift_op.h:35-43)."""
    x = ins["X"][0]                       # [N*T, C, H, W]
    t = attrs["seg_num"]
    ratio = attrs.get("shift_ratio", 0.25)
    nt, c, h, w = x.shape
    x5 = x.reshape(nt // t, t, c, h, w)
    c1, c2 = int(c * ratio), int(c * 2 * ratio)
    back = torch.cat([x5[:, 1:, :c1], torch.zeros_like(x5[:, :1, :c1])],
                     dim=1)
    fwd = torch.cat([torch.zeros_like(x5[:, :1, c1:c2]), x5[:, :-1, c1:c2]],
                    dim=1)
    out = torch.cat([back, fwd, x5[:, :, c2:]], dim=2)
    return {"Out": [out.reshape(nt, c, h, w)]}


def _patches(x, kernel, strides, pads, dilations=(1, 1)):
    """conv_general_dilated_patches' [N, C*kh*kw, L], features in (C, kh,
    kw) order: F.unfold after an explicit (possibly uneven) padding."""
    if any(p for lo_hi in pads for p in lo_hi):
        x = F.pad(x, _torch_pads([(0, 0), (0, 0)] + list(pads)))
    return F.unfold(x, tuple(kernel), dilation=tuple(dilations),
                    stride=tuple(strides))


def _out_hw(x, kernel, strides, pads, dilations=(1, 1)):
    return tuple((x.shape[2 + i] + pads[i][0] + pads[i][1]
                  - dilations[i] * (kernel[i] - 1) - 1) // strides[i] + 1
                 for i in range(2))


@register("unfold")
def _unfold(ctx, ins, attrs):
    """im2col: [N, C, H, W] -> [N, C*kh*kw, L] (unfold_op.cc)."""
    x = ins["X"][0]
    p = attrs.get("paddings", [0, 0, 0, 0])
    pads = ((p[0], p[2] if len(p) > 2 else p[0]),
            (p[1], p[3] if len(p) > 3 else p[1]))
    return {"Y": [_patches(x, attrs["kernel_sizes"],
                           attrs.get("strides", [1, 1]), pads,
                           attrs.get("dilations", [1, 1]))]}


@register("affine_channel")
def _affine_channel(ctx, ins, attrs):
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    if attrs.get("data_layout", "NCHW") == "NCHW":
        shape = [1, -1] + [1] * (x.dim() - 2)
        return {"Out": [x * scale.reshape(shape) + bias.reshape(shape)]}
    return {"Out": [x * scale + bias]}


@register("label_smooth")
def _label_smooth(ctx, ins, attrs):
    x = ins["X"][0]
    dist = ins.get("PriorDist", [None])[0]
    eps = attrs.get("epsilon", 0.0)
    prior = dist if dist is not None else 1.0 / x.shape[-1]
    return {"Out": [(1 - eps) * x + eps * prior]}


@register("lrn")
def _lrn(ctx, ins, attrs):
    x = ins["X"][0]                       # NCHW
    n_size = attrs.get("n", 5)
    k = attrs.get("k", 2.0)
    alpha = attrs.get("alpha", 1e-4)
    beta = attrs.get("beta", 0.75)
    half = n_size // 2
    sq_p = F.pad(x * x, (0, 0, 0, 0, half, n_size - 1 - half))
    acc = sum(sq_p[:, i:i + x.shape[1]] for i in range(n_size))
    mid = k + alpha * acc
    return {"Out": [x / mid ** beta], "MidOut": [mid]}


@register("prelu")
def _prelu(ctx, ins, attrs):
    x, alpha = ins["X"][0], ins["Alpha"][0]
    mode = attrs.get("mode", "all")
    if mode == "channel":
        a = alpha.reshape([1, -1] + [1] * (x.dim() - 2))
    elif mode == "element":
        a = alpha.reshape((1,) + tuple(x.shape[1:]))
    else:
        a = alpha.reshape(())
    return {"Out": [torch.where(x > 0, x, a * x)]}


@register("selu")
def _selu(ctx, ins, attrs):
    x = ins["X"][0]
    scale = attrs.get("scale", 1.0507009873554805)
    alpha = attrs.get("alpha", 1.6732632423543772)
    return {"Out": [scale * torch.where(x > 0, x, alpha * (torch.exp(x) - 1))]}


@register("mish")
def _mish(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x * torch.tanh(_softplus(x))]}


@register("cvm")
def _cvm(ctx, ins, attrs):
    """CTR show / click transform of the first two columns (cvm_op.cc)."""
    x = ins["X"][0]
    if not attrs.get("use_cvm", True):
        return {"Y": [x[:, 2:]]}
    show = torch.log(x[:, 0:1] + 1.0)
    click = torch.log(x[:, 1:2] + 1.0) - torch.log(x[:, 0:1] + 1.0)
    return {"Y": [torch.cat([show, click, x[:, 2:]], dim=1)]}


@register("data_norm")
def _data_norm(ctx, ins, attrs):
    """Normalisation by accumulated batch statistics; `epsilon` is unused,
    as data_norm_op.cc:301-302 uses the raw second moment."""
    x = ins["X"][0]
    size = ins["BatchSize"][0]
    means = ins["BatchSum"][0] / size
    scales = torch.sqrt(size / ins["BatchSquareSum"][0])
    return {"Y": [(x - means) * scales], "Means": [means],
            "Scales": [scales]}


@register("segment_pool")
def _segment_pool(ctx, ins, attrs):
    """SUM / MEAN / MAX / MIN over `num_segments` (static) segments; an
    empty segment is 0 for SUM / MEAN and -inf / +inf for MAX / MIN, as
    jax.ops.segment_max / segment_min fill it."""
    x = ins["X"][0]
    seg = ins["SegmentIds"][0].reshape(-1).long()
    pool = attrs.get("pooltype", "SUM")
    num = int(attrs.get("num_segments", 0))
    if not num:
        raise ValueError("segment_pool needs the static num_segments attr")
    if pool in ("SUM", "MEAN"):
        out = _segment_sum(x, seg, num)
        if pool == "MEAN":
            cnt = _segment_sum(torch.ones(x.shape[0], dtype=x.dtype,
                                          device=x.device), seg, num)
            out = out / _max(cnt, 1.0)[:, None]
        return {"Out": [out]}
    fill = float("-inf") if pool == "MAX" else float("inf")
    init = torch.full((num,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                      device=x.device)
    idx = seg.reshape((-1,) + (1,) * (x.dim() - 1)).expand(x.shape)
    return {"Out": [init.scatter_reduce(
        0, idx, x, "amax" if pool == "MAX" else "amin", include_self=True)]}


@register("grid_sampler")
def _grid_sampler(ctx, ins, attrs):
    """Bilinear sampling at normalised grid coordinates with
    align_corners=True, the corner indices clamped into the image
    (grid_sampler_op.cc, v1.8)."""
    x = ins["X"][0]                       # [N, C, H, W]
    grid = ins["Grid"][0]                 # [N, Hg, Wg, 2] in [-1, 1]
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    x0, y0 = torch.floor(gx), torch.floor(gy)
    dx, dy = gx - x0, gy - y0
    bidx = torch.arange(n, device=x.device)[:, None, None]

    def gather(yy, xx):
        yy = torch.clamp(yy, 0, h - 1).long()
        xx = torch.clamp(xx, 0, w - 1).long()
        return x[bidx, :, yy, xx]         # [N, Hg, Wg, C]

    v00, v01 = gather(y0, x0), gather(y0, x0 + 1)
    v10, v11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    dx_, dy_ = dx[..., None], dy[..., None]
    out = (v00 * (1 - dx_) * (1 - dy_) + v01 * dx_ * (1 - dy_)
           + v10 * (1 - dx_) * dy_ + v11 * dx_ * dy_)
    return {"Output": [torch.movedim(out, -1, 1)]}


# ---------------------------------------------------------------------------
# 3-D convolution and pooling, pooling with index
# ---------------------------------------------------------------------------

def _triple(v):
    if isinstance(v, (list, tuple)):
        return tuple(v) if len(v) == 3 else tuple(v) * 3
    return (v,) * 3


@register("conv3d")
def _conv3d(ctx, ins, attrs):
    x, w = ins["Input"][0], ins["Filter"][0]
    return {"Output": [F.conv3d(
        x, w, stride=_triple(attrs.get("strides", [1, 1, 1])),
        padding=_triple(attrs.get("paddings", [0, 0, 0])),
        dilation=_triple(attrs.get("dilations", [1, 1, 1])),
        groups=attrs.get("groups", 1) or 1)]}


@register("conv3d_transpose")
def _conv3d_transpose(ctx, ins, attrs):
    """`lax.conv_transpose(transpose_kernel=True)` with explicit padding
    (p, p): the kernel flipped, its channel axes swapped ([C_out, C_in,
    k, k, k] takes C_in channels in), and the stride-dilated input padded
    by p. cuDNN's transposed convolution pads it by dil*(k-1) - P, so P =
    dil*(k-1) - p where that is >= 0; past it each side gains zeros."""
    x, w = ins["Input"][0], ins["Filter"][0]
    strides = _triple(attrs.get("strides", [1, 1, 1]))
    pads = _triple(attrs.get("paddings", [0, 0, 0]))
    dil = _triple(attrs.get("dilations", [1, 1, 1]))
    full = [d * (k - 1) for d, k in zip(dil, w.shape[2:])]
    out = F.conv_transpose3d(
        x, w.transpose(0, 1), stride=strides, dilation=dil,
        padding=tuple(max(f - p, 0) for f, p in zip(full, pads)))
    extra = [max(p - f, 0) for f, p in zip(full, pads)]
    if any(extra):
        out = F.pad(out, _torch_pads([(0, 0), (0, 0)]
                                     + [(e, e) for e in extra]))
    return {"Output": [out]}


def _windows_nd(x, ks, st):
    """Every pooling window over the trailing len(ks) dims: [N, C, *out,
    *ks], a view."""
    for i, (k, s) in enumerate(zip(ks, st)):
        x = x.unfold(2 + i, k, s)
    return x


@register("pool3d")
def _pool3d(ctx, ins, attrs):
    """Max (-inf padding, `amax` over each window) or average pooling;
    `exclusive` divides by the count of unpadded positions."""
    x = ins["X"][0]
    ks = _triple(attrs.get("ksize", [1, 1, 1]))
    st = _triple(attrs.get("strides", [1, 1, 1]))
    pd = _triple(attrs.get("paddings", [0, 0, 0]))
    if attrs.get("global_pooling", False):
        ks, pd = tuple(x.shape[2:]), (0, 0, 0)
    pads = _torch_pads([(p, p) for p in pd])
    dims = (-3, -2, -1)
    if attrs.get("pooling_type", "max") == "max":
        win = _windows_nd(F.pad(x, pads, value=float("-inf")), ks, st)
        return {"Out": [torch.amax(win, dim=dims)]}
    s = _windows_nd(F.pad(x, pads), ks, st).sum(dim=dims)
    if attrs.get("exclusive", True):
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        cnt = _windows_nd(F.pad(ones, pads), ks, st).sum(dim=dims)
        return {"Out": [s / _max(cnt, 1.0)]}
    return {"Out": [s / math.prod(ks)]}


def _pool_with_index(x, ks, st, pd):
    """Max pooling with each window's argmax, flat in the unpadded
    spatial plane (pool_with_index_op): the first position of the
    window's maximum in window order (the reference's strict `>`), index
    0 for a window of -inf only (its reduction's initial value)."""
    nd = len(ks)
    spatial = tuple(x.shape[2:])
    flat = torch.arange(math.prod(spatial), dtype=torch.int32,
                        device=x.device).reshape((1, 1) + spatial)
    pads = _torch_pads([(p, p) for p in pd])
    vals = _windows_nd(F.pad(x, pads, value=float("-inf")), ks, st)
    idxs = _windows_nd(F.pad(flat, pads), ks, st)
    vals = vals.reshape(tuple(vals.shape[:2 + nd]) + (-1,))
    idxs = idxs.reshape(tuple(idxs.shape[:2 + nd]) + (-1,))
    m = torch.amax(vals, dim=-1)
    k = vals.shape[-1]
    pos = torch.arange(k, device=x.device)
    first = torch.amin(torch.where(vals == m[..., None], pos, k), dim=-1)
    idx = torch.gather(idxs.expand(tuple(vals.shape[:2]) + (-1,) * (nd + 1)),
                       -1, first[..., None])[..., 0]
    idx = torch.where(m > float("-inf"), idx, torch.zeros_like(idx))
    return m, idx


@register("max_pool2d_with_index")
def _max_pool2d_with_index(ctx, ins, attrs):
    x = ins["X"][0]
    ks = tuple(attrs.get("ksize", [1, 1]))
    st = tuple(attrs.get("strides", [1, 1]))
    pd = tuple(attrs.get("paddings", [0, 0]))
    if attrs.get("global_pooling", False):
        ks, pd = tuple(x.shape[2:]), (0, 0)
    out, idx = _pool_with_index(x, ks, st, pd)
    return {"Out": [out], "Mask": [idx]}


@register("max_pool3d_with_index")
def _max_pool3d_with_index(ctx, ins, attrs):
    x = ins["X"][0]
    ks = _triple(attrs.get("ksize", [1, 1, 1]))
    st = _triple(attrs.get("strides", [1, 1, 1]))
    pd = _triple(attrs.get("paddings", [0, 0, 0]))
    if attrs.get("global_pooling", False):
        ks, pd = tuple(x.shape[2:]), (0, 0, 0)
    out, idx = _pool_with_index(x, ks, st, pd)
    return {"Out": [out], "Mask": [idx]}


# ---------------------------------------------------------------------------
# activation tail (activation_op.cc registrations)
# ---------------------------------------------------------------------------

@register("hard_shrink")
def _hard_shrink(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [torch.where(torch.abs(x) > attrs.get("threshold", 0.5),
                                x, _const(x, 0.0))]}


@register("softshrink")
def _softshrink(ctx, ins, attrs):
    x = ins["X"][0]
    lam = attrs.get("lambda", 0.5)
    return {"Out": [torch.where(x > lam, x - lam, torch.where(
        x < -lam, x + lam, _const(x, 0.0)))]}


@register("tanh_shrink")
def _tanh_shrink(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x - torch.tanh(x)]}


@register("thresholded_relu")
def _thresholded_relu(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [torch.where(x > attrs.get("threshold", 1.0), x,
                                _const(x, 0.0))]}


@register("stanh")
def _stanh(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [attrs.get("scale_b", 1.7159)
                    * torch.tanh(attrs.get("scale_a", 0.67) * x)]}


@register("relu_")
def _relu_inplace(ctx, ins, attrs):
    """The in-place alias some frontends emit; a new tensor here, X is
    never written."""
    return {"Out": [_max(ins["X"][0], 0)]}


@register("maxout")
def _maxout(ctx, ins, attrs):
    x = ins["X"][0]                       # NCHW
    groups = attrs["groups"]
    n, c, h, w = x.shape
    return {"Out": [torch.amax(x.reshape(n, c // groups, groups, h, w),
                               dim=2)]}


@register("celu")
def _celu(ctx, ins, attrs):
    x = ins["X"][0]
    a = attrs.get("alpha", 1.0)
    return {"Out": [torch.where(x > 0, x, a * (torch.exp(x / a) - 1))]}


# ---------------------------------------------------------------------------
# misc tail
# ---------------------------------------------------------------------------

@register("minus")
def _minus(ctx, ins, attrs):
    return {"Out": [ins["X"][0] - ins["Y"][0]]}


def _partial(xs, attrs):
    start = attrs.get("start_index", 0)
    length = attrs.get("length", -1)
    return [x[:, start:(x.shape[1] if length < 0 else start + length)]
            for x in xs]


@register("partial_concat")
def _partial_concat(ctx, ins, attrs):
    return {"Out": [torch.cat(_partial(ins["X"], attrs), dim=1)]}


@register("partial_sum")
def _partial_sum(ctx, ins, attrs):
    parts = _partial(ins["X"], attrs)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return {"Out": [total]}


@register("im2sequence")
def _im2sequence(ctx, ins, attrs):
    """Sliding-window patches as a sequence [N*oh*ow, C*kh*kw]
    (im2sequence_op.cc), features in (C, kh, kw) order."""
    x = ins["X"][0]
    p = attrs.get("paddings", [0, 0, 0, 0])
    patches = _patches(x, attrs["kernels"], attrs.get("strides", [1, 1]),
                       ((p[0], p[2]), (p[1], p[3])))
    n, ckk, _ = patches.shape
    return {"Out": [patches.transpose(1, 2).reshape(-1, ckk)]}


@register("lod_reset")
def _lod_reset(ctx, ins, attrs):
    """Padded-dense sequences carry their lengths beside the data: X
    passes through."""
    return {"Out": [ins["X"][0]]}


@register("gru_unit")
def _gru_unit(ctx, ins, attrs):
    """One GRU step from the pre-projected input: gates = x + h_prev @ W
    (gru_unit_op.cc)."""
    x = ins["Input"][0]                   # [N, 3H]
    h_prev = ins["HiddenPrev"][0]         # [N, H]
    w = ins["Weight"][0]                  # [H, 3H]
    b = ins.get("Bias", [None])[0]
    hdim = h_prev.shape[1]
    gates = x[:, :2 * hdim] + h_prev @ w[:, :2 * hdim]
    if b is not None:
        gates = gates + b[..., :2 * hdim]
    u = torch.sigmoid(gates[:, :hdim])
    r = torch.sigmoid(gates[:, hdim:2 * hdim])
    c_in = x[:, 2 * hdim:] + (r * h_prev) @ w[:, 2 * hdim:]
    if b is not None:
        c_in = c_in + b[..., 2 * hdim:]
    c = torch.tanh(c_in)
    h = u * c + (1 - u) * h_prev
    return {"Gate": [torch.cat([gates, c_in], dim=1)],
            "ResetHiddenPrev": [r * h_prev], "Hidden": [h]}


@register("lstm_unit")
def _lstm_unit(ctx, ins, attrs):
    """One cell step from pre-computed 4H gates {i, f, c, o}
    (lstm_unit_op.cc)."""
    x = ins["X"][0]                       # [N, 4H]
    c_prev = ins["C_prev"][0]             # [N, H]
    hdim = c_prev.shape[1]
    i = torch.sigmoid(x[:, :hdim])
    f = torch.sigmoid(x[:, hdim:2 * hdim] + attrs.get("forget_bias", 0.0))
    g = torch.tanh(x[:, 2 * hdim:3 * hdim])
    o = torch.sigmoid(x[:, 3 * hdim:])
    c = f * c_prev + i * g
    return {"C": [c], "H": [o * torch.tanh(c)]}


@register("row_conv")
def _row_conv(ctx, ins, attrs):
    """Lookahead convolution: out[t] = sum_k x[t+k] * w[k]
    (row_conv_op.cc)."""
    x = ins["X"][0]                       # [B, T, D]
    w = ins["Filter"][0]                  # [K, D]
    xp = F.pad(x, (0, 0, 0, w.shape[0] - 1))
    return {"Out": [sum(xp[:, i:i + x.shape[1]] * w[i][None, None, :]
                        for i in range(w.shape[0]))]}


@register("fsp")
def _fsp(ctx, ins, attrs):
    """Per-sample gram matrix of two feature maps over spatial positions
    (fsp_op.cc)."""
    x, y = ins["X"][0], ins["Y"][0]       # [N, Cx, H, W], [N, Cy, H, W]
    n, cx, h, w = x.shape
    xf = x.reshape(n, cx, h * w)
    yf = y.reshape(n, y.shape[1], h * w)
    return {"Out": [torch.bmm(xf, yf.transpose(1, 2)) / (h * w)]}


@register("cross_entropy2")
def _cross_entropy2(ctx, ins, attrs):
    x = ins["X"][0]                       # probabilities [N, C]
    label = ins["Label"][0]
    picked = torch.gather(x, 1, label.reshape(-1, 1).long())
    xshape = torch.zeros(tuple(x.shape[:-1]) + (0,), dtype=x.dtype,
                         device=x.device)
    return {"Y": [-torch.log(_max(picked, 1e-12)).reshape(label.shape)],
            "MatchX": [picked], "XShape": [xshape]}


@register("size")
def _size(ctx, ins, attrs):
    """The element count of the static shape, in the device int dtype (a
    fill, not a host-to-device copy)."""
    x = ins["Input"][0]
    return {"Out": [torch.full((), math.prod(x.shape),
                               dtype=device_dtype("int64"),
                               device=x.device)]}


@register("is_empty")
def _is_empty(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [torch.full((), math.prod(x.shape) == 0,
                               dtype=torch.bool, device=x.device)]}


@register("diag")
def _diag(ctx, ins, attrs):
    return {"Out": [torch.diag(ins["Diagonal"][0])]}


@register("diag_v2")
def _diag_v2(ctx, ins, attrs):
    x = ins["X"][0]
    off = attrs.get("offset", 0)
    if x.dim() != 1:
        return {"Out": [torch.diagonal(x, offset=off, dim1=-2, dim2=-1)]}
    out = torch.diag(x, off)
    pad = attrs.get("padding_value", 0.0)
    if pad:
        i = torch.arange(out.shape[0], device=x.device)
        out = torch.where(i[None, :] - i[:, None] == off, out,
                          _const(out, pad))
    return {"Out": [out]}


@register("diag_embed")
def _diag_embed(ctx, ins, attrs):
    return {"Out": [torch.diag_embed(ins["Input"][0],
                                     offset=attrs.get("offset", 0))]}


@register("unique_with_counts")
def _unique_with_counts(ctx, ins, attrs):
    """`jnp.unique(size=n, fill_value=0)`: the distinct values ascending,
    then 0s up to the input's length n; Index maps each element to its
    slot, Count is each slot's count (0 past the last), both int32. The
    runs of one stable sort (`id_runs`): no host read."""
    x = ins["X"][0].reshape(-1)
    n = x.shape[0]
    sorted_x, perm, _, slot = id_runs(x)
    uniq = torch.zeros_like(x).index_put((slot,), sorted_x)
    index = torch.zeros_like(slot).scatter(0, perm, slot)
    counts = torch.zeros(n, dtype=torch.int32, device=x.device).index_put(
        (slot,), torch.ones(n, dtype=torch.int32, device=x.device),
        accumulate=True)
    return {"Out": [uniq], "Index": [index.to(torch.int32)],
            "Count": [counts]}


@register("warpctc")
def _warpctc(ctx, ins, attrs):
    """CTC loss on padded-dense [B, T, C] logits with length vectors:
    optax.ctc_loss's recursion (log-softmax inside; blank and label
    alphas in log space, log(0) as -1e5) as torch ops, one step a frame."""
    logits = ins["Logits"][0]             # [B, T, C]
    labels = ins["Label"][0].long()       # [B, N]
    logit_len = ins.get("LogitsLength", [None])[0]
    label_len = ins.get("LabelLength", [None])[0]
    blank = attrs.get("blank", 0)
    log_eps = -1e5
    b, t, c = logits.shape
    n = labels.shape[1]
    dev, fd = logits.device, torch.float32
    steps = torch.arange(t, device=dev)[None, :]
    lpad = torch.zeros((b, t), dtype=fd, device=dev) if logit_len is None \
        else (steps >= logit_len.reshape(-1, 1)).to(fd)
    labellens = torch.full((b,), n, dtype=torch.long, device=dev) \
        if label_len is None else torch.clamp(label_len.reshape(-1).long(),
                                              0, n)
    logprobs = torch.log_softmax(logits, dim=-1)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(fd), (0, 1))
    lp_phi = logprobs[:, :, blank:blank + 1].transpose(0, 1)   # [T, B, 1]
    # jax.nn.one_hot of an out-of-range label is a zero row
    valid = (labels >= 0) & (labels < c)
    emit = torch.gather(logprobs, 2, torch.clamp(labels, 0, c - 1)[:, None, :]
                        .expand(b, t, n))
    lp_emit = torch.where(valid[:, None, :], emit,
                          _const(emit, 0.0)).transpose(0, 1)  # [T, B, N]

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)],
                         dim=-1)

    phi = torch.cat([torch.zeros((b, 1), dtype=fd, device=dev),
                     torch.full((b, n), log_eps, dtype=fd, device=dev)], 1)
    emit_a = torch.full((b, n), log_eps, dtype=fd, device=dev)
    for i in range(t):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit_a + log_eps * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit[i],
                                    emit_a + lp_emit[i])
        next_phi = update_phi(prev_phi + lp_phi[i],
                              emit_a + lp_phi[i] + log_eps * (1.0 - repeat))
        pad = lpad[:, i:i + 1]
        emit_a = pad * emit_a + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = update_phi(phi, emit_a)
    loss = -torch.gather(last, 1, labellens[:, None])
    return {"Loss": [loss.reshape(b, 1)], "WarpCTCGrad": [None]}


@register("unpool")
def _unpool(ctx, ins, attrs):
    """Scatter pooled values back to their max indices (unpool_op.cc)."""
    x = ins["X"][0]                       # [N, C, h, w]
    idx = ins["Indices"][0]               # flat indices into out_h*out_w
    ks = attrs.get("ksize", [2, 2])
    out_h = attrs.get("output_height", x.shape[2] * ks[0])
    out_w = attrs.get("output_width", x.shape[3] * ks[1])
    n, c = x.shape[:2]
    flat = torch.zeros((n, c, out_h * out_w), dtype=x.dtype, device=x.device)
    out = flat.scatter(2, idx.reshape(n, c, -1).long(), x.reshape(n, c, -1))
    return {"Out": [out.reshape(n, c, out_h, out_w)]}
