"""Neural-net lowerings (counterpart of paddle_tpu/ops/nn_ops.py): every
type the reference registers there. Convolutions go to cuDNN
(`F.conv2d` / `F.conv_transpose2d`), as the reference leaves them to
`lax.conv_general_dilated` outside any Pallas kernel. Where torch's
nearest function differs from the reference, the reference's arithmetic is
written out: max pooling reduces windows with `amax`, which splits the
gradient evenly among tied maxima as `jnp.max` does (`F.max_pool2d` gives
it all to one); `batch_norm` keeps the reference's running-statistics rule
(`mean * momentum + batch * (1 - momentum)`, the biased batch variance)
and its inverse-deviation `SavedVariance`; `interpolate` builds the
per-axis weights of `jax.image.resize` (half-pixel centres, Keys cubic
with a = -0.5)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(v) if len(v) == n else tuple(v) * n
    return (v,) * n


@register("conv2d")
def _conv2d(ctx, ins, attrs):
    """NCHW / OIHW convolution with groups and dilation (reference
    nn_ops.py:24)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    out = F.conv2d(x, w, stride=_pair(attrs.get("strides", [1, 1])),
                   padding=_pair(attrs.get("paddings", [0, 0])),
                   dilation=_pair(attrs.get("dilations", [1, 1])),
                   groups=attrs.get("groups", 1) or 1)
    return {"Output": [out.to(x.dtype)]}


@register("depthwise_conv2d")
def _depthwise_conv2d(ctx, ins, attrs):
    return _conv2d(ctx, ins, dict(attrs, groups=ins["Input"][0].shape[1]))


@register("conv2d_transpose")
def _conv2d_transpose(ctx, ins, attrs):
    """Filter [C_in, C_out, kh, kw]; H_out = (H-1)*stride - 2*pad +
    dilation*(k-1) + 1, the gradient of conv2d (reference nn_ops.py:55)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    out = F.conv_transpose2d(x, w, stride=_pair(attrs.get("strides", [1, 1])),
                             padding=_pair(attrs.get("paddings", [0, 0])),
                             dilation=_pair(attrs.get("dilations", [1, 1])))
    return {"Output": [out]}


def _windows(x, ksize, strides):
    """(N, C, H, W) -> (N, C, H', W', kh, kw): every pooling window, a
    view (its gradient sums over overlapping windows without atomics)."""
    return x.unfold(2, ksize[0], strides[0]).unfold(3, ksize[1], strides[1])


def _pad_hw(x, paddings, value=0.0):
    ph, pw = paddings
    if not (ph or pw):
        return x
    return F.pad(x, (pw, pw, ph, ph), value=value)


@register("pool2d")
def _pool2d(ctx, ins, attrs):
    """Max / average pooling (reference nn_ops.py:96): global, adaptive
    (divisible sizes), aligned (a reshape) and windowed paths; `exclusive`
    averages over the unpadded elements of a window."""
    x = ins["X"][0]
    ptype = attrs.get("pooling_type", "max")
    ksize = _pair(attrs.get("ksize", [2, 2]))
    strides = _pair(attrs.get("strides", ksize))
    paddings = _pair(attrs.get("paddings", [0, 0]))
    if attrs.get("global_pooling", False):
        fn = torch.amax if ptype == "max" else torch.mean
        return {"Out": [fn(x, dim=(2, 3), keepdim=True)]}
    n, c, h, w = x.shape
    if attrs.get("adaptive", False):
        oh, ow = ksize
        if h % oh or w % ow:
            raise ValueError("adaptive pool2d needs divisible dims")
        ksize = strides = (h // oh, w // ow)
        paddings = (0, 0)
    if tuple(ksize) == tuple(strides) and paddings == (0, 0) \
            and h % ksize[0] == 0 and w % ksize[1] == 0:
        xr = x.reshape(n, c, h // ksize[0], ksize[0], w // ksize[1],
                       ksize[1])
        fn = torch.amax if ptype == "max" else torch.mean
        return {"Out": [fn(xr, dim=(3, 5))]}
    if ptype == "max":
        low = float("-inf") if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        win = _windows(_pad_hw(x, paddings, low), ksize, strides)
        return {"Out": [torch.amax(win, dim=(-2, -1))]}
    summed = _windows(_pad_hw(x, paddings), ksize, strides).sum(
        dim=(-2, -1))
    if attrs.get("exclusive", True) and (paddings[0] or paddings[1]):
        ones = torch.ones((1, 1, h, w), dtype=x.dtype, device=x.device)
        counts = _windows(_pad_hw(ones, paddings), ksize, strides).sum(
            dim=(-2, -1))
        return {"Out": [summed / counts]}
    return {"Out": [summed / float(ksize[0] * ksize[1])]}


@register("softmax")
def _softmax(ctx, ins, attrs):
    return {"Out": [torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))]}


@register("log_softmax")
def _log_softmax(ctx, ins, attrs):
    return {"Out": [torch.log_softmax(ins["X"][0],
                                      dim=attrs.get("axis", -1))]}


@register("cross_entropy", nondiff_slots=("Label",))
def _cross_entropy(ctx, ins, attrs):
    """X are probabilities; hard labels are indices with a trailing 1-dim,
    soft labels distributions; log(max(p, 1e-12)) (reference
    nn_ops.py:164)."""
    x, label = ins["X"][0], ins["Label"][0]
    eps = torch.full((), 1e-12, dtype=x.dtype, device=x.device)
    if attrs.get("soft_label", False):
        return {"Y": [-torch.sum(label * torch.log(torch.maximum(x, eps)),
                                 dim=-1, keepdim=True)]}
    idx = label.long()
    if idx.dim() == x.dim():
        idx = idx.squeeze(-1)
    picked = torch.take_along_dim(x, idx.unsqueeze(-1), dim=-1)
    return {"Y": [-torch.log(torch.maximum(picked, eps))]}


@register("sigmoid_cross_entropy_with_logits", nondiff_slots=("Label",))
def _sigmoid_ce(ctx, ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return {"Out": [torch.maximum(x, zero) - x * label
                    + torch.log1p(torch.exp(-torch.abs(x)))]}


@register("huber_loss", nondiff_slots=("Y",))
def _huber_loss(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    d = attrs.get("delta", 1.0)
    r = y - x
    a = torch.abs(r)
    return {"Out": [torch.where(a <= d, 0.5 * r * r, d * (a - 0.5 * d))],
            "Residual": [r]}


@register("batch_norm", nondiff_slots=("Mean", "Variance"),
          stateful_outputs=("MeanOut", "VarianceOut"))
def _batch_norm(ctx, ins, attrs):
    """NCHW or NHWC (reference nn_ops.py:227). Training normalises by the
    batch statistics in f32 and returns the running statistics' next
    values, `running * momentum + batch * (1 - momentum)` with the BIASED
    batch variance, for the executor to write into the scope's tensors;
    `SavedVariance` is 1 / sqrt(var + eps). `is_test` normalises by the
    running statistics and returns them unchanged (the same tensors, so
    nothing is written)."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    c_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    red = tuple(i for i in range(x.dim()) if i != c_axis)
    bshape = [1] * x.dim()
    bshape[c_axis] = x.shape[c_axis]
    if attrs.get("is_test", False):
        use_mean, use_var = mean, var
        mean_out, var_out, saved_mean, saved_var = mean, var, mean, var
    else:
        use_mean, use_var = (t.reshape(-1) for t in _moments(x.float(),
                                                               red))
        mean_out = mean * momentum + use_mean * (1 - momentum)
        var_out = var * momentum + use_var * (1 - momentum)
        saved_mean = use_mean
        saved_var = 1.0 / torch.sqrt(use_var + eps)
    inv = 1.0 / torch.sqrt(use_var.float() + eps)
    y = (x - use_mean.reshape(bshape).to(x.dtype)) \
        * (inv.reshape(bshape) * scale.reshape(bshape)).to(x.dtype) \
        + bias.reshape(bshape).to(x.dtype)
    return {"Y": [y], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [saved_mean], "SavedVariance": [saved_var]}


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


def _moments(x, axes):
    """Mean and biased variance over `axes`, kept as dims (jnp.var)."""
    mean = x.mean(dim=axes, keepdim=True)
    return mean, ((x - mean) ** 2).mean(dim=axes, keepdim=True)


def _channel_affine(y, ins, c):
    shape = (1, c) + (1,) * (y.dim() - 2)
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(shape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(shape)
    return y


@register("instance_norm")
def _instance_norm(ctx, ins, attrs):
    x = ins["X"][0]
    mean, var = _moments(x, tuple(range(2, x.dim())))
    y = (x - mean) / torch.sqrt(var + attrs.get("epsilon", 1e-5))
    return {"Y": [_channel_affine(y, ins, x.shape[1])],
            "SavedMean": [mean.squeeze()], "SavedVariance": [var.squeeze()]}


@register("group_norm")
def _group_norm(ctx, ins, attrs):
    x = ins["X"][0]
    g = attrs.get("groups", 32)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    mean, var = _moments(xg, tuple(range(2, xg.dim())))
    y = ((xg - mean) / torch.sqrt(var + attrs.get("epsilon", 1e-5))) \
        .reshape(x.shape)
    return {"Y": [_channel_affine(y, ins, c)], "Mean": [mean.squeeze()],
            "Variance": [var.squeeze()]}


@register("layer_norm")
def _layer_norm(ctx, ins, attrs):
    """Normalise over dims >= begin_norm_axis, in f32."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    bna = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(bna, x.dim()))
    xf = x.float()
    mean, var = _moments(xf, axes)
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
    out = torch.nn.functional.embedding(idx, w)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad >= 0:
        out = torch.where((idx == pad).unsqueeze(-1),
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return {"Out": [out]}


def _zero_rows(out, idx, pad):
    if pad is None or pad < 0:
        return out
    return torch.where((idx == pad).unsqueeze(-1),
                       torch.zeros((), dtype=out.dtype, device=out.device),
                       out)


@register("lookup_table_v2", nondiff_slots=("Ids",))
def _lookup_table_v2(ctx, ins, attrs):
    """Ids without the trailing 1-dim."""
    w, ids = ins["W"][0], ins["Ids"][0]
    out = torch.nn.functional.embedding(ids.long(), w)
    return {"Out": [_zero_rows(out, ids, attrs.get("padding_idx", -1))]}


def _one_hot_f32(x, depth):
    """jax.nn.one_hot: an index outside [0, depth) gives a zero row (and
    no host check, unlike F.one_hot)."""
    cols = torch.arange(depth, dtype=torch.int64, device=x.device)
    return (x.long().unsqueeze(-1) == cols).float()


@register("one_hot", nondiff_slots=("X",))
def _one_hot(ctx, ins, attrs):
    x = ins["X"][0]
    if x.dim() and x.shape[-1] == 1:
        x = x.squeeze(-1)
    return {"Out": [_one_hot_f32(x, attrs["depth"])]}


@register("one_hot_v2", nondiff_slots=("X",))
def _one_hot_v2(ctx, ins, attrs):
    return {"Out": [_one_hot_f32(ins["X"][0], attrs["depth"])]}


@register("pad")
def _pad(ctx, ins, attrs):
    """`paddings` [lo0, hi0, lo1, hi1, ...] from the first dim on."""
    x = ins["X"][0]
    p = attrs["paddings"]
    pads = []
    for i in reversed(range(x.dim())):
        pads += [p[2 * i], p[2 * i + 1]]
    return {"Out": [F.pad(x, pads, value=attrs.get("pad_value", 0.0))]}


@register("pad2d")
def _pad2d(ctx, ins, attrs):
    """`paddings` [top, bottom, left, right]; constant, reflect or edge."""
    x = ins["X"][0]
    p = attrs["paddings"]
    pads = [p[2], p[3], p[0], p[1]]
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return {"Out": [F.pad(x, pads, value=attrs.get("pad_value", 0.0))]}
    return {"Out": [F.pad(x, pads, mode={"reflect": "reflect",
                                         "edge": "replicate"}[mode])]}


def _keys_cubic(d):
    out = ((1.5 * d - 2.5) * d) * d + 1.0
    out = torch.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0, out)
    return torch.where(d >= 2.0, torch.zeros_like(d), out)


def _resize_weights(n_in, n_out, method, device):
    """[n_in, n_out] f32 weights of jax.image.resize along one axis
    (`compute_weight_mat` without antialiasing): half-pixel sample
    positions, the kernel's weights normalised by their sum, zero where
    the sample falls outside the input."""
    inv = n_in / n_out
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    d = torch.abs(sample.unsqueeze(0) - torch.arange(
        n_in, dtype=torch.float32, device=device).unsqueeze(1))
    w = torch.clamp(1.0 - d, min=0.0) if method == "bilinear" \
        else _keys_cubic(d)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * 1.1920929e-07,
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside.unsqueeze(0), w, torch.zeros_like(w))


@register("interpolate")
def _interpolate(ctx, ins, attrs):
    """jax.image.resize without antialiasing (reference nn_ops.py:404):
    nearest takes input row floor((i + 0.5) * in / out) in f32; bilinear
    and bicubic apply the per-axis weights (`_resize_weights`) to the
    axes whose size changes."""
    x = ins["X"][0]
    method = attrs.get("interp_method", "nearest")
    out_h, out_w = attrs.get("out_h", -1), attrs.get("out_w", -1)
    h, w = x.shape[2], x.shape[3]
    if out_h <= 0:
        scale = attrs.get("scale", 0.0)
        out_h, out_w = int(h * scale), int(w * scale)
    out = x
    for axis, (n_in, n_out) in ((2, (h, out_h)), (3, (w, out_w))):
        if n_in == n_out:
            continue
        if method == "nearest":
            pos = (torch.arange(n_out, dtype=torch.float32, device=x.device)
                   + 0.5) * n_in / n_out
            out = torch.index_select(out, axis, torch.floor(pos).long())
            continue
        wm = _resize_weights(n_in, n_out, method, x.device)
        res = torch.tensordot(out.float(), wm, dims=([axis], [0]))
        out = res.movedim(-1, axis)
    return {"Out": [out.to(x.dtype)]}


@register("nearest_interp")
def _nearest_interp(ctx, ins, attrs):
    return _interpolate(ctx, ins, dict(attrs, interp_method="nearest"))


@register("bilinear_interp")
def _bilinear_interp(ctx, ins, attrs):
    return _interpolate(ctx, ins, dict(attrs, interp_method="bilinear"))
