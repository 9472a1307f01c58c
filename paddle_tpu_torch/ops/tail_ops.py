"""The second long tail of ops (counterpart of paddle_tpu/ops/tail_ops.py):
the interpolation family, geometry and ROI pooling, deformable
convolution, the sampled-softmax and random ops, hashing, the inference
fusions, fake quantization, the host ops, the proximal and DGC update
rules, the metric tail and `lstmp`. Every type of the reference file in
its section order, with its flags (`multiclass_nms2` aliases
ops/detection_ops.py's `multiclass_nms`). Each is
differentiated by the generic `__vjp__` (`torch.func.vjp` over the
lowering) unless it says otherwise.

Where the reference's arithmetic is not torch's nearest function, it is
written out:

* `hash` multiplies, xor-shifts and sums in uint32 that wraps, emulated in
  int64 with `& 0xFFFFFFFF` after each step (`_mul32`), and only then
  takes `% mod_by`.
* The random types draw on the device from the op's key
  (`ops/tensor_ops.py` `_random_bits`), never from a host generator, so a
  captured step draws anew on each replay: `randperm` and `shuffle_batch`
  sort the op's bits stably, `random_crop` starts from them and gathers,
  `sampling_id` inverts the row's cumulative sum, `nce` and
  `sample_logits` take `bits % num_classes`. The reference draws from
  jax's RNG, so the values differ; shapes, ranges and the formulas given
  the samples are what the two packages share.
* Gathers that a gradient passes through are advanced indexing, whose
  pullback is `index_put(accumulate=True)` (on CUDA the sort-based
  kernel, no atomics), not `torch.gather` (atomic adds).
* `dgc` takes the reference's strided sample of |V + m U + G| (a ceiling
  stride over at most 4,096 elements), sorts it, and keeps the elements
  at or above the sample's `pos`-th value; the schedule's segment is
  truncated toward zero, as jax's cast. `m U + G` is computed in f64
  and then rounded to f32 (`fma`), which matches the reference's fused
  multiply-add but where the f64 sum lands on a halfway point of f32, so
  the same U, V and G keep the same elements in both packages and on any
  device.
* The shapes some ops take from a tensor (`OutSize` of the interp types,
  `OutputShape` of `affine_grid`) are read from the `_const_value` a
  `fill_constant` output carries, or else on the host: a program that
  reads one on the host, or holds `print`, `py_func` or `chunk_eval`
  (registered `host_read`), runs eagerly under `run_steps`
  (framework/executor.py `_host_synced`). None of them reads the host
  inside a capture: they raise there.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import errors
# multiclass_nms2 aliases multiclass_nms: its lowering, flags and shape
# rule must be registered first
from . import detection_assign_ops  # noqa: F401
from .extra_ops import _max, _softplus
from .kernels.flash_attention import _U32, _mul32
from .math_ops import _clip, _const
from .nn_ops import _resize_weights
from .registry import get as get_op
from .registry import register
from .tensor_ops import _canonical, _random_bits, _uniform01

def _not_capturing(ctx, what):
    if ctx.capturing:
        raise errors.Unavailable(
            "%s reads device values on the host, which a captured step "
            "cannot: run_steps runs such a program eagerly", what, op=what)


def _host_shape(ctx, t, what):
    """The ints of a shape tensor: from the `_const_value` its
    `fill_constant` tagged, else read on the host (an eager step only)."""
    value = getattr(t, "_const_value", None)
    if value is not None:
        return [int(value)] * t.numel()
    _not_capturing(ctx, what)
    return [int(v) for v in t.reshape(-1).tolist()]


def _pick(t, i):
    """t[i] for a 0-d index tensor, on the device (indexing by a 0-d
    tensor reads it on the host)."""
    return torch.index_select(t, 0, i.reshape(1).long()).reshape(())


def _fills(values, dtype, device):
    """A constant vector built from one fill a value: no host-to-device
    copy, so a captured step may hold it."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device)
                        for v in values])


# ---------------------------------------------------------------------------
# interpolation: v1 names + v2 (scale as list, align modes)
# ---------------------------------------------------------------------------

def _resize_nd(x, out_sizes, method, align_corners=False):
    """jax.image.resize without antialiasing over x's trailing spatial
    axes (nearest: input index floor((i + 0.5) * in / out); the linear
    and cubic kernels through `nn_ops._resize_weights`), or, with
    `align_corners`, the reference's linear map of corners to corners
    (for bicubic too, as the reference does)."""
    if align_corners and method != "nearest":
        return _resize_align_corners(x, out_sizes)
    out = x
    for i, n_out in enumerate(out_sizes):
        axis = i + 2
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        if method == "nearest":
            pos = (torch.arange(n_out, dtype=torch.float32, device=x.device)
                   + 0.5) * n_in / n_out
            out = torch.index_select(out, axis, torch.floor(pos).long())
            continue
        wm = _resize_weights(n_in, n_out,
                             "bicubic" if method == "bicubic" else "bilinear",
                             x.device)
        out = torch.tensordot(out.float(), wm, dims=([axis], [0])) \
            .movedim(-1, axis)
    return out.to(x.dtype)


def _resize_align_corners(x, out_sizes):
    out = x
    for dim, osz in enumerate(out_sizes):
        axis = dim + 2
        isz = out.shape[axis]
        if osz == isz:
            continue
        pos = (torch.arange(osz, device=x.device) * (isz - 1)
               / max(osz - 1, 1) if osz > 1
               else torch.zeros(1, device=x.device))
        lo = torch.clamp(torch.floor(pos).long(), 0, isz - 1)
        hi = torch.clamp(lo + 1, max=isz - 1)
        shape = [1] * out.dim()
        shape[axis] = osz
        w = (pos - lo).to(out.dtype).reshape(shape)
        out = (torch.index_select(out, axis, lo) * (1 - w)
               + torch.index_select(out, axis, hi) * w)
    return out


def _interp_sizes(ctx, ins, attrs, x, ndim_sp, op_type):
    names = ["out_d", "out_h", "out_w"][-ndim_sp:]
    sizes = [int(attrs.get(n, -1)) for n in names]
    osz = ins.get("OutSize", [None])[0]
    if osz is not None:
        sizes = _host_shape(ctx, osz, op_type)
    if any(s <= 0 for s in sizes):
        scale = attrs.get("scale", 0.0)
        if isinstance(scale, (list, tuple)):
            # a short list broadcasts its last element over the remaining
            # spatial dims (scale=[2.0] for bilinear means 2.0 both ways)
            if not scale:
                raise ValueError("interp: empty scale list and no out size")
            scales = (list(scale) + [scale[-1]] * ndim_sp)[:ndim_sp]
        else:
            scales = [scale] * ndim_sp
        sizes = [int(d * s) for d, s in zip(x.shape[2:], scales)]
    return sizes


def _make_interp(name, method, ndim_sp):
    @register(name, nondiff_slots=("OutSize", "SizeTensor", "Scale"),
              shape_slot="OutSize")
    def _interp(ctx, ins, attrs, _m=method, _nd=ndim_sp, _t=name):
        x = ins["X"][0]
        sizes = _interp_sizes(ctx, ins, attrs, x, _nd, _t)
        out = _resize_nd(x, sizes, _m,
                         align_corners=attrs.get("align_corners", False))
        return {"Out": [out.to(x.dtype)]}
    return _interp


INTERP_TYPES = (
    ("linear_interp", "linear", 1), ("bicubic_interp", "bicubic", 2),
    ("trilinear_interp", "trilinear", 3),
    ("linear_interp_v2", "linear", 1),
    ("nearest_interp_v2", "nearest", 2),
    ("bilinear_interp_v2", "bilinear", 2),
    ("bicubic_interp_v2", "bicubic", 2),
    ("trilinear_interp_v2", "trilinear", 3))
for _nm, _method, _nd in INTERP_TYPES:
    _make_interp(_nm, _method, _nd)

# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@register("affine_grid", nondiff_slots=("OutputShape",),
          shape_slot="OutputShape")
def _affine_grid(ctx, ins, attrs):
    """affine_grid_op.cc: theta [N,2,3] -> sampling grid [N,H,W,2]."""
    theta = ins["Theta"][0]
    shape = ins.get("OutputShape", [None])[0]
    if shape is not None:
        _, _, h, w = _host_shape(ctx, shape, "affine_grid")
    else:
        _, _, h, w = attrs["output_shape"]
    align = attrs.get("align_corners", True)

    def axis(n):
        if align:
            return torch.linspace(-1.0, 1.0, n, device=theta.device)
        step = 2.0 / n
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, n,
                              device=theta.device)
    ys, xs = torch.meshgrid(axis(h), axis(w), indexing="ij")
    base = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)   # [H,W,3]
    grid = torch.einsum("hwk,njk->nhwj", base.to(theta.dtype), theta)
    return {"Output": [grid]}


def _bilinear_at(feat, y, x):
    """The reference's `_bilinear_at` over a batch: feat [B,C,H,W]; y / x
    [B, *coords] float coordinates -> [B, C, *coords]. Corners clamp into
    the image, a point outside (-1, H) x (-1, W) samples zero."""
    b, c, h, w = feat.shape
    coords = tuple(y.shape[1:])
    y0 = torch.clamp(torch.floor(y).long(), 0, h - 1)
    x0 = torch.clamp(torch.floor(x).long(), 0, w - 1)
    y1, x1 = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    wy = (y - y0).unsqueeze(1)
    wx = (x - x0).unsqueeze(1)
    inb = ((y > -1) & (y < h) & (x > -1) & (x < w)).to(feat.dtype)
    flat = feat.reshape(b, c, h * w).transpose(1, 2)            # [B,HW,C]
    rows = torch.arange(b, device=feat.device).reshape(b, 1)

    def at(yi, xi):
        v = flat[rows, (yi * w + xi).reshape(b, -1)]            # [B,P,C]
        return v.transpose(1, 2).reshape((b, c) + coords)

    out = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx
           + at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)
    return out * inb.unsqueeze(1)


def _roi_batch_index(ins, n_rois, batch, device, slot="RoisNum"):
    """Per-ROI image index from the RoisNum counts tensor; with no counts
    and batch > 1 the mapping is ambiguous, and raises."""
    nums = ins.get(slot, [None])[0]
    if nums is None:
        if batch > 1:
            raise ValueError(
                f"{slot} input is required when batch size > 1 "
                f"(got batch={batch}, {n_rois} rois)")
        return torch.zeros((n_rois,), dtype=torch.long, device=device)
    starts = torch.cumsum(nums.reshape(-1).to(torch.int32), 0)
    return (torch.arange(n_rois, dtype=torch.int32, device=device)[:, None]
            >= starts[None, :]).sum(1)


def _roi_samples(x, rois, bidx, ph, pw, scale, min_size, samples=4):
    """Each ROI's bins sampled on a samples x samples grid: [R, C, ph,
    pw, s, s]."""
    r = rois.to(x.dtype) * scale
    x1, y1, x2, y2 = (r[:, i].reshape(-1, 1, 1, 1, 1) for i in range(4))
    rh = _max(y2 - y1, min_size) / ph
    rw = _max(x2 - x1, min_size) / pw
    dev = x.device
    ii, jj, si, sj = torch.meshgrid(
        torch.arange(ph, device=dev), torch.arange(pw, device=dev),
        torch.arange(samples, device=dev), torch.arange(samples, device=dev),
        indexing="ij")
    ys = y1 + ii * rh + (si + 0.5) * rh / samples
    xs = x1 + jj * rw + (sj + 0.5) * rw / samples
    return _bilinear_at(x[bidx.long()], ys, xs)


@register("psroi_pool", nondiff_slots=("ROIs", "RoisNum"))
def _psroi_pool(ctx, ins, attrs):
    """psroi_pool_op.cc: output channel c at bin (i, j) averages input
    channel c*ph*pw + i*pw + j over the bin (4 x 4 samples)."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    ph = attrs.get("pooled_height", 1)
    pw = attrs.get("pooled_width", 1)
    oc = attrs.get("output_channels")
    scale = attrs.get("spatial_scale", 1.0)
    bidx = _roi_batch_index(ins, rois.shape[0], x.shape[0], x.device)
    v = _roi_samples(x, rois, bidx, ph, pw, scale, 0.1).mean(dim=(-1, -2))
    dev = x.device
    co, gi, gj = torch.meshgrid(torch.arange(oc, device=dev),
                                torch.arange(ph, device=dev),
                                torch.arange(pw, device=dev), indexing="ij")
    chan = co * (ph * pw) + gi * pw + gj
    return {"Out": [v[:, chan, gi, gj]]}


@register("prroi_pool", nondiff_slots=("ROIs", "BatchRoINums"))
def _prroi_pool(ctx, ins, attrs):
    """prroi_pool_op.cc: precise ROI pooling as a dense bilinear
    average."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    ph = attrs.get("pooled_height", 1)
    pw = attrs.get("pooled_width", 1)
    scale = attrs.get("spatial_scale", 1.0)
    bidx = _roi_batch_index(ins, rois.shape[0], x.shape[0], x.device,
                            slot="BatchRoINums")
    v = _roi_samples(x, rois, bidx, ph, pw, scale, 1e-4)
    return {"Out": [v.mean(dim=(-1, -2))]}


def _deform_conv(ctx, ins, attrs, with_mask):
    """deformable_conv_op.cc (v2, modulated) / v1: im2col sampled
    bilinearly at the learned offsets (zero outside the image), then one
    product per group."""
    x, offset, weight = ins["Input"][0], ins["Offset"][0], ins["Filter"][0]
    mask = ins["Mask"][0] if with_mask else None
    stride = attrs.get("strides", [1, 1])
    pad = attrs.get("paddings", [0, 0])
    dil = attrs.get("dilations", [1, 1])
    groups = attrs.get("groups", 1)
    n, cin, h, w = x.shape
    cout, cin_g, kh, kw = weight.shape
    oh = (h + 2 * pad[0] - (dil[0] * (kh - 1) + 1)) // stride[0] + 1
    ow = (w + 2 * pad[1] - (dil[1] * (kw - 1) + 1)) // stride[1] + 1
    k = kh * kw
    dev = x.device
    ys0 = torch.arange(oh, device=dev) * stride[0] - pad[0]
    xs0 = torch.arange(ow, device=dev) * stride[1] - pad[1]
    kk = torch.arange(k, device=dev)
    ki = (kk // kw * dil[0]).reshape(1, k, 1, 1)
    kj = (kk % kw * dil[1]).reshape(1, k, 1, 1)
    off = offset.reshape(n, k, 2, oh, ow)
    ys = ys0.reshape(1, 1, oh, 1) + ki + off[:, :, 0]
    xs = xs0.reshape(1, 1, 1, ow) + kj + off[:, :, 1]
    col = _bilinear_at(x, ys, xs)                   # [N, Cin, K, oh, ow]
    if mask is not None:
        col = col * mask.reshape(n, 1, k, oh, ow)
    col = col.reshape(n, groups, cin // groups * k, oh * ow)
    wmat = weight.reshape(groups, cout // groups, cin_g * k)
    out = torch.matmul(wmat, col)                   # [N, G, Cout_g, P]
    return {"Output": [out.reshape(n, cout, oh, ow)]}


@register("deformable_conv")
def _deformable_conv(ctx, ins, attrs):
    return _deform_conv(ctx, ins, attrs, with_mask=True)


@register("deformable_conv_v1")
def _deformable_conv_v1(ctx, ins, attrs):
    return _deform_conv(ctx, ins, attrs, with_mask=False)


@register("random_crop", is_random=True, nondiff_slots=("Seed",))
def _random_crop(ctx, ins, attrs):
    """Each cropped dim starts at the op's bits % (full - crop + 1), and
    the crop is gathered by device indices."""
    x = ins["X"][0]
    shape = attrs["shape"]          # trailing dims of the crop
    nd = len(shape)
    bits = _random_bits(ctx, attrs, (nd,), 0)
    out = x
    for i, (full, crop) in enumerate(zip(x.shape[-nd:], shape)):
        start = bits[i] % (full - crop + 1)
        idx = start + torch.arange(crop, device=x.device)
        out = torch.index_select(out, x.dim() - nd + i, idx)
    return {"Out": [out],
            "SeedOut": [torch.zeros((1,), dtype=torch.int32,
                                    device=x.device)]}


# ---------------------------------------------------------------------------
# sampled softmax / nce
# ---------------------------------------------------------------------------

@register("nce", is_random=True, nondiff_slots=("Label", "SampleWeight"))
def _nce(ctx, ins, attrs):
    """nce_op.cc: noise-contrastive estimation with uniform negatives
    (the op's bits % num_classes). Cost [b, 1]; logits laid out [true...,
    sampled...]."""
    x, label = ins["Input"][0], ins["Label"][0]
    w = ins["Weight"][0]            # [num_classes, d]
    b = ins.get("Bias", [None])[0]
    num_neg = attrs.get("num_neg_samples", 10)
    num_classes = attrs.get("num_total_classes", w.shape[0])
    bsz = x.shape[0]
    label = label.reshape(bsz, -1)
    num_true = label.shape[1]
    neg = (_random_bits(ctx, attrs, (bsz, num_neg), 0) % num_classes) \
        .to(label.dtype)
    ids = torch.cat([label, neg], 1)                # [b, T+S]
    wt = w[ids.long()]                              # [b, T+S, d]
    logits = torch.einsum("bd,btd->bt", x, wt)
    if b is not None:
        logits = logits + b[ids.long()]
    # NCE binary logistic: true samples label 1, noise label 0, with
    # logits corrected by log(k * p_noise)
    corr = _const(logits, num_neg * (1.0 / num_classes)).log()
    z = logits - corr
    lbl = torch.cat([torch.ones((bsz, num_true), device=x.device),
                     torch.zeros((bsz, num_neg), device=x.device)],
                    1).to(x.dtype)
    loss = _softplus(z) - lbl * z
    cost = loss.sum(dim=1, keepdim=True)
    return {"Cost": [cost.to(x.dtype)], "SampleLogits": [logits],
            "SampleLabels": [ids]}


@register("sample_logits", is_random=True, nondiff_slots=("Labels",))
def _sample_logits(ctx, ins, attrs):
    """sample_logits_op.cc: sampled softmax: the true and uniformly sampled
    (the op's bits % num_classes) logits, corrected by the log of their
    sampling probability; a sample equal to a row's true label is pushed
    to -1e20 (`remove_accidental_hits`)."""
    logits, labels = ins["Logits"][0], ins["Labels"][0]
    num_samples = attrs.get("num_samples", 10)
    bsz, num_classes = logits.shape
    labels = labels.reshape(bsz, -1)
    nt = labels.shape[1]
    sampled = (_random_bits(ctx, attrs, (bsz, num_samples), 0)
               % num_classes).to(labels.dtype)
    ids = torch.cat([labels, sampled], 1)
    rows = torch.arange(bsz, device=logits.device).reshape(bsz, 1)
    picked = logits[rows, ids.long()]
    if attrs.get("remove_accidental_hits", True):
        acc = (sampled[:, None, :] == labels[:, :, None]).any(1)
        hits = torch.where(acc, _const(picked, -1e20), _const(picked, 0.0))
        picked = torch.cat([picked[:, :nt], picked[:, nt:] + hits], 1)
    prob = torch.full_like(picked, 1.0 / num_classes)
    out = picked - torch.log(prob * num_classes * num_samples / num_classes)
    new_labels = torch.arange(nt, dtype=torch.int32,
                              device=logits.device)[None].repeat(bsz, 1)
    return {"SampledLogits": [out], "Samples": [ids],
            "SampledLabels": [new_labels], "Probabilities": [prob],
            "LogitsDim": [_fills(logits.shape, torch.int32, logits.device)],
            "LabelsDim": [_fills(labels.shape, torch.int32, logits.device)]}


@register("sampling_id", is_random=True)
def _sampling_id(ctx, ins, attrs):
    """One id a row of probabilities, by the inverse of the row's
    cumulative sum at a uniform draw scaled to the row's total."""
    x = ins["X"][0]   # [b, C] probabilities
    cdf = torch.cumsum(x.float(), dim=-1)
    u = _uniform01(_random_bits(ctx, attrs, (x.shape[0], 1), 0))
    ids = torch.searchsorted(cdf, u * cdf[:, -1:], right=True)
    return {"Out": [ids.clamp(max=x.shape[1] - 1).reshape(-1)
                    .to(torch.int32)]}


# ---------------------------------------------------------------------------
# hashing / instag / sparse-feature misc
# ---------------------------------------------------------------------------

@register("hash", nondiff_slots=("X",))
def _hash(ctx, ins, attrs):
    """hash_op.cc: each id row hashed into `num_hash` spaces: the ids as
    uint32 times (k * 2654435761), xor-shifted by 16, summed, all in
    uint32 that wraps (int64 masked to 32 bits), then % mod_by."""
    x = ins["X"][0]
    num_hash = attrs.get("num_hash", 1)
    mod_by = attrs.get("mod_by", 100000007)
    flat = x.long().reshape(x.shape[0], -1) & _U32
    hs = []
    for k in range(1, num_hash + 1):
        mixed = _mul32(flat, (k * 2654435761) & _U32)
        mixed = mixed ^ (mixed >> 16)
        hs.append((mixed.sum(-1) & _U32) % mod_by)
    h = torch.stack(hs, 1)
    # uint32 -> int32 as jax's cast: the upper half wraps negative
    h = h - ((h >> 31) << 32)
    return {"Out": [h.to(torch.int32).reshape(x.shape[0], num_hash, 1)]}


@register("filter_by_instag", nondiff_slots=("Ins_tag", "Filter_tag"))
def _filter_by_instag(ctx, ins, attrs):
    """filter_by_instag_op.cc masked: rows whose tag set meets the filter
    tags keep their values, the others are zero; LossWeight is the 0/1 row
    mask (the reference compacts the rows; a static shape cannot)."""
    x = ins["Ins"][0]
    tags = ins["Ins_tag"][0].reshape(x.shape[0], -1)
    filt = ins["Filter_tag"][0].reshape(-1)
    hit = (tags[:, :, None] == filt[None, None, :]).any(2).any(1)
    mask = hit.to(x.dtype)
    shaped = mask.reshape((-1,) + (1,) * (x.dim() - 1))
    rows = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    return {"Out": [x * shaped], "LossWeight": [mask.reshape(-1, 1)],
            "IndexMap": [torch.stack([rows, rows], 1)]}


def _permutation(ctx, attrs, n, device):
    """A permutation of range(n): the stable sort of the op's bits."""
    bits = _random_bits(ctx, attrs, (n,), 0)
    return torch.sort(bits, stable=True).indices.to(device)


@register("shuffle_batch", is_random=True, nondiff_slots=("Seed",))
def _shuffle_batch(ctx, ins, attrs):
    x = ins["X"][0]
    perm = _permutation(ctx, attrs, x.shape[0], x.device)
    return {"Out": [x[perm]], "ShuffleIdx": [perm.to(torch.int32)],
            "SeedOut": [torch.zeros((1,), dtype=torch.int32,
                                    device=x.device)]}


@register("match_matrix_tensor")
def _match_matrix_tensor(ctx, ins, attrs):
    """match_matrix_tensor_op.cc: the bilinear match x^T W y per channel,
    [b, Lx, d] x [d, t, d] x [b, Ly, d] -> [b, t, Lx, Ly]."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["W"][0]
    tmp = torch.einsum("bld,dte->blte", x, w)
    out = torch.einsum("blte,bme->btlm", tmp, y)
    return {"Out": [out], "Tmp": [tmp]}


@register("batch_fc")
def _batch_fc(ctx, ins, attrs):
    """batch_fc_op.cc: a fc a slot, [slot, b, in] @ [slot, in, out] + b."""
    x, w = ins["Input"][0], ins["W"][0]
    b = ins.get("Bias", [None])[0]
    out = torch.einsum("sbi,sio->sbo", x, w)
    if b is not None:
        out = out + b.reshape(b.shape[0], 1, -1)
    return {"Out": [out]}


@register("tree_conv", nondiff_slots=("EdgeSet",))
def _tree_conv(ctx, ins, attrs):
    """tree_conv_op.cc: tree convolution as adjacency-weighted products.
    NodesVector [b, N, F], EdgeSet [b, E, 2], Filter [F, 3, O]."""
    nodes, edges, filt = (ins["NodesVector"][0], ins["EdgeSet"][0],
                          ins["Filter"][0])
    b, n, _ = nodes.shape
    src, dst = edges[..., 0].long(), edges[..., 1].long()
    bidx = torch.arange(b, device=nodes.device)[:, None].expand_as(src)
    adj = torch.zeros((b, n, n), dtype=nodes.dtype, device=nodes.device) \
        .index_put((bidx, dst, src), _const(nodes, 1.0))
    deg = _max(adj.sum(-1, keepdim=True), 1.0)
    # three weight roles: self, children (top-down), parents (bottom-up)
    h_self = torch.einsum("bnf,fo->bno", nodes, filt[:, 0])
    h_down = torch.einsum("bnm,bmf,fo->bno", adj / deg, nodes, filt[:, 1])
    h_up = torch.einsum("bmn,bmf,fo->bno",
                        adj / _max(adj.sum(1, keepdim=True), 1.0),
                        nodes, filt[:, 2])
    return {"Out": [torch.tanh(h_self + h_down + h_up)]}


@register("conv_shift")
def _conv_shift(ctx, ins, attrs):
    """conv_shift_op.cc: circular correlation. X [b, n], Y [b, m] (m
    odd)."""
    x, y = ins["X"][0], ins["Y"][0]
    n, m = x.shape[1], y.shape[1]
    half = (m - 1) // 2
    idx = (torch.arange(n, device=x.device)[:, None]
           + torch.arange(m, device=x.device)[None, :] - half) % n
    return {"Out": [torch.einsum("bnm,bm->bn", x[:, idx], y)]}


# ---------------------------------------------------------------------------
# fused transformer / embedding / sequence ops
# ---------------------------------------------------------------------------

@register("multihead_matmul")
def _multihead_matmul(ctx, ins, attrs):
    """fused/multihead_matmul_op.cu: the fused QKV projection and scaled
    dot-product attention. Input [b, s, 3h] projected, or with W."""
    x = ins["Input"][0]
    w = ins.get("W", [None])[0]
    bias = ins.get("Bias", [None])[0]
    bias_qk = ins.get("BiasQK", [None])[0]
    heads = attrs.get("head_number", 1)
    alpha = attrs.get("alpha", 1.0)
    if w is not None:
        qkv = torch.einsum("bsh,hk->bsk", x, w.reshape(x.shape[-1], -1))
        if bias is not None:
            qkv = qkv + bias.reshape(-1)
    else:
        qkv = x
    b, s, three_h = qkv.shape
    h = three_h // 3
    hd = h // heads
    q, k, v = (t.reshape(b, s, heads, hd).transpose(1, 2)
               for t in torch.split(qkv, h, dim=-1))
    scores = torch.einsum("bnsd,bntd->bnst", q, k) * alpha
    if bias_qk is not None:
        scores = scores + bias_qk
    probs = torch.softmax(scores, dim=-1)
    outh = torch.einsum("bnst,bntd->bnsd", probs, v)
    return {"Out": [outh.transpose(1, 2).reshape(b, s, h)]}


@register("fused_embedding_eltwise_layernorm", nondiff_slots=("Ids",))
def _fused_emb_ln(ctx, ins, attrs):
    """fused_embedding_eltwise_layernorm_op.cu: the sum of N embedding
    lookups, then layer_norm (BERT's input encoder)."""
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    eps = attrs.get("epsilon", 1e-5)
    acc = None
    for ids, emb in zip(ins["Ids"], ins["Embs"]):
        v = emb[ids.reshape(ids.shape[:2]).long()]
        acc = v if acc is None else acc + v
    # the moments in f32, rounded to the operands' dtype, as jnp.mean and
    # jnp.var compute a bf16 input's
    a = acc.float()
    mean = a.mean(-1, keepdim=True)
    var = ((a - mean) ** 2).mean(-1, keepdim=True).to(acc.dtype)
    mu = mean.to(acc.dtype)
    out = (acc - mu) / torch.sqrt(var + eps) * scale + bias
    return {"Out": [out]}


@register("fused_embedding_seq_pool", nondiff_slots=("Ids",))
def _fused_embedding_seq_pool(ctx, ins, attrs):
    """fused/fused_embedding_seq_pool_op.cc: lookup, then a sum over the
    sequence. Ids [b, L, 1]; rows past SeqLen count zero."""
    w, ids = ins["W"][0], ins["Ids"][0]
    ids2 = ids.reshape(ids.shape[0], -1)
    v = w[ids2.long()]                              # [b, L, d]
    sl = ins.get("SeqLen", [None])[0]
    if sl is not None:
        mask = (torch.arange(ids2.shape[1], device=w.device)[None, :]
                < sl.reshape(-1, 1)).to(w.dtype)
        v = v * mask[..., None]
    return {"Out": [v.sum(1)]}


def _fusion_rnn(ctx, ins, attrs, cell):
    """fusion_gru / fusion_lstm: the input projection, then the port's
    gru / lstm lowering (ops/sequence_ops.py) over it."""
    x = ins["X"][0]
    proj = torch.einsum("btf,fk->btk", x, ins["WeightX"][0])
    b = ins.get("Bias", [None])[0]
    sub_ins = {"Input": [proj], "Weight": [ins["WeightH"][0]], "Bias": [b]}
    for slot in ("SeqLen", "H0") + (("C0",) if cell == "lstm" else ()):
        if slot in ins:
            sub_ins[slot] = ins[slot]
    out = get_op(cell).lower(ctx, sub_ins, dict(attrs))
    hidden = out.get("Hidden", out.get("Out"))
    res = {"Hidden": hidden, "XX": [proj]}
    if cell == "lstm":
        res["Cell"] = out.get("Cell", hidden)
    return res


@register("fusion_gru")
def _fusion_gru(ctx, ins, attrs):
    return _fusion_rnn(ctx, ins, attrs, "gru")


@register("fusion_lstm")
def _fusion_lstm(ctx, ins, attrs):
    return _fusion_rnn(ctx, ins, attrs, "lstm")


@register("fusion_repeated_fc_relu")
def _fusion_repeated_fc_relu(ctx, ins, attrs):
    x = ins["X"][0]
    for w, b in zip(ins["W"], ins["Bias"]):
        x = _max(x @ w + b.reshape(-1), 0.0)
    return {"Out": [x], "ReluOut": [x]}


@register("fusion_squared_mat_sub")
def _fusion_squared_mat_sub(ctx, ins, attrs):
    """(x @ y)^2 - x^2 @ y^2, scaled (the pairwise-interaction trick of a
    factorization machine)."""
    x, y = ins["X"][0], ins["Y"][0]
    scalar = attrs.get("scalar", 1.0)
    xy = x @ y
    sq = (x * x) @ (y * y)
    return {"Out": [scalar * (xy * xy - sq)], "SquaredXY": [xy * xy],
            "SquaredX": [x * x], "SquaredY": [y * y]}


@register("fusion_seqconv_eltadd_relu")
def _fusion_seqconv_eltadd_relu(ctx, ins, attrs):
    sub = get_op("sequence_conv").lower(
        ctx, {"X": ins["X"], "Filter": ins["Filter"],
              **({"SeqLen": ins["SeqLen"]} if "SeqLen" in ins else {})},
        {"context_length": attrs.get("contextLength",
                                     attrs.get("context_length", 1)),
         "context_start": attrs.get("contextStart",
                                    attrs.get("context_start", 0))})
    out = _max(sub["Out"][0] + ins["Bias"][0].reshape(-1), 0.0)
    return {"Out": [out], "ColMat": [out]}


@register("fusion_seqexpand_concat_fc")
def _fusion_seqexpand_concat_fc(ctx, ins, attrs):
    """X[1:] broadcast along the time of X[0], the features concatenated,
    one fc."""
    xs = ins["X"]
    base = xs[0]                                    # [b, T, f0]
    t = base.shape[1]
    feats = [base] + [x[:, None, :].expand(x.shape[0], t, x.shape[-1])
                      for x in xs[1:]]
    out = torch.einsum("btf,fk->btk", torch.cat(feats, dim=-1),
                       ins["FCWeight"][0])
    if ins.get("FCBias", [None])[0] is not None:
        out = out + ins["FCBias"][0].reshape(-1)
    act = attrs.get("fc_activation", "identity")
    if act == "relu":
        out = _max(out, 0.0)
    elif act == "tanh":
        out = torch.tanh(out)
    return {"Out": [out], "FCOut": [out]}


@register("fusion_seqpool_concat")
def _fusion_seqpool_concat(ctx, ins, attrs):
    pools = []
    ptype = attrs.get("pooltype", "SUM")
    lens = ins.get("SeqLens", [None] * len(ins["X"]))
    for i, x in enumerate(ins["X"]):
        sub_ins = {"X": [x]}
        if lens and i < len(lens) and lens[i] is not None:
            sub_ins["SeqLen"] = [lens[i]]
        pools.append(get_op("sequence_pool").lower(
            ctx, sub_ins, {"pool_type": ptype})["Out"][0])
    return {"Out": [torch.cat(pools, dim=-1)]}


@register("fusion_seqpool_cvm_concat")
def _fusion_seqpool_cvm_concat(ctx, ins, attrs):
    """As fusion_seqpool_concat: the CVM columns are kept, as the
    reference keeps them."""
    return {"Out": _fusion_seqpool_concat(ctx, ins, attrs)["Out"]}


@register("inplace_abn")
def _inplace_abn(ctx, ins, attrs):
    """batch_norm (the port's lowering: its running statistics' next
    values in MeanOut / VarianceOut, the batch statistics in f32), then
    the activation."""
    out = get_op("batch_norm").lower(ctx, ins, dict(attrs))
    act = attrs.get("activation", "")
    y = out["Y"][0]
    if act == "leaky_relu":
        y = torch.where(y > 0, y, y * attrs.get("alpha", 0.01))
    elif act == "elu":
        a = attrs.get("alpha", 1.0)
        y = torch.where(y > 0, y, a * (torch.exp(y) - 1))
    out["Y"] = [y]
    return out


# ---------------------------------------------------------------------------
# quantize/dequantize (pure, non-fused variants)
# ---------------------------------------------------------------------------

def _quantize(x, scale, qmax):
    return _clip(torch.round(x / _max(scale, 1e-12) * qmax), -qmax, qmax)


@register("fake_quantize_abs_max")
def _fake_quantize_abs_max(ctx, ins, attrs):
    x = ins["X"][0]
    qmax = float(2 ** (attrs.get("bit_length", 8) - 1) - 1)
    scale = torch.abs(x).amax()
    return {"Out": [_quantize(x, scale, qmax)],
            "OutScale": [scale.reshape(1)]}


@register("fake_channel_wise_quantize_abs_max")
def _fake_cw_quantize_abs_max(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("quant_axis", 0)
    qmax = float(2 ** (attrs.get("bit_length", 8) - 1) - 1)
    red = tuple(i for i in range(x.dim()) if i != axis)
    scale = torch.abs(x).amax(dim=red)
    shape = [1] * x.dim()
    shape[axis] = -1
    return {"Out": [_quantize(x, scale.reshape(shape), qmax)],
            "OutScale": [scale]}


@register("fake_dequantize_max_abs")
def _fake_dequantize_max_abs(ctx, ins, attrs):
    x, scale = ins["X"][0], ins["Scale"][0]
    max_range = attrs.get("max_range", 127.0)
    return {"Out": [x.float() * scale.reshape(-1)[0] / max_range]}


@register("fake_channel_wise_dequantize_max_abs")
def _fake_cw_dequantize_max_abs(ctx, ins, attrs):
    x = ins["X"][0]
    scales = ins["Scales"]
    bits = attrs.get("quant_bits", [8])
    shape = [1] * x.dim()
    shape[attrs.get("quant_axis", 0)] = -1
    out = x.float() * scales[0].reshape(shape) / float(2 ** (bits[0] - 1) - 1)
    if len(scales) > 1 and scales[1] is not None:
        out = out * scales[1].reshape(-1)[0] / float(2 ** (bits[1] - 1) - 1)
    return {"Out": [out]}


@register("fake_quantize_range_abs_max",
          stateful_outputs=("OutScales", "OutScale"))
def _fake_quantize_range_abs_max(ctx, ins, attrs):
    """fake_quantize_op.cc:236 FindRangeAbsMaxFunctor: a window_size ring
    of per-batch abs-max scales; the scale is the max over the window.
    InScales carries the ring across steps (slot iter % window holds this
    batch's value); Iter is the step counter tensor."""
    x = ins["X"][0]
    it = ins.get("Iter", [None])[0]
    scales = ins.get("InScales", [None])[0]
    window = attrs.get("window_size", 10000)
    qmax = float(2 ** (attrs.get("bit_length", 8) - 1) - 1)
    cur = torch.abs(x).amax().float()
    new_scales = None
    if attrs.get("is_test", False) and scales is not None:
        scale = scales.reshape(-1).amax()
        new_scales = scales.reshape(-1)  # eval must not clobber the window
    elif it is not None and scales is not None \
            and scales.numel() == window:
        idx = torch.remainder(it.reshape(-1)[0].to(torch.int32), window)
        slots = torch.arange(window, device=x.device)
        new_scales = torch.where(slots == idx, cur.to(scales.dtype),
                                 scales.reshape(-1))
        scale = new_scales.amax()
    else:
        scale = cur
    res = {"Out": [_quantize(x, scale, qmax)],
           "OutScale": [scale.reshape(1)]}
    if it is not None:
        if new_scales is None:
            slots = torch.arange(window, device=x.device)
            new_scales = torch.where(slots == 0, scale,
                                     torch.zeros((), device=x.device))
        res["OutScales"] = [new_scales.to(
            scales.dtype if scales is not None else x.dtype)]
    return res


@register("moving_average_abs_max_scale",
          stateful_outputs=("OutState", "OutAccum"))
def _moving_average_abs_max_scale(ctx, ins, attrs):
    x = ins["X"][0]
    state = ins.get("InState", [None])[0]
    accum = ins.get("InAccum", [None])[0]
    rate = attrs.get("moving_rate", 0.9)
    cur = torch.abs(x).amax()
    if state is not None and accum is not None:
        new_state = state * rate + 1.0
        new_accum = accum * rate + cur
        return {"Out": [x], "OutScale": [(new_accum / new_state).reshape(1)],
                "OutState": [new_state], "OutAccum": [new_accum]}
    return {"Out": [x], "OutScale": [cur.reshape(1)]}


# ---------------------------------------------------------------------------
# random / tensor creation
# ---------------------------------------------------------------------------

@register("bernoulli", is_random=True)
def _bernoulli(ctx, ins, attrs):
    x = ins["X"][0]
    u = _uniform01(_random_bits(ctx, attrs, x.shape, 0))
    return {"Out": [(u < x).to(x.dtype)]}


@register("randperm", is_random=True)
def _randperm(ctx, ins, attrs):
    dtype = _canonical(attrs.get("dtype", "int64"))
    return {"Out": [_permutation(ctx, attrs, attrs["n"], ctx.device)
                    .to(dtype)]}


@register("empty")
def _empty(ctx, ins, attrs):
    shape = tuple(attrs.get("shape", [1]))
    return {"Out": [torch.zeros(shape, device=ctx.device,
                                dtype=_canonical(attrs.get("dtype",
                                                           "float32")))]}


@register("fill")
def _fill(ctx, ins, attrs):
    shape = tuple(attrs.get("shape", [1]))
    dtype = _canonical(attrs.get("dtype", "float32"))
    # the values cast on the host first, as the reference's np.asarray
    values = torch.as_tensor(np.asarray(attrs.get("value", [0.0]))
                             .reshape(-1)).to(dtype).tolist()
    return {"Out": [_fills(values, dtype, ctx.device).reshape(shape)]}


@register("allclose", nondiff_slots=("Input", "Other"))
def _allclose(ctx, ins, attrs):
    a, b = ins["Input"][0], ins["Other"][0]
    out = torch.isclose(a, b, rtol=float(attrs.get("rtol", 1e-5)),
                        atol=float(attrs.get("atol", 1e-8)),
                        equal_nan=bool(attrs.get("equal_nan", False)))
    return {"Out": [out.all().reshape(())]}


def _batch_size_like_shape(ins, attrs):
    shape = list(attrs.get("shape", [1]))
    shape[attrs.get("output_dim_idx", 0)] = \
        ins["Input"][0].shape[attrs.get("input_dim_idx", 0)]
    return tuple(shape)


@register("uniform_random_batch_size_like", is_random=True,
          nondiff_slots=("Input",))
def _uniform_random_batch_size_like(ctx, ins, attrs):
    shape = _batch_size_like_shape(ins, attrs)
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    u = _uniform01(_random_bits(ctx, attrs, shape, 0))
    return {"Out": [(u * (hi - lo) + lo).to(
        _canonical(attrs.get("dtype", "float32")))]}


@register("gaussian_random_batch_size_like", is_random=True,
          nondiff_slots=("Input",))
def _gaussian_random_batch_size_like(ctx, ins, attrs):
    """Box-Muller over two uniform streams of the op's key, as the port's
    gaussian_random."""
    shape = _batch_size_like_shape(ins, attrs)
    u1 = 1.0 - _uniform01(_random_bits(ctx, attrs, shape, 0))   # (0, 1]
    u2 = _uniform01(_random_bits(ctx, attrs, shape, 1))
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2 * torch.pi) * u2)
    out = z * attrs.get("std", 1.0) + attrs.get("mean", 0.0)
    return {"Out": [out.to(_canonical(attrs.get("dtype", "float32")))]}


# ---------------------------------------------------------------------------
# control-flow helpers / host interop
# ---------------------------------------------------------------------------

def _print(ctx, ins, attrs):
    """print_op.cc: identity, printing `message` and the values on the
    host (an eager step only)."""
    x = ins["In"][0] if "In" in ins else ins["X"][0]
    if not ctx.is_eval_shape \
            and attrs.get("print_phase", "both") != "backward":
        _not_capturing(ctx, "print")
        print(attrs.get("message", "") + str(x.detach().cpu().numpy()),
              flush=True)
    return {"Out": [x]}


def _print_vjp(ctx, ins, attrs, diff, out_slots):
    """print's own pullback: the identity. The values are printed from the
    plain tensors, outside torch.func (whose wrapped tensors the host
    cannot read)."""
    outs = _print(ctx, ins, attrs)
    return outs, lambda cts: tuple(cts[0] for _ in diff)


register("print", vjp=_print_vjp, host_read=True)(_print)

_PY_FUNCS = {}


def register_py_func(fid, fn):
    """The reference's global function table: `py_func` ops call `fn` by
    its id."""
    _PY_FUNCS[int(fid)] = fn


def _py_func(ctx, ins, attrs):
    """py_func_op.cc: a Python callable on the inputs' host values (an
    eager step only); the outputs come back to the inputs' device, as
    `out_dtypes` when `out_shapes` is given."""
    fn = _PY_FUNCS[int(attrs["forward_callable_id"])]
    xs = ins["X"]
    device = xs[0].device if xs else ctx.device
    out_shapes = attrs.get("out_shapes", None)
    out_dtypes = attrs.get("out_dtypes", ["float32"])
    if ctx.is_eval_shape and out_shapes is not None:
        return {"Out": [torch.empty(tuple(s), dtype=_canonical(d),
                                    device=device)
                        for s, d in zip(out_shapes, out_dtypes)]}
    _not_capturing(ctx, "py_func")
    res = fn(*[x.detach().cpu().numpy() for x in xs])
    res = res if isinstance(res, (list, tuple)) else (res,)
    if out_shapes is None:
        return {"Out": [torch.as_tensor(np.asarray(o)).to(device)
                        for o in res]}
    return {"Out": [torch.as_tensor(np.asarray(v)).to(
        device=device, dtype=_canonical(d))
        for v, d in zip(res, out_dtypes)]}


def _py_func_vjp(ctx, ins, attrs, diff, out_slots):
    """py_func runs outside torch.func (the host cannot read its wrapped
    tensors) and has no gradient, as the reference's pure_callback has
    none."""
    def pullback(cts):
        raise errors.Unimplemented(
            "py_func has no gradient (nor has the reference's "
            "jax.pure_callback)", op="py_func")
    return _py_func(ctx, ins, attrs), pullback


register("py_func", vjp=_py_func_vjp, host_read=True)(_py_func)


@register("coalesce_tensor")
def _coalesce_tensor(ctx, ins, attrs):
    """coalesce_tensor_op.cc: the inputs flattened into one buffer, and a
    view of it for each input."""
    xs = ins["Input"]
    fused = torch.cat([x.reshape(-1) for x in xs])
    outs, off = [], 0
    for x in xs:
        n = x.numel()
        outs.append(fused[off:off + n].reshape(x.shape))
        off += n
    return {"Output": outs, "FusedOutput": [fused]}


def _mask_index(ins, n):
    """Mask's scalar as an index into n choices, clamped as jax's gather
    clamps."""
    m = ins["Mask"][0].reshape(-1)[:1].long()
    return torch.where(m < 0, m + n, m).clamp(0, n - 1)


@register("select_input", nondiff_slots=("Mask",))
def _select_input(ctx, ins, attrs):
    """select_input_op.cc: one of the N inputs, picked by a scalar
    mask."""
    xs = ins["X"]
    stacked = torch.stack(xs)
    return {"Out": [stacked[_mask_index(ins, len(xs))][0]]}


@register("select_output", nondiff_slots=("Mask",))
def _select_output(ctx, ins, attrs):
    """select_output_op.cc: the input routed to the branch the mask names;
    the other outputs are zero (static shapes: consumers gate on the same
    mask)."""
    x = ins["X"][0]
    mask = ins["Mask"][0].reshape(-1)[0].to(torch.int32)
    n = attrs.get("num_outputs", 2)
    return {"Out": [torch.where(mask == i, x, torch.zeros_like(x))
                    for i in range(n)]}


# ---------------------------------------------------------------------------
# optimizer tail
# ---------------------------------------------------------------------------

def _prox(prox, lr, l1, l2):
    if l1 > 0:
        prox = torch.sign(prox) * _max(torch.abs(prox) - lr * l1, 0.0)
    return prox / (1.0 + lr * l2)


@register("proximal_gd", stateful_outputs=("ParamOut",),
          nondiff_slots=("Param", "Grad", "LearningRate"))
def _proximal_gd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0].reshape(())
    return {"ParamOut": [_prox(p - lr * g, lr, attrs.get("l1", 0.0),
                               attrs.get("l2", 0.0))]}


@register("proximal_adagrad", stateful_outputs=("ParamOut", "MomentOut"),
          nondiff_slots=("Param", "Grad", "Moment", "LearningRate"))
def _proximal_adagrad(ctx, ins, attrs):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = ins["LearningRate"][0].reshape(())
    m2 = m + g * g
    alr = lr / torch.sqrt(m2 + 1e-10)
    return {"ParamOut": [_prox(p - alr * g, alr, attrs.get("l1", 0.0),
                               attrs.get("l2", 0.0))],
            "MomentOut": [m2]}


@register("dgc_clip_by_norm", nondiff_slots=("X", "current_step"))
def _dgc_clip_by_norm(ctx, ins, attrs):
    """The gradient clipped to `max_norm` from `rampup_begin_step` on,
    passed through before it."""
    x = ins["X"][0]
    step = ins.get("current_step", [None])[0]
    step = torch.zeros((), device=x.device) if step is None \
        else step.reshape(())
    max_norm = attrs.get("max_norm", 1.0)
    norm = torch.sqrt(torch.sum(x * x))
    factor = torch.minimum(_const(norm, 1.0), max_norm / _max(norm, 1e-12))
    out = torch.where(step >= attrs.get("rampup_begin_step", 0.0),
                      x * factor, x)
    return {"Out": [out]}


def fma(a, x, b):
    """a * x + b computed in f64, then rounded to x's dtype: the product
    of two f32 values is exact in f64, so only the sum and the final
    cast round, the same bits on any device. XLA computes the
    reference's `m * u + g` as a fused multiply-add, rounded once; the
    two agree except where the f64 sum lands on a halfway point of f32."""
    a = float(np.float32(a)) if x.dtype == torch.float32 else float(a)
    return (x.double() * a + b.double()).to(x.dtype)


def dgc_sparsity(step, attrs):
    """The sparsity s of `step` (an f32 [] tensor): the schedule's segment
    ((step - begin) / interval), truncated toward zero and clipped."""
    sched = [float(s) for s in attrs.get("sparsity", [0.999])]
    nseg = len(sched)
    begin = float(attrs.get("rampup_begin_step", 0.0))
    interval = max(float(attrs.get("rampup_step", 1.0)) / nseg, 1.0)
    idx = torch.clamp(((step - begin) / interval).to(torch.int32), 0,
                      nseg - 1)
    return _pick(_fills(sched, torch.float32, step.device), idx)


@register("dgc",
          stateful_outputs=("UOut", "VOut"),
          nondiff_slots=("U", "V", "Grad", "current_step"))
def _dgc(ctx, ins, attrs):
    """dgc_op.h (Lin et al., Deep Gradient Compression): u = m u + g,
    v += u; the elements of |v| at or above the sparsity's threshold are
    EncodeGrad and are reset in u and v (momentum factor masking), the
    rest accumulate. The threshold is the `pos`-th of the sorted strided
    sample of |v| (a ceiling stride over at most 4,096 elements, so the
    sample spans the tensor), pos = s * n_sample truncated. Before
    rampup_begin_step the gradient passes through and v is zeroed."""
    u, v, g = ins["U"][0], ins["V"][0], ins["Grad"][0]
    step = ins["current_step"][0].reshape(()).float()
    m = attrs.get("m", 0.9)
    s = dgc_sparsity(step, attrs)
    u2 = fma(m, u, g)
    v2 = v + u2
    flat = torch.abs(v2.reshape(-1))
    n = flat.numel()
    stride = -(-n // min(n, 4096))
    sample = torch.sort(flat[::stride]).values
    n_sample = sample.numel()
    pos = torch.clamp((s * n_sample).to(torch.int32), 0, n_sample - 1)
    thr = _pick(sample, pos)
    keep = (torch.abs(v2) >= thr).to(v2.dtype)
    use_dgc = step >= float(attrs.get("rampup_begin_step", 0.0))
    encoded = torch.where(use_dgc, v2 * keep, g)
    u_out = torch.where(use_dgc, u2 * (1.0 - keep), u2)
    v_out = torch.where(use_dgc, v2 * (1.0 - keep), torch.zeros_like(v2))
    return {"UOut": [u_out], "VOut": [v_out], "EncodeGrad": [encoded]}


@register("dgc_momentum",
          stateful_outputs=("ParamOut", "VelocityOut"),
          nondiff_slots=("Param", "Grad", "Velocity", "LearningRate",
                         "current_step"))
def _dgc_momentum(ctx, ins, attrs):
    """dgc_momentum_op.h:44: momentum before rampup_begin_step; SGD from it
    on, with the velocity frozen (dgc has folded the momentum into
    EncodeGrad)."""
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    lr = ins["LearningRate"][0].reshape(())
    mu = attrs.get("mu", 0.9)
    v2 = mu * v + g
    if attrs.get("use_nesterov", False):
        p_mom = p - lr * (g + mu * v2)
    else:
        p_mom = p - lr * v2
    step_in = ins.get("current_step")
    if step_in:
        step = step_in[0].reshape(()).float()
        in_dgc = step >= float(attrs.get("rampup_begin_step", 0.0))
        p2 = torch.where(in_dgc, p - lr * g, p_mom)      # sgd branch
        v_out = torch.where(in_dgc, v, v2)               # velocity frozen
    else:  # no step input: plain momentum (legacy call sites)
        p2, v_out = p_mom, v2
    return {"ParamOut": [p2], "VelocityOut": [v_out]}


# ---------------------------------------------------------------------------
# metric tail
# ---------------------------------------------------------------------------

@register("mean_iou", nondiff_slots=("Predictions", "Labels"))
def _mean_iou(ctx, ins, attrs):
    pred = ins["Predictions"][0].reshape(-1).long()
    label = ins["Labels"][0].reshape(-1).long()
    n = attrs["num_classes"]
    ones = torch.ones_like(pred, dtype=torch.int32)
    cm = torch.zeros((n * n,), dtype=torch.int32, device=pred.device) \
        .index_put((label * n + pred,), ones, accumulate=True).reshape(n, n)
    diag = torch.diagonal(cm)
    inter = diag.float()
    union = (cm.sum(0) + cm.sum(1)).float() - inter
    valid = union > 0
    iou = torch.where(valid, inter / _max(union, 1.0),
                      torch.zeros((), device=pred.device))
    mean = iou.sum() / torch.clamp(valid.sum(), min=1)
    return {"OutMeanIou": [mean.reshape(())],
            "OutWrong": [(cm.sum(1) - diag).to(torch.int32)],
            "OutCorrect": [diag.to(torch.int32)]}


@register("positive_negative_pair",
          nondiff_slots=("Score", "Label", "QueryID"))
def _positive_negative_pair(ctx, ins, attrs):
    """positive_negative_pair_op.cc: within each query, the score-ordered
    pairs that agree / disagree with the label order."""
    s = ins["Score"][0].reshape(-1)
    lab = ins["Label"][0].reshape(-1)
    q = ins["QueryID"][0].reshape(-1)
    considered = (q[:, None] == q[None, :]) & (lab[:, None] > lab[None, :])
    si, sj = s[:, None], s[None, :]

    def count(c):
        return (considered & c).sum().float().reshape(1)
    return {"PositivePair": [count(si > sj)], "NegativePair": [count(si < sj)],
            "NeutralPair": [count(si == sj)]}


# chunk_eval's tag roles per scheme (chunk_eval_op.h:124-150): a label
# encodes chunk_type * num_tag_types + tag; type == num_chunk_types is "O"
_CHUNK_SCHEMES = {
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def chunk_counts(inf, lab, lens, num_chunk_types, scheme, excluded=()):
    """(inferred chunks, label chunks, correct chunks) of numpy tag
    sequences [b, T] (GetSegments of chunk_eval_op.h:41-87, each row cut
    to its length)."""
    try:
        n_tag, t_b, t_i, t_e, t_s = _CHUNK_SCHEMES[scheme]
    except KeyError:
        raise ValueError(f"Unknown chunk scheme {scheme!r}")
    other = num_chunk_types
    excluded = frozenset(excluded or ())

    def _chunk_end(ptag, ptype, tag, typ):
        if ptype == other:
            return False
        if typ == other or typ != ptype:
            return True
        if ptag in (t_b, t_i) and ptag >= 0:
            return tag in (t_b, t_s) and tag >= 0
        return ptag in (t_e, t_s) and ptag >= 0

    def _chunk_begin(ptag, ptype, tag, typ):
        if ptype == other:
            return typ != other
        if typ == other:
            return False
        if typ != ptype:
            return True
        if tag in (t_b, t_s) and tag >= 0:
            return True
        if tag in (t_i, t_e) and tag >= 0:
            return ptag in (t_e, t_s) and ptag >= 0
        return False

    def segments(seq):
        out, start, in_chunk = set(), 0, False
        tag, typ = -1, other
        for i, t in enumerate(seq):
            ptag, ptype = tag, typ
            tag, typ = int(t) % n_tag, int(t) // n_tag
            if in_chunk and _chunk_end(ptag, ptype, tag, typ):
                out.add((start, i - 1, ptype))
                in_chunk = False
            if _chunk_begin(ptag, ptype, tag, typ):
                start, in_chunk = i, True
        if in_chunk:
            out.add((start, len(seq) - 1, typ))
        return {s for s in out if s[2] not in excluded}

    ncorr = ninf = nlab = 0
    for bi in range(inf.shape[0]):
        L = int(lens[bi])
        ci, cl = segments(inf[bi][:L]), segments(lab[bi][:L])
        ncorr += len(ci & cl)
        ninf += len(ci)
        nlab += len(cl)
    return ninf, nlab, ncorr


@register("chunk_eval", nondiff_slots=("Inference", "Label", "SeqLength"),
          host_read=True)
def _chunk_eval(ctx, ins, attrs):
    """chunk_eval_op.cc (IOB / IOE / IOBES / plain): chunk precision,
    recall and F1, counted on the host (an eager step only), as the
    reference's host callback counts them."""
    inf, lab = ins["Inference"][0], ins["Label"][0]
    sl = ins.get("SeqLength", [None])[0]
    dev = lab.device
    if attrs.get("chunk_scheme", "IOB") not in _CHUNK_SCHEMES:
        raise ValueError(f"Unknown chunk scheme {attrs['chunk_scheme']!r}")
    if ctx.is_eval_shape:
        counts = (0, 0, 0)
    else:
        _not_capturing(ctx, "chunk_eval")
        lab_np = lab.cpu().numpy()
        b = lab_np.shape[0] if lab_np.ndim > 1 else 1
        inf2 = inf.cpu().numpy().reshape(lab_np.shape).reshape(b, -1)
        lab2 = lab_np.reshape(b, -1)
        lens = sl.cpu().numpy().reshape(-1) if sl is not None \
            else np.full(b, inf2.shape[1])
        counts = chunk_counts(inf2, lab2, lens, attrs["num_chunk_types"],
                              attrs.get("chunk_scheme", "IOB"),
                              attrs.get("excluded_chunk_types", ()))
    ninf, nlab, ncorr = counts
    p = ncorr / ninf if ninf else 0.0
    r = ncorr / nlab if nlab else 0.0
    f1 = 2 * p * r / (p + r) if ncorr else 0.0

    def scalar(v, dtype):
        return torch.full((1,), v, dtype=dtype, device=dev)
    return {"Precision": [scalar(p, torch.float32)],
            "Recall": [scalar(r, torch.float32)],
            "F1-Score": [scalar(f1, torch.float32)],
            "NumInferChunks": [scalar(ninf, torch.int32)],
            "NumLabelChunks": [scalar(nlab, torch.int32)],
            "NumCorrectChunks": [scalar(ncorr, torch.int32)]}


@register("teacher_student_sigmoid_loss")
def _teacher_student_sigmoid_loss(ctx, ins, attrs):
    """teacher_student_sigmoid_loss_op.cc: the CTR distillation loss; a
    label < 0 encodes a teacher score -label - 1, else the plain log
    loss."""
    x = ins["X"][0].reshape(-1)
    label = ins["Label"][0].reshape(-1).to(x.dtype)
    xc = _clip(x, attrs.get("soft_max_lower_bound", -15.0),
               attrs.get("soft_max_up_bound", 15.0))
    sig = torch.sigmoid(xc)
    teacher = -label - 1.0
    ce_student = -label * torch.log(sig + 1e-9) \
        - (1 - label) * torch.log(1 - sig + 1e-9)
    ce_teacher = -teacher * torch.log(sig + 1e-9) \
        - (1 - teacher) * torch.log(1 - sig + 1e-9)
    out = torch.where(label < 0, ce_teacher, ce_student)
    return {"Y": [out.reshape(-1, 1)]}


# ---------------------------------------------------------------------------
# lstmp (LSTM with recurrent projection)
# ---------------------------------------------------------------------------

@register("lstmp")
def _lstmp(ctx, ins, attrs):
    """lstmp_op.cc: an LSTM whose hidden state is projected to a lower
    width before the recurrence (Sak et al.). Input projected [b, T,
    4d]; gates {input, forget, candidate, output}."""
    x = ins["Input"][0]
    w = ins["Weight"][0]            # [p, 4d] recurrent weight (from proj)
    proj_w = ins["ProjWeight"][0]   # [d, p]
    b = ins.get("Bias", [None])[0]
    bsz, _, four_d = x.shape
    d = four_d // 4
    h = x.new_zeros((bsz, proj_w.shape[1]))
    c = x.new_zeros((bsz, d))
    hs, cs = [], []
    for xt in x.unbind(1):
        gates = xt + h @ w
        if b is not None:
            gates = gates + b.reshape(-1)[:four_d]
        i, f, cand, o = torch.split(gates, d, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(cand)
        h = (torch.sigmoid(o) * torch.tanh(c)) @ proj_w
        hs.append(h)
        cs.append(c)
    return {"Projection": [torch.stack(hs, 1)], "Cell": [torch.stack(cs, 1)]}


# ---------------------------------------------------------------------------
# op-name aliases for reference registration names
# ---------------------------------------------------------------------------

def _alias(new, old, slot_map=None):
    target = get_op(old)
    # nondiff bookkeeping runs on the aliased op's OWN slot names: map the
    # target's nondiff slots back through the (v1 name -> v2 name) slot_map
    inv = {v: k for k, v in (slot_map or {}).items()}
    nondiff = tuple(inv.get(s, s) for s in target.nondiff_slots)

    @register(new, nondiff_slots=nondiff, infer=target.infer,
              stateful_outputs=tuple(target.stateful_outputs))
    def _fwd(ctx, ins, attrs, _t=target, _m=slot_map):
        if _m:
            ins = {(_m.get(k, k)): v for k, v in ins.items()}
        return _t.lower(ctx, ins, attrs)
    return _fwd


_alias("write_to_array", "array_write")
_alias("read_from_array", "array_read")
# v1 feeds the broadcast target via slot 'target_tensor' (expand_as_op.cc:28)
_alias("expand_as", "expand_as_v2", slot_map={"target_tensor": "Y"})
_alias("multiclass_nms2", "multiclass_nms")
