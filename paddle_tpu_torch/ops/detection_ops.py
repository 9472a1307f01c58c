"""The detection ops (counterpart of paddle_tpu/ops/detection_ops.py):
priors and anchors, box coding, IoU, clipping, YOLO's box and loss, ROI
pooling, the NMS family, the RPN / FPN proposal ops and the SSD training
ops, every one of the reference file's 21 types in its section order,
with its flags. Outputs are static: a padded block plus a count tensor
where the reference's op emits LoD. Each is differentiated by the generic
`__vjp__` (`torch.func.vjp` over the lowering).

The reference loops over images (and NMS over classes) in Python; here
those loops are batched, so no lowering reads a device value on the host
and a step that holds them is captured whole:

* Greedy NMS (`_nms_rows`) is one loop over the <= top_k candidates on a
  `[rows, k]` keep mask, a row per (image, class), with the `eta` decay
  of the threshold carried per row. `multiclass_nms`, `generate_proposals`
  and `retinanet_detection_output` all run it.
* `bipartite_match` (`_bipartite_rows`) is one loop of min(G, P) rounds
  over `[B, G, P]`: each round takes the first maximum of every
  instance's flattened matrix, in row-major order, as the reference's
  `jnp.argmax` does.
* Every sort the reference does with the stable `jnp.argsort` is
  `torch.argsort(..., stable=True)`, so tied scores keep their input
  order: NMS order, the global keep_top_k cut, the hard-negative ranks.
* Scatters with a `mode="drop"` target write to one extra dump row that
  is sliced off (`_scatter_rows`); their live targets are unique.
* Gathers that a gradient passes through are advanced indexing, whose
  pullback is `index_put(accumulate=True)` (on CUDA the sort-based
  kernel, no atomics), not `torch.gather` (atomic adds).
* Each op keeps its reference's box convention: `+1` widths in pixel
  space (`generate_proposals`, `box_decoder_and_assign`, un-normalized
  IoU), none in normalized space, and the `log(1000 / 16)` delta clip.
"""
from __future__ import annotations

import math

import torch

from .extra_ops import _max
from .math_ops import _clip, _const
from .registry import register

_LOG_1000_16 = float(math.log(1000.0 / 16.0))


def _lowest(x):
    return torch.finfo(x.dtype).min


def _argsort_desc(x, dim=-1):
    """jnp.argsort(-x): stable, ties in input order."""
    return torch.argsort(-x, dim=dim, stable=True)


def _minimum(x, v):
    """jnp.minimum(x, v) for a scalar or tensor v."""
    if not isinstance(v, torch.Tensor):
        v = _const(x, v)
    return torch.minimum(x, v)


def _rows(n, device):
    return torch.arange(n, device=device)[:, None]


def _vec(values, dtype, device):
    """A constant vector made on the device by fills (a host-to-device
    copy cannot be captured)."""
    return torch.stack([torch.full((), float(v), dtype=dtype, device=device)
                        for v in values])


def _classes(scores, c, background):
    """The classes other than `background` along dim 1 of scores [N, C,
    ...] and their labels [C'] (f32), taken by slices on the device."""
    labels = torch.arange(c, dtype=torch.float32, device=scores.device)
    if 0 <= background < c:
        return (torch.cat([scores[:, :background],
                           scores[:, background + 1:]], 1),
                torch.cat([labels[:background], labels[background + 1:]]))
    return scores, labels


def _scatter_rows(shape, fill, target, values, width):
    """zeros(shape).at[target].set(values, mode="drop") along dim 1 of a
    [B, width, ...] block: targets >= width are dropped (written to a dump
    row that is sliced off)."""
    b = target.shape[0]
    out = torch.full((b, width + 1) + tuple(shape), fill,
                     dtype=values.dtype, device=values.device)
    tgt = torch.clamp(target.long(), max=width)
    out = out.index_put((_rows(b, values.device), tgt), values)
    return out[:, :width]


# ---------------------------------------------------------------------------
# anchors / priors
# ---------------------------------------------------------------------------

def _prior_centers(h, w, step_h, step_w, offset, device):
    cx = (torch.arange(w, dtype=torch.float32, device=device) + offset) \
        * step_w
    cy = (torch.arange(h, dtype=torch.float32, device=device) + offset) \
        * step_h
    return torch.meshgrid(cy, cx, indexing="ij")    # [h, w] each


def _corners(cx, cy, bw, bh, iw, ih):
    return torch.stack([(cx - bw / 2) / iw, (cy - bh / 2) / ih,
                        (cx + bw / 2) / iw, (cy + bh / 2) / ih], dim=-1)


def _with_variances(out, variances, clip):
    if clip:
        out = _clip(out, 0.0, 1.0)
    var = _vec(variances, torch.float32, out.device).expand(out.shape)
    return {"Boxes": [out], "Variances": [var.contiguous()]}


@register("prior_box")
def _prior_box(ctx, ins, attrs):
    feat, img = ins["Input"][0], ins["Image"][0]
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    min_sizes = [float(v) for v in attrs["min_sizes"]]
    max_sizes = [float(v) for v in attrs.get("max_sizes", [])]
    ars = [1.0]
    for ar in attrs.get("aspect_ratios", []):
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(float(ar))
            if attrs.get("flip", False):
                ars.append(1.0 / float(ar))
    step_w = attrs.get("step_w", 0.0) or iw / w
    step_h = attrs.get("step_h", 0.0) or ih / h
    cy, cx = _prior_centers(h, w, step_h, step_w, attrs.get("offset", 0.5),
                            feat.device)
    whs = []
    for ms in min_sizes:
        for ar in ars:                   # the min size at each ratio
            whs.append((ms * math.sqrt(ar), ms / math.sqrt(ar)))
        if max_sizes:                    # one more between min and max
            mx = max_sizes[min_sizes.index(ms)]
            whs.append((math.sqrt(ms * mx), math.sqrt(ms * mx)))
    out = torch.stack([_corners(cx, cy, bw, bh, iw, ih) for bw, bh in whs],
                      dim=2)             # [h, w, priors, 4]
    return _with_variances(out, attrs.get("variances", [0.1, 0.1, 0.2, 0.2]),
                           attrs.get("clip", False))


@register("density_prior_box")
def _density_prior_box(ctx, ins, attrs):
    feat, img = ins["Input"][0], ins["Image"][0]
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    fixed_sizes = [float(v) for v in attrs.get("fixed_sizes", [])]
    fixed_ratios = [float(v) for v in attrs.get("fixed_ratios", [1.0])]
    densities = [int(v) for v in attrs.get("densities", [1])]
    step_w = attrs.get("step_w", 0.0) or iw / w
    step_h = attrs.get("step_h", 0.0) or ih / h
    cy, cx = _prior_centers(h, w, step_h, step_w, attrs.get("offset", 0.5),
                            feat.device)
    step_avg = 0.5 * (step_w + step_h)   # density_prior_box_op.h
    boxes = []
    for size, density in zip(fixed_sizes, densities):
        shift = int(step_avg / density)
        for ratio in fixed_ratios:
            bw = size * math.sqrt(ratio)
            bh = size / math.sqrt(ratio)
            for dy in range(density):
                for dx in range(density):
                    ccx = cx - step_avg / 2.0 + shift / 2.0 + dx * shift
                    ccy = cy - step_avg / 2.0 + shift / 2.0 + dy * shift
                    boxes.append(_corners(ccx, ccy, bw, bh, iw, ih))
    return _with_variances(torch.stack(boxes, dim=2),
                           attrs.get("variances", [0.1, 0.1, 0.2, 0.2]),
                           attrs.get("clip", False))


@register("anchor_generator")
def _anchor_generator(ctx, ins, attrs):
    feat = ins["Input"][0]
    h, w = feat.shape[2], feat.shape[3]
    sizes = [float(v) for v in attrs["anchor_sizes"]]
    ratios = [float(v) for v in attrs["aspect_ratios"]]
    sw, sh = (float(v) for v in attrs["stride"])
    cyg, cxg = _prior_centers(h, w, sh, sw, attrs.get("offset", 0.5),
                              feat.device)
    anchors = []
    for r in ratios:
        for s in sizes:
            bw = s * math.sqrt(1.0 / r)
            bh = s * math.sqrt(r)
            anchors.append(torch.stack(
                [cxg - bw / 2, cyg - bh / 2, cxg + bw / 2, cyg + bh / 2],
                dim=-1))
    out = _with_variances(torch.stack(anchors, dim=2),
                          attrs.get("variances", [0.1, 0.1, 0.2, 0.2]),
                          False)
    return {"Anchors": out["Boxes"], "Variances": out["Variances"]}


# ---------------------------------------------------------------------------
# box arithmetic
# ---------------------------------------------------------------------------

def _box_wh(b, normalized):
    extra = 0.0 if normalized else 1.0
    return b[..., 2] - b[..., 0] + extra, b[..., 3] - b[..., 1] + extra


@register("box_coder")
def _box_coder(ctx, ins, attrs):
    prior = ins["PriorBox"][0]                   # [M, 4]
    pvar = ins.get("PriorBoxVar", [None])[0]
    target = ins["TargetBox"][0]
    code_type = attrs.get("code_type", "encode_center_size")
    normalized = attrs.get("box_normalized", True)
    var_attr = attrs.get("variance", [])
    pw, ph = _box_wh(prior, normalized)
    pcx = prior[..., 0] + pw / 2
    pcy = prior[..., 1] + ph / 2
    if pvar is None and var_attr:
        pvar = _vec(var_attr, torch.float32, prior.device)
    if code_type.startswith("encode"):
        tw, th = _box_wh(target, normalized)     # target [N, 4]
        tcx = (target[..., 0] + target[..., 2]) / 2
        tcy = (target[..., 1] + target[..., 3]) / 2
        dx = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        dy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        dw = torch.log(torch.abs(tw[:, None] / pw[None, :]))
        dh = torch.log(torch.abs(th[:, None] / ph[None, :]))
        out = torch.stack([dx, dy, dw, dh], dim=-1)      # [N, M, 4]
        if pvar is not None:
            out = out / torch.broadcast_to(pvar, out.shape)
        return {"OutputBox": [out]}
    # decode: the deltas [N, M, 4]; `axis` 0 aligns the priors with dim 1,
    # 1 with dim 0
    if target.dim() == 3 and attrs.get("axis", 0) == 1:
        pw, ph, pcx, pcy = pw[:, None], ph[:, None], pcx[:, None], \
            pcy[:, None]
    d = target
    if pvar is not None:
        d = d * torch.broadcast_to(pvar, d.shape)
    cx = d[..., 0] * pw + pcx
    cy = d[..., 1] * ph + pcy
    w = torch.exp(d[..., 2]) * pw
    h = torch.exp(d[..., 3]) * ph
    extra = 0.0 if normalized else 1.0
    return {"OutputBox": [torch.stack([cx - w / 2, cy - h / 2,
                                       cx + w / 2 - extra,
                                       cy + h / 2 - extra], dim=-1)]}


def _iou_matrix(x, y, normalized=True):
    """IoU of every box of x [..., n, 4] with every box of y [..., m, 4]:
    [..., n, m]."""
    extra = 0.0 if normalized else 1.0

    def area(b):
        return (b[..., 2] - b[..., 0] + extra) * (b[..., 3] - b[..., 1]
                                                  + extra)
    ax = area(x)[..., :, None]
    ay = area(y)[..., None, :]
    x1 = torch.maximum(x[..., :, None, 0], y[..., None, :, 0])
    y1 = torch.maximum(x[..., :, None, 1], y[..., None, :, 1])
    x2 = torch.minimum(x[..., :, None, 2], y[..., None, :, 2])
    y2 = torch.minimum(x[..., :, None, 3], y[..., None, :, 3])
    iw = _max(x2 - x1 + extra, 0.0)
    ih = _max(y2 - y1 + extra, 0.0)
    inter = iw * ih
    return inter / _max(ax + ay - inter, 1e-10)


@register("iou_similarity")
def _iou_similarity(ctx, ins, attrs):
    return {"Out": [_iou_matrix(ins["X"][0], ins["Y"][0],
                                attrs.get("box_normalized", True))]}


@register("box_clip")
def _box_clip(ctx, ins, attrs):
    boxes = ins["Input"][0]                      # [N, 4] or [B, N, 4]
    iminfo = ins["ImInfo"][0]                    # [B, 3] (h, w, scale)
    h = iminfo[..., 0] / iminfo[..., 2] - 1.0
    w = iminfo[..., 1] / iminfo[..., 2] - 1.0
    if boxes.dim() == 3:
        h, w = h[:, None], w[:, None]
    x1 = _max(boxes[..., 0], 0.0)
    y1 = _max(boxes[..., 1], 0.0)
    return {"Output": [torch.stack(
        [torch.minimum(x1, w), torch.minimum(y1, h),
         _max(torch.minimum(boxes[..., 2], w), 0.0),
         _max(torch.minimum(boxes[..., 3], h), 0.0)], dim=-1)]}


@register("polygon_box_transform")
def _polygon_box_transform(ctx, ins, attrs):
    """Quad offsets -> coordinates: x channels 4 col - x, y channels
    4 row - x."""
    x = ins["Input"][0]                          # [N, 8, H, W]
    n, c, h, w = x.shape
    col = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, None]
    row = torch.arange(h, dtype=x.dtype, device=x.device)[None, None, :,
                                                          None]
    is_x = (torch.arange(c, device=x.device) % 2 == 0)[None, :, None, None]
    return {"Output": [torch.where(is_x, 4 * col - x, 4 * row - x)]}


@register("yolo_box")
def _yolo_box(ctx, ins, attrs):
    """yolo_box_op.h:29-77."""
    x = ins["X"][0]                              # [N, A*(5+C), H, W]
    imgsize = ins["ImgSize"][0]                  # [N, 2] (h, w)
    anchors = attrs["anchors"]
    class_num = attrs["class_num"]
    conf_thresh = attrs.get("conf_thresh", 0.01)
    downsample = attrs.get("downsample_ratio", 32)
    scale = attrs.get("scale_x_y", 1.0)
    bias = -0.5 * (scale - 1.0)
    n, _, h, w = x.shape
    an_num = len(anchors) // 2
    input_h, input_w = downsample * h, downsample * w
    dev = x.device
    xr = x.reshape(n, an_num, 5 + class_num, h, w)
    img_h = imgsize[:, 0].float()[:, None, None, None]
    img_w = imgsize[:, 1].float()[:, None, None, None]
    grid_x = torch.arange(w, dtype=torch.float32, device=dev)[None, None,
                                                              None, :]
    grid_y = torch.arange(h, dtype=torch.float32, device=dev)[None, None,
                                                              :, None]
    aw = _vec(anchors[0::2], torch.float32, dev)[None, :, None, None]
    ah = _vec(anchors[1::2], torch.float32, dev)[None, :, None, None]
    cx = (grid_x + torch.sigmoid(xr[:, :, 0]) * scale + bias) * img_w / w
    cy = (grid_y + torch.sigmoid(xr[:, :, 1]) * scale + bias) * img_h / h
    bw = torch.exp(xr[:, :, 2]) * aw * img_w / input_w
    bh = torch.exp(xr[:, :, 3]) * ah * img_h / input_h
    conf = torch.sigmoid(xr[:, :, 4])
    on = conf >= conf_thresh
    x1, y1 = cx - bw / 2, cy - bh / 2
    x2, y2 = cx + bw / 2, cy + bh / 2
    if attrs.get("clip_bbox", True):
        x1, y1 = _max(x1, 0.0), _max(y1, 0.0)
        x2 = torch.minimum(x2, img_w - 1)
        y2 = torch.minimum(y2, img_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)        # [N, A, H, W, 4]
    boxes = torch.where(on[..., None], boxes, _const(boxes, 0.0))
    scores = conf[..., None] * torch.sigmoid(
        torch.movedim(xr[:, :, 5:], 2, -1))              # [N, A, H, W, C]
    scores = torch.where(on[..., None], scores, _const(scores, 0.0))
    return {"Boxes": [boxes.reshape(n, an_num * h * w, 4)],
            "Scores": [scores.reshape(n, an_num * h * w, class_num)]}


# ---------------------------------------------------------------------------
# ROI ops
# ---------------------------------------------------------------------------

@register("roi_align")
def _roi_align(ctx, ins, attrs):
    """roi_align_op.h: the average of ns x ns bilinear samples a bin."""
    from .tail_ops import _roi_batch_index
    x = ins["X"][0]                              # [N, C, H, W]
    rois = ins["ROIs"][0]                        # [R, 4]
    ph = attrs.get("pooled_height", 1)
    pw = attrs.get("pooled_width", 1)
    spatial_scale = attrs.get("spatial_scale", 1.0)
    sampling = attrs.get("sampling_ratio", -1)
    n, c, h, w = x.shape
    bids = _roi_batch_index(ins, rois.shape[0], n, x.device).long()
    xmin = rois[:, 0] * spatial_scale
    ymin = rois[:, 1] * spatial_scale
    rw = _max(rois[:, 2] * spatial_scale - xmin, 1.0)
    rh = _max(rois[:, 3] * spatial_scale - ymin, 1.0)
    bin_w, bin_h = rw / pw, rh / ph
    ns = sampling if sampling > 0 else 2

    def sample(py, px, iy, ix):
        y = ymin + py * bin_h + (iy + 0.5) * bin_h / ns
        xx = xmin + px * bin_w + (ix + 0.5) * bin_w / ns
        y = _clip(y, 0.0, h - 1)
        xx = _clip(xx, 0.0, w - 1)
        y0 = torch.floor(y).to(torch.int32)
        x0 = torch.floor(xx).to(torch.int32)
        y1 = torch.clamp(y0 + 1, 0, h - 1).long()
        x1 = torch.clamp(x0 + 1, 0, w - 1).long()
        ly, lx = y - y0, xx - x0
        y0, x0 = y0.long(), x0.long()
        return (x[bids, :, y0, x0] * ((1 - ly) * (1 - lx))[:, None]
                + x[bids, :, y0, x1] * ((1 - ly) * lx)[:, None]
                + x[bids, :, y1, x0] * (ly * (1 - lx))[:, None]
                + x[bids, :, y1, x1] * (ly * lx)[:, None])    # [R, C]

    outs = []
    for py in range(ph):
        row = []
        for px in range(pw):
            acc = 0.0
            for iy in range(ns):
                for ix in range(ns):
                    acc = acc + sample(py, px, iy, ix)
            row.append(acc / (ns * ns))
        outs.append(torch.stack(row, dim=-1))            # [R, C, pw]
    return {"Out": [torch.stack(outs, dim=-2)]}          # [R, C, ph, pw]


@register("roi_pool")
def _roi_pool(ctx, ins, attrs):
    """roi_pool_op.cc: the max over each quantized bin (`amax`: a tie
    splits the gradient, as jnp.max); an empty bin is 0."""
    from .tail_ops import _roi_batch_index
    x, rois = ins["X"][0], ins["ROIs"][0]
    ph = attrs.get("pooled_height", 1)
    pw = attrs.get("pooled_width", 1)
    spatial_scale = attrs.get("spatial_scale", 1.0)
    n, c, h, w = x.shape
    dev = x.device
    bids = _roi_batch_index(ins, rois.shape[0], n, dev).long()

    def edge(col, hi):
        return torch.clamp(torch.round(rois[:, col] * spatial_scale), 0,
                           hi).to(torch.int32)
    x1, y1, x2, y2 = edge(0, w - 1), edge(1, h - 1), edge(2, w - 1), \
        edge(3, h - 1)
    rw = torch.clamp(x2 - x1 + 1, min=1)
    rh = torch.clamp(y2 - y1 + 1, min=1)
    ys = torch.arange(h, device=dev)[None, :]
    xs = torch.arange(w, device=dev)[None, :]
    neg = _lowest(x)
    feat = x[bids]                                       # [R, C, H, W]
    rows = []
    for py in range(ph):
        hstart = y1 + (py * rh) // ph
        hend = y1 + ((py + 1) * rh + ph - 1) // ph
        ymask = (ys >= hstart[:, None]) & (ys < torch.maximum(
            hend, hstart + 1)[:, None])                  # [R, H]
        cols = []
        for px in range(pw):
            wstart = x1 + (px * rw) // pw
            wend = x1 + ((px + 1) * rw + pw - 1) // pw
            xmask = (xs >= wstart[:, None]) & (xs < torch.maximum(
                wend, wstart + 1)[:, None])              # [R, W]
            m = ymask[:, None, :, None] & xmask[:, None, None, :]
            val = torch.amax(torch.where(m, feat, _const(feat, neg)),
                             dim=(2, 3))
            empty = ~(ymask.any(1) & xmask.any(1))
            cols.append(torch.where(empty[:, None], _const(val, 0.0), val))
        rows.append(torch.stack(cols, dim=-1))
    return {"Out": [torch.stack(rows, dim=-2)], "Argmax": [None]}


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

def _nms_rows(boxes, scores, iou_threshold, top_k, normalized, eta=1.0):
    """Greedy NMS of each row's top_k highest-scoring boxes, every row at
    once: boxes [R, M, 4], scores [R, M]. Returns the sorted indices
    [R, k], the sorted scores and the keep mask aligned with them. As the
    reference's NMSFast: candidate i survives iff no box kept before it
    overlaps it above the CURRENT threshold, which, with eta < 1, decays
    by eta after each kept candidate while it is above 0.5."""
    r = scores.shape[0]
    rows = _rows(r, scores.device)
    order = _argsort_desc(scores)[:, :top_k]
    s = scores[rows, order]
    b = boxes[rows, order]                               # [R, k, 4]
    k = b.shape[1]
    iou = _iou_matrix(b, b, normalized).detach()         # [R, k, k]
    col = torch.arange(k, device=scores.device)
    keep = torch.ones((r, k), dtype=torch.bool, device=scores.device)
    thr = torch.full((r,), float(iou_threshold), dtype=s.dtype,
                     device=s.device)
    if eta >= 1.0:
        over_all = (iou > thr[:, None, None]) & (col[:, None] < col[None, :])
    for i in range(k):
        if eta >= 1.0:
            over = over_all[:, :, i] & keep
        else:
            over = (iou[:, :, i] > thr[:, None]) & keep & (col < i)
        kept = ~over.any(1)
        keep = torch.where(col == i, kept[:, None], keep)
        if eta < 1.0:
            thr = torch.where(kept & (thr > 0.5), thr * eta, thr)
    return order, s, keep


def _cut_rows(cat, src, take):
    """The global top `take` rows of each image's [R, 6] (label, score,
    box) block by score (stable), padding rows (label < 0) as [-1, 0 ...];
    with each row's source index (-1 on padding) and the live count."""
    top = _argsort_desc(cat[..., 1])[:, :take]
    rows = _rows(cat.shape[0], cat.device)
    out = cat[rows, top]
    valid = out[..., 0] >= 0
    pad = _vec((-1, 0, 0, 0, 0, 0), out.dtype, out.device)
    out = torch.where(valid[..., None], out, pad)
    index = torch.where(valid, src[rows, top], -1).to(torch.int32)
    return out, valid.sum(-1).to(torch.int32), index


def _class_rows(cls, ok, s, b):
    """[..., k, 6] rows (label or -1, score or lowest, box)."""
    label = torch.where(ok, cls, _const(s, -1.0))
    score = torch.where(ok, s, _const(s, _lowest(s)))
    return torch.cat([label[..., None], score[..., None], b], -1)


@register("multiclass_nms")
def _multiclass_nms(ctx, ins, attrs):
    """multiclass_nms_op.cc, static: per image a [keep_top_k, 6] block
    (label, score, x1, y1, x2, y2) padded with label -1 rows, the live
    count NmsRoisNum, and Index (each row's index into the input boxes,
    -1 on padding). 2-D input ([M, 4] / [C, M]) is one image with a
    scalar count; 3-D input gives the blocks concatenated, [N] counts and
    indices offset by the image's M."""
    bboxes, scores = ins["BBoxes"][0], ins["Scores"][0]
    single = bboxes.dim() == 2
    if single:
        bboxes, scores = bboxes[None], scores[None]
    n, c, m = scores.shape
    nms_top_k = attrs.get("nms_top_k", m)
    nms_top_k = min(int(nms_top_k) if nms_top_k > 0 else m, m)
    keep_top_k = int(attrs.get("keep_top_k", m))
    if keep_top_k <= 0:
        keep_top_k = c * nms_top_k
    sel, labels = _classes(scores, c, attrs.get("background_label", 0))
    cc = sel.shape[1]                                    # [N, C', M]
    dev = scores.device
    order, s, keep = _nms_rows(
        bboxes[:, None].expand(n, cc, m, 4).reshape(n * cc, m, 4),
        sel.reshape(n * cc, m), attrs.get("nms_threshold", 0.3), nms_top_k,
        attrs.get("normalized", True), float(attrs.get("nms_eta", 1.0)))
    k = order.shape[1]
    order, s, keep = (t.reshape(n, cc, k) for t in (order, s, keep))
    ok = keep & (s > attrs.get("score_threshold", 0.0))
    b = bboxes[_rows(n, dev)[:, :, None], order]         # [N, C', k, 4]
    cat = _class_rows(labels.to(s.dtype)[None, :, None], ok, s,
                      b).reshape(n, cc * k, 6)
    src = torch.where(ok, order, -1).reshape(n, cc * k)
    out, count, index = _cut_rows(cat, src, min(keep_top_k, cc * k))
    if single:
        return {"Out": [out[0]], "NmsRoisNum": [count[0]],
                "Index": [index[0][:, None]]}
    index = torch.where(index >= 0,
                        index + (_rows(n, dev) * m).to(torch.int32), -1)
    return {"Out": [out.reshape(-1, 6)], "NmsRoisNum": [count],
            "Index": [index.reshape(-1, 1)]}


# ---------------------------------------------------------------------------
# training-side detection ops
# ---------------------------------------------------------------------------

def _iou_cwh(x1, y1, w1, h1, x2, y2, w2, h2):
    """IoU of center-format boxes; broadcasts."""
    ov_w = torch.minimum(x1 + w1 / 2, x2 + w2 / 2) \
        - torch.maximum(x1 - w1 / 2, x2 - w2 / 2)
    ov_h = torch.minimum(y1 + h1 / 2, y2 + h2 / 2) \
        - torch.maximum(y1 - h1 / 2, y2 - h2 / 2)
    inter = torch.where((ov_w > 0) & (ov_h > 0), ov_w * ov_h,
                        _const(ov_w, 0.0))
    return inter / _max(w1 * h1 + w2 * h2 - inter, 1e-10)


def _sce(x, label):
    """Stable sigmoid cross entropy (yolov3_loss_op.h:30)."""
    return _max(x, 0.0) - x * label + torch.log1p(torch.exp(-torch.abs(x)))


@register("yolov3_loss", nondiff_slots=("GTBox", "GTLabel", "GTScore"))
def _yolov3_loss(ctx, ins, attrs):
    """yolov3_loss_op.h:259 as batched tensor ops: prediction-vs-truth
    IoU as one [N, M, H, W, B] broadcast, each truth's best anchor an
    argmax, the positive cells' writes one scatter (of duplicate cells
    the last truth's, as the reference's sequential scatter). Square
    grids, as the reference kernel."""
    x = ins["X"][0]                              # [N, M*(5+C), H, W]
    gt_box = ins["GTBox"][0].float()             # [N, B, 4] xywh in [0, 1]
    gt_label = ins["GTLabel"][0].to(torch.int32)
    gt_score = ins.get("GTScore", [None])[0]
    anchors = [float(a) for a in attrs["anchors"]]
    mask = [int(v) for v in attrs["anchor_mask"]]
    class_num = int(attrs["class_num"])
    ignore_thresh = float(attrs.get("ignore_thresh", 0.7))
    downsample = int(attrs.get("downsample_ratio", 32))
    label_smooth = bool(attrs.get("use_label_smooth", True))
    scale_xy = float(attrs.get("scale_x_y", 1.0))
    bias_xy = -0.5 * (scale_xy - 1.0)
    n, _, h, w = x.shape
    an_num, m, b = len(anchors) // 2, len(mask), gt_box.shape[1]
    dev = x.device
    input_size = downsample * h
    xr = x.float().reshape(n, m, 5 + class_num, h, w)
    gt_score = torch.ones((n, b), dtype=torch.float32, device=dev) \
        if gt_score is None else gt_score.float()
    gx, gy, gw, gh = gt_box.unbind(-1)
    valid = (gw > 1e-6) & (gh > 1e-6)                    # [N, B]
    if label_smooth:
        sw = min(1.0 / class_num, 1.0 / 40)
        pos_l, neg_l = 1.0 - sw, sw
    else:
        pos_l, neg_l = 1.0, 0.0
    anc = _vec(anchors, torch.float32, dev).reshape(an_num, 2)
    mask_arr = _vec(mask, torch.int32, dev)
    anc_m = anc[mask_arr.long()]                         # [M, 2]

    # the predicted boxes of every cell, for the ignore mask
    ii = torch.arange(w, dtype=torch.float32, device=dev)[None, None, None]
    jj = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :,
                                                          None]
    px = (ii + torch.sigmoid(xr[:, :, 0]) * scale_xy + bias_xy) / h
    py = (jj + torch.sigmoid(xr[:, :, 1]) * scale_xy + bias_xy) / h
    pw = torch.exp(xr[:, :, 2]) * anc_m[None, :, 0, None, None] / input_size
    ph = torch.exp(xr[:, :, 3]) * anc_m[None, :, 1, None, None] / input_size
    g5 = [t[:, None, None, None, :] for t in (gx, gy, gw, gh)]
    iou_pg = _iou_cwh(px[..., None], py[..., None], pw[..., None],
                      ph[..., None], *g5)
    iou_pg = torch.where(valid[:, None, None, None, :], iou_pg,
                         _const(iou_pg, 0.0))
    best_iou = iou_pg.amax(-1) if b else torch.zeros_like(px)
    obj_mask = torch.where(best_iou > ignore_thresh, _const(px, -1.0),
                           _const(px, 0.0))              # [N, M, H, W]

    # each truth's best anchor: shape-only IoU at the origin
    aw = anc[None, None, :, 0] / input_size
    ah = anc[None, None, :, 1] / input_size
    zero = _const(gw, 0.0)
    iou_ga = _iou_cwh(zero, zero, gw[..., None], gh[..., None], zero, zero,
                      aw, ah)                            # [N, B, A]
    best_n = torch.argmax(iou_ga, -1).to(torch.int32)
    eq = best_n[..., None] == mask_arr[None, None, :]    # [N, B, M]
    mask_idx = torch.where(eq.any(-1), torch.argmax(eq.to(torch.int8), -1)
                           .to(torch.int32), -1)
    gt_match = torch.where(valid, mask_idx, -1)
    gi = torch.clamp((gx * w).to(torch.int32), 0, w - 1)
    gj = torch.clamp((gy * h).to(torch.int32), 0, h - 1)
    matched = valid & (mask_idx >= 0)

    # positive cells take the truth's score: a flat scatter, a later truth
    # on the same cell winning, unmatched truths dropped
    cell_id = ((_rows(n, dev) * m + mask_idx) * h + gj) * w + gi   # [N, B]
    bb = torch.arange(b, device=dev)
    later = (cell_id[:, :, None] == cell_id[:, None, :]) \
        & (bb[None, :] > bb[:, None])[None] & matched[:, None, :]
    writes = matched & ~later.any(-1)
    dump = n * m * h * w
    flat = torch.cat([obj_mask.reshape(-1), obj_mask.new_zeros(1)])
    flat = flat.index_put((torch.where(writes, cell_id, dump).reshape(-1)
                           .long(),), gt_score.reshape(-1))
    obj_mask = flat[:dump].reshape(n, m, h, w)

    # location and class losses at each matched truth's cell
    mg = torch.where(matched, mask_idx, 0).long()
    cell = xr[_rows(n, dev), mg, :, torch.where(matched, gj, 0).long(),
              torch.where(matched, gi, 0).long()]        # [N, B, 5+C]
    g_safe_w = torch.where(valid, gw, _const(gw, 1.0))
    g_safe_h = torch.where(valid, gh, _const(gh, 1.0))
    anc_best = anc[torch.where(matched, best_n, 0).long()]   # [N, B, 2]
    tx = gx * h - gi
    ty = gy * h - gj
    tw = torch.log(_max(g_safe_w * input_size, 1e-9)
                   / _max(anc_best[..., 0], 1e-9))
    th = torch.log(_max(g_safe_h * input_size, 1e-9)
                   / _max(anc_best[..., 1], 1e-9))
    sf = (2.0 - g_safe_w * g_safe_h) * gt_score
    loc = (_sce(cell[..., 0], tx) + _sce(cell[..., 1], ty)
           + torch.abs(cell[..., 2] - tw) + torch.abs(cell[..., 3] - th)) \
        * sf
    onehot = gt_label[..., None] == torch.arange(class_num, device=dev)
    cls_target = torch.where(onehot, _const(loc, pos_l), _const(loc, neg_l))
    cls = _sce(cell[..., 5:], cls_target).sum(-1) * gt_score
    loss_pos = torch.where(matched, loc + cls, _const(loc, 0.0)).sum(1)

    # objectness over the final mask
    xo = xr[:, :, 4]
    obj_pos = torch.where(obj_mask > 1e-5, _sce(xo, 1.0) * obj_mask,
                          _const(xo, 0.0))
    obj_neg = torch.where((obj_mask <= 1e-5) & (obj_mask > -0.5),
                          _sce(xo, 0.0), _const(xo, 0.0))
    loss_obj = (obj_pos + obj_neg).sum((1, 2, 3))
    return {"Loss": [(loss_pos + loss_obj).to(x.dtype)],
            "ObjectnessMask": [obj_mask.to(x.dtype)],
            "GTMatchMask": [gt_match]}


def _compact(ok, values, width, fill):
    """Each row's `ok` entries moved to its front in order (a stable
    compaction by cumsum ranks), the rest `fill`: [R, width, ...]."""
    rank = torch.cumsum(ok.to(torch.int32), 1) - 1
    tgt = torch.where(ok, rank, width)
    return _scatter_rows(values.shape[2:], fill, tgt, values, width)


@register("generate_proposals",
          nondiff_slots=("Scores", "BboxDeltas", "ImInfo", "Anchors",
                         "Variances"))
def _generate_proposals(ctx, ins, attrs):
    """generate_proposals_op.cc (the RPN's proposals), pixel convention
    (+1 widths), the log(1000/16) delta clip, the min-size and center
    filter, then greedy NMS, every image at once: [N * post_nms_topN, 4]
    padded blocks (probabilities of padding rows lowest, so a consumer
    can tell them by score) and the per-image counts RpnRoisNum."""
    scores = ins["Scores"][0]                    # [N, A, H, W]
    deltas = ins["BboxDeltas"][0]                # [N, 4A, H, W]
    im_info = ins["ImInfo"][0]                   # [N, 3] (h, w, scale)
    anchors = ins["Anchors"][0].reshape(-1, 4)
    variances = ins["Variances"][0].reshape(-1, 4)
    pre_n = int(attrs.get("pre_nms_topN", 6000))
    post_n = int(attrs.get("post_nms_topN", 1000))
    min_size = max(float(attrs.get("min_size", 0.1)), 1.0)
    n, a, h, w = scores.shape
    m = a * h * w
    pre_n = min(pre_n, m)
    dev = scores.device
    sc = torch.movedim(scores, 1, -1).reshape(n, m)      # h, w, a order
    dl = torch.movedim(deltas.reshape(n, a, 4, h, w), (3, 4, 1),
                       (1, 2, 3)).reshape(n, m, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    acx = anchors[:, 0] + 0.5 * aw
    acy = anchors[:, 1] + 0.5 * ah
    rows = _rows(n, dev)
    order = _argsort_desc(sc)[:, :pre_n]                 # [N, pre_n]
    d = dl[rows, order]
    s = sc[rows, order]
    va = variances[order]
    aw_o, ah_o = aw[order], ah[order]
    cx = va[..., 0] * d[..., 0] * aw_o + acx[order]
    cy = va[..., 1] * d[..., 1] * ah_o + acy[order]
    bw = torch.exp(_minimum(va[..., 2] * d[..., 2], _LOG_1000_16)) * aw_o
    bh = torch.exp(_minimum(va[..., 3] * d[..., 3], _LOG_1000_16)) * ah_o
    imh, imw, imsc = (im_info[:, i:i + 1] for i in range(3))

    def clip(v, hi):
        return torch.minimum(_max(v, 0.0), hi - 1.0)
    x1 = clip(cx - bw / 2, imw)
    y1 = clip(cy - bh / 2, imh)
    x2 = clip(cx + bw / 2 - 1.0, imw)
    y2 = clip(cy + bh / 2 - 1.0, imh)
    ws, hs = x2 - x1 + 1.0, y2 - y1 + 1.0
    keep_sz = ((x2 - x1) / imsc + 1.0 >= min_size) \
        & ((y2 - y1) / imsc + 1.0 >= min_size) \
        & (x1 + ws / 2 <= imw) & (y1 + hs / 2 <= imh)
    boxes = torch.stack([x1, y1, x2, y2], -1)
    low = _lowest(s)
    s = torch.where(keep_sz, s, _const(s, low))
    order2, s2, keep = _nms_rows(boxes, s, float(attrs.get("nms_thresh", 0.7)),
                                 pre_n, False, float(attrs.get("eta", 1.0)))
    ok = keep & (s2 > low)
    rois = _compact(ok, boxes[rows, order2], pre_n, 0.0)[:, :post_n]
    probs = _compact(ok, s2[..., None], pre_n, low)[:, :post_n]
    counts = _minimum(ok.sum(1), post_n).to(torch.int32)
    return {"RpnRois": [rois.reshape(-1, 4)],
            "RpnRoiProbs": [probs.reshape(-1, 1)],
            "RpnRoisNum": [counts]}


@register("distribute_fpn_proposals", nondiff_slots=("FpnRois", "RoisNum"))
def _distribute_fpn_proposals(ctx, ins, attrs):
    """distribute_fpn_proposals_op.cc: each ROI to the level floor(log2(
    sqrt(area) / refer_scale + 1e-6)) + refer_level, clipped. Per level a
    [R, 4] block (the level's ROIs first, zeros after), the level counts,
    and RestoreIndex into the concatenation of the blocks (padding input
    rows, past an image's RoisNum, to zero rows of level 0's block)."""
    rois = ins["FpnRois"][0]                     # [R, 4]
    min_level = int(attrs["min_level"])
    max_level = int(attrs["max_level"])
    refer_level = int(attrs["refer_level"])
    refer_scale = float(attrs["refer_scale"])
    r = rois.shape[0]
    dev = rois.device
    scale = torch.sqrt(_max((rois[:, 2] - rois[:, 0])
                            * (rois[:, 3] - rois[:, 1]), 1e-12))
    lvl = torch.floor(torch.log2(scale / refer_scale + 1e-6)) + refer_level
    lvl = torch.clamp(lvl, min_level, max_level).to(torch.int32)
    nums_in = [x for x in ins.get("RoisNum", []) if x is not None]
    if nums_in:
        nums = torch.cat([x.reshape(-1) for x in nums_in])
        per_img = r // nums.shape[0]
        live = (torch.arange(r, device=dev) % per_img) \
            < torch.repeat_interleave(nums, per_img)
    else:
        live = torch.ones((r,), dtype=torch.bool, device=dev)
    rank_all = torch.zeros((r,), dtype=torch.int32, device=dev)
    lvl_eff = torch.where(live, lvl, -1)
    outs, counts = [], []
    for li in range(max_level - min_level + 1):
        sel = lvl_eff == min_level + li
        rank = torch.cumsum(sel.to(torch.int32), 0) - 1
        rank_all = torch.where(sel, rank, rank_all)
        outs.append(_scatter_rows((4,), 0.0, torch.where(sel, rank, r)[None],
                                  rois[None], r)[0])
        counts.append(sel.sum().to(torch.int32))
    restore = (lvl - min_level) * r + rank_all
    if nums_in:
        dead_rank = torch.cumsum((~live).to(torch.int32), 0) - 1
        restore = torch.where(live, restore, counts[0] + dead_rank)
    return {"MultiFpnRois": outs,
            "MultiLevelRoIsNum": [torch.stack(counts)],
            "RestoreIndex": [restore.to(torch.int32)[:, None]]}


@register("collect_fpn_proposals",
          nondiff_slots=("MultiLevelRois", "MultiLevelScores",
                         "MultiLevelRoIsNum"))
def _collect_fpn_proposals(ctx, ins, attrs):
    """collect_fpn_proposals_op.cc: the levels' (rois, scores)
    concatenated, the global top post_nms_topN by score; rows past a
    level's count score lowest and never win."""
    rois = torch.cat([x.reshape(-1, 4) for x in ins["MultiLevelRois"]], 0)
    scores = torch.cat([s.reshape(-1) for s in ins["MultiLevelScores"]], 0)
    nums_in = [v for v in ins.get("MultiLevelRoIsNum", []) if v is not None]
    low = _lowest(scores)
    if nums_in:
        nums = torch.cat([v.reshape(-1) for v in nums_in])
        valid = torch.cat([
            torch.arange(x.reshape(-1, 4).shape[0], dtype=torch.int32,
                         device=rois.device) < nums[i]
            for i, x in enumerate(ins["MultiLevelRois"])])
        scores = torch.where(valid, scores, _const(scores, low))
    post_n = min(int(attrs.get("post_nms_topN", 1000)), rois.shape[0])
    order = _argsort_desc(scores)[:post_n]
    cnt = (scores > low).sum().to(torch.int32)
    return {"FpnRois": [rois[order]],
            "RoisNum": [_minimum(cnt, post_n).reshape(1)]}


@register("matrix_nms", nondiff_slots=("BBoxes", "Scores"))
def _matrix_nms(ctx, ins, attrs):
    """matrix_nms_op.cc NMSMatrix: decay-based soft NMS in closed form,
    decay_i = min_{j<i} f(iou_ij) / f(iou_max_j), every class at once
    (one image)."""
    bboxes, scores = ins["BBoxes"][0], ins["Scores"][0]
    if bboxes.dim() == 3:
        if bboxes.shape[0] != 1:
            raise ValueError("matrix_nms lowering is single-image")
        bboxes, scores = bboxes[0], scores[0]
    c, m = scores.shape
    nms_top_k = int(attrs.get("nms_top_k", m))
    nms_top_k = m if nms_top_k <= 0 else min(nms_top_k, m)
    keep_top_k = int(attrs.get("keep_top_k", m))
    if keep_top_k <= 0:
        keep_top_k = c * nms_top_k
    sigma = float(attrs.get("gaussian_sigma", 2.0))
    dev = scores.device
    low = _lowest(scores)
    s_raw, labels = _classes(scores[None], c,
                             int(attrs.get("background_label", 0)))
    s_raw = s_raw[0]
    s = torch.where(s_raw > float(attrs.get("score_threshold", 0.0)), s_raw,
                    _const(s_raw, low))
    order = _argsort_desc(s)[:, :nms_top_k]              # [C', k]
    b = bboxes[order]
    ss = torch.gather(s, 1, order)
    live = ss > low
    iou = _iou_matrix(b, b, bool(attrs.get("normalized", True)))
    k = b.shape[1]
    ar = torch.arange(k, device=dev)
    tri = (ar[:, None] > ar[None, :]) & live[:, :, None] & live[:, None, :]
    iou_t = torch.where(tri, iou, _const(iou, 0.0))
    iou_max = torch.where(tri, iou, _const(iou, -math.inf)).amax(2)
    iou_max = torch.where(torch.isfinite(iou_max), iou_max,
                          _const(iou_max, 0.0))
    if attrs.get("use_gaussian", False):
        decay = torch.exp((iou_max[:, None, :] ** 2 - iou_t ** 2) * sigma)
    else:
        decay = (1.0 - iou_t) / _max(1.0 - iou_max[:, None, :], 1e-10)
    dec = torch.where(tri, decay, _const(decay, 1.0)).amin(2)
    ds = torch.where(live, dec * ss, _const(ss, low))
    ok = ds > float(attrs.get("post_threshold", 0.0))
    cat = _class_rows(labels.to(ds.dtype)[:, None], ok, ds,
                      b).reshape(1, -1, 6)
    src = torch.where(ok, order, -1).reshape(1, -1)
    out, count, index = _cut_rows(cat, src, min(keep_top_k, cat.shape[1]))
    return {"Out": [out[0]], "Index": [index[0][:, None]],
            "RoisNum": [count]}


def _bipartite_rows(dist, match_type="bipartite", threshold=0.5):
    """bipartite_match_op.cc on every instance of dist [B, R, C] at once:
    min(R, C) greedy rounds, each matching the global maximum of an
    instance's matrix (its first in row-major order) if it is > 0 and
    taking its row and column out; `per_prediction` then matches each
    column still free to its best row if that reaches `threshold`.
    Returns (row of each column or -1 [B, C] int32, its distance)."""
    bsz, r, c = dist.shape
    dev = dist.device
    neg = _lowest(dist)
    d = dist
    row_of_col = torch.full((bsz, c), -1, dtype=torch.int32, device=dev)
    dist_of_col = torch.zeros((bsz, c), dtype=dist.dtype, device=dev)
    ri = torch.arange(r, device=dev)
    ci = torch.arange(c, device=dev)
    for _ in range(min(r, c)):
        flat = d.reshape(bsz, -1)
        at = torch.argmax(flat, 1)
        best = torch.gather(flat, 1, at[:, None])[:, 0]
        do = best > 0
        i, j = at // c, at % c
        row_hit = (ri[None] == i[:, None]) & do[:, None]        # [B, R]
        col_hit = (ci[None] == j[:, None]) & do[:, None]        # [B, C]
        row_of_col = torch.where(col_hit, i[:, None].to(torch.int32),
                                 row_of_col)
        dist_of_col = torch.where(col_hit, best[:, None], dist_of_col)
        d = torch.where(row_hit[:, :, None] | col_hit[:, None, :],
                        _const(d, neg), d)
    if match_type == "per_prediction":
        best_val = dist.amax(1)
        best_row = torch.argmax(dist, 1).to(torch.int32)
        extra = (row_of_col < 0) & (best_val >= threshold)
        row_of_col = torch.where(extra, best_row, row_of_col)
        dist_of_col = torch.where(extra, best_val, dist_of_col)
    return row_of_col, dist_of_col


@register("bipartite_match", nondiff_slots=("DistMat",))
def _bipartite_match(ctx, ins, attrs):
    """bipartite_match_op.cc on the distance matrix [R, C] (rows the
    truths, columns the priors), by `_bipartite_rows`."""
    dist = ins["DistMat"][0]
    if dist.dim() == 3:
        if dist.shape[0] != 1:
            raise ValueError("bipartite_match lowering is single-instance")
        dist = dist[0]
    row_of_col, dist_of_col = _bipartite_rows(
        dist[None], attrs.get("match_type", "bipartite"),
        float(attrs.get("dist_threshold", 0.5)))
    return {"ColToRowMatchIndices": [row_of_col],
            "ColToRowMatchDist": [dist_of_col]}


@register("target_assign", nondiff_slots=("MatchIndices", "NegIndices"))
def _target_assign(ctx, ins, attrs):
    """target_assign_op.cc: out[i][j] = X[match[i][j]] where matched, else
    mismatch_value; weight 1 for the matched and for the mined negatives
    (NegIndices, mine_hard_examples' padded [B, C] block, -1 padding)."""
    x = ins["X"][0]                              # [R, D] or [B, R, D]
    match = ins["MatchIndices"][0].to(torch.int32)   # [B, C]
    neg = ins.get("NegIndices", [None])[0]
    if x.dim() == 2:
        x = x[None]
    bsz, c = match.shape
    dev = x.device
    # a batch of 1 on either side broadcasts, as jnp.take_along_axis
    rows = x[_rows(x.shape[0], dev), torch.clamp(match, min=0).long()]
    matched = (match >= 0)[..., None]
    out = torch.where(matched, rows,
                      _const(rows, attrs.get("mismatch_value", 0)))
    wt = matched[..., 0].float()
    if neg is not None:
        neg = neg.to(torch.int32).reshape(bsz, -1)
        hit = _scatter_rows((), 0.0, torch.where(neg >= 0, neg, c),
                            torch.ones(neg.shape, device=dev), c)
        wt = torch.maximum(wt, hit)
    return {"Out": [out], "OutWeight": [wt[..., None]]}


def _rank_among(mask, priority):
    """Each True entry's rank among its row's True entries, by `priority`
    ascending (stable); False entries rank after every True one."""
    key = torch.where(mask, priority, _const(priority, math.inf))
    order = torch.argsort(key, dim=-1, stable=True)
    ar = torch.arange(mask.shape[-1], dtype=torch.int32,
                      device=mask.device).expand(mask.shape).contiguous()
    return torch.empty_like(ar).scatter(-1, order, ar)


@register("mine_hard_examples",
          nondiff_slots=("ClsLoss", "LocLoss", "MatchIndices", "MatchDist"))
def _mine_hard_examples(ctx, ins, attrs):
    """mine_hard_examples_op.cc, max_negative: per instance the unmatched
    priors ranked by loss, descending, and the first neg_pos_ratio x
    #positives kept; NegFlag the mask, NegIndices the kept priors' indices
    in place (-1 elsewhere)."""
    if attrs.get("mining_type", "max_negative") != "max_negative":
        raise NotImplementedError("hard_example mining_type: max_negative "
                                  "only (the reference marks hard_example "
                                  "as unimplemented too)")
    cls_loss = ins["ClsLoss"][0]                 # [B, P]
    loc_loss = ins.get("LocLoss", [None])[0]
    match = ins["MatchIndices"][0].to(torch.int32)
    dist = ins.get("MatchDist", [None])[0]
    loss = cls_loss if loc_loss is None else cls_loss + loc_loss
    is_neg = match < 0
    if dist is not None:
        is_neg = is_neg & (dist < float(attrs.get("neg_dist_threshold",
                                                  0.5)))
    n_pos = (match >= 0).sum(1).to(torch.int32)
    n_neg = (n_pos.float() * float(attrs.get("neg_pos_ratio", 3.0))).to(
        torch.int32)
    masked = torch.where(is_neg, loss, _const(loss, -math.inf))
    rank = _rank_among(torch.ones_like(is_neg), -masked)
    neg_flag = is_neg & (rank < n_neg[:, None])
    p = match.shape[1]
    neg_idx = torch.where(neg_flag, torch.arange(
        p, dtype=torch.int32, device=match.device)[None], -1)
    return {"UpdatedMatchIndices": [match], "NegIndices": [neg_idx],
            "NegFlag": [neg_flag]}


@register("box_decoder_and_assign",
          nondiff_slots=("PriorBox", "PriorBoxVar", "BoxScore"))
def _box_decoder_and_assign(ctx, ins, attrs):
    """box_decoder_and_assign_op.cc: per-class deltas decoded against the
    priors (pixel convention, the dw / dh clip `box_clip`), then each
    roi's best-scoring class box (background column 0 skipped)."""
    prior = ins["PriorBox"][0]                   # [R, 4]
    pvar = ins["PriorBoxVar"][0]                 # [R, 4]
    deltas = ins["TargetBox"][0]                 # [R, 4*C]
    score = ins["BoxScore"][0]                   # [R, C]
    clip = float(attrs.get("box_clip", 4.135))
    r, c = score.shape
    pw = prior[:, 2] - prior[:, 0] + 1.0
    ph = prior[:, 3] - prior[:, 1] + 1.0
    pcx = prior[:, 0] + 0.5 * pw
    pcy = prior[:, 1] + 0.5 * ph
    d = deltas.reshape(r, c, 4)
    dx = d[..., 0] * pvar[:, None, 0]
    dy = d[..., 1] * pvar[:, None, 1]
    dw = _minimum(d[..., 2] * pvar[:, None, 2], clip)
    dh = _minimum(d[..., 3] * pvar[:, None, 3], clip)
    cx = dx * pw[:, None] + pcx[:, None]
    cy = dy * ph[:, None] + pcy[:, None]
    bw = torch.exp(dw) * pw[:, None]
    bh = torch.exp(dh) * ph[:, None]
    decoded = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2 - 1.0,
                           cy + bh / 2 - 1.0], dim=-1)
    best = torch.argmax(score[:, 1:], 1) + 1
    assigned = decoded[torch.arange(r, device=score.device), best]
    return {"DecodeBox": [decoded.reshape(r, c * 4)],
            "OutputAssignBox": [assigned]}


@register("retinanet_detection_output",
          nondiff_slots=("BBoxes", "Scores", "Anchors", "ImInfo"))
def _retinanet_detection_output(ctx, ins, attrs):
    """retinanet_detection_output_op.cc, one image: per FPN level the
    nms_top_k best (anchor, class) pairs decoded against the level's
    anchors, then the levels merged and NMS per class (every class at
    once); a [keep_top_k, 6] block padded with label -1 and the count."""
    im_info = ins["ImInfo"][0].reshape(-1)
    score_threshold = float(attrs.get("score_threshold", 0.05))
    nms_top_k = int(attrs.get("nms_top_k", 1000))
    keep_top_k = int(attrs.get("keep_top_k", 100))
    boxes_all, scores_all, labels_all = [], [], []
    for blv, slv, alv in zip(ins["BBoxes"], ins["Scores"], ins["Anchors"]):
        d = blv.reshape(-1, 4)
        s = slv.reshape(-1, slv.shape[-1])       # [A, C]
        c = s.shape[1]
        anc = alv.reshape(-1, 4)
        flat = s.reshape(-1)
        top = _argsort_desc(flat)[:min(nms_top_k, flat.shape[0])]
        ai, ci = top // c, (top % c).to(torch.int32)
        sv = flat[top]
        aw = anc[ai, 2] - anc[ai, 0] + 1.0
        ah = anc[ai, 3] - anc[ai, 1] + 1.0
        acx = anc[ai, 0] + 0.5 * aw
        acy = anc[ai, 1] + 0.5 * ah
        dd = d[ai]
        cx = dd[:, 0] * aw + acx
        cy = dd[:, 1] * ah + acy
        bw = torch.exp(_minimum(dd[:, 2], 4.135)) * aw
        bh = torch.exp(_minimum(dd[:, 3], 4.135)) * ah

        def clip(v, hi):
            return torch.minimum(_max(v, 0.0), hi - 1.0)
        boxes_all.append(torch.stack(
            [clip(cx - bw / 2, im_info[1]), clip(cy - bh / 2, im_info[0]),
             clip(cx + bw / 2 - 1.0, im_info[1]),
             clip(cy + bh / 2 - 1.0, im_info[0])], 1))
        scores_all.append(torch.where(sv > score_threshold, sv,
                                      _const(sv, _lowest(sv))))
        labels_all.append(ci)
    boxes = torch.cat(boxes_all, 0)
    scores = torch.cat(scores_all, 0)
    labels = torch.cat(labels_all, 0)
    low = _lowest(scores)
    num_classes = ins["Scores"][0].shape[-1]
    k_all = boxes.shape[0]
    cls = torch.arange(num_classes, device=boxes.device)
    s_cls = torch.where(labels[None] == cls[:, None], scores[None],
                        _const(scores, low))             # [C, K]
    order, s2, keep = _nms_rows(
        boxes[None].expand(num_classes, k_all, 4), s_cls,
        float(attrs.get("nms_threshold", 0.3)), min(nms_top_k, k_all),
        False, float(attrs.get("nms_eta", 1.0)))
    ok = keep & (s2 > low)
    cat = _class_rows(cls[:, None].to(s2.dtype), ok, s2,
                      boxes[order]).reshape(1, -1, 6)
    out, count, _ = _cut_rows(cat, torch.zeros_like(cat[..., 0],
                                                    dtype=torch.int32),
                              min(keep_top_k, cat.shape[1]))
    return {"Out": [out[0]], "NmsRoisNum": [count]}
