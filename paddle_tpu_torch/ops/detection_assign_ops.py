"""The detection target-assignment ops (counterpart of paddle_tpu/ops/
detection_assign_ops.py): the RCNN, RetinaNet, SSD and EAST families'
training-side ops, every one of the reference file's 7 types with its
flags, and its build-time shape rules. Outputs are static: dense
per-anchor / per-roi targets with weight masks, padded blocks with count
tensors. Each is differentiated by the generic `__vjp__`.

As in ops/detection_ops.py, the reference's Python loops over images
(and over classes) are batched:

* `rpn_target_assign`, `retinanet_target_assign`,
  `generate_proposal_labels` and `generate_mask_labels` work on [B, ...]
  at once; every count (fg, bg, kept) is a tensor, never read on the
  host.
* `ssd_loss` matches every image in one `_bipartite_rows` loop and ranks
  the hard negatives of every image in one stable sort.
* `locality_aware_nms` merges and suppresses every (image, class) row at
  once: one loop over the boxes for the merge, one over the candidates
  for the NMS.
* Subsampling with `use_random` draws on the device from the op's key
  (`ops/tensor_ops.py` `_random_bits`, a stream per image block and
  kind), where the reference draws from jax's key: the counts of the
  sampled sets are what the two packages share, and with
  `use_random=False` both keep the lowest-index candidates.
"""
from __future__ import annotations

import torch

from ..framework.dtype import convert_dtype
from .detection_ops import _bipartite_rows, _const, _iou_matrix, _max, \
    _rank_among, _rows, _scatter_rows, _vec
from .registry import _REGISTRY, register
from .tensor_ops import _random_bits, _uniform01


def _priorities(ctx, attrs, shape, stream, use_random):
    if use_random:
        return _uniform01(_random_bits(ctx, attrs, shape, stream))
    return torch.arange(shape[-1], dtype=torch.float32,
                        device=ctx.device).expand(shape)


def _encode_delta(ex, gt, weights=None):
    """BoxToDelta (bbox_util.h:54), pixel convention (+1 widths)."""
    ew = ex[..., 2] - ex[..., 0] + 1.0
    eh = ex[..., 3] - ex[..., 1] + 1.0
    ecx = ex[..., 0] + 0.5 * ew
    ecy = ex[..., 1] + 0.5 * eh
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    gcx = gt[..., 0] + 0.5 * gw
    gcy = gt[..., 1] + 0.5 * gh
    d = torch.stack([(gcx - ecx) / ew, (gcy - ecy) / eh,
                     torch.log(_max(gw, 1e-6) / ew),
                     torch.log(_max(gh, 1e-6) / eh)], dim=-1)
    if weights is not None:
        d = d / _vec(weights, d.dtype, d.device)
    return d


def _valid_gt(gt_boxes, is_crowd):
    """Padding truths are zero-area boxes; crowd truths are left out of
    matching (FilterCrowdGt). [B, G]."""
    area = (gt_boxes[..., 2] - gt_boxes[..., 0]) \
        * (gt_boxes[..., 3] - gt_boxes[..., 1])
    valid = area > 0
    if is_crowd is not None:
        valid = valid & (is_crowd.reshape(valid.shape) == 0)
    return valid


def _batched(t, dims):
    return t if t is None or t.dim() == dims else t[None]


def _take(table, idx):
    """table [B, G, ...] at idx [B, n]: [B, n, ...]."""
    return table[_rows(table.shape[0], table.device), idx.long()]


@register("rpn_target_assign", is_random=True,
          nondiff_slots=("Anchor", "GtBoxes", "IsCrowd", "ImInfo"))
def _rpn_target_assign(ctx, ins, attrs):
    """rpn_target_assign_op.cc, dense: per anchor TargetLabel [B, A, 1]
    (1 fg, 0 bg), ScoreWeight (1 iff sampled), TargetBBox (anchor-to-truth
    deltas on sampled fg rows) and BBoxInsideWeight (1 on sampled fg
    rows). fg = IoU >= positive overlap or each truth's best anchor, bg =
    IoU < negative overlap, inside the straddle margin; at most
    fg_fraction x rpn_batch_size_per_im fg and the rest bg sampled."""
    anchors = ins["Anchor"][0].reshape(-1, 4)            # [A, 4]
    gt = _batched(ins["GtBoxes"][0], 3)                  # [B, G, 4]
    crowd = _batched(ins.get("IsCrowd", [None])[0], 2)
    im_info = ins["ImInfo"][0]
    bs = int(attrs.get("rpn_batch_size_per_im", 256))
    straddle = float(attrs.get("rpn_straddle_thresh", 0.0))
    pos_ov = float(attrs.get("rpn_positive_overlap", 0.7))
    neg_ov = float(attrs.get("rpn_negative_overlap", 0.3))
    use_random = bool(attrs.get("use_random", True))
    eps = 1e-5
    b, a = gt.shape[0], anchors.shape[0]
    valid = _valid_gt(gt, crowd)                         # [B, G]
    if straddle >= 0:
        imh, imw = im_info[:, 0:1], im_info[:, 1:2]
        inside = ((anchors[None, :, 0] >= -straddle)
                  & (anchors[None, :, 1] >= -straddle)
                  & (anchors[None, :, 2] < imw + straddle)
                  & (anchors[None, :, 3] < imh + straddle))
    else:
        inside = torch.ones((b, a), dtype=torch.bool, device=gt.device)
    iou = _iou_matrix(anchors[None], gt, normalized=False)   # [B, A, G]
    iou = torch.where(valid[:, None, :], iou, _const(iou, -1.0))
    amax = iou.amax(2)
    aarg = torch.argmax(iou, 2)
    gmax = torch.where(inside[:, :, None], iou, _const(iou, -1.0)).amax(1)
    is_best = ((iou >= gmax[:, None, :] - eps) & valid[:, None, :]
               & (gmax[:, None, :] > 0)).any(2)
    fg = inside & valid.any(1, keepdim=True) & ((amax >= pos_ov) | is_best)
    bg = inside & (amax < neg_ov) & ~fg
    fg_rank = _rank_among(fg, _priorities(ctx, attrs, (b, a), 0, use_random))
    n_fg = torch.clamp(fg.sum(1, keepdim=True).to(torch.int32),
                       max=int(float(attrs.get("rpn_fg_fraction", 0.5))
                               * bs))
    fg_keep = fg & (fg_rank < n_fg)
    bg_rank = _rank_among(bg, _priorities(ctx, attrs, (b, a), 1, use_random))
    bg_keep = bg & (bg_rank < torch.clamp(bs - n_fg, min=0))
    delta = _encode_delta(anchors[None], _take(gt, torch.clamp(aarg, min=0)))
    on = fg_keep[..., None]
    return {"TargetLabel": [fg_keep.float()[..., None]],
            "ScoreWeight": [(fg_keep | bg_keep).float()[..., None]],
            "TargetBBox": [torch.where(on, delta, _const(delta, 0.0))],
            "BBoxInsideWeight": [on.float().expand(b, a, 4).contiguous()]}


@register("retinanet_target_assign",
          nondiff_slots=("Anchor", "GtBoxes", "GtLabels", "IsCrowd",
                         "ImInfo"))
def _retinanet_target_assign(ctx, ins, attrs):
    """retinanet_target_assign (rpn_target_assign_op.cc's variant): no
    subsampling; fg (IoU >= positive overlap or each truth's best anchor)
    carries its truth's class, bg (IoU < negative overlap) is label 0,
    the band between weight 0; ForegroundNumber [B, 1] at least 1."""
    anchors = ins["Anchor"][0].reshape(-1, 4)
    gt = _batched(ins["GtBoxes"][0], 3)
    labels = ins["GtLabels"][0].reshape(gt.shape[0], -1).to(torch.int32)
    crowd = _batched(ins.get("IsCrowd", [None])[0], 2)
    pos_ov = float(attrs.get("positive_overlap", 0.5))
    neg_ov = float(attrs.get("negative_overlap", 0.4))
    eps = 1e-5
    b, a = gt.shape[0], anchors.shape[0]
    valid = _valid_gt(gt, crowd)
    iou = _iou_matrix(anchors[None], gt, normalized=False)
    iou = torch.where(valid[:, None, :], iou, _const(iou, -1.0))
    amax = iou.amax(2)
    aarg = torch.clamp(torch.argmax(iou, 2), min=0)
    gmax = iou.amax(1)
    is_best = ((iou >= gmax[:, None, :] - eps) & valid[:, None, :]
               & (gmax[:, None, :] > 0)).any(2)
    fg = valid.any(1, keepdim=True) & ((amax >= pos_ov) | is_best)
    bg = (amax < neg_ov) & ~fg
    lab = torch.where(fg, _take(labels, aarg), 0).to(torch.int32)
    delta = _encode_delta(anchors[None], _take(gt, aarg))
    on = fg[..., None]
    return {"TargetLabel": [lab[..., None]],
            "ScoreWeight": [(fg | bg).float()[..., None]],
            "TargetBBox": [torch.where(on, delta, _const(delta, 0.0))],
            "BBoxInsideWeight": [on.float().expand(b, a, 4).contiguous()],
            "ForegroundNumber": [torch.clamp(
                fg.sum(1, keepdim=True).to(torch.int32), min=1)]}


@register("generate_proposal_labels", is_random=True,
          nondiff_slots=("RpnRois", "GtClasses", "IsCrowd", "GtBoxes",
                         "ImInfo", "RpnRoisNum"))
def _generate_proposal_labels(ctx, ins, attrs):
    """generate_proposal_labels_op.cc (SampleRoisForOneImage), static:
    each image gives batch_size_per_im rows, the sampled fg rois, then
    bg, then zeros; RoisNum the live counts, RoiWeights 1 on live rows.
    The candidates are the image's live proposals and its valid truths;
    BboxTargets go to the labelled class's 4 columns (class 1 when
    is_cls_agnostic), divided by bbox_reg_weights."""
    gt = _batched(ins["GtBoxes"][0], 3)                  # [B, G, 4]
    b, g = gt.shape[:2]
    rois = ins["RpnRois"][0].reshape(b, -1, 4)           # [B, R, 4]
    r = rois.shape[1]
    gt_cls = ins["GtClasses"][0].reshape(b, g)
    crowd = _batched(ins.get("IsCrowd", [None])[0], 2)
    nums = ins.get("RpnRoisNum", [None])[0]
    bs = int(attrs.get("batch_size_per_im", 512))
    fg_thresh = float(attrs.get("fg_thresh", 0.5))
    bg_hi = float(attrs.get("bg_thresh_hi", 0.5))
    bg_lo = float(attrs.get("bg_thresh_lo", 0.0))
    reg_w = attrs.get("bbox_reg_weights", [0.1, 0.1, 0.2, 0.2])
    class_nums = int(attrs.get("class_nums", 2))
    use_random = bool(attrs.get("use_random", True))
    dev = gt.device
    valid = _valid_gt(gt, crowd)
    live = torch.ones((b, r), dtype=torch.bool, device=dev) if nums is None \
        else torch.arange(r, device=dev)[None] < nums.reshape(-1)[:, None]
    cand = torch.cat([rois, gt], 1)                      # [B, R+G, 4]
    cand_live = torch.cat([live, valid], 1)
    iou = _iou_matrix(cand, gt, normalized=False)
    iou = torch.where(valid[:, None, :], iou, _const(iou, -1.0))
    mov = iou.amax(2)
    marg = torch.clamp(torch.argmax(iou, 2), min=0)
    fg = cand_live & (mov >= fg_thresh)
    bg = cand_live & (mov < bg_hi) & (mov >= bg_lo)
    n_cand = r + g
    fg_rank = _rank_among(fg, _priorities(ctx, attrs, (b, n_cand), 0,
                                          use_random))
    n_fg = torch.clamp(fg.sum(1, keepdim=True).to(torch.int32),
                       max=int(round(float(attrs.get("fg_fraction", 0.25))
                                     * bs)))
    fg_keep = fg & (fg_rank < n_fg)
    bg_rank = _rank_among(bg, _priorities(ctx, attrs, (b, n_cand), 1,
                                          use_random))
    n_bg = torch.minimum(bs - n_fg, bg.sum(1, keepdim=True).to(torch.int32))
    bg_keep = bg & (bg_rank < n_bg)
    # fg rows to [0, n_fg), bg rows to [n_fg, n_fg + n_bg)
    tgt_row = torch.where(fg_keep, fg_rank,
                          torch.where(bg_keep, n_fg + bg_rank, bs))
    rois_o = _scatter_rows((4,), 0.0, tgt_row, cand, bs)
    lab_cand = torch.where(fg_keep, _take(gt_cls, marg).to(torch.int32), 0)
    lab_o = _scatter_rows((), 0, tgt_row, lab_cand, bs)
    delta = _encode_delta(cand, _take(gt, marg), weights=reg_w)
    delta = torch.where(fg_keep[..., None], delta, _const(delta, 0.0))
    d_o = _scatter_rows((4,), 0.0, tgt_row, delta, bs)
    # the 4-vector into the labelled class's columns
    cls_slot = torch.ones_like(lab_o) if attrs.get("is_cls_agnostic", False) \
        else torch.clamp(lab_o, min=0)
    at_slot = (torch.arange(class_nums, device=dev)[None, None]
               == cls_slot[..., None]) & (lab_o > 0)[..., None]
    tgt_full = torch.where(at_slot[..., None], d_o[:, :, None],
                           _const(d_o, 0.0)).reshape(b, bs, 4 * class_nums)
    w_full = at_slot[..., None].expand(b, bs, class_nums, 4).float() \
        .reshape(b, bs, 4 * class_nums)
    count = (n_fg + n_bg).to(torch.int32)
    row_w = (torch.arange(bs, device=dev)[None] < count).float()
    return {"Rois": [rois_o.reshape(-1, 4)],
            "LabelsInt32": [lab_o.reshape(-1, 1)],
            "BboxTargets": [tgt_full.reshape(b * bs, -1)],
            "BboxInsideWeights": [w_full.reshape(b * bs, -1)],
            "BboxOutsideWeights": [w_full.reshape(b * bs, -1)],
            "RoisNum": [count.reshape(-1)],
            "RoiWeights": [row_w.reshape(-1, 1)]}


@register("generate_mask_labels",
          nondiff_slots=("ImInfo", "GtClasses", "IsCrowd", "GtSegms",
                         "Rois", "LabelsInt32", "RoisNum"))
def _generate_mask_labels(ctx, ins, attrs):
    """generate_mask_labels_op.cc, with GtSegms a dense per-truth bitmap
    [B, G, Hm, Wm] over the image (the polygons rasterized in the data
    pipeline): each fg roi's matched truth's bitmap resampled bilinearly
    over the roi to resolution^2 and thresholded at 0.5; MaskInt32 rows
    -1 but the roi's class columns."""
    im_info = ins["ImInfo"][0]
    crowd = _batched(ins.get("IsCrowd", [None])[0], 2)
    segms = ins["GtSegms"][0]                    # [B, G, Hm, Wm]
    b, g, hm, wm = segms.shape
    rois = ins["Rois"][0].reshape(b, -1, 4)      # [B, R, 4]
    r = rois.shape[1]
    labels = ins["LabelsInt32"][0].reshape(b, r).to(torch.int32)
    nums = ins.get("RoisNum", [None])[0]
    num_classes = int(attrs.get("num_classes", 2))
    res = int(attrs.get("resolution", 14))
    dev = rois.device
    live = torch.ones((b, r), dtype=torch.bool, device=dev) if nums is None \
        else torch.arange(r, device=dev)[None] < nums.reshape(-1)[:, None]
    fg = live & (labels > 0)
    if ins.get("GtBoxes"):
        gt = ins["GtBoxes"][0]
        valid = _valid_gt(gt, crowd)
        iou = _iou_matrix(rois, gt, normalized=False)
        marg = torch.argmax(torch.where(valid[:, None, :], iou,
                                        _const(iou, -1.0)), 2)
    else:
        marg = torch.zeros((b, r), dtype=torch.long, device=dev)
    segs = _take(segms, marg)                    # [B, R, Hm, Wm]
    x1, y1, x2, y2 = rois.unbind(-1)
    imh, imw = im_info[:, 0:1, None], im_info[:, 1:2, None]
    jj = (torch.arange(res, dtype=torch.float32, device=dev) + 0.5) / res
    u = x1[..., None] + jj * (x2 - x1)[..., None]        # [B, R, res]
    v = y1[..., None] + jj * (y2 - y1)[..., None]
    bu = torch.clamp(u / _max(imw, 1.0) * wm - 0.5, 0.0, wm - 1.0)
    bv = torch.clamp(v / _max(imh, 1.0) * hm - 0.5, 0.0, hm - 1.0)
    u0 = torch.floor(bu).to(torch.int32)
    v0 = torch.floor(bv).to(torch.int32)
    u1 = torch.clamp(u0 + 1, 0, wm - 1).long()
    v1 = torch.clamp(v0 + 1, 0, hm - 1).long()
    lu = (bu - u0)[:, :, None, :]                # [B, R, 1, res]
    lv = (bv - v0)[:, :, :, None]                # [B, R, res, 1]
    u0, v0 = u0.long(), v0.long()
    bi = torch.arange(b, device=dev)[:, None, None, None]
    ri = torch.arange(r, device=dev)[None, :, None, None]

    def at(vv, uu):
        return segs[bi, ri, vv[..., :, None], uu[..., None, :]].float()
    samp = (at(v0, u0) * (1 - lv) * (1 - lu) + at(v0, u1) * (1 - lv) * lu
            + at(v1, u0) * lv * (1 - lu) + at(v1, u1) * lv * lu)
    bin_m = (samp >= 0.5).to(torch.int32).reshape(b, r, 1, res * res)
    at_cls = torch.arange(num_classes, device=dev)[None, None, :, None] \
        == torch.clamp(labels, min=0)[..., None, None]
    full = torch.where(at_cls & fg[..., None, None], bin_m, -1)
    return {"MaskRois": [torch.where(fg[..., None], rois,
                                     _const(rois, 0.0)).reshape(-1, 4)],
            "RoiHasMaskInt32": [fg.to(torch.int32).reshape(-1, 1)],
            "MaskInt32": [full.reshape(b * r, num_classes * res * res)]}


# ---------------------------------------------------------------------------
# locality-aware NMS (EAST text detection): quad geometry, batched
# ---------------------------------------------------------------------------

_MAXV = 16   # the clip buffer: a 4-gon cut by 4 half-planes has <= 8 vertices


def _shoelace(pts, cnt):
    """Signed area of the first `cnt` vertices of pts [..., V, 2]."""
    v = pts.shape[-2]
    idx = torch.arange(v, device=pts.device)
    c = cnt[..., None]
    nxt = torch.where(idx + 1 >= c, 0, idx + 1)
    x, y = pts[..., 0], pts[..., 1]
    cross = x * torch.gather(y, -1, nxt) - torch.gather(x, -1, nxt) * y
    return 0.5 * torch.where(idx < c, cross, _const(cross, 0.0)).sum(-1)


def _clip_halfplane(pts, cnt, a, b):
    """One Sutherland-Hodgman step: the part of pts [..., V, 2] (`cnt`
    live vertices) left of the directed edge a -> b ([..., 2])."""
    v = pts.shape[-2]
    idx = torch.arange(v, device=pts.device)
    c = cnt[..., None]
    m = idx < c
    nxt = torch.where(idx + 1 >= c, 0, idx + 1)
    p = pts
    q = torch.gather(pts, -2, nxt[..., None].expand(pts.shape))
    d = b - a

    def side(x):
        return d[..., None, 0] * (x[..., 1] - a[..., None, 1]) \
            - d[..., None, 1] * (x[..., 0] - a[..., None, 0])
    sp, sq = side(p), side(q)
    in_p, in_q = sp >= 0, sq >= 0
    t = sp / torch.where(torch.abs(sp - sq) < 1e-12, _const(sp, 1e-12),
                         sp - sq)
    inter = p + t[..., None] * (q - p)
    emit1 = m & in_p                 # p if inside; the crossing if it flips
    emit2 = m & (in_p ^ in_q)
    cnt1 = torch.cumsum(emit1.to(torch.int32), -1)
    cnt2 = torch.cumsum(emit2.to(torch.int32), -1)
    before2 = torch.cat([torch.zeros_like(cnt2[..., :1]), cnt2[..., :-1]], -1)
    pos1 = torch.where(emit1, cnt1 - 1 + before2, _MAXV)
    pos2 = torch.where(emit2, cnt1 + cnt2 - 1, _MAXV)
    lead = pts.shape[:-2]
    out = pts.new_zeros(lead + (_MAXV + 1, 2))
    pos = torch.cat([pos1, pos2], -1).long()
    out = out.scatter(-2, pos[..., None].expand(lead + (2 * v, 2)),
                      torch.cat([p, inter], -2))
    return out[..., :_MAXV, :], cnt1[..., -1] + cnt2[..., -1]


def _padded(q):
    return torch.cat([q, q.new_zeros(q.shape[:-2] + (_MAXV - 4, 2))], -2)


def _quad_iou(q1, q2):
    """PolyIoU of quads q1, q2 [..., 4, 2]: q1 clipped by q2's 4 edges
    (both wound CCW by their signed area), the cut's shoelace area."""
    four = torch.full(q1.shape[:-2], 4, dtype=torch.int32, device=q1.device)

    def ccw(q):
        s = _shoelace(_padded(q), four)
        return torch.where((s < 0)[..., None, None], q.flip(-2), q)
    a, c = ccw(q1), ccw(q2)
    pts, cnt = _padded(a), four
    for e in range(4):
        pts, cnt = _clip_halfplane(pts, cnt, c[..., e, :],
                                   c[..., (e + 1) % 4, :])
    inter = torch.abs(_shoelace(pts, cnt))
    a1 = torch.abs(_shoelace(_padded(a), four))
    a2 = torch.abs(_shoelace(_padded(c), four))
    union = a1 + a2 - inter
    return torch.where(union > 1e-9, inter / union, _const(union, 0.0))


def _box_iou_pairs(b1, b2, normalized):
    off = 0.0 if normalized else 1.0
    ix = _max(torch.minimum(b1[..., 2], b2[..., 2])
              - torch.maximum(b1[..., 0], b2[..., 0]) + off, 0.0)
    iy = _max(torch.minimum(b1[..., 3], b2[..., 3])
              - torch.maximum(b1[..., 1], b2[..., 1]) + off, 0.0)
    inter = ix * iy
    a1 = (b1[..., 2] - b1[..., 0] + off) * (b1[..., 3] - b1[..., 1] + off)
    a2 = (b2[..., 2] - b2[..., 0] + off) * (b2[..., 3] - b2[..., 1] + off)
    return torch.where(a1 + a2 - inter > 1e-9, inter / (a1 + a2 - inter),
                       _const(inter, 0.0))


@register("locality_aware_nms", nondiff_slots=("BBoxes", "Scores"))
def _locality_aware_nms(ctx, ins, attrs):
    """locality_aware_nms_op.cc (EAST), every (image, class) row at once:
    pass 1 streams the boxes in input order and merges consecutive
    overlapping ones score-weighted (PolyWeightedMerge); pass 2 is greedy
    NMS over the merged set. [N * keep_top_k, 2 + box_size] rows (label,
    score, coords; padding score 0, label -1) and OutCount. Boxes of 4
    (rects) or 8 (quads, polygon IoU by Sutherland-Hodgman clipping)."""
    boxes = _batched(ins["BBoxes"][0], 3)        # [N, M, K]
    scores = _batched(ins["Scores"][0], 3)       # [N, C, M]
    n, m, k = boxes.shape
    c = scores.shape[1]
    if k not in (4, 8):
        raise NotImplementedError(
            f"locality_aware_nms: box_size {k} (4 and 8 supported; the "
            f"reference's 16/24/32-point variants are out of scope)")
    score_thresh = float(attrs.get("score_threshold", 0.0))
    nms_thresh = float(attrs.get("nms_threshold", 0.3))
    nms_top_k = int(attrs.get("nms_top_k", -1))
    keep_top_k = int(attrs.get("keep_top_k", -1))
    bg = int(attrs.get("background_label", -1))
    normalized = bool(attrs.get("normalized", True))
    if keep_top_k <= 0:
        keep_top_k = m
    top_k = m if nms_top_k <= 0 else min(nms_top_k, m)
    dev = boxes.device

    def iou_pairs(b1, b2):
        if k == 4:
            return _box_iou_pairs(b1, b2, normalized)
        return _quad_iou(b1.reshape(b1.shape[:-1] + (4, 2)),
                         b2.reshape(b2.shape[:-1] + (4, 2)))

    classes = [ci for ci in range(c) if ci != bg]
    cc = len(classes)
    sc = torch.cat([scores[:, ci:ci + 1] for ci in classes], 1)  # [N, C', M]
    rows = n * cc
    bx = boxes[:, None].expand(n, cc, m, k).reshape(rows, m, k)
    sc = sc.reshape(rows, m)

    # pass 1: carry the open (box, score); emit it when the next box stops
    # overlapping it
    cur_b = bx.new_zeros((rows, k))
    cur_s = sc.new_zeros((rows,))
    started = torch.zeros((rows,), dtype=torch.bool, device=dev)
    eb, es = [], []
    for i in range(m):
        b_i, s_i = bx[:, i], sc[:, i]
        do_merge = started & (iou_pairs(b_i, cur_b) > nms_thresh)
        tot = cur_s + s_i
        merged = (b_i * s_i[:, None] + cur_b * cur_s[:, None]) \
            / _max(tot, 1e-12)[:, None]
        eb.append(torch.where(do_merge[:, None], _const(cur_b, 0.0), cur_b))
        es.append(torch.where(do_merge | ~started, _const(cur_s, 0.0), cur_s))
        cur_b = torch.where(do_merge[:, None], merged, b_i)
        cur_s = torch.where(do_merge, tot, s_i)
        started = torch.ones_like(started)
    eb.append(cur_b)
    es.append(torch.where(started, cur_s, _const(cur_s, 0.0)))
    eb = torch.stack(eb, 1)                      # [rows, M+1, K]
    es = torch.stack(es, 1)

    # pass 2: greedy NMS over the merged set
    order = torch.argsort(-es, dim=1, stable=True)[:, :top_k]
    rr = _rows(rows, dev)
    bo, so = eb[rr, order], es[rr, order]
    t = bo.shape[1]
    if k == 4:
        off = 0.0 if normalized else 1.0
        x1 = torch.maximum(bo[:, :, None, 0], bo[:, None, :, 0])
        y1 = torch.maximum(bo[:, :, None, 1], bo[:, None, :, 1])
        x2 = torch.minimum(bo[:, :, None, 2], bo[:, None, :, 2])
        y2 = torch.minimum(bo[:, :, None, 3], bo[:, None, :, 3])
        inter = _max(x2 - x1 + off, 0.0) * _max(y2 - y1 + off, 0.0)
        ar = (bo[..., 2] - bo[..., 0] + off) * (bo[..., 3] - bo[..., 1] + off)
        iou = inter / _max(ar[:, :, None] + ar[:, None, :] - inter, 1e-9)
    else:
        iou = _quad_iou(bo[:, :, None].expand(rows, t, t, k).reshape(
            rows, t, t, 4, 2), bo[:, None].expand(rows, t, t, k).reshape(
            rows, t, t, 4, 2))                   # [rows, t, t]
    col = torch.arange(t, device=dev)
    keep = so > max(score_thresh, 0.0)
    for i in range(t):
        sup = keep & (iou[:, i] > nms_thresh) & (col > i) & keep[:, i:i + 1]
        keep = keep & ~sup
    so = torch.where(keep, so, _const(so, 0.0))
    lab = torch.cat([torch.full((n, 1, t), ci, dtype=torch.int32,
                                device=dev) for ci in classes], 1)
    ab = bo.reshape(n, cc * t, k)
    asc = so.reshape(n, cc * t)
    al = lab.reshape(n, cc * t)
    top = torch.argsort(-asc, dim=1, stable=True)[:, :keep_top_k]
    nr = _rows(n, dev)
    sc_k = asc[nr, top]
    row = torch.cat([torch.where(sc_k > 0, al[nr, top], -1).to(ab.dtype)
                     [..., None], sc_k[..., None], ab[nr, top]], -1)
    return {"Out": [row.reshape(-1, 2 + k)],
            "OutCount": [(sc_k > 0).sum(1).to(torch.int32)]}


@register("roi_perspective_transform",
          nondiff_slots=("ROIs", "RoisNum"))
def _roi_perspective_transform(ctx, ins, attrs):
    """roi_perspective_transform_op.cc (OCR rectification): each quad ROI
    warped to a transformed_height x transformed_width rect by the
    homography taking the rect's corners to the quad's (an 8 x 8 solve a
    roi, batched), X sampled bilinearly along it; Mask marks in-bounds
    samples. Out2InIdx / Out2InWeights (the CUDA backward's scratch) are
    not emitted."""
    from .tail_ops import _roi_batch_index
    x = ins["X"][0]                              # [N, C, H, W]
    rois = ins["ROIs"][0]                        # [R, 8] quads
    ss = float(attrs.get("spatial_scale", 1.0))
    th = int(attrs.get("transformed_height", 1))
    tw = int(attrs.get("transformed_width", 1))
    n, c, h, w = x.shape
    r = rois.shape[0]
    dev = x.device
    bids = _roi_batch_index(ins, r, n, dev).long()
    quad = rois.reshape(r, 4, 2) * ss
    rect = ((0.0, 0.0), (tw - 1.0, 0.0), (tw - 1.0, th - 1.0),
            (0.0, th - 1.0))
    # H maps (u, v, 1) to (x, y): rows [u v 1 0 0 0 -ux -vx] h = x, ...
    zero = quad.new_zeros((r,))
    one = zero + 1.0
    rows, rhs = [], []
    for p, (u, v) in enumerate(rect):
        xq, yq = quad[:, p, 0], quad[:, p, 1]
        rows.append(torch.stack([zero + u, zero + v, one, zero, zero, zero,
                                 -u * xq, -v * xq], -1))
        rows.append(torch.stack([zero, zero, zero, zero + u, zero + v, one,
                                 -u * yq, -v * yq], -1))
        rhs += [xq, yq]
    a = torch.stack(rows, 1)                     # [R, 8, 8]
    eye = torch.eye(8, dtype=a.dtype, device=dev)
    sol = torch.linalg.solve(a + 1e-9 * eye, torch.stack(rhs, 1))
    hmats = torch.cat([sol, one[:, None]], 1)    # [R, 9]
    vv, uu = torch.meshgrid(torch.arange(th, dtype=torch.float32, device=dev),
                            torch.arange(tw, dtype=torch.float32, device=dev),
                            indexing="ij")
    grid = torch.stack([uu, vv, torch.ones_like(uu)], 0).reshape(3, th * tw)
    xy = torch.einsum("rij,jp->rip", hmats.reshape(r, 3, 3), grid)
    den = torch.where(torch.abs(xy[:, 2]) < 1e-9, _const(xy, 1e-9), xy[:, 2])
    xs, ys = xy[:, 0] / den, xy[:, 1] / den
    inb = (xs >= -0.5) & (xs <= w - 0.5) & (ys >= -0.5) & (ys <= h - 0.5)
    xc = torch.clamp(xs, 0.0, w - 1.0)
    yc = torch.clamp(ys, 0.0, h - 1.0)
    x0 = torch.floor(xc).to(torch.int32)
    y0 = torch.floor(yc).to(torch.int32)
    x1 = torch.clamp(x0 + 1, 0, w - 1).long()
    y1 = torch.clamp(y0 + 1, 0, h - 1).long()
    lx = (xc - x0)[:, None, :]
    ly = (yc - y0)[:, None, :]
    x0, y0 = x0.long(), y0.long()
    ri = bids[:, None, None]
    ci = torch.arange(c, device=dev)[None, :, None]

    def at(yy, xx):
        return x[ri, ci, yy[:, None, :], xx[:, None, :]]
    out = (at(y0, x0) * (1 - ly) * (1 - lx) + at(y0, x1) * (1 - ly) * lx
           + at(y1, x0) * ly * (1 - lx) + at(y1, x1) * ly * lx)
    out = torch.where(inb[:, None, :], out, _const(out, 0.0))
    return {"Out": [out.reshape(r, c, th, tw)],
            "Mask": [inb.to(torch.int32).reshape(r, 1, th, tw)],
            "TransformMatrix": [hmats], "Out2InIdx": [None],
            "Out2InWeights": [None]}


@register("ssd_loss", is_random=False,
          nondiff_slots=("GtBox", "GtLabel", "PriorBox", "PriorBoxVar"))
def _ssd_loss(ctx, ins, attrs):
    """The reference's 8-op composition (python/paddle/fluid/layers/
    detection.py:1517: iou_similarity, bipartite_match, target_assign,
    mine_hard_examples, smooth_l1 and softmax CE) as one lowering over
    every image: bipartite matching (then per-prediction), hard negatives
    at neg_pos_ratio by the conf loss, encode_center_size targets with
    the prior variances, the conf CE over the matched and the mined, each
    image's loss over its matched count. Zero-area truths are padding.
    [B, 1]."""
    if attrs.get("mining_type", "max_negative") != "max_negative":
        raise NotImplementedError("ssd_loss: max_negative mining only "
                                  "(sample_size is a hard_example knob)")
    loc = ins["Location"][0]                     # [B, P, 4]
    conf = ins["Confidence"][0]                  # [B, P, C]
    gt_box = ins["GtBox"][0]                     # [B, G, 4]
    gt_lbl = ins["GtLabel"][0]                   # [B, G, 1] or [B, G]
    prior = ins["PriorBox"][0].reshape(-1, 4)    # [P, 4]
    pvar_in = ins.get("PriorBoxVar", [None])[0]
    pvar = _vec((0.1, 0.1, 0.2, 0.2), prior.dtype, prior.device)[None] \
        * torch.ones_like(prior) if pvar_in is None \
        else pvar_in.reshape(-1, 4)
    overlap_t = float(attrs.get("overlap_threshold", 0.5))
    neg_overlap = float(attrs.get("neg_overlap", 0.5))
    ratio = float(attrs.get("neg_pos_ratio", 3.0))
    loc_w = float(attrs.get("loc_loss_weight", 1.0))
    conf_w = float(attrs.get("conf_loss_weight", 1.0))
    bg_label = int(attrs.get("background_label", 0))
    b, p, _ = conf.shape
    dev = conf.device
    gt_lbl = gt_lbl.reshape(b, -1)
    valid = _valid_gt(gt_box, None)                      # [B, G]
    iou = torch.where(valid[:, :, None], _iou_matrix(gt_box, prior[None]),
                      _const(prior, -1.0))               # [B, G, P]
    match, mdist = _bipartite_rows(
        torch.where(iou < 0, _const(iou, 0.0), iou),
        attrs.get("match_type", "per_prediction"), overlap_t)
    matched = match >= 0
    safe = torch.clamp(match, min=0).long()
    rows = _rows(b, dev)
    tgt_lbl = torch.where(matched, gt_lbl[rows, safe].to(torch.int32),
                          bg_label).long()
    logp = torch.log_softmax(conf.float(), -1)
    ce = -logp[rows, torch.arange(p, device=dev)[None], tgt_lbl]   # [B, P]

    # hard negatives by the conf loss, highest first
    is_neg = ~matched & (mdist < neg_overlap)
    n_pos = matched.sum(1, keepdim=True).to(torch.int32)
    n_neg = torch.minimum((n_pos.float() * ratio).to(torch.int32),
                          is_neg.sum(1, keepdim=True).to(torch.int32))
    neg_keep = is_neg & (_rank_among(is_neg, -ce.detach()) < n_neg)

    # loc targets: encode_center_size(truth, prior) over the variances
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = prior[:, 0] + 0.5 * pw
    pcy = prior[:, 1] + 0.5 * ph
    gtm = gt_box[rows, safe]                             # [B, P, 4]
    gw = gtm[..., 2] - gtm[..., 0]
    gh = gtm[..., 3] - gtm[..., 1]
    gcx = gtm[..., 0] + 0.5 * gw
    gcy = gtm[..., 1] + 0.5 * gh
    pw_s, ph_s = _max(pw, 1e-6), _max(ph, 1e-6)
    tloc = torch.stack([(gcx - pcx) / pw_s / pvar[:, 0],
                        (gcy - pcy) / ph_s / pvar[:, 1],
                        torch.log(_max(gw, 1e-6) / pw_s) / pvar[:, 2],
                        torch.log(_max(gh, 1e-6) / ph_s) / pvar[:, 3]], -1)
    diff = torch.abs(loc.float() - tloc)
    sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).sum(-1)
    zero = _const(sl1, 0.0)
    loc_loss = torch.where(matched, sl1, zero).sum(1)
    conf_loss = torch.where(matched | neg_keep, ce, zero).sum(1)
    total = loc_w * loc_loss + conf_w * conf_loss
    if attrs.get("normalize", True):     # over the matched-prior count
        total = total / _max(n_pos[:, 0].float(), 1.0)
    return {"Loss": [total[:, None]]}


# ---------------------------------------------------------------------------
# Build-time shapes of the ops above and of two of ops/detection_ops.py
# (each op's InferShape in the reference): set from attrs and static dims,
# so no lowering runs at build time at the sentinel batch.
# ---------------------------------------------------------------------------

def _mk_infer(rules):
    """rules: [(slot, shape_fn(block, op) -> shape, dtype)]."""
    def infer(block, op):
        for slot, shape_fn, dtype in rules:
            for nme in op.outputs.get(slot, []):
                if nme == "@EMPTY@":
                    continue
                v = block.find_var_recursive(nme)
                if v is None:
                    continue
                try:
                    v.shape = tuple(shape_fn(block, op))
                    v.dtype = convert_dtype(dtype)
                except Exception:
                    pass
        block.program.bump_version()
    return infer


def _in_shape(block, op, slot):
    return tuple(block.var(op.inputs[slot][0]).shape)


def _anchor_count(block, op):
    tot = 1
    for d in _in_shape(block, op, "Anchor"):
        tot *= d
    return tot // 4


def _attach_detection_infers():
    def per_anchor(width, dtype="float32"):
        return lambda b, o: (-1, _anchor_count(b, o), width)

    def by_classes(b, o):
        return (-1, 4 * int(o.attrs.get("class_nums", 2)))

    rules = {
        "rpn_target_assign": [
            ("TargetLabel", per_anchor(1), "float32"),
            ("ScoreWeight", per_anchor(1), "float32"),
            ("TargetBBox", per_anchor(4), "float32"),
            ("BBoxInsideWeight", per_anchor(4), "float32")],
        "retinanet_target_assign": [
            ("TargetLabel", per_anchor(1), "int32"),
            ("ScoreWeight", per_anchor(1), "float32"),
            ("TargetBBox", per_anchor(4), "float32"),
            ("BBoxInsideWeight", per_anchor(4), "float32"),
            ("ForegroundNumber", lambda b, o: (-1, 1), "int32")],
        "generate_proposal_labels": [
            ("Rois", lambda b, o: (-1, 4), "float32"),
            ("LabelsInt32", lambda b, o: (-1, 1), "int32"),
            ("BboxTargets", by_classes, "float32"),
            ("BboxInsideWeights", by_classes, "float32"),
            ("BboxOutsideWeights", by_classes, "float32"),
            ("RoisNum", lambda b, o: (-1,), "int32"),
            ("RoiWeights", lambda b, o: (-1, 1), "float32")],
        "generate_mask_labels": [
            ("MaskRois", lambda b, o: (-1, 4), "float32"),
            ("RoiHasMaskInt32", lambda b, o: (-1, 1), "int32"),
            ("MaskInt32", lambda b, o: (-1, int(o.attrs["num_classes"])
                                        * int(o.attrs["resolution"]) ** 2),
             "int32")],
        "locality_aware_nms": [
            ("Out", lambda b, o: (-1, 2 + _in_shape(b, o, "BBoxes")[-1]),
             "float32"),
            ("OutCount", lambda b, o: (-1,), "int32")],
        "ssd_loss": [("Loss", lambda b, o: (-1, 1), "float32")],
        "generate_proposals": [
            ("RpnRois", lambda b, o: (-1, 4), "float32"),
            ("RpnRoiProbs", lambda b, o: (-1, 1), "float32"),
            ("RpnRoisNum", lambda b, o: (-1,), "int32")],
        "multiclass_nms": [
            ("Out", lambda b, o: (-1, 6), "float32"),
            ("NmsRoisNum", lambda b, o: (-1,), "int32"),
            ("Index", lambda b, o: (-1, 1), "int32")],
    }
    for op_type, rule in rules.items():
        _REGISTRY[op_type].infer = _mk_infer(rule)


_attach_detection_infers()
