"""The dense tail, part 2 (counterpart of paddle_tpu/ops/dense_tail_ops2.py):
the vision and CTR structural types, every one of the reference file's 12
in its order, with its flags. Padded tensors and length vectors stand for
LoD, as in the reference. Each is differentiated by the generic
`__vjp__` (`torch.func.vjp` over the lowering).

Where the reference's arithmetic is not torch's nearest function, it is
written out:

* `spp` pools each bin of its pyramid over the reference's window (rows
  floor(i h / bins) to ceil((i + 1) h / bins), the edges of adaptive
  pooling) by `amax` / `mean` of a slice, whose pullbacks split a tie and
  add no atomics, where adaptive pooling's backward adds atomically.
* `similarity_focus` is greedy in descending order of a slice's values:
  an element is marked when neither its row nor its column is taken yet.
  That is the same as taking, min(M, N) times, the free element that
  comes first in the stable descending order, which is one masked
  `argmin` over every slice of the batch a round.
* `correlation` shifts the second map with `torch.roll`, which wraps at
  the border as the reference's `jnp.roll`, and box-filters by a SAME
  convolution with zero padding (low (k - 1) // 2, high the rest).
* `pyramid_hash` hashes each n-gram by FNV-1a in uint32 that wraps,
  emulated in int64 with `& 0xFFFFFFFF` after each step (`_mul32`), then
  takes `% space_len`. Its training dropout draws on the device from the
  op's key (`ops/tensor_ops.py` `_random_bits`), as `tdm_sampler`'s
  negatives do: a captured step draws anew on each replay.
* `detection_map` matches greedily per class and image in score order:
  one loop over the K detections with every (class, image) pair at once.
* Gathers that a gradient passes through are advanced indexing, whose
  pullback is `index_put(accumulate=True)` (on CUDA the sort-based
  kernel, no atomics), not `torch.gather` (atomic adds).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .dense_tail_ops import _lengths
from .extra_ops import _max
from .kernels.flash_attention import _U32, _mul32
from .math_ops import _clip
from .registry import register
from .tail_ops import _bilinear_at, _roi_batch_index
from .tensor_ops import _random_bits, _uniform01


@register("spp")
def _spp(ctx, ins, attrs):
    """Spatial pyramid pooling: level l pools an adaptive 2^l x 2^l grid;
    the levels flatten and concatenate to [N, C * sum(4^l)]."""
    x = ins["X"][0]                              # [N, C, H, W]
    levels = int(attrs.get("pyramid_height", 1))
    use_max = attrs.get("pooling_type", "max") == "max"
    n, c, h, w = x.shape
    outs = []
    for lv in range(levels):
        bins = 2 ** lv
        hs = [(i * h) // bins for i in range(bins)]
        he = [-(-(i + 1) * h // bins) for i in range(bins)]
        ws = [(j * w) // bins for j in range(bins)]
        we = [-(-(j + 1) * w // bins) for j in range(bins)]
        cells = []
        for i in range(bins):
            for j in range(bins):
                win = x[:, :, hs[i]:he[i], ws[j]:we[j]]
                cells.append(win.amax(dim=(2, 3)) if use_max
                             else win.mean(dim=(2, 3)))
        outs.append(torch.stack(cells, dim=-1).reshape(n, c * bins * bins))
    return {"Out": [torch.cat(outs, dim=1)]}


def _one_hot(idx, n):
    """idx == range(n) along a new last dim (F.one_hot checks its range
    on the host)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


@register("similarity_focus", nondiff_slots=("X",))
def _similarity_focus(ctx, ins, attrs):
    """For each chosen slice along `axis`, walk its elements in descending
    order and mark an element's whole fiber along `axis` with 1 when
    neither its row nor its column is taken yet (module docstring)."""
    x = ins["X"][0]                              # [B, d1, d2, d3]
    axis = int(attrs.get("axis", 1))
    indexes = [int(i) for i in attrs.get("indexes", [0])]
    perm = [0, axis] + [d for d in (1, 2, 3) if d != axis]
    xc = x.permute(perm)                         # [B, A, M, N]
    b, _, m, n2 = xc.shape
    dev = x.device
    flat_idx = torch.arange(m * n2, device=dev)
    res = torch.zeros(xc.shape, dtype=torch.float32, device=dev)
    big = torch.full((), m * n2, dtype=torch.long, device=dev)
    for idx in indexes:
        sl = xc[:, idx].reshape(b, m * n2)
        order = torch.sort(-sl, dim=1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            1, order, flat_idx.expand(b, -1).contiguous())
        row_t = torch.zeros((b, m), dtype=torch.bool, device=dev)
        col_t = torch.zeros((b, n2), dtype=torch.bool, device=dev)
        marks = torch.zeros((b, m * n2), dtype=torch.float32, device=dev)
        for _ in range(min(m, n2)):
            free = ~(row_t[:, :, None] | col_t[:, None, :]).reshape(b, -1)
            e = torch.where(free, rank, big).argmin(dim=1)
            marks = torch.maximum(marks, _one_hot(e, m * n2).float())
            row_t = row_t | _one_hot(e // n2, m)
            col_t = col_t | _one_hot(e % n2, n2)
        res = torch.maximum(res, marks.reshape(b, 1, m, n2))
    inv = np.argsort(perm).tolist()
    return {"Out": [res.permute(inv).to(x.dtype)]}


@register("correlation")
def _correlation(ctx, ins, attrs):
    """FlowNet's cost volume: out[n, q, y, x] = the mean over channels and
    the kernel window of x1[p] x2[p + d_q], displacements on a stride2 grid
    within +-max_displacement (module docstring)."""
    x1 = ins["Input1"][0].float()
    x2 = ins["Input2"][0].float()
    pad = int(attrs.get("pad_size", 0))
    ksize = int(attrs.get("kernel_size", 1))
    maxd = int(attrs.get("max_displacement", 1))
    s1 = int(attrs.get("stride1", 1))
    s2 = int(attrs.get("stride2", 1))
    n, c, h, w = x1.shape
    p1 = F.pad(x1, (pad, pad, pad, pad))
    p2 = F.pad(x2, (pad, pad, pad, pad))
    d_r = maxd // s2
    krad = (ksize - 1) // 2
    ph, pw = h + 2 * pad, w + 2 * pad
    lo, hi = (ksize - 1) // 2, ksize - 1 - (ksize - 1) // 2
    kern = torch.full((1, 1, ksize, ksize), 1.0 / (ksize * ksize),
                      device=x1.device)
    y0, y1 = maxd + krad, ph - maxd - krad
    xa, xb = maxd + krad, pw - maxd - krad
    outs = []
    for dy in range(-d_r * s2, d_r * s2 + 1, s2):
        for dx in range(-d_r * s2, d_r * s2 + 1, s2):
            prod = p1 * torch.roll(p2, shifts=(-dy, -dx), dims=(2, 3))
            if ksize > 1:
                prod = F.conv2d(F.pad(prod.reshape(n * c, 1, ph, pw),
                                      (lo, hi, lo, hi)),
                                kern).reshape(n, c, ph, pw)
            cm = prod.mean(dim=1)
            outs.append(cm[:, y0:max(y1, y0):s1, xa:max(xb, xa):s1])
    return {"Output": [torch.stack(outs, dim=1)]}


@register("bilateral_slice", nondiff_slots=())
def _bilateral_slice(ctx, ins, attrs):
    """HDRNet's slice: each pixel samples the bilateral grid trilinearly
    at (x, y, guide) (corners clamped to the grid) for local affine
    coefficients, applied to X's channels (plus an offset)."""
    x = ins["X"][0].float()                      # [N, Ci, H, W]
    grid = ins["Grid"][0].float()                # [N, Cf, GD, GH, GW]
    guide = ins["Guide"][0].float()              # [N, H, W]
    has_offset = bool(attrs.get("has_offset", False))
    n, ci, h, w = x.shape
    cf, gd, gh, gw = grid.shape[1:]
    co = cf // (ci + 1) if has_offset else cf // ci
    dev = x.device
    gx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w * gw \
        - 0.5
    gy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h * gh \
        - 0.5
    gz = guide * gd - 0.5                        # [N, H, W]
    x0 = torch.clamp(torch.floor(gx).long(), 0, gw - 1)
    x1 = torch.clamp(x0 + 1, 0, gw - 1)
    y0 = torch.clamp(torch.floor(gy).long(), 0, gh - 1)
    y1 = torch.clamp(y0 + 1, 0, gh - 1)
    z0 = torch.clamp(torch.floor(gz).long(), 0, gd - 1)
    z1 = torch.clamp(z0 + 1, 0, gd - 1)
    fx = _clip(gx - x0, 0.0, 1.0)[None, None, :]      # [1, 1, W]
    fy = _clip(gy - y0, 0.0, 1.0)[None, :, None]      # [1, H, 1]
    fz = _clip(gz - z0, 0.0, 1.0)                     # [N, H, W]
    flat = grid.reshape(n, cf, gd * gh * gw).transpose(1, 2)   # [N, G, Cf]
    rows = torch.arange(n, device=dev).reshape(n, 1)
    out = 0.0
    for zi, wz in ((z0, 1.0 - fz), (z1, fz)):
        for yi, wy in ((y0, 1.0 - fy), (y1, fy)):
            for xi, wx in ((x0, 1.0 - fx), (x1, fx)):
                cell = (zi * gh + yi[None, :, None]) * gw + xi[None, None, :]
                g = flat[rows, cell.reshape(n, -1)]            # [N, HW, Cf]
                g = g.transpose(1, 2).reshape(n, cf, h, w)
                out = out + g * (wz * wy * wx)[:, None]
    if has_offset:
        cc = out.reshape(n, co, ci + 1, h, w)
        res = torch.einsum("noihw,nihw->nohw", cc[:, :, :ci], x) \
            + cc[:, :, ci]
    else:
        res = torch.einsum("noihw,nihw->nohw",
                           out.reshape(n, co, ci, h, w), x)
    return {"Out": [res]}


@register("deformable_psroi_pooling", nondiff_slots=("ROIs", "RoisNum"))
def _deformable_psroi_pooling(ctx, ins, attrs):
    """Position-sensitive ROI pooling whose bins shift by learned
    normalised offsets (Trans); each bin averages the sample_per_part^2
    bilinear samples inside the image (`ops/tail_ops.py` `_bilinear_at` at
    the coordinates clamped into it); TopCount is that number."""
    x = ins["Input"][0].float()                  # [N, C, H, W]
    rois = ins["ROIs"][0]                        # [R, 4]
    trans = ins.get("Trans", [None])[0]          # [R, 2, part_h, part_w]
    no_trans = bool(attrs.get("no_trans", trans is None)) or trans is None
    ss = float(attrs.get("spatial_scale", 1.0))
    out_dim = int(attrs.get("output_dim", 1))
    group = attrs.get("group_size", [1, 1])
    gh, gw = (int(group[0]), int(group[1])) if hasattr(group, "__len__") \
        else (int(group), int(group))
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    part = attrs.get("part_size", [ph, pw])
    part_h, part_w = (int(part[0]), int(part[1])) if hasattr(
        part, "__len__") and len(part) else (ph, pw)
    spp_ = max(int(attrs.get("sample_per_part", 1)), 1)
    tstd = float(attrs.get("trans_std", 0.1))
    n, c, h, w = x.shape
    r = rois.shape[0]
    dev = x.device
    bids = _roi_batch_index(ins, r, n, dev).long()
    x1 = rois[:, 0] * ss - 0.5
    y1 = rois[:, 1] * ss - 0.5
    rw = _max((rois[:, 2] + 1.0) * ss - 0.5 - x1, 0.1)
    rh = _max((rois[:, 3] + 1.0) * ss - 0.5 - y1, 0.1)
    bin_w = (rw / pw)[:, None, None]
    bin_h = (rh / ph)[:, None, None]
    x1, y1 = x1[:, None, None], y1[:, None, None]
    samp = torch.arange(spp_, dtype=torch.float32, device=dev) + 0.5
    iy, ix = samp[None, :, None], samp[None, None, :]
    vals, cnts = [], []
    for i in range(ph):
        for j in range(pw):
            pint_h = min(i * part_h // ph, part_h - 1)
            pint_w = min(j * part_w // pw, part_w - 1)
            if no_trans:
                off_x = off_y = 0.0
            else:
                off_x = (trans[:, 0, pint_h, pint_w] * tstd
                         * rw)[:, None, None]
                off_y = (trans[:, 1, pint_h, pint_w] * tstd
                         * rh)[:, None, None]
            sx = x1 + j * bin_w + ix * bin_w / spp_ + off_x   # [R, s, s]
            sy = y1 + i * bin_h + iy * bin_h / spp_ + off_y
            sy, sx = torch.broadcast_tensors(sy, sx)
            inb = (sx > -0.5) & (sx < w - 0.5) & (sy > -0.5) & (sy < h - 0.5)
            gi = min(i * gh // ph, gh - 1)
            gj = min(j * gw // pw, gw - 1)
            chan = (torch.arange(out_dim, device=dev) * gh + gi) * gw + gj
            feat = x[bids[:, None], chan[None, :]]           # [R, O, H, W]
            v = _bilinear_at(feat, _clip(sy, 0.0, h - 1.0),
                             _clip(sx, 0.0, w - 1.0))        # [R, O, s, s]
            acc = torch.where(inb[:, None], v, 0.0).sum(dim=(2, 3))
            ok = inb.float().sum(dim=(1, 2))[:, None]        # [R, 1]
            vals.append(acc / _max(ok, 1.0))
            cnts.append(ok.expand(r, out_dim))
    out = torch.stack(vals, dim=-1).reshape(r, out_dim, ph, pw)
    cnt = torch.stack(cnts, dim=-1).reshape(r, out_dim, ph, pw)
    return {"Output": [out], "TopCount": [cnt]}


# ---------------------------------------------------------------------------
# TDM (tree-based deep match, CTR retrieval)
# ---------------------------------------------------------------------------

@register("tdm_child", nondiff_slots=("X", "TreeInfo"))
def _tdm_child(ctx, ins, attrs):
    """TreeInfo rows are [item_id, layer_id, ancestor_id, child_0 ..
    child_{child_nums-1}]; node 0 and childless nodes give zeros;
    LeafMask marks the children that are items (item_id != 0)."""
    x = ins["X"][0].long()
    info = ins["TreeInfo"][0].long()             # [nodes, 3 + child_nums]
    child_nums = int(attrs.get("child_nums", 1))
    shp = tuple(x.shape)
    flat = x.reshape(-1)
    has_child = ((flat != 0) & (info[flat, 3] != 0))[:, None]
    zero = torch.zeros((), dtype=torch.long, device=x.device)
    children = torch.where(has_child, info[flat, 3:3 + child_nums], zero)
    leaf = torch.where(has_child, (info[children, 0] != 0).long(), zero)
    return {"Child": [children.reshape(shp + (child_nums,)).int()],
            "LeafMask": [leaf.reshape(shp + (child_nums,)).int()]}


@register("tdm_sampler", is_random=True,
          nondiff_slots=("X", "Travel", "Layer"))
def _tdm_sampler(ctx, ins, attrs):
    """Per input item and tree layer: the positive node of its Travel
    path and `neg_num` negatives drawn (the op's bits, stream = the layer)
    from that layer's node list; a negative equal to the positive moves to
    the next slot, (draw + 1) % width. Each layer gives [pos?, negs] with
    labels 1 / 0, and a zero mask where the path is padding (node 0)."""
    x = ins["X"][0].long().reshape(-1)
    travel = ins["Travel"][0].long()             # [items, L]
    layer = ins["Layer"][0].long().reshape(-1)   # every layer's nodes
    neg_nums = [int(v) for v in attrs.get("neg_samples_num_list", [1])]
    offsets = [int(v) for v in attrs.get("layer_offset_lod",
                                         [0, layer.shape[0]])]
    out_pos = bool(attrs.get("output_positive", True))
    n = x.shape[0]
    dev = x.device
    zero = torch.zeros((), dtype=torch.long, device=dev)
    path = travel[x]                             # [N, L]
    outs, labels, masks = [], [], []
    for li, neg in enumerate(neg_nums):
        lo, hi = offsets[li], offsets[li + 1]
        width = max(hi - lo, 1)
        pos = path[:, li]
        alive = (pos != 0)[:, None]
        draw = _random_bits(ctx, attrs, (n, neg), li).to(dev) % width
        draw = torch.where(layer[lo + draw] == pos[:, None],
                           (draw + 1) % width, draw)
        negs = layer[lo + draw]
        if out_pos:
            o = torch.cat([pos[:, None], negs], dim=1)
            lab = torch.cat([torch.ones((n, 1), dtype=torch.long,
                                        device=dev),
                             torch.zeros((n, neg), dtype=torch.long,
                                         device=dev)], dim=1)
        else:
            o = negs
            lab = torch.zeros((n, neg), dtype=torch.long, device=dev)
        outs.append(torch.where(alive, o, zero))
        labels.append(torch.where(alive, lab, zero))
        masks.append(alive.long().expand(o.shape))
    return {"Out": [torch.cat(outs, dim=1)[..., None].int()],
            "Labels": [torch.cat(labels, dim=1)[..., None].int()],
            "Mask": [torch.cat(masks, dim=1)[..., None].int()]}


# ---------------------------------------------------------------------------
# text-matching CTR ops
# ---------------------------------------------------------------------------

def _fnv1a(tokens):
    """FNV-1a over the last dim of int64 tokens, in uint32 that wraps
    (int64 masked to 32 bits after each step)."""
    h = torch.full(tokens.shape[:-1], 0x811C9DC5, dtype=torch.long,
                   device=tokens.device)
    for i in range(tokens.shape[-1]):
        h = _mul32(h ^ (tokens[..., i] & _U32), 0x01000193)
    return h


@register("pyramid_hash", is_random=True, nondiff_slots=("X",))
def _pyramid_hash(ctx, ins, attrs):
    """Every n-gram window of length 2..pyramid_layer hashes (FNV-1a) into
    W's space_len rows; a window's embedding is its row over sqrt(length);
    Out sums a sequence's live windows. In training, `drop_out_percent`
    drops windows by the op's bits (module docstring). The white and black
    lists are host data preparation, as in the reference."""
    x = ins["X"][0].long()                       # [B, T]
    if x.dim() == 1:
        x = x[None]
    w = ins["W"][0]                              # [space_len, num_emb]
    num_emb = int(attrs.get("num_emb", w.shape[-1]))
    space = int(attrs.get("space_len", w.shape[0]))
    pyramid = max(int(attrs.get("pyramid_layer", 2)), 2)
    drop = float(attrs.get("drop_out_percent", 0.0))
    training = bool(attrs.get("is_training", 0))
    b, t = x.shape
    dev = x.device
    lens = _lengths(ins.get("SeqLen", [None])[0], b, t, dev)
    out = torch.zeros((b, num_emb), dtype=torch.float32, device=dev)
    for ln in range(2, pyramid + 1):
        if t < ln:
            break
        windows = torch.stack([x[:, i:t - ln + 1 + i] for i in range(ln)],
                              dim=-1)            # [B, T-l+1, l]
        hidx = _fnv1a(windows) % space
        emb = w[hidx] / float(np.float32(np.sqrt(ln)))
        live = (torch.arange(t - ln + 1, device=dev)[None, :] + ln) \
            <= lens[:, None]
        if training and drop > 0.0:
            u = _uniform01(_random_bits(ctx, attrs, live.shape, ln))
            live = live & (u.to(dev) >= drop)
        out = out + torch.where(live[..., None], emb, 0.0).sum(dim=1)
    return {"Out": [out]}


@register("var_conv_2d", nondiff_slots=("ROW", "COLUMN"))
def _var_conv_2d(ctx, ins, attrs):
    """A per-sample variable-size 2-D convolution over padded maps: one
    batched convolution (cuDNN), then the positions outside a sample's own
    ceil(row / stride) x ceil(col / stride) window are zeroed."""
    x = ins["X"][0].float()                      # [B, C, H, W]
    rows = ins["ROW"][0].reshape(-1).long()
    cols = ins["COLUMN"][0].reshape(-1).long()
    w = ins["W"][0].float()                      # [OutC, InC * KH * KW]
    ic = int(attrs.get("InputChannel", x.shape[1]))
    oc = int(attrs.get("OutputChannel", 1))
    kh = int(attrs.get("KernelH", 1))
    kw = int(attrs.get("KernelW", 1))
    sh = int(attrs.get("StrideH", 1))
    sw = int(attrs.get("StrideW", 1))
    out = F.conv2d(x, w.reshape(oc, ic, kh, kw), stride=(sh, sw),
                   padding=(kh // 2, kw // 2))
    oh, ow = out.shape[2], out.shape[3]
    dev = x.device
    mh = torch.arange(oh, device=dev)[None, :] < (-(-rows // sh))[:, None]
    mw = torch.arange(ow, device=dev)[None, :] < (-(-cols // sw))[:, None]
    mask = mh[:, None, :, None] & mw[:, None, None, :]
    return {"Out": [torch.where(mask, out, 0.0)], "Col": [None]}


@register("rank_attention", nondiff_slots=("RankOffset",))
def _rank_attention(ctx, ins, attrs):
    """Per instance of rank `lower`: the co-ranked instances' features
    (RankOffset's columns 2k + 2 give their rows) gathered into InputHelp
    [N, K * D], the (lower, faster) rank pair's parameter blocks [K * D,
    P] gathered, and one product. Pairs with a rank 0 give zeros."""
    x = ins["X"][0].float()                      # [N, D]
    ro = ins["RankOffset"][0].long()             # [N, 1 + 2K]
    param = ins["RankParam"][0].float()
    max_rank = int(attrs.get("MaxRank", 3))
    n, d = x.shape
    p = param.shape[-1]
    pview = param.reshape(-1, d, p)
    k = torch.arange(max_rank, device=x.device)
    lower = ro[:, 0] - 1                         # [N]
    faster = ro[:, 1 + 2 * k] - 1                # [N, K]
    index = ro[:, 2 + 2 * k]                     # [N, K]
    valid = (lower[:, None] >= 0) & (faster >= 0)
    xk = torch.where(valid[..., None], x[index.clamp(min=0)], 0.0)
    start = (lower[:, None] * max_rank + faster).clamp(min=0)
    blocks = torch.where(valid[..., None, None], pview[start], 0.0)
    out = torch.einsum("nkd,nkdp->np", xk, blocks)
    return {"Out": [out], "InputHelp": [xk.reshape(n, max_rank * d)],
            "InsRank": [ro[:, :1].float()]}


# ---------------------------------------------------------------------------
# detection mAP evaluator
# ---------------------------------------------------------------------------

def _iou(b1, b2):
    x1 = torch.maximum(b1[..., 0], b2[..., 0])
    y1 = torch.maximum(b1[..., 1], b2[..., 1])
    x2 = torch.minimum(b1[..., 2], b2[..., 2])
    y2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = _max(x2 - x1, 0.0) * _max(y2 - y1, 0.0)
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    return inter / _max(a1 + a2 - inter, 1e-10)


def _take(t, idx):
    """t[..., idx] along the last dim, idx with t's leading dims."""
    return t.gather(-1, idx[..., None])[..., 0]


@register("detection_map",
          nondiff_slots=("DetectRes", "Label", "HasState", "PosCount",
                         "TruePos", "FalsePos"))
def _detection_map(ctx, ins, attrs):
    """The mAP evaluator. DetectRes [B, K, 6] (label, score, x1..y2; a
    label < 0 pads), Label [B, G, 6] (label, difficult, x1..y2; zero area
    pads). The accumulated states are per-class score lists: PosCount
    [C], TruePos / FalsePos [C, Q, 2] (score, flag; flag -1 where no
    detection), grown by concatenation. Each class's detections match the
    image's unmatched boxes of that class greedily in score order (a
    difficult match is neither a true nor a false positive unless
    `evaluate_difficult`); AP is 11-point or integral."""
    det, gt = ins["DetectRes"][0], ins["Label"][0]
    if det.dim() == 2:
        det = det[None]
    if gt.dim() == 2:
        gt = gt[None]
    c = int(attrs.get("class_num", 2))
    ov_t = float(attrs.get("overlap_threshold", 0.5))
    eval_diff = bool(attrs.get("evaluate_difficult", True))
    ap_type = attrs.get("ap_type", "integral")
    b, k = det.shape[:2]
    g = gt.shape[1]
    dev = det.device
    prev_pos = ins.get("PosCount", [None])[0]
    prev_tp = ins.get("TruePos", [None])[0]
    prev_fp = ins.get("FalsePos", [None])[0]

    lab_d = det[..., 0].long()                   # [B, K]
    score = det[..., 1]
    lab_g = gt[..., 0].long()                    # [B, G]
    diff_g = gt[..., 1] > 0
    box_g = gt[..., 2:6]
    area = (box_g[..., 2] - box_g[..., 0]) * (box_g[..., 3] - box_g[..., 1])
    valid_g = area > 0
    count_g = valid_g if eval_diff else (valid_g & ~diff_g)
    cls = torch.arange(c, device=dev)
    cls_g = lab_g[None] == cls[:, None, None]                    # [C, B, G]
    pos_all = (count_g[None] & cls_g).float().sum(dim=(1, 2))    # [C]
    ious = _iou(det[:, :, None, 2:6], box_g[:, None, :, :])      # [B, K, G]
    ious = torch.where((cls_g & valid_g[None])[:, :, None, :], ious[None],
                       -1.0)                                     # [C,B,K,G]
    sel = lab_d[None] == cls[:, None, None]                      # [C, B, K]
    order = torch.sort(-torch.where(sel, score[None], -torch.inf), dim=-1,
                       stable=True).indices
    diff_cg = diff_g[None].expand(c, b, g)
    taken = torch.zeros((c, b, g), dtype=torch.bool, device=dev)
    tps, fps = [], []
    for t in range(k):
        di = order[..., t]                                       # [C, B]
        row = ious.gather(2, di[..., None, None].expand(c, b, 1, g))[:, :, 0]
        best = torch.where(taken, -1.0, row).argmax(dim=-1)
        sd = _take(sel, di)
        ok = (_take(row, best) >= ov_t) & sd & ~_take(taken, best)
        is_diff = _take(diff_cg, best) & ok
        taken = taken | (_one_hot(best, g) & ok[..., None])
        tps.append(ok & (eval_diff | ~is_diff))
        fps.append(sd & ~ok)
    live = sel.gather(-1, order).reshape(c, b * k)
    sc = score[None].expand(c, b, k).gather(-1, order).reshape(c, b * k)
    tpf = torch.stack(tps, dim=-1).reshape(c, b * k)
    fpf = torch.stack(fps, dim=-1).reshape(c, b * k)
    tp_all = torch.stack([sc, torch.where(live, tpf.float(), -1.0)], dim=-1)
    fp_all = torch.stack([sc, torch.where(live, fpf.float(), -1.0)], dim=-1)
    if prev_pos is not None:
        pos_all = pos_all + prev_pos.reshape(-1)[:c]
    if prev_tp is not None:
        tp_all = torch.cat([prev_tp, tp_all], dim=1)
        fp_all = torch.cat([prev_fp, fp_all], dim=1)

    # AP per class over the accumulated lists
    sc, tpv, fpv = tp_all[..., 0], tp_all[..., 1], fp_all[..., 1]
    alive = tpv >= 0
    order = torch.sort(torch.where(alive, -sc, torch.inf), dim=1,
                       stable=True).indices
    mask = alive.gather(1, order)
    ctp = torch.cumsum(torch.where(mask, tpv.gather(1, order), 0.0), dim=1)
    cfp = torch.cumsum(torch.where(mask, fpv.gather(1, order), 0.0), dim=1)
    recall = ctp / _max(pos_all, 1e-10)[:, None]
    precision = ctp / _max(ctp + cfp, 1e-10)
    if ap_type == "11point":
        pts = [torch.where(mask & (recall >= torch.tensor(
            np.float32(tp), device=dev)), precision, 0.0).amax(dim=1)
               for tp in np.linspace(0, 1, 11)]
        aps = torch.stack(pts, dim=1).mean(dim=1)
    else:
        prev_r = torch.cat([torch.zeros((c, 1), device=dev),
                            recall[:, :-1]], dim=1)
        aps = torch.where(mask, (recall - prev_r) * precision,
                          0.0).sum(dim=1)
    has = (pos_all > 0).float()
    m_ap = (aps * has).sum() / _max(has.sum(), 1.0)
    return {"MAP": [m_ap.reshape(1)], "AccumPosCount": [pos_all],
            "AccumTruePos": [tp_all], "AccumFalsePos": [fp_all]}


@register("fc")
def _fc(ctx, ins, attrs):
    """The fused FC of the inference passes: Input flattened to 2-D at
    in_num_col_dims, times W (its 4 padding rows and columns dropped with
    `padding_weights`), plus Bias, then relu if asked; any other
    activation raises, as in the reference."""
    x, w = ins["Input"][0], ins["W"][0]
    num_col = int(attrs.get("in_num_col_dims", 1))
    lead = tuple(x.shape[:num_col])
    x2 = x.reshape((int(np.prod(lead)) if lead else 1, -1))
    if attrs.get("padding_weights", False):
        w = w[:-4, :-4]
    out = x2 @ w
    bias = ins.get("Bias", [None])[0]
    if bias is not None:
        out = out + bias.reshape(1, -1)
    act = attrs.get("activation_type", "") or attrs.get("activation", "")
    if act == "relu":
        out = _max(out, 0.0)
    elif act:
        raise NotImplementedError(f"fc activation_type={act!r}")
    return {"Out": [out.reshape(lead + (w.shape[1],))]}
