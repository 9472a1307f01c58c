"""Inputs for the detection ops (paddle_tpu_torch/ops/detection_ops.py,
detection_assign_ops.py and tail_ops.py's alias `multiclass_nms2`) and
MobileNet-SSD, shared by tests/test_torch_detection_ops.py (the port
against the JAX reference on the CPU) and chip_smoke.py's phase 22 (the
port on the card against the port on the CPU). numpy only: nothing here
imports JAX or either package.

* `detection_cases()`: {case: (inputs, attrs)} at small shapes from a
  numpy seed, one case per op type and more arms of some (`<op>:<arm>`);
  ints are int32, as the device holds them. Inputs hold what the ports
  must get right by hand: priors on a regular grid, whose IoUs with a
  truth tie exactly (`bipartite_match:grid_ties`, `ssd_loss`), tied
  scores and identical boxes for NMS, `nms_eta` < 1, an image whose
  truths are all padding, two truths on one YOLO cell.
* `RANDOM`: the `use_random` cases, whose draws differ between the
  packages: their sampled counts are held, not the rows.
* `VJP_CASES`: the cases whose pullback is held too, over the floating
  inputs outside the op's nondiff slots.
* MobileNet-v1 SSD 300 as PaddlePaddle/models' PaddleCV/ssd composes it
  (`mobilenet_ssd`, `ssd_feed`), for either package's `layers`.
"""
import numpy as np

# the reference files' types this slice covers, by file
DETECTION_OPS = (
    "prior_box", "density_prior_box", "anchor_generator", "box_coder",
    "iou_similarity", "box_clip", "polygon_box_transform", "yolo_box",
    "roi_align", "roi_pool", "multiclass_nms", "yolov3_loss",
    "generate_proposals", "distribute_fpn_proposals",
    "collect_fpn_proposals", "matrix_nms", "bipartite_match",
    "target_assign", "mine_hard_examples", "box_decoder_and_assign",
    "retinanet_detection_output")
ASSIGN_OPS = (
    "rpn_target_assign", "retinanet_target_assign",
    "generate_proposal_labels", "generate_mask_labels",
    "locality_aware_nms", "roi_perspective_transform", "ssd_loss")
ALIASES = ("multiclass_nms2",)


def op_of(case):
    return case.split(":")[0]


def grid_priors(n, size):
    """An n x n grid of square priors of side `size` (normalized),
    centred on the cells: IoUs with a truth tie exactly across cells."""
    c = (np.arange(n, dtype=np.float32) + 0.5) / n
    cy, cx = np.meshgrid(c, c, indexing="ij")
    half = np.float32(size / 2)
    return np.stack([cx - half, cy - half, cx + half, cy + half],
                    -1).reshape(-1, 4).astype(np.float32)


def _boxes(rng, n, lo=0.0, hi=1.0, wmin=0.1, wmax=0.4):
    x1 = rng.uniform(lo, hi - wmax, n)
    y1 = rng.uniform(lo, hi - wmax, n)
    w = rng.uniform(wmin, wmax, n)
    h = rng.uniform(wmin, wmax, n)
    return np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)


def _pixel_boxes(rng, n, size, wmin, wmax):
    return _boxes(rng, n, 0.0, float(size), wmin, wmax)


def detection_cases():
    rng = np.random.RandomState(25)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731

    def i32v(*v):
        return np.array(v, np.int32)

    def f32v(*v):
        return np.array(v, np.float32)

    # NMS inputs: overlapping boxes, an exact duplicate, tied scores
    nms_boxes = np.stack([_boxes(rng, 10) for _ in range(2)])
    nms_boxes[:, 3] = nms_boxes[:, 1]
    nms_boxes[:, 5] = nms_boxes[:, 4] + 0.02
    nms_scores = rng.uniform(0, 1, (2, 4, 10)).astype(np.float32)
    nms_scores[:, 2, 1] = nms_scores[:, 2, 3]
    tie_boxes = grid_priors(3, 0.5)[None]                # [1, 9, 4]
    tie_scores = np.round(rng.uniform(0, 1, (1, 3, 9)), 1).astype(np.float32)

    # SSD: priors on a regular 4 x 4 grid, two sizes
    priors = np.concatenate([grid_priors(4, 0.3), grid_priors(4, 0.5)])
    p = priors.shape[0]
    pvar = np.tile(f32v(0.1, 0.1, 0.2, 0.2), (p, 1))
    gt = np.zeros((3, 3, 4), np.float32)
    gt[0, :2] = [[0.05, 0.05, 0.35, 0.35], [0.5, 0.4, 0.9, 0.85]]
    gt[1, :3] = _boxes(rng, 3, wmin=0.2, wmax=0.45)
    gt[1, 2] = priors[5]               # a prior exactly: IoU 1, ties of 0
    gl = np.zeros((3, 3, 1), np.int32)
    gl[0, :2, 0] = [1, 2]
    gl[1, :, 0] = [2, 1, 1]            # the third image: all padding

    # pixel-space RPN / RCNN inputs
    anchors = np.stack(np.meshgrid(np.arange(4), np.arange(4),
                                   indexing="ij"), -1).astype(np.float32)
    anchors = np.concatenate([
        np.concatenate([anchors[..., ::-1] * 16 - s, anchors[..., ::-1] * 16
                        + s], -1)[:, :, None] for s in (8, 16)], 2)
    a_var = np.full(anchors.shape, 0.1, np.float32)
    a_var[..., 2:] = 0.2
    im_info = np.tile(f32v(64, 64, 1), (2, 1))
    rcnn_gt = np.zeros((2, 3, 4), np.float32)
    rcnn_gt[0, :2] = _pixel_boxes(rng, 2, 64, 12, 30)
    rcnn_gt[1, :3] = _pixel_boxes(rng, 3, 64, 12, 30)
    rcnn_gt[1, 1] = anchors[1, 2, 1]   # an anchor exactly
    crowd = np.zeros((2, 3), np.int32)
    crowd[1, 2] = 1
    rcnn_cls = i32v(1, 2, 0, 2, 1, 1).reshape(2, 3)
    rois = np.concatenate([_pixel_boxes(rng, 6, 64, 8, 30)
                           for _ in range(2)])
    rois[1] = rcnn_gt[0, 0] + 1.0

    # YOLO: truths in xywh, two on one cell and anchor, one padding
    ygt = np.zeros((2, 3, 4), np.float32)
    ygt[0] = [[0.3, 0.3, 0.2, 0.25], [0.32, 0.31, 0.21, 0.24],
              [0.7, 0.6, 0.4, 0.5]]
    ygt[1, :2] = [[0.55, 0.2, 0.3, 0.2], [0.1, 0.8, 0.1, 0.12]]
    quads = f32v(1, 1, 6, 1.5, 6.5, 5, 0.5, 4.5,
                 2, 2, 7, 2, 7, 7, 2, 7).reshape(2, 8)
    text = np.stack([_boxes(rng, 6, 0, 10, 2, 4)])      # [1, 6, 4]
    text[0, 1] = text[0, 0] + 0.2      # locality: consecutive overlaps
    text_quads = text[..., [0, 1, 2, 1, 2, 3, 0, 3]]   # the rects as quads
    segm = (rng.uniform(0, 1, (2, 2, 8, 8)) > 0.5).astype(np.int32)
    mine_match = i32v(0, -1, -1, 1, -1, -1, -1, 2,
                      -1, -1, -1, -1, 0, -1, -1, -1).reshape(2, 8)
    mine_loss = np.round(rng.uniform(0, 2, (2, 8)), 1).astype(np.float32)

    c = {
        # ---- anchors / priors
        "prior_box": (
            {"Input": [f(1, 2, 4, 4)], "Image": [f(1, 3, 32, 32)]},
            {"min_sizes": [8.0], "max_sizes": [16.0],
             "aspect_ratios": [2.0], "flip": True, "clip": True}),
        "prior_box:steps": (
            {"Input": [f(1, 2, 3, 5)], "Image": [f(1, 3, 30, 40)]},
            {"min_sizes": [4.0, 10.0], "aspect_ratios": [2.0, 3.0, 2.0],
             "flip": False, "step_w": 8.0, "step_h": 10.0, "offset": 0.3,
             "variances": [0.1, 0.1, 0.1, 0.1]}),
        "density_prior_box": (
            {"Input": [f(1, 2, 4, 4)], "Image": [f(1, 3, 32, 32)]},
            {"fixed_sizes": [8.0, 16.0], "fixed_ratios": [1.0, 2.0],
             "densities": [2, 1], "clip": True}),
        "anchor_generator": (
            {"Input": [f(1, 2, 4, 5)]},
            {"anchor_sizes": [16.0, 32.0], "aspect_ratios": [0.5, 1.0, 2.0],
             "stride": [8.0, 8.0]}),
        # ---- box arithmetic
        "box_coder": (
            {"PriorBox": [_boxes(rng, 5)], "PriorBoxVar": [
                np.tile(f32v(0.1, 0.1, 0.2, 0.2), (5, 1))],
             "TargetBox": [_boxes(rng, 3)]},
            {"code_type": "encode_center_size"}),
        "box_coder:decode": (
            {"PriorBox": [_boxes(rng, 5)], "PriorBoxVar": [
                np.tile(f32v(0.1, 0.1, 0.2, 0.2), (5, 1))],
             "TargetBox": [f(3, 5, 4) * 0.5]},
            {"code_type": "decode_center_size", "axis": 0}),
        "box_coder:decode_axis1_pixels": (
            {"PriorBox": [_pixel_boxes(rng, 4, 32, 4, 10)],
             "TargetBox": [f(4, 3, 4) * 0.5]},
            {"code_type": "decode_center_size", "axis": 1,
             "box_normalized": False, "variance": [0.1, 0.1, 0.2, 0.2]}),
        "iou_similarity": (
            {"X": [np.concatenate([_boxes(rng, 3), grid_priors(1, 0.4)])],
             "Y": [np.concatenate([_boxes(rng, 5), grid_priors(1, 0.4)])]},
            {}),
        "iou_similarity:pixels": (
            {"X": [_pixel_boxes(rng, 4, 32, 2, 10)],
             "Y": [_pixel_boxes(rng, 3, 32, 2, 10)]},
            {"box_normalized": False}),
        "box_clip": (
            {"Input": [_pixel_boxes(rng, 10, 40, 5, 20).reshape(2, 5, 4)
                       - 5.0],
             "ImInfo": [f32v(30, 28, 1, 40, 36, 2).reshape(2, 3)]}, {}),
        "polygon_box_transform": ({"Input": [f(1, 8, 3, 4)]}, {}),
        "yolo_box": (
            {"X": [f(2, 16, 4, 4)], "ImgSize": [i32v(64, 64, 48, 56)
                                                 .reshape(2, 2)]},
            {"anchors": [10, 13, 16, 30], "class_num": 3,
             "conf_thresh": 0.3, "downsample_ratio": 8}),
        "yolo_box:scaled": (
            {"X": [f(1, 16, 3, 3)], "ImgSize": [i32v(40, 40).reshape(1, 2)]},
            {"anchors": [10, 13, 16, 30], "class_num": 3,
             "conf_thresh": 0.01, "downsample_ratio": 16,
             "clip_bbox": False, "scale_x_y": 1.2}),
        # ---- ROI ops
        "roi_align": (
            {"X": [f(2, 3, 8, 8)],
             "ROIs": [_pixel_boxes(rng, 4, 16, 3, 8)],
             "RoisNum": [i32v(2, 2)]},
            {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 0.5,
             "sampling_ratio": 2}),
        "roi_align:default_sampling": (
            {"X": [f(1, 2, 6, 6)], "ROIs": [_pixel_boxes(rng, 3, 6, 1, 4)]},
            {"pooled_height": 3, "pooled_width": 2}),
        "roi_pool": (
            {"X": [f(2, 3, 8, 8)],
             "ROIs": [_pixel_boxes(rng, 4, 16, 3, 8)],
             "RoisNum": [i32v(1, 3)]},
            {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.5}),
        # ---- NMS
        "multiclass_nms": (
            {"BBoxes": [nms_boxes], "Scores": [nms_scores]},
            {"score_threshold": 0.1, "nms_top_k": 6, "keep_top_k": 8,
             "nms_threshold": 0.5, "background_label": 0}),
        "multiclass_nms:eta": (
            {"BBoxes": [nms_boxes], "Scores": [nms_scores]},
            {"score_threshold": 0.05, "nms_top_k": -1, "keep_top_k": -1,
             "nms_threshold": 0.7, "nms_eta": 0.8,
             "background_label": -1}),
        "multiclass_nms:single": (
            {"BBoxes": [nms_boxes[0]], "Scores": [nms_scores[0]]},
            {"score_threshold": 0.2, "nms_top_k": 8, "keep_top_k": 5,
             "nms_threshold": 0.4, "background_label": 2}),
        "multiclass_nms:ties": (
            {"BBoxes": [tie_boxes], "Scores": [tie_scores]},
            {"score_threshold": 0.0, "nms_top_k": 9, "keep_top_k": 12,
             "nms_threshold": 0.1, "background_label": 0}),
        "multiclass_nms:pixels": (
            {"BBoxes": [np.stack([_pixel_boxes(rng, 8, 32, 4, 12)])],
             "Scores": [rng.uniform(0, 1, (1, 3, 8)).astype(np.float32)]},
            {"score_threshold": 0.3, "nms_top_k": 8, "keep_top_k": 6,
             "nms_threshold": 0.3, "normalized": False}),
        "matrix_nms": (
            {"BBoxes": [nms_boxes[:1, :8]], "Scores": [nms_scores[:1, :3,
                                                                  :8]]},
            {"score_threshold": 0.1, "post_threshold": 0.05,
             "nms_top_k": 6, "keep_top_k": 10, "background_label": 0}),
        "matrix_nms:gaussian": (
            {"BBoxes": [nms_boxes[1, :8]], "Scores": [nms_scores[1, :3, :8]]},
            {"score_threshold": 0.0, "post_threshold": 0.1,
             "nms_top_k": -1, "keep_top_k": -1, "use_gaussian": True,
             "gaussian_sigma": 2.0, "background_label": -1}),
        # ---- YOLO loss
        "yolov3_loss": (
            {"X": [f(2, 16, 4, 4)], "GTBox": [ygt],
             "GTLabel": [i32v(1, 2, 0, 2, 1, 0).reshape(2, 3)],
             "GTScore": [rng.uniform(0.5, 1, (2, 3)).astype(np.float32)]},
            {"anchors": [10, 13, 16, 30, 33, 23], "anchor_mask": [0, 1],
             "class_num": 3, "ignore_thresh": 0.5, "downsample_ratio": 8}),
        "yolov3_loss:no_smooth": (
            {"X": [f(1, 24, 3, 3)], "GTBox": [ygt[1:]],
             "GTLabel": [i32v(2, 1, 0).reshape(1, 3)]},
            {"anchors": [10, 13, 16, 30, 33, 23], "anchor_mask": [0, 1, 2],
             "class_num": 3, "ignore_thresh": 0.3, "downsample_ratio": 16,
             "use_label_smooth": False, "scale_x_y": 1.1}),
        # ---- RPN / FPN
        "generate_proposals": (
            {"Scores": [f(2, 2, 4, 4)], "BboxDeltas": [f(2, 8, 4, 4) * 0.3],
             "ImInfo": [im_info], "Anchors": [anchors], "Variances": [a_var]},
            {"pre_nms_topN": 20, "post_nms_topN": 8, "nms_thresh": 0.5,
             "min_size": 2.0}),
        "generate_proposals:eta": (
            {"Scores": [f(1, 2, 4, 4)], "BboxDeltas": [f(1, 8, 4, 4) * 0.3],
             "ImInfo": [im_info[:1] * f32v(0.75, 1, 1.5)],
             "Anchors": [anchors], "Variances": [a_var]},
            {"pre_nms_topN": 40, "post_nms_topN": 40, "nms_thresh": 0.7,
             "min_size": 4.0, "eta": 0.9}),
        "distribute_fpn_proposals": (
            {"FpnRois": [np.concatenate([_pixel_boxes(rng, 4, 200, 4, 150)
                                         for _ in range(2)])],
             "RoisNum": [i32v(3, 4)]},
            {"min_level": 2, "max_level": 5, "refer_level": 4,
             "refer_scale": 64}),
        "distribute_fpn_proposals:no_counts": (
            {"FpnRois": [_pixel_boxes(rng, 6, 200, 4, 150)]},
            {"min_level": 2, "max_level": 4, "refer_level": 3,
             "refer_scale": 32}),
        "collect_fpn_proposals": (
            {"MultiLevelRois": [_pixel_boxes(rng, 5, 64, 4, 20),
                                _pixel_boxes(rng, 4, 64, 4, 20)],
             "MultiLevelScores": [f(5, 1), f(4, 1)],
             "MultiLevelRoIsNum": [i32v(4), i32v(3)]},
            {"post_nms_topN": 6}),
        "collect_fpn_proposals:no_counts": (
            {"MultiLevelRois": [_pixel_boxes(rng, 3, 64, 4, 20),
                                _pixel_boxes(rng, 4, 64, 4, 20)],
             "MultiLevelScores": [f(3, 1), f(4, 1)]},
            {"post_nms_topN": 10}),
        # ---- the SSD training ops
        "bipartite_match": (
            {"DistMat": [np.round(rng.uniform(0, 1, (3, 7)), 1)
                         .astype(np.float32)]},
            {"match_type": "bipartite"}),
        "bipartite_match:per_prediction": (
            {"DistMat": [np.round(rng.uniform(0, 1, (1, 4, 6)), 1)
                         .astype(np.float32)]},
            {"match_type": "per_prediction", "dist_threshold": 0.3}),
        "bipartite_match:grid_ties": (
            {"DistMat": [_iou_np(grid_priors(2, 0.5)[[0, 3]],
                                 priors)]},
            {"match_type": "per_prediction", "dist_threshold": 0.1}),
        "target_assign": (
            {"X": [f(2, 3, 4)],
             "MatchIndices": [i32v(0, -1, 2, -1, 1, 1,
                                   -1, -1, 0, 2, -1, -1).reshape(2, 6)],
             "NegIndices": [i32v(1, 3, -1, -1, 0, -1,
                                 1, 4, 5, -1, -1, -1).reshape(2, 6)]},
            {"mismatch_value": 0}),
        "target_assign:no_negatives": (
            {"X": [f(1, 3, 2)],
             "MatchIndices": [i32v(2, -1, 0, -1, 1).reshape(1, 5)]},
            {"mismatch_value": -1}),
        "mine_hard_examples": (
            {"ClsLoss": [mine_loss], "LocLoss": [f(2, 8) * 0.1],
             "MatchIndices": [mine_match],
             "MatchDist": [rng.uniform(0, 0.8, (2, 8)).astype(np.float32)]},
            {"neg_pos_ratio": 2.0, "neg_dist_threshold": 0.5}),
        "mine_hard_examples:cls_only": (
            {"ClsLoss": [mine_loss], "MatchIndices": [mine_match]},
            {"neg_pos_ratio": 3.0}),
        "box_decoder_and_assign": (
            {"PriorBox": [_pixel_boxes(rng, 4, 32, 4, 12)],
             "PriorBoxVar": [np.tile(f32v(0.1, 0.1, 0.2, 0.2), (4, 1))],
             "TargetBox": [f(4, 12)],
             "BoxScore": [rng.uniform(0, 1, (4, 3)).astype(np.float32)]},
            {"box_clip": 4.135}),
        "retinanet_detection_output": (
            {"BBoxes": [f(1, 6, 4) * 0.2, f(1, 4, 4) * 0.2],
             "Scores": [rng.uniform(0, 1, (1, 6, 3)).astype(np.float32),
                        rng.uniform(0, 1, (1, 4, 3)).astype(np.float32)],
             "Anchors": [_pixel_boxes(rng, 6, 48, 6, 16),
                         _pixel_boxes(rng, 4, 48, 10, 24)],
             "ImInfo": [f32v(48, 48, 1).reshape(1, 3)]},
            {"score_threshold": 0.2, "nms_top_k": 5, "keep_top_k": 6,
             "nms_threshold": 0.5}),
        # ---- detection_assign_ops.py
        "rpn_target_assign": (
            {"Anchor": [anchors], "GtBoxes": [rcnn_gt], "IsCrowd": [crowd],
             "ImInfo": [im_info]},
            {"rpn_batch_size_per_im": 8, "rpn_positive_overlap": 0.5,
             "rpn_negative_overlap": 0.3, "use_random": False}),
        "rpn_target_assign:random": (
            {"Anchor": [anchors], "GtBoxes": [rcnn_gt], "IsCrowd": [crowd],
             "ImInfo": [im_info]},
            {"rpn_batch_size_per_im": 6, "rpn_fg_fraction": 0.25,
             "rpn_positive_overlap": 0.3, "rpn_negative_overlap": 0.3,
             "rpn_straddle_thresh": -1.0, "use_random": True}),
        "retinanet_target_assign": (
            {"Anchor": [anchors], "GtBoxes": [rcnn_gt],
             "GtLabels": [rcnn_cls.reshape(2, 3, 1)], "IsCrowd": [crowd],
             "ImInfo": [im_info]},
            {"positive_overlap": 0.5, "negative_overlap": 0.4}),
        "generate_proposal_labels": (
            {"RpnRois": [rois], "GtClasses": [rcnn_cls], "IsCrowd": [crowd],
             "GtBoxes": [rcnn_gt], "ImInfo": [im_info],
             "RpnRoisNum": [i32v(5, 6)]},
            {"batch_size_per_im": 6, "fg_fraction": 0.5, "fg_thresh": 0.5,
             "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0, "class_nums": 3,
             "use_random": False}),
        "generate_proposal_labels:agnostic": (
            {"RpnRois": [rois], "GtClasses": [rcnn_cls],
             "GtBoxes": [rcnn_gt], "ImInfo": [im_info]},
            {"batch_size_per_im": 8, "fg_fraction": 0.25, "fg_thresh": 0.3,
             "bg_thresh_hi": 0.3, "bg_thresh_lo": 0.0, "class_nums": 3,
             "is_cls_agnostic": True, "use_random": False}),
        "generate_proposal_labels:random": (
            {"RpnRois": [rois], "GtClasses": [rcnn_cls], "IsCrowd": [crowd],
             "GtBoxes": [rcnn_gt], "ImInfo": [im_info],
             "RpnRoisNum": [i32v(6, 4)]},
            {"batch_size_per_im": 5, "fg_fraction": 0.4, "fg_thresh": 0.3,
             "bg_thresh_hi": 0.3, "bg_thresh_lo": 0.0, "class_nums": 3,
             "use_random": True}),
        "generate_mask_labels": (
            {"ImInfo": [im_info], "GtClasses": [rcnn_cls[:, :2]],
             "IsCrowd": [crowd[:, :2]], "GtSegms": [segm],
             "Rois": [rois], "LabelsInt32": [i32v(1, 0, 2, 2, 0, 1,
                                                  0, 1, 1, 2, 2, 0)
                                             .reshape(12, 1)],
             "RoisNum": [i32v(5, 6)], "GtBoxes": [rcnn_gt[:, :2]]},
            {"num_classes": 3, "resolution": 4}),
        "generate_mask_labels:no_boxes": (
            {"ImInfo": [im_info[:1]], "GtClasses": [rcnn_cls[:1, :2]],
             "GtSegms": [segm[:1]], "Rois": [rois[:6]],
             "LabelsInt32": [i32v(1, 2, 0, 1, 2, 1).reshape(6, 1)]},
            {"num_classes": 3, "resolution": 3}),
        "locality_aware_nms": (
            {"BBoxes": [text], "Scores": [rng.uniform(
                0, 1, (1, 2, 6)).astype(np.float32)]},
            {"score_threshold": 0.1, "nms_top_k": 5, "keep_top_k": 6,
             "nms_threshold": 0.2, "normalized": False,
             "background_label": -1}),
        "locality_aware_nms:quads": (
            {"BBoxes": [text_quads], "Scores": [rng.uniform(
                0, 1, (1, 1, 6)).astype(np.float32)]},
            {"score_threshold": 0.05, "nms_top_k": -1, "keep_top_k": 4,
             "nms_threshold": 0.1, "background_label": -1}),
        "roi_perspective_transform": (
            {"X": [f(1, 2, 8, 8)], "ROIs": [quads]},
            {"transformed_height": 3, "transformed_width": 4,
             "spatial_scale": 1.0}),
        "roi_perspective_transform:batched": (
            {"X": [f(2, 1, 6, 6)], "ROIs": [quads * 0.5],
             "RoisNum": [i32v(1, 1)]},
            {"transformed_height": 2, "transformed_width": 2,
             "spatial_scale": 1.5}),
        "ssd_loss": (
            {"Location": [f(3, p, 4) * 0.5], "Confidence": [f(3, p, 3)],
             "GtBox": [gt], "GtLabel": [gl], "PriorBox": [priors],
             "PriorBoxVar": [pvar]}, {}),
        "ssd_loss:bipartite": (
            {"Location": [f(2, p, 4) * 0.5], "Confidence": [f(2, p, 3)],
             "GtBox": [gt[:2]], "GtLabel": [gl[:2, :, 0]],
             "PriorBox": [priors]},
            {"match_type": "bipartite", "neg_pos_ratio": 2.0,
             "overlap_threshold": 0.3, "loc_loss_weight": 0.5,
             "normalize": False, "background_label": 0}),
    }
    c["multiclass_nms2"] = c["multiclass_nms"]
    return c


def _iou_np(x, y):
    ix = np.maximum(np.minimum(x[:, None, 2], y[None, :, 2])
                    - np.maximum(x[:, None, 0], y[None, :, 0]), 0)
    iy = np.maximum(np.minimum(x[:, None, 3], y[None, :, 3])
                    - np.maximum(x[:, None, 1], y[None, :, 1]), 0)
    inter = ix * iy
    ax = (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    ay = (y[:, 2] - y[:, 0]) * (y[:, 3] - y[:, 1])
    return (inter / (ax[:, None] + ay[None, :] - inter)).astype(np.float32)


RANDOM = {"rpn_target_assign:random", "generate_proposal_labels:random"}

VJP_CASES = {"box_coder", "box_coder:decode", "box_coder:decode_axis1_pixels",
             "iou_similarity", "box_clip", "polygon_box_transform",
             "yolo_box", "roi_align", "roi_pool", "multiclass_nms",
             "multiclass_nms:eta", "multiclass_nms2", "yolov3_loss",
             "target_assign", "box_decoder_and_assign",
             "roi_perspective_transform", "ssd_loss", "ssd_loss:bipartite"}

# ---------------------------------------------------------------------------
# MobileNet-v1 SSD 300 (PaddlePaddle/models PaddleCV/ssd mobilenet_ssd.py,
# train.py's train_parameters["pascalvoc"])
# ---------------------------------------------------------------------------

VOC_CLASSES = 21
SSD_IMAGE = 300
SSD_MIN_SIZES = (60.0, 105.0, 150.0, 195.0, 240.0, 285.0)
SSD_MAX_SIZES = ((), (150.0,), (195.0,), (240.0,), (285.0,), (300.0,))
SSD_ASPECT_RATIOS = ((2.0,), (2.0, 3.0), (2.0, 3.0), (2.0, 3.0), (2.0, 3.0),
                     (2.0, 3.0))
SSD_PRIORS = 1917                  # at image 300
SSD_BATCH = 64
SSD_GT = 20                        # truth rows an image, padding included
SSD_LR = 0.001
# train.py: lr_epochs [40, 60, 80, 100] x (16,551 VOC images // 64),
# lr_decay [1, 0.5, 0.25, 0.1, 0.01]
SSD_BOUNDARIES = [40 * 258, 60 * 258, 80 * 258, 100 * 258]
SSD_VALUES = [SSD_LR * d for d in (1, 0.5, 0.25, 0.1, 0.01)]
SSD_L2 = 5e-5
SSD_NMS = {"nms_threshold": 0.45, "nms_top_k": 400, "keep_top_k": 200,
           "score_threshold": 0.01}


def _conv_bn(L, ParamAttr, MSRA, x, filter_size, num_filters, stride,
             padding, groups=1):
    """mobilenet_ssd.py conv_bn: a conv without bias (MSRA, the
    parameter's learning_rate 0.1 as the source sets it), batch_norm,
    relu."""
    conv = L.conv2d(x, num_filters, filter_size, stride=stride,
                    padding=padding, groups=groups,
                    param_attr=ParamAttr(learning_rate=0.1,
                                         initializer=MSRA()),
                    bias_attr=False)
    return L.batch_norm(conv, act="relu")


def _separable(L, PA, MSRA, x, f1, f2, stride, scale):
    dw = _conv_bn(L, PA, MSRA, x, 3, int(f1 * scale), stride, 1,
                  groups=int(f1 * scale))
    return _conv_bn(L, PA, MSRA, dw, 1, int(f2 * scale), 1, 0)


def _extra(L, PA, MSRA, x, f1, f2, scale):
    """A 1x1 then a 3x3 stride-2 conv_bn (the source's extra_block; its
    num_groups is int(1 * scale), which is 0 below scale 1: one group)."""
    pw = _conv_bn(L, PA, MSRA, x, 1, int(f1 * scale), 1, 0)
    return _conv_bn(L, PA, MSRA, pw, 3, int(f2 * scale), 2, 1)


def mobilenet_ssd(L, ParamAttr, MSRA, image=SSD_IMAGE, scale=1.0,
                  classes=VOC_CLASSES, gt_rows=SSD_GT):
    """MobileNet-v1 SSD with layers module `L`: the data vars, the six
    source maps (module11 19 x 19 x 512, module13 10 x 10 x 1024 at image
    300 and scale 1, then the four extra blocks to 5, 3, 2 and 1), the
    head as fluid's multi_box_head composes it (prior_box per map, conv
    heads of kernel 1, transpose, reshape, concat), and ssd_loss summed.
    Returns a dict of the vars."""
    img = L.data(name="image", shape=[3, image, image], dtype="float32")
    gt_box = L.data(name="gt_box", shape=[gt_rows, 4], dtype="float32")
    gt_label = L.data(name="gt_label", shape=[gt_rows, 1], dtype="int32")
    difficult = L.data(name="difficult", shape=[gt_rows, 1],
                       dtype="float32")
    t = _conv_bn(L, ParamAttr, MSRA, img, 3, int(32 * scale), 2, 1)
    for f1, f2, stride in ((32, 64, 1), (64, 128, 2), (128, 128, 1),
                           (128, 256, 2), (256, 256, 1), (256, 512, 2),
                           (512, 512, 1), (512, 512, 1), (512, 512, 1),
                           (512, 512, 1), (512, 512, 1)):
        t = _separable(L, ParamAttr, MSRA, t, f1, f2, stride, scale)
    module11 = t
    t = _separable(L, ParamAttr, MSRA, t, 512, 1024, 2, scale)
    module13 = _separable(L, ParamAttr, MSRA, t, 1024, 1024, 1, scale)
    maps = [module11, module13]
    for f1, f2 in ((256, 512), (128, 256), (128, 256), (64, 128)):
        maps.append(_extra(L, ParamAttr, MSRA, maps[-1], f1, f2, scale))
    locs, confs, boxes, variances = [], [], [], []
    for i, fm in enumerate(maps):
        box, var = L.prior_box(
            fm, img, min_sizes=[SSD_MIN_SIZES[i]],
            max_sizes=list(SSD_MAX_SIZES[i]),
            aspect_ratios=list(SSD_ASPECT_RATIOS[i]),
            variance=[0.1, 0.1, 0.2, 0.2], flip=True, clip=False,
            steps=[0.0, 0.0], offset=0.5)
        n_priors = 1 + 2 * len(SSD_ASPECT_RATIOS[i]) \
            + len(SSD_MAX_SIZES[i])
        h, w = fm.shape[2], fm.shape[3]
        loc = L.conv2d(fm, n_priors * 4, 1, padding=0)
        conf = L.conv2d(fm, n_priors * classes, 1, padding=0)
        locs.append(L.reshape(L.transpose(loc, [0, 2, 3, 1]),
                              [0, h * w * n_priors, 4]))
        confs.append(L.reshape(L.transpose(conf, [0, 2, 3, 1]),
                               [0, h * w * n_priors, classes]))
        boxes.append(L.reshape(box, [-1, 4]))
        variances.append(L.reshape(var, [-1, 4]))
    loc = L.concat(locs, axis=1)
    conf = L.concat(confs, axis=1)
    prior = L.concat(boxes, axis=0)
    pvar = L.concat(variances, axis=0)
    loss = L.reduce_sum(L.ssd_loss(loc, conf, gt_box, gt_label, prior,
                                   pvar))
    return {"image": img, "gt_box": gt_box, "gt_label": gt_label,
            "difficult": difficult, "loc": loc, "conf": conf,
            "prior": prior, "pvar": pvar, "loss": loss}


def ssd_decode(L, net, classes=VOC_CLASSES, nms=None):
    """The decode and evaluation ops on `net`'s vars (in the program they
    belong to): detection_output, then detection_map (11point) against
    the truths as [B, G, 6] (label, difficult, box)."""
    nms = dict(SSD_NMS, **(nms or {}))
    out, index, count = L.detection_output(
        net["loc"], net["conf"], net["prior"], net["pvar"],
        return_index=True, **nms)
    label = L.concat([L.cast(net["gt_label"], "float32"), net["difficult"],
                      net["gt_box"]], axis=2)
    m = L.detection_map(L.reshape(out, [-1, nms["keep_top_k"], 6]), label,
                        classes, background_label=0, overlap_threshold=0.5,
                        evaluate_difficult=False, ap_version="11point")
    return out, index, count, m


def ssd_feed(batch, image=SSD_IMAGE, classes=VOC_CLASSES, gt_rows=SSD_GT,
             seed=0):
    """A batch in Pascal VOC's layout from numpy seed `seed`: images N(0,
    1), 1-8 truths an image (normalized boxes of side 0.1-0.6, labels
    1..classes-1, one in ten difficult), padded to `gt_rows` with zero
    rows."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((batch, gt_rows, 4), np.float32)
    label = np.zeros((batch, gt_rows, 1), np.int32)
    difficult = np.zeros((batch, gt_rows, 1), np.float32)
    for i in range(batch):
        n = rng.randint(1, 9)
        gt[i, :n] = _boxes(rng, n, wmin=0.1, wmax=0.6)
        label[i, :n, 0] = rng.randint(1, classes, n)
        difficult[i, :n, 0] = rng.uniform(0, 1, n) < 0.1
    return {"image": rng.randn(batch, 3, image, image).astype(np.float32),
            "gt_box": gt, "gt_label": label, "difficult": difficult}
