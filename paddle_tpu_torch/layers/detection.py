"""Detection layer functions (counterpart of paddle_tpu/layers/
detection.py, every builder of its `__all__` with the same signature and
the same op descs): priors and anchors, box coding, IoU, clipping, YOLO,
the NMS family, matching and target assignment, the RPN / FPN proposal
ops, the RCNN / RetinaNet / SSD / EAST / OCR training ops, the ROI ops,
`detection_output` (composed as the reference composes it) and
`detection_map`. Thin wrappers over the lowerings of ops/detection_ops.py,
ops/detection_assign_ops.py, ops/extra_ops.py (`sigmoid_focal_loss`),
ops/tail_ops.py (`psroi_pool`, `prroi_pool`) and ops/dense_tail_ops2.py
(`detection_map`); static outputs carry count tensors where the
reference's ops emit LoD."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = [
    "prior_box", "density_prior_box", "anchor_generator", "box_coder",
    "iou_similarity", "box_clip", "yolo_box", "yolov3_loss",
    "multiclass_nms", "matrix_nms", "bipartite_match", "target_assign",
    "generate_proposals", "distribute_fpn_proposals",
    "collect_fpn_proposals", "retinanet_detection_output",
    "sigmoid_focal_loss", "roi_align", "roi_pool", "psroi_pool",
    "prroi_pool", "rpn_target_assign", "retinanet_target_assign",
    "generate_proposal_labels", "generate_mask_labels",
    "locality_aware_nms", "roi_perspective_transform", "ssd_loss",
    "detection_output", "detection_map", "box_decoder_and_assign",
]


def _op(helper, op_type, inputs, out_slots, attrs=None, dtypes=None):
    outs = {}
    for s in out_slots:
        dt = (dtypes or {}).get(s, "float32")
        outs[s] = helper.create_variable_for_type_inference(dt)
    helper.append_op(op_type, inputs=inputs,
                     outputs={k: [v] for k, v in outs.items()},
                     attrs=attrs or {})
    return outs


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None):
    helper = LayerHelper("prior_box")
    outs = _op(helper, "prior_box", {"Input": [input], "Image": [image]},
               ("Boxes", "Variances"),
               {"min_sizes": list(min_sizes),
                "max_sizes": list(max_sizes or []),
                "aspect_ratios": list(aspect_ratios),
                "variances": list(variance), "flip": flip, "clip": clip,
                "step_w": steps[0], "step_h": steps[1], "offset": offset})
    return outs["Boxes"], outs["Variances"]


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False,
                      steps=(0.0, 0.0), offset=0.5, flatten_to_2d=False,
                      name=None):
    helper = LayerHelper("density_prior_box")
    outs = _op(helper, "density_prior_box",
               {"Input": [input], "Image": [image]},
               ("Boxes", "Variances"),
               {"densities": list(densities),
                "fixed_sizes": list(fixed_sizes),
                "fixed_ratios": list(fixed_ratios),
                "variances": list(variance), "clip": clip,
                "step_w": steps[0], "step_h": steps[1], "offset": offset})
    return outs["Boxes"], outs["Variances"]


def anchor_generator(input, anchor_sizes, aspect_ratios, stride,
                     variance=(0.1, 0.1, 0.2, 0.2), offset=0.5, name=None):
    helper = LayerHelper("anchor_generator")
    outs = _op(helper, "anchor_generator", {"Input": [input]},
               ("Anchors", "Variances"),
               {"anchor_sizes": list(anchor_sizes),
                "aspect_ratios": list(aspect_ratios),
                "stride": list(stride), "variances": list(variance),
                "offset": offset})
    return outs["Anchors"], outs["Variances"]


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    helper = LayerHelper("box_coder")
    ins = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    attrs = {"code_type": code_type, "box_normalized": box_normalized,
             "axis": axis}
    if isinstance(prior_box_var, (list, tuple)):
        attrs["variance"] = [float(v) for v in prior_box_var]
    elif prior_box_var is not None:
        ins["PriorBoxVar"] = [prior_box_var]
    outs = _op(helper, "box_coder", ins, ("OutputBox",), attrs)
    return outs["OutputBox"]


def iou_similarity(x, y, box_normalized=True, name=None):
    helper = LayerHelper("iou_similarity")
    outs = _op(helper, "iou_similarity", {"X": [x], "Y": [y]}, ("Out",),
               {"box_normalized": box_normalized})
    return outs["Out"]


def box_clip(input, im_info, name=None):
    helper = LayerHelper("box_clip")
    outs = _op(helper, "box_clip",
               {"Input": [input], "ImInfo": [im_info]}, ("Output",))
    return outs["Output"]


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None, scale_x_y=1.0):
    helper = LayerHelper("yolo_box")
    outs = _op(helper, "yolo_box", {"X": [x], "ImgSize": [img_size]},
               ("Boxes", "Scores"),
               {"anchors": list(anchors), "class_num": int(class_num),
                "conf_thresh": float(conf_thresh),
                "downsample_ratio": int(downsample_ratio),
                "clip_bbox": clip_bbox, "scale_x_y": float(scale_x_y)})
    return outs["Boxes"], outs["Scores"]


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None, scale_x_y=1.0):
    helper = LayerHelper("yolov3_loss")
    ins = {"X": [x], "GTBox": [gt_box], "GTLabel": [gt_label]}
    if gt_score is not None:
        ins["GTScore"] = [gt_score]
    outs = _op(helper, "yolov3_loss", ins,
               ("Loss", "ObjectnessMask", "GTMatchMask"),
               {"anchors": list(anchors), "anchor_mask": list(anchor_mask),
                "class_num": int(class_num),
                "ignore_thresh": float(ignore_thresh),
                "downsample_ratio": int(downsample_ratio),
                "use_label_smooth": use_label_smooth,
                "scale_x_y": float(scale_x_y)},
               dtypes={"GTMatchMask": "int32"})
    return outs["Loss"]


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, name=None, return_index=False,
                   rois_num=None):
    helper = LayerHelper("multiclass_nms")
    outs = _op(helper, "multiclass_nms",
               {"BBoxes": [bboxes], "Scores": [scores]},
               ("Out", "Index", "NmsRoisNum"),
               {"score_threshold": float(score_threshold),
                "nms_top_k": int(nms_top_k), "keep_top_k": int(keep_top_k),
                "nms_threshold": float(nms_threshold),
                "normalized": normalized, "nms_eta": float(nms_eta),
                "background_label": int(background_label)},
               dtypes={"Index": "int32", "NmsRoisNum": "int32"})
    if return_index:
        return outs["Out"], outs["Index"], outs["NmsRoisNum"]
    return outs["Out"], outs["NmsRoisNum"]


def matrix_nms(bboxes, scores, score_threshold, post_threshold, nms_top_k,
               keep_top_k, use_gaussian=False, gaussian_sigma=2.0,
               background_label=0, normalized=True, return_index=False,
               return_rois_num=True, name=None):
    helper = LayerHelper("matrix_nms")
    outs = _op(helper, "matrix_nms",
               {"BBoxes": [bboxes], "Scores": [scores]},
               ("Out", "Index", "RoisNum"),
               {"score_threshold": float(score_threshold),
                "post_threshold": float(post_threshold),
                "nms_top_k": int(nms_top_k), "keep_top_k": int(keep_top_k),
                "use_gaussian": use_gaussian,
                "gaussian_sigma": float(gaussian_sigma),
                "background_label": int(background_label),
                "normalized": normalized},
               dtypes={"Index": "int32", "RoisNum": "int32"})
    if return_index:
        return outs["Out"], outs["Index"]
    if return_rois_num:
        return outs["Out"], outs["RoisNum"]
    return outs["Out"]


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    helper = LayerHelper("bipartite_match")
    outs = _op(helper, "bipartite_match", {"DistMat": [dist_matrix]},
               ("ColToRowMatchIndices", "ColToRowMatchDist"),
               {"match_type": match_type or "bipartite",
                "dist_threshold": float(dist_threshold or 0.5)},
               dtypes={"ColToRowMatchIndices": "int32"})
    return outs["ColToRowMatchIndices"], outs["ColToRowMatchDist"]


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    helper = LayerHelper("target_assign")
    ins = {"X": [input], "MatchIndices": [matched_indices]}
    if negative_indices is not None:
        ins["NegIndices"] = [negative_indices]
    outs = _op(helper, "target_assign", ins, ("Out", "OutWeight"),
               {"mismatch_value": mismatch_value or 0})
    return outs["Out"], outs["OutWeight"]


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       return_rois_num=False, name=None):
    helper = LayerHelper("generate_proposals")
    outs = _op(helper, "generate_proposals",
               {"Scores": [scores], "BboxDeltas": [bbox_deltas],
                "ImInfo": [im_info], "Anchors": [anchors],
                "Variances": [variances]},
               ("RpnRois", "RpnRoiProbs", "RpnRoisNum"),
               {"pre_nms_topN": int(pre_nms_top_n),
                "post_nms_topN": int(post_nms_top_n),
                "nms_thresh": float(nms_thresh),
                "min_size": float(min_size), "eta": float(eta)},
               dtypes={"RpnRoisNum": "int32"})
    if return_rois_num:
        return outs["RpnRois"], outs["RpnRoiProbs"], outs["RpnRoisNum"]
    return outs["RpnRois"], outs["RpnRoiProbs"]


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, rois_num=None, name=None):
    helper = LayerHelper("distribute_fpn_proposals")
    n_lvl = max_level - min_level + 1
    multi = [helper.create_variable_for_type_inference(fpn_rois.dtype)
             for _ in range(n_lvl)]
    counts = helper.create_variable_for_type_inference("int32")
    restore = helper.create_variable_for_type_inference("int32")
    ins = {"FpnRois": [fpn_rois]}
    if rois_num is not None:
        ins["RoisNum"] = [rois_num]
    helper.append_op("distribute_fpn_proposals", inputs=ins,
                     outputs={"MultiFpnRois": multi,
                              "MultiLevelRoIsNum": [counts],
                              "RestoreIndex": [restore]},
                     attrs={"min_level": int(min_level),
                            "max_level": int(max_level),
                            "refer_level": int(refer_level),
                            "refer_scale": int(refer_scale)})
    # RestoreIndex addresses concat(multi) directly (padded static layout);
    # with rois_num given, also hand back the per-level live counts (the
    # 2.x reference signature) so callers can mask padding
    if rois_num is not None:
        return multi, restore, counts
    return multi, restore


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, rois_num_per_level=None,
                          name=None):
    helper = LayerHelper("collect_fpn_proposals")
    n_lvl = int(max_level) - int(min_level) + 1
    if len(multi_rois) != n_lvl or len(multi_scores) != n_lvl:
        raise ValueError(
            f"collect_fpn_proposals: expected {n_lvl} levels "
            f"(min_level={min_level}..max_level={max_level}), got "
            f"{len(multi_rois)} rois / {len(multi_scores)} scores lists")
    ins = {"MultiLevelRois": list(multi_rois),
           "MultiLevelScores": list(multi_scores)}
    if rois_num_per_level is not None:
        ins["MultiLevelRoIsNum"] = list(rois_num_per_level)
    outs = {}
    outs["FpnRois"] = helper.create_variable_for_type_inference(
        multi_rois[0].dtype)
    outs["RoisNum"] = helper.create_variable_for_type_inference("int32")
    helper.append_op("collect_fpn_proposals", inputs=ins,
                     outputs={k: [v] for k, v in outs.items()},
                     attrs={"post_nms_topN": int(post_nms_top_n)})
    if rois_num_per_level is not None:
        return outs["FpnRois"], outs["RoisNum"]
    return outs["FpnRois"]


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0):
    helper = LayerHelper("retinanet_detection_output")
    out = helper.create_variable_for_type_inference(bboxes[0].dtype)
    cnt = helper.create_variable_for_type_inference("int32")
    helper.append_op("retinanet_detection_output",
                     inputs={"BBoxes": list(bboxes),
                             "Scores": list(scores),
                             "Anchors": list(anchors),
                             "ImInfo": [im_info]},
                     outputs={"Out": [out], "NmsRoisNum": [cnt]},
                     attrs={"score_threshold": float(score_threshold),
                            "nms_top_k": int(nms_top_k),
                            "keep_top_k": int(keep_top_k),
                            "nms_threshold": float(nms_threshold),
                            "nms_eta": float(nms_eta)})
    return out


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25):
    helper = LayerHelper("sigmoid_focal_loss")
    outs = _op(helper, "sigmoid_focal_loss",
               {"X": [x], "Label": [label], "FgNum": [fg_num]}, ("Out",),
               {"gamma": float(gamma), "alpha": float(alpha)})
    return outs["Out"]


def _roi_op(op_type, input, rois, pooled_height, pooled_width,
            spatial_scale, rois_num=None, extra_attrs=None,
            num_slot="RoisNum"):
    helper = LayerHelper(op_type)
    ins = {"X": [input], "ROIs": [rois]}
    if rois_num is not None:
        ins[num_slot] = [rois_num]
    attrs = {"pooled_height": int(pooled_height),
             "pooled_width": int(pooled_width),
             "spatial_scale": float(spatial_scale)}
    attrs.update(extra_attrs or {})
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(op_type, inputs=ins, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, name=None,
              rois_num=None):
    return _roi_op("roi_align", input, rois, pooled_height, pooled_width,
                   spatial_scale, rois_num,
                   {"sampling_ratio": int(sampling_ratio)})


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, rois_num=None, name=None):
    return _roi_op("roi_pool", input, rois, pooled_height, pooled_width,
                   spatial_scale, rois_num)


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, rois_num=None, name=None):
    return _roi_op("psroi_pool", input, rois, pooled_height, pooled_width,
                   spatial_scale, rois_num,
                   {"output_channels": int(output_channels)})


def prroi_pool(input, rois, spatial_scale=1.0, pooled_height=1,
               pooled_width=1, batch_roi_nums=None, name=None):
    return _roi_op("prroi_pool", input, rois, pooled_height, pooled_width,
                   spatial_scale, batch_roi_nums, num_slot="BatchRoINums")


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip, name=None):
    helper = LayerHelper("box_decoder_and_assign")
    outs = _op(helper, "box_decoder_and_assign",
               {"PriorBox": [prior_box], "PriorBoxVar": [prior_box_var],
                "TargetBox": [target_box], "BoxScore": [box_score]},
               ("DecodeBox", "OutputAssignBox"),
               {"box_clip": float(box_clip)})
    return outs["DecodeBox"], outs["OutputAssignBox"]


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd, im_info,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    """Reference python/paddle/fluid/layers/detection.py:310. The reference
    gathers predictions at sampled indices into ragged tensors; the static
    form instead returns DENSE per-anchor predictions/targets plus weight
    masks (score_weight selects the sampled fg+bg set, bbox_weight the
    sampled fg set) — masked losses give the same gradients. Returns
    (score_pred, loc_pred, score_tgt, loc_tgt, bbox_weight, score_weight)."""
    helper = LayerHelper("rpn_target_assign")
    ins = {"Anchor": [anchor_box], "GtBoxes": [gt_boxes],
           "ImInfo": [im_info]}
    if is_crowd is not None:
        ins["IsCrowd"] = [is_crowd]
    outs = _op(helper, "rpn_target_assign", ins,
               ("TargetLabel", "ScoreWeight", "TargetBBox",
                "BBoxInsideWeight"),
               {"rpn_batch_size_per_im": int(rpn_batch_size_per_im),
                "rpn_straddle_thresh": float(rpn_straddle_thresh),
                "rpn_fg_fraction": float(rpn_fg_fraction),
                "rpn_positive_overlap": float(rpn_positive_overlap),
                "rpn_negative_overlap": float(rpn_negative_overlap),
                "use_random": bool(use_random)})
    for v in outs.values():
        v.stop_gradient = True
    return (cls_logits, bbox_pred, outs["TargetLabel"], outs["TargetBBox"],
            outs["BBoxInsideWeight"], outs["ScoreWeight"])


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels, is_crowd, im_info,
                            num_classes=1, positive_overlap=0.5,
                            negative_overlap=0.4):
    """Reference layers/detection.py:69. Dense static form (see
    rpn_target_assign above). Returns (score_pred, loc_pred, score_tgt,
    loc_tgt, bbox_weight, score_weight, fg_num)."""
    helper = LayerHelper("retinanet_target_assign")
    ins = {"Anchor": [anchor_box], "GtBoxes": [gt_boxes],
           "GtLabels": [gt_labels], "ImInfo": [im_info]}
    if is_crowd is not None:
        ins["IsCrowd"] = [is_crowd]
    outs = _op(helper, "retinanet_target_assign", ins,
               ("TargetLabel", "ScoreWeight", "TargetBBox",
                "BBoxInsideWeight", "ForegroundNumber"),
               {"positive_overlap": float(positive_overlap),
                "negative_overlap": float(negative_overlap)},
               dtypes={"TargetLabel": "int32", "ForegroundNumber": "int32"})
    for v in outs.values():
        v.stop_gradient = True
    return (cls_logits, bbox_pred, outs["TargetLabel"], outs["TargetBBox"],
            outs["BBoxInsideWeight"], outs["ScoreWeight"],
            outs["ForegroundNumber"])


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.25,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True,
                             is_cls_agnostic=False, is_cascade_rcnn=False,
                             rpn_rois_num=None, return_roi_weights=False):
    """Reference layers/detection.py generate_proposal_labels. Static form:
    exactly batch_size_per_im rows per image (fg, then bg, then padding),
    RoisNum = live counts. Returns (rois, labels_int32, bbox_targets,
    bbox_inside_weights, bbox_outside_weights, rois_num)."""
    helper = LayerHelper("generate_proposal_labels")
    ins = {"RpnRois": [rpn_rois], "GtClasses": [gt_classes],
           "GtBoxes": [gt_boxes], "ImInfo": [im_info]}
    if is_crowd is not None:
        ins["IsCrowd"] = [is_crowd]
    if rpn_rois_num is not None:
        ins["RpnRoisNum"] = [rpn_rois_num]
    outs = _op(helper, "generate_proposal_labels", ins,
               ("Rois", "LabelsInt32", "BboxTargets", "BboxInsideWeights",
                "BboxOutsideWeights", "RoisNum", "RoiWeights"),
               {"batch_size_per_im": int(batch_size_per_im),
                "fg_fraction": float(fg_fraction),
                "fg_thresh": float(fg_thresh),
                "bg_thresh_hi": float(bg_thresh_hi),
                "bg_thresh_lo": float(bg_thresh_lo),
                "bbox_reg_weights": [float(w) for w in bbox_reg_weights],
                "class_nums": int(class_nums or 2),
                "use_random": bool(use_random),
                "is_cls_agnostic": bool(is_cls_agnostic),
                "is_cascade_rcnn": bool(is_cascade_rcnn)},
               dtypes={"LabelsInt32": "int32", "RoisNum": "int32"})
    for v in outs.values():
        v.stop_gradient = True
    ret = (outs["Rois"], outs["LabelsInt32"], outs["BboxTargets"],
           outs["BboxInsideWeights"], outs["BboxOutsideWeights"],
           outs["RoisNum"])
    if return_roi_weights:   # static-design extra: 1 on live rows, 0 on pad
        ret = ret + (outs["RoiWeights"],)
    return ret


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution,
                         gt_boxes=None, rois_num=None):
    """Reference layers/detection.py generate_mask_labels. Static form:
    gt_segms is a dense per-gt bitmap [B, G, Hm, Wm] (polygons rasterized
    host-side), not a polygon LoD. Returns (mask_rois, roi_has_mask_int32,
    mask_int32)."""
    helper = LayerHelper("generate_mask_labels")
    ins = {"ImInfo": [im_info], "GtClasses": [gt_classes],
           "GtSegms": [gt_segms], "Rois": [rois],
           "LabelsInt32": [labels_int32]}
    if is_crowd is not None:
        ins["IsCrowd"] = [is_crowd]
    if gt_boxes is not None:
        ins["GtBoxes"] = [gt_boxes]
    if rois_num is not None:
        ins["RoisNum"] = [rois_num]
    outs = _op(helper, "generate_mask_labels", ins,
               ("MaskRois", "RoiHasMaskInt32", "MaskInt32"),
               {"num_classes": int(num_classes),
                "resolution": int(resolution)},
               dtypes={"RoiHasMaskInt32": "int32", "MaskInt32": "int32"})
    for v in outs.values():
        v.stop_gradient = True
    return outs["MaskRois"], outs["RoiHasMaskInt32"], outs["MaskInt32"]


def locality_aware_nms(bboxes, scores, score_threshold, nms_top_k,
                       keep_top_k, nms_threshold=0.3, normalized=True,
                       nms_eta=1.0, background_label=-1, name=None):
    """Reference layers/detection.py locality_aware_nms (EAST). Static
    output [keep_top_k, 2 + box_size] + count."""
    helper = LayerHelper("locality_aware_nms")
    outs = _op(helper, "locality_aware_nms",
               {"BBoxes": [bboxes], "Scores": [scores]},
               ("Out", "OutCount"),
               {"score_threshold": float(score_threshold),
                "nms_top_k": int(nms_top_k), "keep_top_k": int(keep_top_k),
                "nms_threshold": float(nms_threshold),
                "normalized": bool(normalized), "nms_eta": float(nms_eta),
                "background_label": int(background_label)},
               dtypes={"OutCount": "int32"})
    # static-shape convention: padded block + live-row count (the
    # reference's LoD carries the count implicitly)
    return outs["Out"], outs["OutCount"]


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0,
                              rois_num=None, name=None):
    """Reference layers/detection.py roi_perspective_transform (OCR).
    Returns (out, mask, transform_matrix)."""
    helper = LayerHelper("roi_perspective_transform")
    ins = {"X": [input], "ROIs": [rois]}
    if rois_num is not None:
        ins["RoisNum"] = [rois_num]
    outs = _op(helper, "roi_perspective_transform", ins,
               ("Out", "Mask", "TransformMatrix"),
               {"transformed_height": int(transformed_height),
                "transformed_width": int(transformed_width),
                "spatial_scale": float(spatial_scale)},
               dtypes={"Mask": "int32"})
    return outs["Out"], outs["Mask"], outs["TransformMatrix"]


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True,
             sample_size=None):
    """Reference layers/detection.py:1517. One fused static lowering of the
    reference's 8-op composition (iou_similarity -> bipartite_match ->
    target_assign -> mine_hard_examples -> smooth_l1 + CE); gt padding =
    zero-area boxes. Returns the per-image weighted loss [B, 1]."""
    helper = LayerHelper("ssd_loss")
    ins = {"Location": [location], "Confidence": [confidence],
           "GtBox": [gt_box], "GtLabel": [gt_label],
           "PriorBox": [prior_box]}
    if prior_box_var is not None:
        ins["PriorBoxVar"] = [prior_box_var]
    outs = _op(helper, "ssd_loss", ins, ("Loss",),
               {"background_label": int(background_label),
                "overlap_threshold": float(overlap_threshold),
                "neg_pos_ratio": float(neg_pos_ratio),
                "neg_overlap": float(neg_overlap),
                "loc_loss_weight": float(loc_loss_weight),
                "conf_loss_weight": float(conf_loss_weight),
                "match_type": match_type, "mining_type": mining_type,
                "normalize": bool(normalize),
                "sample_size": -1 if sample_size is None
                else int(sample_size)})
    return outs["Loss"]


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0,
                     return_index=False):
    """python/paddle/fluid/layers/detection.py:620: softmax the class
    logits, transpose them to [N, C, P], decode the boxes (box_coder
    decode_center_size), then multiclass_nms, composed from those ops as
    the reference composes them. `scores` arrives [N, P, C] raw."""
    from . import nn as _nn
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size", axis=0)
    probs = _nn.transpose(_nn.softmax(scores), [0, 2, 1])
    return multiclass_nms(decoded, probs,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold, normalized=True,
                          nms_eta=nms_eta,
                          background_label=background_label,
                          return_index=return_index)


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.5, evaluate_difficult=True,
                  has_state=None, input_states=None, out_states=None,
                  ap_version="integral"):
    """Reference layers/detection.py detection_map (mAP evaluator).
    Static form: DetectRes [B, K, 6] padded (label < 0), Label [B, G, 6]
    (label, difficult, x1..y2, zero-area = pad). For streaming epoch mAP,
    pass the previous batch's accumulators as `input_states` and receive
    the updated ones: returns (map, accum_pos_count, accum_true_pos,
    accum_false_pos) when states are involved, else just map."""
    helper = LayerHelper("detection_map")
    ins = {"DetectRes": [detect_res], "Label": [label]}
    if input_states is not None:
        ins["PosCount"], ins["TruePos"], ins["FalsePos"] = \
            [input_states[0]], [input_states[1]], [input_states[2]]
    outs = _op(helper, "detection_map", ins,
               ("MAP", "AccumPosCount", "AccumTruePos", "AccumFalsePos"),
               {"class_num": int(class_num),
                "background_label": int(background_label),
                "overlap_threshold": float(overlap_threshold),
                "evaluate_difficult": bool(evaluate_difficult),
                "ap_type": ap_version})
    if input_states is not None or out_states is not None:
        return (outs["MAP"], outs["AccumPosCount"], outs["AccumTruePos"],
                outs["AccumFalsePos"])
    return outs["MAP"]
