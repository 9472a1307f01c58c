"""PyTorch port, detection: paddle_tpu_torch/ops/detection_ops.py,
detection_assign_ops.py, tail_ops.py's alias `multiclass_nms2` and the 31
builders of layers/detection.py, held against the JAX reference on the
CPU.

* One parity case per type of the reference's ops/detection_ops.py (21
  types), ops/detection_assign_ops.py (7) and the alias, and more arms of
  some, from tests/torch_detection_op_cases.py: f32 at rtol 1e-4 / atol
  1e-5, integer, index and bool outputs equal. The arms hold exact IoU
  ties on a regular prior grid, tied NMS scores and duplicate boxes,
  `nms_eta` < 1, an image whose truths are all padding.
* A vjp case (torch.func.vjp over the port's lowering against jax.vjp
  over the reference's, the same cotangents) for the differentiable
  types.
* `use_random=True`: the sampled fg and bg counts equal the reference's,
  and the draw is the same twice from one seed.
* `test_every_detection_op_type_has_a_case` re-reads the two reference
  files: their 28 types and the alias registered in the port with the
  reference's flags and shape rules.
* The 31 builders give the reference's descs.

The programs built on them (the reference's pipelines, MobileNet-SSD)
are held in tests/test_torch_detection_models.py.
"""
import pathlib
import re
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import initializer as ref_initializer
from paddle_tpu import layers as ref_layers
from paddle_tpu import regularizer as ref_regularizer
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.layer_helper import ParamAttr as RefParamAttr
from paddle_tpu.ops import registry as ref_registry

from paddle_tpu_torch import initializer as port_initializer
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch import regularizer as port_regularizer
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.layer_helper import ParamAttr as PortParamAttr
from paddle_tpu_torch.ops import registry as port_registry

import jax
import jax.numpy as jnp

import torch_detection_op_cases as cases
import torch_extra_op_cases
from test_torch_tail_ops import _NoHostReads, _dtype, _flat, _jax, _np, \
    _run_port

CASES = cases.detection_cases()
RTOL, ATOL = 1e-4, 1e-5


def _run_ref(op, ins, attrs):
    """The reference's lowering on the CPU under one jax.jit a case."""
    jins = {s: [_jax(a, jnp.float32) for a in vs] for s, vs in ins.items()}
    ctx = ref_registry.LowerCtx(rng_key=jax.random.key(0))
    lower = ref_registry.get(op).lower
    return jax.jit(lambda v: lower(ctx, v, dict(attrs)))(jins)


def _assert_close(ref, port, values=True):
    """The same slots, shapes and dtypes; floats within RTOL / ATOL,
    integers and bools equal."""
    ref, port = _flat(ref), _flat(port)
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    for slot in ref:
        assert len(port[slot]) == len(ref[slot]), slot
        for r, p in zip(ref[slot], port[slot]):
            if r is None:
                assert p is None, slot
                continue
            assert tuple(p.shape) == tuple(r.shape), (slot, p.shape, r.shape)
            assert _dtype(p) == _dtype(r), (slot, _dtype(p), _dtype(r))
            if not values:
                continue
            if p.is_floating_point():
                np.testing.assert_allclose(_np(p), _np(r), rtol=RTOL,
                                           atol=ATOL, err_msg=slot)
            else:
                assert np.array_equal(_np(p), _np(r)), slot


PARITY = sorted(c for c in CASES if c not in cases.RANDOM)


@pytest.mark.parametrize("case", PARITY)
def test_detection_lowering_matches_reference(case):
    ins, attrs = CASES[case]
    op = cases.op_of(case)
    _assert_close(_run_ref(op, ins, attrs), _run_port(op, ins, attrs))


@pytest.mark.parametrize("case", sorted(cases.VJP_CASES))
def test_detection_vjp_matches_reference(case):
    ins, attrs = CASES[case]
    op = cases.op_of(case)
    outs = _run_ref(op, ins, attrs)
    outs = {s: outs[s] for s in _run_port(op, ins, attrs)}
    vjp_ins, vattrs = torch_extra_op_cases.vjp_case(
        op, ins, attrs, outs, ref_registry.make_vjp_attrs,
        nondiff=ref_registry.get(op).nondiff_slots)
    assert vattrs["diff_entries"]
    _assert_close(_run_ref("__vjp__", vjp_ins, vattrs),
                  _run_port("__vjp__", vjp_ins, vattrs))


def _reference_types(name):
    root = pathlib.Path(ref_registry.__file__).parent
    return re.findall(r'register\("(\w+)"', (root / name).read_text())


def test_every_detection_op_type_has_a_case():
    """The two reference files register 21 + 7 types; with tail_ops.py's
    alias multiclass_nms2 each has a case here and is registered in the
    port with the reference's flags; the types with the reference's
    build-time shape rules have one in the port."""
    det = _reference_types("detection_ops.py")
    assign = _reference_types("detection_assign_ops.py")
    assert tuple(det) == cases.DETECTION_OPS
    assert tuple(assign) == cases.ASSIGN_OPS
    all_types = det + assign + list(cases.ALIASES)
    assert len(set(all_types)) == 29
    assert {cases.op_of(c) for c in CASES} == set(all_types)
    for t in all_types:
        ref, port = ref_registry.get(t), port_registry.get(t)
        assert (port.nondiff_slots, port.stateful_outputs, port.is_random) \
            == (ref.nondiff_slots, ref.stateful_outputs, ref.is_random), t
        if t not in cases.ALIASES:
            assert (port.infer is None) == (ref.infer is None), t
    # the reference makes its alias before it attaches multiclass_nms's
    # shape rule, so its alias has none; the port's shares its target's
    assert port_registry.get("multiclass_nms2").infer \
        is port_registry.get("multiclass_nms").infer
    random_types = {t for t in all_types if ref_registry.get(t).is_random}
    assert random_types == {"rpn_target_assign", "generate_proposal_labels"}
    assert {cases.op_of(c) for c in cases.RANDOM} == random_types
    assert cases.VJP_CASES <= set(CASES)


def test_shared_cases_import_numpy_only():
    import ast
    tree = ast.parse(pathlib.Path(cases.__file__).read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert mods == {"numpy"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lowering_reads_nothing_on_the_host(case):
    ins, attrs = CASES[case]
    with _NoHostReads():
        _run_port(cases.op_of(case), ins, attrs)


@pytest.mark.parametrize("case", sorted(cases.RANDOM))
def test_random_sampling_counts_equal_reference(case):
    """use_random=True: the reference's slots, shapes and dtypes; the
    sampled fg and bg counts of each image equal the reference's, the
    draw is the same twice from one seed; the sampled rows are among the
    candidates use_random=False samples from."""
    ins, attrs = CASES[case]
    op = cases.op_of(case)
    ref = _run_ref(op, ins, attrs)
    port = _run_port(op, ins, attrs)
    _assert_close(ref, port, values=False)
    again = _run_port(op, ins, attrs)
    for s in port:
        for a, b in zip(port[s], again[s]):
            assert torch.equal(a, b), s
    if op == "rpn_target_assign":
        def counts(o):
            lab = _np(o["TargetLabel"][0])[..., 0]
            w = _np(o["ScoreWeight"][0])[..., 0]
            return (lab * w).sum(1), ((1 - lab) * w).sum(1)
    else:
        def counts(o):
            lab = _np(o["LabelsInt32"][0]).reshape(2, -1)
            live = _np(o["RoiWeights"][0]).reshape(2, -1)
            return (lab > 0).sum(1), ((lab == 0) & (live > 0)).sum(1)
    for r, p in zip(counts(ref), counts(port)):
        assert np.array_equal(r, p)
    assert counts(port)[0].sum() > 0 and counts(port)[1].sum() > 0


def test_nms_keeps_tied_scores_in_input_order():
    """Ties in score keep their input order (the stable sort), as the
    reference's jnp.argsort: the kept rows' indices equal the reference's
    and are not a sorted-by-index accident."""
    ins, attrs = CASES["multiclass_nms:ties"]
    scores = ins["Scores"][0][0]
    assert len(set(scores[1].tolist())) < scores.shape[1]
    ref = np.asarray(_run_ref("multiclass_nms", ins, attrs)["Index"][0])
    port = _run_port("multiclass_nms", ins, attrs)["Index"][0].numpy()
    assert np.array_equal(port, ref)
    live = port[port >= 0]
    assert len(live) > 3 and list(live) != sorted(live)


def test_bipartite_takes_the_first_maximum_on_grid_ties():
    """The regular prior grid gives a truth equal IoUs with several
    priors: the matched prior is the first in row-major order."""
    ins, attrs = CASES["bipartite_match:grid_ties"]
    dist = ins["DistMat"][0]
    row = dist[0]
    assert (row == row.max()).sum() > 1
    port = _run_port("bipartite_match", ins,
                     dict(attrs, match_type="bipartite"))
    match = port["ColToRowMatchIndices"][0].numpy()[0]
    assert match[int(np.argmax(row))] == 0


# ---------------------------------------------------------------------------
# the builders
# ---------------------------------------------------------------------------

REF = types.SimpleNamespace(prog=ref_program, names=ref_unique_name,
                            L=ref_layers, ParamAttr=RefParamAttr,
                            opt=paddle.optimizer, fleet=ref_fleet,
                            MSRA=ref_initializer.MSRA,
                            L2Decay=ref_regularizer.L2Decay)
PORT = types.SimpleNamespace(prog=port_program, names=port_unique_name,
                             L=port_layers, ParamAttr=PortParamAttr,
                             opt=port_optimizer, fleet=port_fleet,
                             MSRA=port_initializer.MSRA,
                             L2Decay=port_regularizer.L2Decay)


def _builders(ns):
    """Every builder of layers/detection.py's __all__, most in two arms."""
    L = ns.L
    img = L.data(name="img", shape=[3, 32, 32], dtype="float32")
    feat = L.data(name="feat", shape=[8, 4, 4], dtype="float32")
    L.prior_box(feat, img, [8.0], [16.0], [2.0], flip=True, clip=True)
    L.prior_box(feat, img, [4.0, 9.0], aspect_ratios=[2.0, 3.0],
                steps=[8.0, 8.0], offset=0.3)
    L.density_prior_box(feat, img, [2, 1], [8.0, 16.0], [1.0, 2.0],
                        clip=True)
    L.anchor_generator(feat, [16, 32], [0.5, 1.0], [8.0, 8.0])
    prior = L.data(name="prior", shape=[6, 4], dtype="float32",
                   append_batch_size=False)
    pvar = L.data(name="pvar", shape=[6, 4], dtype="float32",
                  append_batch_size=False)
    tbox = L.data(name="tbox", shape=[4], dtype="float32")
    deltas = L.data(name="deltas", shape=[6, 4], dtype="float32")
    L.box_coder(prior, pvar, tbox)
    L.box_coder(prior, [0.1, 0.1, 0.2, 0.2], deltas,
                code_type="decode_center_size", box_normalized=False)
    L.iou_similarity(tbox, prior, box_normalized=False)
    info = L.data(name="info", shape=[3], dtype="float32")
    L.box_clip(deltas, info)
    yx = L.data(name="yx", shape=[16, 4, 4], dtype="float32")
    ysize = L.data(name="ysize", shape=[2], dtype="int32")
    L.yolo_box(yx, ysize, [10, 13, 16, 30], 3, 0.01, 8)
    ygt = L.data(name="ygt", shape=[3, 4], dtype="float32")
    ylab = L.data(name="ylab", shape=[3], dtype="int32")
    yscore = L.data(name="yscore", shape=[3], dtype="float32")
    L.yolov3_loss(yx, ygt, ylab, [10, 13, 16, 30], [0, 1], 3, 0.7, 8)
    L.yolov3_loss(yx, ygt, ylab, [10, 13, 16, 30], [0, 1], 3, 0.5, 8,
                  gt_score=yscore, use_label_smooth=False, scale_x_y=1.1)
    boxes = L.data(name="boxes", shape=[6, 4], dtype="float32")
    scores = L.data(name="scores", shape=[3, 6], dtype="float32")
    L.multiclass_nms(boxes, scores, 0.1, 5, 4)
    L.multiclass_nms(boxes, scores, 0.1, 5, 4, nms_eta=0.9,
                     return_index=True)
    L.matrix_nms(boxes, scores, 0.1, 0.05, 5, 4)
    L.matrix_nms(boxes, scores, 0.1, 0.05, 5, 4, use_gaussian=True,
                 return_index=True)
    dist = L.data(name="dist", shape=[3, 6], dtype="float32",
                  append_batch_size=False)
    L.bipartite_match(dist)
    match, _ = L.bipartite_match(dist, "per_prediction", 0.3)
    rows = L.data(name="rows", shape=[3, 4], dtype="float32")
    neg = L.data(name="neg", shape=[6], dtype="int32")
    L.target_assign(rows, match, negative_indices=neg, mismatch_value=0)
    L.target_assign(rows, match)
    rs = L.data(name="rs", shape=[3, 4, 4], dtype="float32")
    rd = L.data(name="rd", shape=[12, 4, 4], dtype="float32")
    anchors, avar = L.anchor_generator(rs, [16, 32, 64], [1.0], [8, 8])
    rois, probs, num = L.generate_proposals(rs, rd, info, anchors, avar,
                                            return_rois_num=True)
    L.generate_proposals(rs, rd, info, anchors, avar, 100, 20, 0.7, 1.0)
    multi, restore, counts = L.distribute_fpn_proposals(rois, 2, 5, 4, 224,
                                                        rois_num=num)
    L.distribute_fpn_proposals(rois, 2, 4, 3, 224)
    L.collect_fpn_proposals(multi[:2], [probs, probs], 2, 3, 50)
    L.collect_fpn_proposals(multi[:2], [probs, probs], 2, 3, 50,
                            rois_num_per_level=[counts, counts])
    L.retinanet_detection_output([deltas], [scores], [prior], info)
    fg = L.data(name="fg", shape=[1], dtype="int32")
    L.sigmoid_focal_loss(scores, ylab, fg, gamma=1.5)
    L.roi_align(feat, rois, 2, 2, 0.25, 2, rois_num=num)
    L.roi_pool(feat, rois, 2, 3, 0.25)
    L.psroi_pool(feat, rois, 2, 0.25, 2, 2)
    L.prroi_pool(feat, rois, 0.25, 2, 2, batch_roi_nums=num)
    L.box_decoder_and_assign(prior, pvar, deltas, scores, 4.135)
    gtb = L.data(name="gtb", shape=[3, 4], dtype="float32")
    crowd = L.data(name="crowd", shape=[3], dtype="int32")
    gcls = L.data(name="gcls", shape=[3], dtype="int32")
    L.rpn_target_assign(deltas, scores, anchors, avar, gtb, crowd, info,
                        use_random=False)
    L.retinanet_target_assign(deltas, scores, anchors, avar, gtb, gcls,
                              crowd, info, num_classes=3)
    s_rois, labels, *_, s_num, rw = L.generate_proposal_labels(
        rois, gcls, crowd, gtb, info, class_nums=3, rpn_rois_num=num,
        return_roi_weights=True)
    segm = L.data(name="segm", shape=[3, 8, 8], dtype="int32")
    L.generate_mask_labels(info, gcls, crowd, segm, s_rois, labels, 3, 4,
                           gt_boxes=gtb, rois_num=s_num)
    tb = L.data(name="tb", shape=[6, 8], dtype="float32")
    L.locality_aware_nms(tb, scores, 0.1, 5, 4)
    quads = L.data(name="quads", shape=[8], dtype="float32")
    L.roi_perspective_transform(feat, quads, 3, 4, 0.5)
    loc = L.data(name="loc", shape=[6, 4], dtype="float32")
    conf = L.data(name="conf", shape=[6, 3], dtype="float32")
    glab = L.data(name="glab", shape=[3, 1], dtype="int32")
    L.ssd_loss(loc, conf, gtb, glab, prior, pvar)
    L.ssd_loss(loc, conf, gtb, glab, prior, match_type="bipartite",
               neg_pos_ratio=2.0, normalize=False)
    det, idx, cnt = L.detection_output(loc, conf, prior, pvar,
                                       keep_top_k=4, return_index=True)
    L.detection_output(loc, conf, prior, pvar, nms_threshold=0.45)
    label = L.data(name="label", shape=[3, 6], dtype="float32")
    L.detection_map(L.reshape(det, [-1, 4, 6]), label, 3)
    L.detection_map(L.reshape(det, [-1, 4, 6]), label, 3,
                    ap_version="11point", out_states=[])


def _descs(build, *args):
    out = []
    for ns in (REF, PORT):
        main, start = ns.prog.Program(), ns.prog.Program()
        with ns.prog.program_guard(main, start), ns.names.guard():
            build(ns, *args)
        out.append((main.to_desc(), start.to_desc()))
    return out


def test_builders_give_the_reference_descs():
    ref, port = _descs(_builders)
    assert port == ref
    used = {op["type"] for op in port[0]["blocks"][0]["ops"]}
    exported = set(port_layers.detection.__all__)
    assert len(exported) == 31
    assert exported == set(ref_layers.detection.__all__)
    assert {"multiclass_nms", "ssd_loss", "detection_map", "psroi_pool",
            "prroi_pool", "sigmoid_focal_loss"} <= used
