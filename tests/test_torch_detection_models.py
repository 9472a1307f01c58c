"""PyTorch port, detection programs: the reference's detection pipelines
and MobileNet-SSD, built from layers/detection.py in both packages and
held against the JAX reference on the CPU (the ops alone are held in
tests/test_torch_detection_ops.py).

* The reference's SSD-style and Faster-RCNN-style programs (tests/
  test_detection_pipelines.py) at their tiny sizes, `use_random=False`:
  three Adam steps against the reference from its startup arrays, and
  the SSD's decode branch.
* MobileNet-SSD (tests/torch_detection_op_cases.py `mobilenet_ssd`, the
  PaddleCV/ssd network): descs equal at scale 0.25 (image 300) with the
  RMSProp step and the decode program; one step against the reference
  at scale 0.125 and image 64 by the floor method; `run_steps` == `run`
  and fleet's ZeRO stage 1 == stage 0 (Momentum) bit for bit.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as fluid
from paddle_tpu.framework.scope import Scope as RefScope

from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.framework import Executor, Scope, load_numpy
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name

import torch_detection_op_cases as cases
from test_torch_detection_ops import ATOL, PORT, REF, RTOL, _descs


STEPS = 3


def _rcnn(ns):
    """tests/test_detection_pipelines.py's Faster-RCNN-style network."""
    L = ns.L
    feat = L.data(name="image", shape=[8, 16, 16], dtype="float32")
    gt_boxes = L.data(name="gt_boxes", shape=[3, 4], dtype="float32")
    gt_classes = L.data(name="gt_classes", shape=[3], dtype="int64")
    is_crowd = L.data(name="is_crowd", shape=[3], dtype="int64")
    im_info = L.data(name="im_info", shape=[3], dtype="float32")
    body = L.conv2d(feat, 16, 3, padding=1, act="relu")
    a_per_loc, hw = 3, 16 * 16
    rpn_cls = L.conv2d(body, a_per_loc, 1)
    rpn_reg = L.conv2d(body, a_per_loc * 4, 1)
    anchors, avar = L.anchor_generator(body, anchor_sizes=[16, 32, 64],
                                       aspect_ratios=[1.0], stride=[8, 8])
    cls_pred = L.reshape(L.transpose(rpn_cls, [0, 2, 3, 1]),
                         [0, hw * a_per_loc, 1])
    loc_pred = L.reshape(L.transpose(rpn_reg, [0, 2, 3, 1]),
                         [0, hw * a_per_loc, 4])
    score_pred, bbox_pred, score_tgt, loc_tgt, bbox_w, score_w = \
        L.rpn_target_assign(loc_pred, cls_pred, anchors, avar, gt_boxes,
                            is_crowd, im_info, rpn_batch_size_per_im=64,
                            rpn_positive_overlap=0.5,
                            rpn_negative_overlap=0.3, use_random=False)
    rpn_cls_loss = L.reduce_sum(L.elementwise_mul(
        L.sigmoid_cross_entropy_with_logits(score_pred, score_tgt),
        score_w)) / 128.0
    rpn_reg_loss = L.reduce_sum(L.smooth_l1(
        bbox_pred, loc_tgt, inside_weight=bbox_w,
        outside_weight=bbox_w)) / 64.0
    rois, _, rois_num = L.generate_proposals(
        L.sigmoid(rpn_cls), rpn_reg, im_info, anchors, avar,
        pre_nms_top_n=128, post_nms_top_n=32, nms_thresh=0.7, min_size=4.0,
        return_rois_num=True)
    s_rois, s_labels, bbox_targets, bbox_in_w, bbox_out_w, s_num, roi_w = \
        L.generate_proposal_labels(
            rois, gt_classes, is_crowd, gt_boxes, im_info,
            batch_size_per_im=16, fg_fraction=0.5, fg_thresh=0.5,
            bg_thresh_hi=0.5, bg_thresh_lo=0.0, class_nums=3,
            use_random=False, rpn_rois_num=rois_num,
            return_roi_weights=True)
    pooled = L.roi_align(body, s_rois, pooled_height=4, pooled_width=4,
                         spatial_scale=1.0 / 8.0, rois_num=s_num)
    fc6 = L.fc(L.reshape(pooled, [-1, 16 * 4 * 4]), 64, act="relu")
    cls_logits = L.fc(fc6, 3)
    bbox_reg = L.fc(fc6, 4 * 3)
    cls_loss = L.reduce_sum(L.elementwise_mul(
        L.softmax_with_cross_entropy(cls_logits, L.cast(s_labels, "int64")),
        roi_w)) / 32.0
    reg_loss = L.reduce_sum(L.smooth_l1(
        bbox_reg, bbox_targets, inside_weight=bbox_in_w,
        outside_weight=bbox_out_w)) / 32.0
    return rpn_cls_loss + rpn_reg_loss + cls_loss + reg_loss


def _rcnn_feed(rng, b=2):
    gt = np.zeros((b, 3, 4), np.float32)
    cls = np.zeros((b, 3), np.int64)
    for i in range(b):
        for j in range(rng.randint(1, 3)):
            x1, y1 = rng.uniform(0, 80, 2)
            w, h = rng.uniform(20, 46, 2)
            gt[i, j] = [x1, y1, min(x1 + w, 127), min(y1 + h, 127)]
            cls[i, j] = rng.randint(1, 3)
    return {"image": rng.randn(b, 8, 16, 16).astype(np.float32) * 0.5,
            "gt_boxes": gt, "gt_classes": cls,
            "is_crowd": np.zeros((b, 3), np.int64),
            "im_info": np.tile(np.asarray([[128.0, 128.0, 1.0]], np.float32),
                               (b, 1))}


def _ssd_tiny(ns):
    """tests/test_detection_pipelines.py's SSD-style network, with its
    decode branch."""
    L = ns.L
    image = L.data(name="image", shape=[3, 32, 32], dtype="float32")
    gt_box = L.data(name="gt_box", shape=[4, 4], dtype="float32")
    gt_label = L.data(name="gt_label", shape=[4, 1], dtype="int64")
    c1 = L.conv2d(image, 16, 3, stride=2, padding=1, act="relu")
    c2 = L.conv2d(c1, 32, 3, stride=2, padding=1, act="relu")
    pb, pbv = L.prior_box(c2, image, min_sizes=[8.0], max_sizes=[16.0],
                          aspect_ratios=[2.0], flip=True, clip=True)
    n_loc, ncls = 4, 3
    p_total = 8 * 8 * n_loc
    loc = L.reshape(L.transpose(L.conv2d(c2, n_loc * 4, 3, padding=1),
                                [0, 2, 3, 1]), [0, p_total, 4])
    conf = L.reshape(L.transpose(L.conv2d(c2, n_loc * ncls, 3, padding=1),
                                 [0, 2, 3, 1]), [0, p_total, ncls])
    prior, pvar = L.reshape(pb, [-1, 4]), L.reshape(pbv, [-1, 4])
    loss = L.mean(L.ssd_loss(loc, conf, gt_box, gt_label, prior, pvar,
                             overlap_threshold=0.5, neg_pos_ratio=3.0))
    det, det_num = L.detection_output(loc, conf, prior, pvar,
                                      score_threshold=0.01, nms_top_k=50,
                                      keep_top_k=10)
    return loss, det, det_num


def _ssd_tiny_feed(rng, b=2):
    gt = np.zeros((b, 4, 4), np.float32)
    gl = np.zeros((b, 4, 1), np.int64)
    for i in range(b):
        for j in range(rng.randint(1, 4)):
            x1, y1 = rng.uniform(0.0, 0.6, 2)
            gt[i, j] = [x1, y1, x1 + rng.uniform(0.15, 0.4),
                        y1 + rng.uniform(0.15, 0.4)]
            gl[i, j, 0] = rng.randint(1, 3)
    return {"image": rng.randn(b, 3, 32, 32).astype(np.float32),
            "gt_box": np.clip(gt, 0, 1), "gt_label": gl}


def _built(ns, build, opt):
    main, start = ns.prog.Program(), ns.prog.Program()
    with ns.prog.program_guard(main, start), ns.names.guard():
        out = build(ns)
        loss = out[0] if isinstance(out, tuple) else out
        opt(ns).minimize(loss)
    return main, start, out


def _persistable_names(main):
    return sorted(v.name for v in main.global_block().vars.values()
                  if v.persistable and not v.name.startswith("__"))


def _against_reference(build, feeds, opt):
    """`feeds` steps of `build` in both packages from the reference's
    startup arrays: (reference losses, port losses, reference
    persistables, port scope, the last step's fetches of both, the
    startup arrays)."""
    ref_main, ref_start, ref_out = _built(REF, build, opt)
    scope, exe = RefScope(), fluid.Executor()
    exe.run(ref_start, scope=scope)
    init = {n: np.asarray(scope.find(n)) for n in scope.local_names()
            if not n.startswith("__")}
    ref_fetch = list(ref_out) if isinstance(ref_out, tuple) else [ref_out]
    ref_losses, ref_last = [], None
    for f in feeds:
        got = exe.run(ref_main, feed=f, fetch_list=ref_fetch, scope=scope)
        ref_losses.append(float(np.asarray(got[0]).reshape(-1)[0]))
        ref_last = got
    ref_state = {n: np.asarray(scope.find(n))
                 for n in _persistable_names(ref_main)}
    main, start, out = _built(PORT, build, opt)
    assert main.to_desc() == ref_main.to_desc()
    pscope, pexe = Scope(), Executor("cpu")
    pexe.run(start, scope=pscope)
    load_numpy(pscope, init, "cpu")
    fetch = list(out) if isinstance(out, tuple) else [out]
    losses, last = [], None
    for f in feeds:
        got = pexe.run(main, feed=f, fetch_list=fetch, scope=pscope)
        losses.append(float(np.asarray(got[0]).reshape(-1)[0]))
        last = got
    return ref_losses, losses, ref_state, pscope, (ref_last, last), init


@pytest.mark.parametrize("which", ["ssd", "faster_rcnn"])
def test_reference_pipelines_train_as_the_reference(which):
    rng = np.random.RandomState(1 if which == "ssd" else 0)
    if which == "ssd":
        feed = _ssd_tiny_feed(rng)
        build = _ssd_tiny
    else:
        feed = _rcnn_feed(rng)
        build = _rcnn
    ref_losses, losses, ref_state, scope, (ref_last, last), _ = \
        _against_reference(build, [feed] * STEPS,
                           lambda ns: ns.opt.Adam(learning_rate=2e-3))
    np.testing.assert_allclose(losses, ref_losses, rtol=RTOL)
    assert losses[-1] < losses[0]
    for n, want in ref_state.items():
        np.testing.assert_allclose(scope.numpy(n), want, rtol=RTOL,
                                   atol=ATOL, err_msg=n)
    if which == "ssd":
        det, num = last[1:]
        ref_det, ref_num = (np.asarray(v) for v in ref_last[1:])
        assert np.array_equal(np.asarray(num), ref_num)
        assert det.shape == ref_det.shape == (20, 6)
        np.testing.assert_array_equal(det[:, 0], ref_det[:, 0])
        np.testing.assert_allclose(det, ref_det, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# MobileNet-SSD
# ---------------------------------------------------------------------------

SSD_SMALL = {"image": 64, "scale": 0.125}
SSD_BATCH = 2


def _ssd(ns, image=300, scale=0.25, decode=False):
    net = cases.mobilenet_ssd(ns.L, ns.ParamAttr, ns.MSRA, image=image,
                              scale=scale)
    if decode:
        return net, cases.ssd_decode(ns.L, net)
    return net


def _rmsprop(ns):
    return ns.opt.RMSProp(
        learning_rate=ns.L.piecewise_decay(cases.SSD_BOUNDARIES,
                                           cases.SSD_VALUES),
        regularization=ns.L2Decay(cases.SSD_L2))


def test_mobilenet_ssd_descs_equal_reference():
    """Scale 0.25 at image 300: the network, the decode program and the
    RMSProp step; 1,917 priors."""
    def build(ns):
        net, _ = _ssd(ns, decode=True)
        _rmsprop(ns).minimize(net["loss"])
        return net
    ref, port = _descs(build)
    assert port == ref
    main, start = port_program.Program(), port_program.Program()
    with port_program.program_guard(main, start), port_unique_name.guard():
        net = _ssd(PORT)
    assert net["prior"].shape == (cases.SSD_PRIORS, 4)
    assert net["conf"].shape == (-1, cases.SSD_PRIORS, cases.VOC_CLASSES)
    ops = [op.type for op in main.global_block().ops]
    assert ops.count("conv2d") == 27 + 8 + 12 and ops.count("prior_box") == 6


FLOOR_X, FLOOR_ATOL = 4.0, 1e-6


def _sgd_l2(ns):
    return ns.opt.SGD(learning_rate=1.0,
                      regularization=ns.L2Decay(cases.SSD_L2))


def test_mobilenet_ssd_step_matches_reference():
    """Scale 0.125, image 64, batch 2: one step from the reference's
    startup arrays, SGD at lr 1 with L2Decay (so the step is the
    gradient). The loss within RTOL; the step of every parameter, and the
    change of the batch-norm running statistics, each group by the floor
    method: a random MobileNet at this width is ill-conditioned (the
    gradient of some tensors moves by ~2% when the weights move by 1e-7),
    so the distance of the port's change from the reference's, over the
    group, is held within FLOOR_X times that of the port's own change
    from weights nudged by (1 + 1e-7 N(0, 1)). RMSProp's first step moves
    each weight by about lr / sqrt(1 - rho) whatever the gradient's size,
    so there it would compare the signs of gradients near zero; the
    RMSProp program's descs are held above."""
    feed = cases.ssd_feed(SSD_BATCH, image=SSD_SMALL["image"], seed=3)
    feed.pop("difficult")

    def build(ns):
        return _ssd(ns, **SSD_SMALL)["loss"]
    ref_loss, losses, ref_state, scope, _, init = _against_reference(
        build, [feed], _sgd_l2)
    np.testing.assert_allclose(losses, ref_loss, rtol=RTOL)
    main, start, loss = _built(PORT, build, _sgd_l2)
    params = [p.name for p in main.global_block().all_parameters()
              if p.trainable]
    stats = [n for n in ref_state if n not in params
             and n != "learning_rate_0"]
    assert len(stats) == 2 * 35 and len(params) == 3 * 35 + 2 * 12
    rng = np.random.RandomState(25)
    nudged = {n: (v * (1 + 1e-7 * rng.randn(*v.shape))).astype(v.dtype)
              if n in params else v for n, v in init.items()}
    fscope, fexe = Scope(), Executor("cpu")
    fexe.run(start, scope=fscope)
    load_numpy(fscope, nudged, "cpu")
    fexe.run(main, feed=feed, fetch_list=[loss], scope=fscope)
    for names in (params, stats):
        ref_change = {n: ref_state[n] - init[n] for n in names}
        change = {n: scope.numpy(n) - init[n] for n in names}
        floor_change = {n: fscope.numpy(n) - nudged[n] for n in names}
        d, floor = _distance(change, ref_change), _distance(floor_change,
                                                              change)
        assert 0 < floor and d <= FLOOR_X * floor + FLOOR_ATOL, \
            (names[0], d, floor)


def _distance(a, b):
    """||a - b|| / ||b|| over every tensor of the group."""
    num = sum(float(np.sum((a[n] - b[n]) ** 2)) for n in b)
    return (num / sum(float(np.sum(b[n] ** 2)) for n in b)) ** 0.5


def _ssd_port(stage=None, momentum=False):
    main, start = port_program.Program(), port_program.Program()
    with port_program.program_guard(main, start), port_unique_name.guard():
        net = _ssd(PORT, **SSD_SMALL)
        opt = port_optimizer.Momentum(0.001, 0.9) if momentum \
            else _rmsprop(PORT)
        if stage is not None:
            port_fleet.init(is_collective=True)
            s = port_fleet.DistributedStrategy()
            s.sharding_stage = stage
            opt = port_fleet.distributed_optimizer(opt, s)
        opt.minimize(net["loss"])
    return main, start, net["loss"]


@pytest.fixture(scope="module")
def ssd_start():
    main, start, _ = _ssd_port()
    scope = Scope()
    Executor("cpu").run(start, scope=scope)
    feeds = [cases.ssd_feed(SSD_BATCH, image=SSD_SMALL["image"], seed=s)
             for s in range(2)]
    return {n: scope.numpy(n) for n in scope.local_names()}, feeds


def _ssd_run(built, init, feeds, window=False):
    main, start, loss = built
    scope, exe = Scope(), Executor("cpu")
    exe.run(start, scope=scope)
    load_numpy(scope, {n: v for n, v in init.items()
                       if scope.find(n) is not None}, "cpu")
    feeds = [{k: v for k, v in f.items() if k != "difficult"}
             for f in feeds]
    if window:
        stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
        got = exe.run_steps(len(feeds), main, feed=stacked,
                            fetch_list=[loss], scope=scope)[0]
        losses = [float(g) for g in got]
    else:
        losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                           scope=scope)[0]))
                  for f in feeds]
    params = {p.name: scope.numpy(p.name)
              for p in main.global_block().all_parameters()}
    return losses, params, exe


@pytest.mark.parametrize("arm", ["run_steps", "zero_stage1"])
def test_mobilenet_ssd_arms_equal_bit_for_bit(arm, ssd_start):
    """run_steps(2) against two Executor.run steps (RMSProp), and fleet's
    ZeRO stage 1 against stage 0 with Momentum(0.001, 0.9): losses and
    parameters bit for bit."""
    init, feeds = ssd_start
    if arm == "run_steps":
        built = _ssd_port()
        want, want_p, _ = _ssd_run(built, init, feeds)
        got, got_p, _ = _ssd_run(built, init, feeds, window=True)
    else:
        want, want_p, _ = _ssd_run(_ssd_port(0, True), init, feeds)
        built = _ssd_port(1, True)
        assert sum(op.type == "__zero_update__"
                   for op in built[0].global_block().ops) >= 1
        got, got_p, _ = _ssd_run(built, init, feeds)
    assert np.isfinite(want).all() and want[1] != want[0]
    assert got == want
    for n in want_p:
        assert np.array_equal(got_p[n], want_p[n]), n
