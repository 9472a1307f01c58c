"""Inputs for the extra ops (paddle_tpu_torch/ops/extra_ops.py) and the
book's recommender system, shared by tests/test_torch_extra_ops.py (the
port against the JAX reference on the CPU) and chip_smoke.py's phase 19
(the port on the card against the port on the CPU). numpy only: nothing
here imports JAX or either package.

* `extra_cases()`: {case: (inputs, attrs)} at small shapes from a numpy
  seed, one case per op type and more arms of some (`<op>:<arm>`); ints
  are int32, as the device holds them. Inputs hold what the ports write
  out by hand: ties in the pooling with index, repeated indices in the
  scatters and segment sums, an empty segment, grid points outside the
  image, a matrix that is not positive definite, an infeasible CTC
  alignment.
* `VJP_CASES`: the cases whose pullback is held too; `BF16_CASES`: the
  cases AMP can hand bf16 operands (the ops that follow a white-list
  product: activations, rearrangements, the scorer).
* `vjp_case(op, ins, attrs, outs, make_vjp_attrs)`: the `__vjp__` op's
  inputs and attrs for a forward case whose outputs are `outs`.
* `recsys(L, ...)` builds the PaddlePaddle book's recommender system
  (chapter 5, test_recommender_system.py) with a layers module `L`;
  `recsys_feed` draws its batches.
"""
import numpy as np

# --------------------------------------------------------------------------
# the extra ops
# --------------------------------------------------------------------------


def extra_cases():
    rng = np.random.RandomState(22)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    i32 = lambda lo, hi, *s: rng.randint(lo, hi, s).astype(np.int32)  # noqa
    unit = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)  # noqa
    binary = lambda *s: (rng.rand(*s) < 0.5).astype(np.float32)  # noqa
    ties = lambda *s: (np.round(f(*s) * 2) / 2).astype(np.float32)  # noqa

    def logp(*s):
        x = f(*s)
        x = x - x.max(1, keepdims=True)
        return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(
            np.float32)

    def probs(*s):
        e = np.exp(f(*s))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    def spd(b, n):
        m = f(b, n, n)
        return (m @ np.swapaxes(m, -1, -2)
                + n * np.eye(n, dtype=np.float32)).astype(np.float32)

    not_pd = spd(2, 4)
    not_pd[1] = -not_pd[1]
    nll_label = i32(0, 5, 6, 1)
    nll_label[2, 0] = -100                       # an ignored row
    target = probs(4, 5)
    target[0, 1] = 0.0                           # a zero target
    seg = np.array([0, 0, 1, 3, 3, 3], np.int32)  # segment 2 and 4 empty
    pooled = ties(2, 3, 4, 6)
    pool_idx = _max_pool_flat_indices(pooled, 2)
    spectral = f(4, 3, 2)
    x_pool3 = f(1, 2, 4, 5, 6)
    return {
        # losses
        "bce_loss": ({"X": [unit(0.05, 0.95, 4, 5)],
                      "Label": [binary(4, 5)]}, {}),
        "hinge_loss": ({"Logits": [f(6, 1)], "Labels": [binary(6, 1)]}, {}),
        "rank_loss": ({"Label": [binary(5, 1)], "Left": [f(5, 1)],
                       "Right": [f(5, 1)]}, {}),
        "margin_rank_loss": ({"Label": [np.where(binary(5, 1) > 0, 1.0, -1.0)
                                        .astype(np.float32)],
                              "X1": [f(5, 1)], "X2": [f(5, 1)]},
                             {"margin": 0.1}),
        "log_loss": ({"Predicted": [unit(0.05, 0.95, 6, 1)],
                      "Labels": [binary(6, 1)]}, {"epsilon": 1e-4}),
        "bpr_loss": ({"X": [f(4, 6)], "Label": [i32(0, 6, 4, 1)]}, {}),
        "nll_loss": ({"X": [logp(6, 5)], "Label": [nll_label],
                      "Weight": [unit(0.5, 1.5, 5)]},
                     {"ignore_index": -100, "reduction": "mean"}),
        "nll_loss:sum": ({"X": [logp(6, 5)], "Label": [nll_label]},
                         {"reduction": "sum"}),
        "nll_loss:none_4d": ({"X": [logp(2, 5, 3, 3)],
                              "Label": [i32(0, 5, 2, 3, 3)]},
                             {"reduction": "none"}),
        "kldiv_loss": ({"X": [logp(4, 5)], "Target": [target]},
                       {"reduction": "mean"}),
        "kldiv_loss:batchmean": ({"X": [logp(4, 5)], "Target": [target]},
                                 {"reduction": "batchmean"}),
        "kldiv_loss:none": ({"X": [logp(4, 5)], "Target": [target]},
                            {"reduction": "none"}),
        "smooth_l1_loss": ({"X": [f(4, 3)], "Y": [f(4, 3)],
                            "InsideWeight": [unit(0.5, 1.5, 4, 3)],
                            "OutsideWeight": [unit(0.5, 1.5, 4, 3)]},
                           {"sigma": 2.0}),
        "huber_regression_loss": ({"X": [f(4, 3)], "Y": [f(4, 3)]},
                                  {"delta": 0.7}),
        "sigmoid_focal_loss": ({"X": [f(6, 4)], "Label": [i32(0, 5, 6, 1)],
                                "FgNum": [np.array([3], np.int32)]},
                               {"gamma": 2.0, "alpha": 0.25}),
        "center_loss": ({"X": [f(6, 3)], "Label": [i32(0, 3, 6, 1)],
                         "Centers": [f(4, 3)],
                         "CenterUpdateRate": [np.array([0.3], np.float32)]},
                        {"need_update": True}),
        "center_loss:alpha": ({"X": [f(6, 3)], "Label": [i32(0, 4, 6, 1)],
                               "Centers": [f(4, 3)]},
                              {"need_update": True, "alpha": 0.5}),
        # linalg
        "addmm": ({"Input": [f(3, 4)], "X": [f(3, 5)], "Y": [f(5, 4)]},
                  {"Alpha": 0.5, "Beta": 2.0}),
        "mv": ({"X": [f(4, 5)], "Vec": [f(5)]}, {}),
        "cholesky": ({"X": [spd(2, 4)]}, {"upper": False}),
        "cholesky:upper": ({"X": [spd(2, 4)]}, {"upper": True}),
        "cholesky:not_pd": ({"X": [not_pd]}, {}),
        "inverse": ({"Input": [spd(2, 3)]}, {}),
        "matrix_power": ({"X": [0.5 * f(3, 3)]}, {"n": 3}),
        "matrix_power:neg": ({"X": [spd(1, 3)[0]]}, {"n": -2}),
        "matrix_power:zero": ({"X": [f(3, 3)]}, {"n": 0}),
        "kron": ({"X": [f(2, 3)], "Y": [f(3, 2)]}, {}),
        "cross": ({"X": [f(4, 3)], "Y": [f(4, 3)]}, {"dim": 1}),
        "cross:unset": ({"X": [f(3, 4)], "Y": [f(3, 4)]}, {"dim": -100}),
        "dist": ({"X": [f(3, 4)], "Y": [f(3, 4)]}, {"p": 2.0}),
        "dist:inf": ({"X": [f(3, 4)], "Y": [f(3, 4)]}, {"p": float("inf")}),
        "dist:zero": ({"X": [ties(3, 4)], "Y": [ties(3, 4)]}, {"p": 0}),
        "dist:p3": ({"X": [f(3, 4)], "Y": [f(3, 4)]}, {"p": 3.0}),
        "frobenius_norm": ({"X": [f(3, 4, 5)]},
                           {"dim": [1, 2], "keep_dim": False}),
        "frobenius_norm:all": ({"X": [f(3, 4)]},
                               {"reduce_all": True, "keep_dim": True}),
        "logsumexp": ({"X": [f(3, 4)]}, {"axis": [1], "keepdim": True}),
        "logsumexp:all": ({"X": [f(3, 4)]}, {"reduce_all": True}),
        "l1_norm": ({"X": [f(3, 4)]}, {}),
        "norm": ({"X": [f(3, 4)]}, {"axis": 1, "epsilon": 1e-10}),
        "trace": ({"Input": [f(3, 4, 4)]},
                  {"offset": 1, "axis1": 1, "axis2": 2}),
        "cos_sim": ({"X": [f(5, 6)], "Y": [f(5, 6)]}, {}),
        "spectral_norm": ({"Weight": [spectral], "U": [f(4)], "V": [f(6)]},
                          {"dim": 0, "power_iters": 2, "eps": 1e-12}),
        "spectral_norm:dim1": ({"Weight": [spectral], "U": [f(3)],
                                "V": [f(8)]},
                               {"dim": 1, "power_iters": 1}),
        # indexing and rearrangement
        "index_sample": ({"X": [f(3, 6)], "Index": [i32(0, 6, 3, 4)]}, {}),
        "multiplex": ({"X": [f(4, 3), f(4, 3), f(4, 3)],
                       "Ids": [i32(0, 3, 4, 1)]}, {}),
        "reverse": ({"X": [f(2, 3, 4)]}, {"axis": [0, 2]}),
        "scatter_nd_add": ({"X": [f(5, 3)],
                            "Index": [np.array([[1], [3], [1], [0], [1],
                                                [4]], np.int32)],
                            "Updates": [f(6, 3)]}, {}),
        "scatter_nd_add:2d": ({"X": [f(4, 5)],
                               "Index": [np.array([[1, 2], [3, 0], [1, 2],
                                                   [0, 4]], np.int32)],
                               "Updates": [f(4)]}, {}),
        "scatter_nd": ({"Index": [np.array([[2], [0], [2], [5], [2]],
                                           np.int32)],
                        "Updates": [f(5, 3)]}, {"shape": [6, 3]}),
        "unbind": ({"X": [f(3, 4)]}, {"axis": 1}),
        "shard_index": ({"X": [i32(0, 20, 6, 1)]},
                        {"index_num": 20, "nshards": 3, "shard_id": 1,
                         "ignore_value": -1}),
        "squeeze": ({"X": [f(2, 1, 3, 1)]}, {"axes": [1]}),
        "squeeze:all": ({"X": [f(2, 1, 3, 1)]}, {"axes": []}),
        "squeeze:not_one": ({"X": [f(2, 1, 3, 1)]}, {"axes": [0]}),
        "unsqueeze": ({"X": [f(2, 3)]}, {"axes": [3, 0]}),
        "flatten": ({"X": [f(2, 3, 4)]}, {"axis": 2}),
        "flatten:zero": ({"X": [f(2, 3, 4)]}, {"axis": 0}),
        "crop_tensor": ({"X": [f(4, 5)]}, {"offsets": [1, 2],
                                           "shape": [2, 3]}),
        "crop": ({"X": [f(4, 5)]}, {"offsets": [0, 1], "shape": [3, 3]}),
        "pad_constant_like": ({"X": [f(4, 5)], "Y": [f(2, 3)]},
                              {"pad_value": 1.5}),
        "pad3d": ({"X": [f(1, 2, 3, 4, 5)]},
                  {"paddings": [1, 2, 0, 1, 2, 1], "mode": "constant",
                   "value": 0.5}),
        "pad3d:reflect": ({"X": [f(1, 2, 3, 4, 5)]},
                          {"paddings": [1, 2, 0, 1, 2, 1],
                           "mode": "reflect"}),
        "pad3d:replicate": ({"X": [f(1, 2, 3, 4, 5)]},
                            {"paddings": [1, 2, 0, 1, 2, 1],
                             "mode": "replicate"}),
        "pad3d:circular": ({"X": [f(1, 2, 3, 4, 5)]},
                           {"paddings": [1, 2, 0, 1, 2, 1],
                            "mode": "circular"}),
        "pixel_shuffle": ({"X": [f(1, 8, 2, 3)]}, {"upscale_factor": 2}),
        "space_to_depth": ({"X": [f(1, 2, 4, 6)]}, {"blocksize": 2}),
        "shuffle_channel": ({"X": [f(2, 6, 2, 2)]}, {"group": 3}),
        "temporal_shift": ({"X": [f(6, 4, 2, 2)]},
                           {"seg_num": 3, "shift_ratio": 0.25}),
        "unfold": ({"X": [f(2, 3, 5, 6)]},
                   {"kernel_sizes": [2, 3], "strides": [1, 2],
                    "paddings": [1, 0, 0, 1], "dilations": [1, 1]}),
        "unfold:dilated": ({"X": [f(2, 3, 5, 6)]},
                           {"kernel_sizes": [2, 2], "strides": [1, 1],
                            "paddings": [1, 1], "dilations": [2, 1]}),
        "affine_channel": ({"X": [f(2, 3, 4, 4)], "Scale": [f(3)],
                            "Bias": [f(3)]}, {"data_layout": "NCHW"}),
        "affine_channel:nhwc": ({"X": [f(2, 4, 4, 3)], "Scale": [f(3)],
                                 "Bias": [f(3)]}, {"data_layout": "NHWC"}),
        "label_smooth": ({"X": [probs(4, 5)]}, {"epsilon": 0.1}),
        "label_smooth:prior": ({"X": [probs(4, 5)],
                                "PriorDist": [probs(1, 5)]},
                               {"epsilon": 0.1}),
        "lrn": ({"X": [f(2, 6, 3, 3)]},
                {"n": 5, "k": 2.0, "alpha": 1e-2, "beta": 0.75}),
        "prelu": ({"X": [f(2, 3, 4, 4)], "Alpha": [unit(0.1, 0.3, 1)]},
                  {"mode": "all"}),
        "prelu:channel": ({"X": [f(2, 3, 4, 4)],
                           "Alpha": [unit(0.1, 0.3, 3)]},
                          {"mode": "channel"}),
        "prelu:element": ({"X": [f(2, 3, 4, 4)],
                           "Alpha": [unit(0.1, 0.3, 3, 4, 4)]},
                          {"mode": "element"}),
        "selu": ({"X": [f(3, 4)]}, {}),
        "mish": ({"X": [f(3, 4)]}, {}),
        "cvm": ({"X": [np.abs(f(4, 5))]}, {"use_cvm": True}),
        "cvm:off": ({"X": [np.abs(f(4, 5))]}, {"use_cvm": False}),
        "data_norm": ({"X": [f(4, 3)],
                       "BatchSize": [np.full(3, 10.0, np.float32)],
                       "BatchSum": [f(3)],
                       "BatchSquareSum": [unit(5.0, 15.0, 3)]},
                      {"epsilon": 1e-4}),
        "segment_pool": ({"X": [f(6, 3)], "SegmentIds": [seg]},
                         {"pooltype": "SUM", "num_segments": 5}),
        "segment_pool:mean": ({"X": [f(6, 3)], "SegmentIds": [seg]},
                              {"pooltype": "MEAN", "num_segments": 5}),
        "segment_pool:max": ({"X": [f(6, 3)], "SegmentIds": [seg]},
                             {"pooltype": "MAX", "num_segments": 5}),
        "segment_pool:min": ({"X": [f(6, 3)], "SegmentIds": [seg]},
                             {"pooltype": "MIN", "num_segments": 5}),
        "grid_sampler": ({"X": [f(2, 3, 4, 5)],
                          "Grid": [unit(-1.2, 1.2, 2, 3, 4, 2)]}, {}),
        # 3-D convolution and pooling, pooling with index
        "conv3d": ({"Input": [f(1, 4, 5, 5, 5)],
                    "Filter": [f(6, 2, 3, 3, 3)]},
                   {"strides": [1, 2, 1], "paddings": [1, 0, 1],
                    "dilations": [1, 1, 2], "groups": 2}),
        "conv3d_transpose": ({"Input": [f(1, 4, 3, 3, 3)],
                              "Filter": [f(6, 4, 3, 3, 3)]},
                             {"strides": [2, 1, 1], "paddings": [1, 0, 3],
                              "dilations": [1, 1, 1]}),
        "conv3d_transpose:dilated": ({"Input": [f(1, 4, 3, 3, 3)],
                                      "Filter": [f(6, 4, 2, 3, 2)]},
                                     {"strides": 1, "paddings": 1,
                                      "dilations": [2, 1, 1]}),
        "pool3d": ({"X": [x_pool3]},
                   {"pooling_type": "max", "ksize": [2, 3, 2],
                    "strides": [2, 1, 2], "paddings": [1, 1, 0]}),
        "pool3d:avg": ({"X": [x_pool3]},
                       {"pooling_type": "avg", "ksize": [2, 3, 2],
                        "strides": [2, 1, 2], "paddings": [1, 1, 0],
                        "exclusive": True}),
        "pool3d:avg_inclusive": ({"X": [x_pool3]},
                                 {"pooling_type": "avg", "ksize": 2,
                                  "strides": 2, "paddings": 1,
                                  "exclusive": False}),
        "pool3d:global": ({"X": [x_pool3]},
                          {"pooling_type": "max", "global_pooling": True}),
        "max_pool2d_with_index": ({"X": [ties(2, 3, 5, 6)]},
                                  {"ksize": [3, 3], "strides": [2, 2],
                                   "paddings": [1, 1]}),
        "max_pool2d_with_index:global": ({"X": [ties(2, 3, 4, 4)]},
                                         {"global_pooling": True}),
        "max_pool3d_with_index": ({"X": [ties(1, 2, 4, 4, 5)]},
                                  {"ksize": [2, 2, 2], "strides": [2, 2, 2],
                                   "paddings": [0, 1, 1]}),
        # activation tail
        "hard_shrink": ({"X": [f(3, 5)]}, {"threshold": 0.5}),
        "softshrink": ({"X": [f(3, 5)]}, {"lambda": 0.5}),
        "tanh_shrink": ({"X": [f(3, 5)]}, {}),
        "thresholded_relu": ({"X": [f(3, 5)]}, {"threshold": 0.3}),
        "stanh": ({"X": [f(3, 5)]}, {"scale_a": 0.67, "scale_b": 1.7159}),
        "relu_": ({"X": [f(3, 5)]}, {}),
        "maxout": ({"X": [f(2, 6, 3, 3)]}, {"groups": 2}),
        "celu": ({"X": [f(3, 5)]}, {"alpha": 1.5}),
        # misc tail
        "minus": ({"X": [f(3, 4)], "Y": [f(3, 4)]}, {}),
        "partial_concat": ({"X": [f(3, 5), f(3, 5)]},
                           {"start_index": 1, "length": 2}),
        "partial_concat:rest": ({"X": [f(3, 5), f(3, 5)]},
                                {"start_index": 2, "length": -1}),
        "partial_sum": ({"X": [f(3, 5), f(3, 5), f(3, 5)]},
                        {"start_index": 1, "length": 3}),
        "im2sequence": ({"X": [f(2, 3, 5, 6)]},
                        {"kernels": [2, 3], "strides": [1, 2],
                         "paddings": [1, 0, 0, 1]}),
        "lod_reset": ({"X": [f(3, 4)]}, {"target_lod": [0, 1, 3]}),
        "gru_unit": ({"Input": [f(4, 9)], "HiddenPrev": [f(4, 3)],
                      "Weight": [f(3, 9)], "Bias": [f(1, 9)]}, {}),
        "lstm_unit": ({"X": [f(4, 12)], "C_prev": [f(4, 3)]},
                      {"forget_bias": 0.5}),
        "row_conv": ({"X": [f(2, 5, 3)], "Filter": [f(3, 3)]}, {}),
        "fsp": ({"X": [f(2, 3, 4, 4)], "Y": [f(2, 5, 4, 4)]}, {}),
        "cross_entropy2": ({"X": [probs(4, 5)], "Label": [i32(0, 5, 4, 1)]},
                           {}),
        "size": ({"Input": [f(3, 4, 5)]}, {}),
        "is_empty": ({"X": [f(3, 4)]}, {}),
        "is_empty:empty": ({"X": [f(0, 4)]}, {}),
        "diag": ({"Diagonal": [f(4)]}, {}),
        "diag_v2": ({"X": [f(4)]}, {"offset": 1, "padding_value": 0.5}),
        "diag_v2:matrix": ({"X": [f(3, 4)]}, {"offset": -1}),
        "diag_embed": ({"Input": [f(2, 3)]}, {"offset": 1}),
        "unique_with_counts": ({"X": [np.array([5, 1, 5, 0, 7, 1, 5, 3],
                                               np.int32)]}, {}),
        "warpctc": ({"Logits": [f(3, 8, 5)],
                     "Label": [np.array([[1, 2, 2, 3], [4, 4, 0, 0],
                                         [1, 3, 2, 4]], np.int32)],
                     "LogitsLength": [np.array([8, 6, 2], np.int32)],
                     "LabelLength": [np.array([4, 2, 4], np.int32)]},
                    {"blank": 0}),
        "warpctc:feasible": ({"Logits": [f(3, 8, 5)],
                              "Label": [np.array([[1, 2, 2, 3], [4, 4, 0, 0],
                                                  [1, 3, 2, 0]], np.int32)],
                              "LogitsLength": [np.array([8, 6, 5],
                                                        np.int32)],
                              "LabelLength": [np.array([4, 2, 3],
                                                       np.int32)]},
                             {"blank": 0}),
        "warpctc:unpadded": ({"Logits": [f(2, 6, 4)],
                              "Label": [i32(1, 4, 2, 3)]}, {"blank": 0}),
        "unpool": ({"X": [f(2, 3, 2, 3)], "Indices": [pool_idx]},
                   {"ksize": [2, 2], "output_height": 4,
                    "output_width": 6}),
    }


def _max_pool_flat_indices(x, k):
    """The flat argmax of each non-overlapping k x k window (first of a
    tie): valid `unpool` indices, one a window."""
    n, c, h, w = x.shape
    win = x.reshape(n, c, h // k, k, w // k, k).transpose(0, 1, 2, 4, 3, 5)
    arg = win.reshape(n, c, h // k, w // k, k * k).argmax(-1)
    rows = np.arange(h // k)[:, None] * k + arg // k
    cols = np.arange(w // k)[None, :] * k + arg % k
    return (rows * w + cols).astype(np.int32)


def op_of(case):
    return case.split(":")[0]


# the types whose gradient the port writes out or whose reference gradient
# is not the obvious one, the losses, and the recommender's scorer; no
# pooling with index (the reference's tuple reduce_window has no gradient).
# Left out: a matrix that is not positive definite (NaN), and warpctc's
# infeasible row, whose loss of ~1e5 (log 0 as -1e5) puts its alphas'
# ulp at 0.0078, so its gradient (exp of differences of such alphas)
# carries ~1% of rounding in either package (its forward is held, and its
# gradient held finite by test_warpctc_infeasible_alignment_...)
VJP_OPS = {"warpctc", "segment_pool", "grid_sampler", "cholesky",
           "spectral_norm", "lrn", "bce_loss", "hinge_loss", "rank_loss",
           "margin_rank_loss", "log_loss", "bpr_loss", "nll_loss",
           "kldiv_loss", "smooth_l1_loss", "huber_regression_loss",
           "sigmoid_focal_loss", "center_loss", "cos_sim"}
VJP_CASES = sorted(c for c in extra_cases() if op_of(c) in VJP_OPS
                   and c not in ("cholesky:not_pd", "segment_pool:min",
                                 "warpctc"))
BF16_CASES = {
    "hard_shrink", "softshrink", "tanh_shrink", "thresholded_relu", "stanh",
    "relu_", "maxout", "celu", "selu", "mish", "prelu", "prelu:channel",
    "cos_sim", "minus", "pixel_shuffle", "space_to_depth",
    "shuffle_channel", "temporal_shift", "reverse", "unbind", "squeeze",
    "unsqueeze", "flatten", "crop_tensor", "affine_channel", "pad3d",
}
VJP_BF16 = {"cos_sim"}


def vjp_case(op, ins, attrs, outs, make_vjp_attrs, seed=1, nondiff=()):
    """(inputs, attrs) of the `__vjp__` op over forward case (`op`, `ins`,
    `attrs`) whose outputs are `outs` ({slot: arrays or tensors}): every
    floating input outside the slots `nondiff` differentiated, a numpy
    cotangent from `seed` for each floating output (XShape and None
    outputs take none)."""
    out_slots = [s for s, vs in outs.items() if s != "XShape"
                 and all(v is not None for v in vs)
                 and all("float" in str(v.dtype) for v in vs)]
    diff = [(s, i) for s, vs in ins.items() if s not in nondiff
            for i, a in enumerate(vs) if np.issubdtype(a.dtype, np.floating)]
    rng = np.random.RandomState(seed)
    vjp_ins = dict(ins)
    for s in out_slots:
        vjp_ins[f"OG:{s}"] = [np.asarray(rng.randn(*tuple(o.shape)),
                                         np.float32) for o in outs[s]]
    fake_op = type("Op", (), {
        "type": op, "attrs": dict(attrs),
        "inputs": {s: [f"{s}{i}" for i in range(len(v))]
                   for s, v in ins.items()},
        "outputs": {s: [f"o{s}{i}" for i in range(len(outs[s]))]
                    for s in out_slots}})
    return vjp_ins, make_vjp_attrs(fake_op, diff, out_slots)


# --------------------------------------------------------------------------
# the book's recommender system
# --------------------------------------------------------------------------

# MovieLens-1M's dictionaries as the book reads them (paddle.dataset
# .movielens): max_user_id() + 1, the two genders, len(age_table),
# max_job_id() + 1, max_movie_id() + 1, len(movie_categories()) and
# len(get_movie_title_dict()). The title dictionary's size is the one the
# book's data gives (5,174 words); the data is not in the repository.
ML1M = {"user": 6041, "gender": 2, "age": 7, "job": 21, "movie": 3953,
        "category": 18, "title": 5174}
CATEGORY_LEN, TITLE_LEN = 6, 15   # ids a movie: categories 1-6, title 1-15
RECSYS_LR, RECSYS_SCALE = 0.2, 5.0


def recsys(L, sizes=None, is_sparse=True, emb=32, small=16, hidden=200,
           title_filters=32):
    """The book's recommender system (chapter 5,
    test_recommender_system.py) with layers module `L`, in the padded
    convention (a movie's categories and title are [B, len] ids and a
    length vector, as the sequence models feed them). User tower: id
    (emb, fc emb), gender, age, job (small, fc small), concat, fc
    `hidden` tanh. Movie tower: id (emb, fc emb), categories (emb,
    sequence_pool sum), title (emb, sequence_conv `title_filters` x 3
    tanh, sequence_pool sum), concat, fc `hidden` tanh. Head: cos_sim,
    scale(5), square_error_cost against the rating, mean. Every embedding
    `is_sparse`. Returns (loss, prediction)."""
    sizes = sizes or ML1M

    def table(name, vocab, width, ids):
        # the book names the tables of the scalar features only
        return L.embedding(ids, size=[vocab, width], is_sparse=is_sparse,
                           param_attr=None if name in ("category", "title")
                           else f"{name}_table")

    def scalar_feature(name, width):
        ids = L.data(name=f"{name}_id", shape=[1], dtype="int64")
        return L.fc(table(name, sizes[name], width, ids), width)

    def sequence(name, T, width):
        ids = L.data(name=f"{name}_ids", shape=[T], dtype="int64")
        lens = L.data(name=f"{name}_len", shape=[1], dtype="int64")
        e = table(name, sizes[name], width, L.unsqueeze(ids, [2]))
        return L.reshape(e, [-1, T, width]), lens

    usr = L.concat([scalar_feature("user", emb),
                    scalar_feature("gender", small),
                    scalar_feature("age", small),
                    scalar_feature("job", small)], axis=1)
    usr = L.fc(usr, hidden, act="tanh")
    cats, cat_len = sequence("category", CATEGORY_LEN, emb)
    title, title_len = sequence("title", TITLE_LEN, emb)
    conv = L.sequence_conv(title, num_filters=title_filters, filter_size=3,
                           act="tanh", length=title_len)
    mov = L.concat([scalar_feature("movie", emb),
                    L.sequence_pool(cats, "sum", length=cat_len),
                    L.sequence_pool(conv, "sum", length=title_len)], axis=1)
    mov = L.fc(mov, hidden, act="tanh")
    pred = L.scale(L.cos_sim(usr, mov), scale=RECSYS_SCALE)
    score = L.data(name="score", shape=[1], dtype="float32")
    return L.mean(L.square_error_cost(pred, score)), pred


def recsys_feed(n, batch, sizes=None, seed=0):
    """`n` batches from numpy `seed` at the dictionaries' sizes: user and
    movie ids from 1 (MovieLens numbers them so), gender, age and job
    from 0, 1-6 category ids and 1-15 title words a movie (padded with
    0), an integer rating in 1-5."""
    sizes = sizes or ML1M
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        f = {"user_id": rng.randint(1, sizes["user"], (batch, 1)),
             "gender_id": rng.randint(0, sizes["gender"], (batch, 1)),
             "age_id": rng.randint(0, sizes["age"], (batch, 1)),
             "job_id": rng.randint(0, sizes["job"], (batch, 1)),
             "movie_id": rng.randint(1, sizes["movie"], (batch, 1))}
        for name, T in (("category", CATEGORY_LEN), ("title", TITLE_LEN)):
            lens = rng.randint(1, T + 1, (batch, 1))
            ids = rng.randint(0, sizes[name], (batch, T))
            f[f"{name}_ids"] = np.where(np.arange(T)[None, :] < lens, ids, 0)
            f[f"{name}_len"] = lens
        f = {k: v.astype(np.int64) for k, v in f.items()}
        f["score"] = rng.randint(1, 6, (batch, 1)).astype(np.float32)
        out.append(f)
    return out
