"""Inputs for the tail ops (paddle_tpu_torch/ops/tail_ops.py), shared by
tests/test_torch_tail_ops.py (the port against the JAX reference on the
CPU) and chip_smoke.py's phase 20 (the port on the card against the port
on the CPU). numpy only: nothing here imports JAX or either package.

* `tail_cases()`: {case: (inputs, attrs)} at small shapes from a numpy
  seed, one case per op type and more arms of some (`<op>:<arm>`); ints
  are int32, as the device holds them. A LoDTensorArray input is a
  (buffer or None, length) tuple, as both packages hold one. Inputs hold
  what the ports write out by hand: ids near 2**32 for `hash`, sampling
  points and ROIs past the image's edge, a repeated edge of `tree_conv`,
  a class no row has for `mean_iou`, tied scores, every segment of the
  DGC schedule and a tensor past DGC's 4,096-element sample.
* `RANDOM`: the types whose outputs are draws (the packages draw from
  different generators: their properties are held, not their values).
* `REF_EAGER`: the cases the reference runs outside jax.jit, as it reads
  their inputs on the host (a shape set by a tensor, an untyped
  `py_func`).
* `VJP_CASES`: the cases whose pullback is held too; `BF16_CASES`: the
  cases AMP can hand bf16 operands; `VJP_BF16`: those whose bf16
  pullback is held too.
* `PY_FUNCS`: {id: function} for `py_func`, registered by each consumer.

tests/torch_extra_op_cases.py's `vjp_case` builds the `__vjp__` op's
inputs for these cases too.
"""
import numpy as np

DGC_SPARSITY = [0.75, 0.9375, 0.984375, 0.996, 0.999]
DGC_RAMP = {"rampup_begin_step": 2.0, "rampup_step": 8.0}


def _py_affine(x):
    return (2.0 * x + 1.0).astype(np.float32)


def _py_stats(x):
    return x.sum(0), np.float32(x.max())


# ids of their own: the reference's tests register id 7 in its table
PY_FUNCS = {2301: _py_affine, 2302: _py_stats}


def tail_cases():
    rng = np.random.RandomState(23)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    i32 = lambda lo, hi, *s: rng.randint(lo, hi, s).astype(np.int32)  # noqa
    unit = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)  # noqa

    def i32v(*v):
        return np.array(v, np.int32)

    def f32v(*v):
        return np.array(v, np.float32)

    def probs(*s):
        e = np.exp(f(*s))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    # ids as uint32 bits: -1 is 2**32 - 1
    hash_ids = i32v(-1, -2, -7, -2 ** 31, 2 ** 31 - 1, 2 ** 31 - 3, 0, 1,
                    123456789, -123456789, 65535, 65536).reshape(4, 3)
    dgc_u, dgc_v, dgc_g = f(40, 50), f(40, 50), f(40, 50)
    big_u, big_v, big_g = f(70, 90), f(70, 90), f(70, 90)
    rois = f32v(0, 0, 4, 4, 1, 1, 5, 3, 3, 2, 7, 8).reshape(3, 4)
    edges = i32v(0, 1, 0, 2, 1, 3, 0, 1, 0, 4, 4, 3, 2, 1, 3, 3).reshape(
        2, 4, 2)
    scores = f32v(0.9, 0.1, 0.5, 0.5, 0.3, 0.7, 0.2, 0.2)
    chunk_inf = i32v(0, 1, 4, 2, 3, 4, 0, 0, 1, 2, 3, 4, 4, 2, 3, 3, 0,
                     1).reshape(3, 6)
    chunk_lab = i32v(0, 1, 4, 2, 4, 4, 0, 1, 1, 2, 3, 4, 4, 2, 3, 4, 0,
                     1).reshape(3, 6)
    dgc = dict(DGC_RAMP, m=0.9, sparsity=DGC_SPARSITY)
    dgc_ins = {"U": [dgc_u], "V": [dgc_v], "Grad": [dgc_g]}
    mom_ins = {"Param": [f(5, 6)], "Grad": [f(5, 6)], "Velocity": [f(5, 6)],
               "LearningRate": [f32v(0.1)]}
    mom = {"mu": 0.9, "rampup_begin_step": 2.0}
    bn_ins = {"X": [f(2, 3, 4, 4)], "Scale": [unit(0.5, 1.5, 3)],
              "Bias": [f(3)], "Mean": [f(3)], "Variance": [unit(0.5, 2, 3)]}
    return {
        # interpolation
        "linear_interp": ({"X": [f(2, 3, 8)]}, {"out_w": 13}),
        "linear_interp_v2": ({"X": [f(2, 3, 8)]}, {"out_w": 5}),
        "linear_interp_v2:align": ({"X": [f(2, 3, 8)]},
                                   {"out_w": 11, "align_corners": True}),
        "bicubic_interp": ({"X": [f(2, 3, 6, 7)]}, {"out_h": 9, "out_w": 5}),
        "bicubic_interp_v2": ({"X": [f(1, 2, 5, 5)]}, {"scale": [1.5]}),
        "bicubic_interp_v2:align": ({"X": [f(1, 2, 5, 4)]},
                                    {"out_h": 7, "out_w": 6,
                                     "align_corners": True}),
        "bilinear_interp_v2": ({"X": [f(2, 3, 6, 5)],
                                "OutSize": [i32v(8, 9)]}, {}),
        "bilinear_interp_v2:scale": ({"X": [f(2, 3, 6, 5)]}, {"scale": 0.5}),
        "bilinear_interp_v2:align": ({"X": [f(1, 2, 4, 5)]},
                                     {"out_h": 7, "out_w": 3,
                                      "align_corners": True}),
        "nearest_interp_v2": ({"X": [f(2, 2, 5, 6)]},
                              {"out_h": 10, "out_w": 3}),
        "trilinear_interp": ({"X": [f(1, 2, 3, 4, 5)]},
                             {"out_d": 5, "out_h": 6, "out_w": 3}),
        "trilinear_interp_v2": ({"X": [f(1, 2, 2, 3, 4)]},
                                {"scale": [2.0, 1.5]}),
        "trilinear_interp_v2:align": ({"X": [f(1, 2, 2, 3, 4)]},
                                      {"out_d": 3, "out_h": 4, "out_w": 6,
                                       "align_corners": True}),
        # geometry
        "affine_grid": ({"Theta": [f(2, 2, 3)]},
                        {"output_shape": [2, 1, 4, 5],
                         "align_corners": True}),
        "affine_grid:shape_tensor": ({"Theta": [f(2, 2, 3)],
                                      "OutputShape": [i32v(2, 1, 3, 6)]},
                                     {"align_corners": False}),
        "psroi_pool": ({"X": [f(2, 8, 6, 6)], "ROIs": [rois],
                        "RoisNum": [i32v(2, 1)]},
                       {"pooled_height": 2, "pooled_width": 2,
                        "output_channels": 2, "spatial_scale": 1.0}),
        "prroi_pool": ({"X": [f(1, 3, 5, 5)], "ROIs": [rois[:2] * 0.8]},
                       {"pooled_height": 2, "pooled_width": 3,
                        "spatial_scale": 1.0}),
        "deformable_conv": ({"Input": [f(2, 4, 5, 5)],
                             "Offset": [1.5 * f(2, 18, 5, 5)],
                             "Mask": [unit(0, 1, 2, 9, 5, 5)],
                             "Filter": [f(6, 2, 3, 3)]},
                            {"strides": [1, 1], "paddings": [1, 1],
                             "dilations": [1, 1], "groups": 2}),
        "deformable_conv_v1": ({"Input": [f(1, 3, 6, 6)],
                                "Offset": [1.5 * f(1, 8, 3, 3)],
                                "Filter": [f(4, 3, 2, 2)]},
                               {"strides": [2, 2], "paddings": [0, 0],
                                "dilations": [1, 1]}),
        "deformable_conv_v1:dilated": ({"Input": [f(1, 2, 7, 7)],
                                        "Offset": [f(1, 18, 5, 5)],
                                        "Filter": [f(3, 2, 3, 3)]},
                                       {"strides": [1, 1],
                                        "paddings": [1, 1],
                                        "dilations": [2, 2]}),
        "random_crop": ({"X": [f(2, 3, 6, 7)]}, {"shape": [4, 5]}),
        # sampled softmax / nce
        "nce": ({"Input": [f(4, 6)], "Label": [i32(0, 10, 4, 1)],
                 "Weight": [f(10, 6)], "Bias": [f(10)]},
                {"num_neg_samples": 5, "num_total_classes": 10}),
        "sample_logits": ({"Logits": [f(4, 12)],
                           "Labels": [i32(0, 12, 4, 1)]},
                          {"num_samples": 6}),
        "sampling_id": ({"X": [probs(5, 7)]}, {}),
        # hashing / instag / sparse-feature misc
        "hash": ({"X": [hash_ids]}, {"num_hash": 3, "mod_by": 100000007}),
        "hash:mod_past_int32": ({"X": [hash_ids]},
                                {"num_hash": 2, "mod_by": 3000000019}),
        "filter_by_instag": ({"Ins": [f(5, 3)],
                              "Ins_tag": [i32(0, 6, 5, 2)],
                              "Filter_tag": [i32v(1, 4, 9)]}, {}),
        "shuffle_batch": ({"X": [f(6, 3)]}, {}),
        "match_matrix_tensor": ({"X": [f(2, 3, 4)], "Y": [f(2, 5, 4)],
                                 "W": [f(4, 2, 4)]}, {}),
        "batch_fc": ({"Input": [f(3, 4, 5)], "W": [f(3, 5, 2)],
                      "Bias": [f(3, 2)]}, {}),
        "tree_conv": ({"NodesVector": [f(2, 5, 4)], "EdgeSet": [edges],
                       "Filter": [f(4, 3, 3)]}, {}),
        "conv_shift": ({"X": [f(3, 7)], "Y": [f(3, 3)]}, {}),
        # fused transformer / embedding / sequence ops
        "multihead_matmul": ({"Input": [f(2, 4, 8)], "W": [0.3 * f(8, 24)],
                              "Bias": [f(24)],
                              "BiasQK": [f(2, 2, 4, 4)]},
                             {"head_number": 2, "alpha": 0.35}),
        "multihead_matmul:packed": ({"Input": [f(2, 4, 12)]},
                                    {"head_number": 2}),
        "fused_embedding_eltwise_layernorm": (
            {"Ids": [i32(0, 10, 2, 5, 1), i32(0, 4, 2, 5, 1)],
             "Embs": [f(10, 8), f(4, 8)], "Scale": [unit(0.5, 1.5, 8)],
             "Bias": [f(8)]}, {"epsilon": 1e-5}),
        "fused_embedding_seq_pool": ({"W": [f(10, 4)],
                                      "Ids": [i32(0, 10, 3, 5, 1)],
                                      "SeqLen": [i32v(5, 2, 0)]}, {}),
        "fused_embedding_seq_pool:full": ({"W": [f(10, 4)],
                                           "Ids": [i32(0, 10, 3, 5, 1)]},
                                          {}),
        "fusion_gru": ({"X": [f(2, 4, 3)], "WeightX": [f(3, 15)],
                        "WeightH": [0.5 * f(5, 15)], "Bias": [f(1, 15)],
                        "SeqLen": [i32v(4, 2)]}, {}),
        "fusion_lstm": ({"X": [f(2, 4, 3)], "WeightX": [f(3, 20)],
                         "WeightH": [0.5 * f(5, 20)], "Bias": [f(1, 20)],
                         "SeqLen": [i32v(3, 4)]}, {}),
        "fusion_repeated_fc_relu": ({"X": [f(3, 4)],
                                     "W": [f(4, 5), f(5, 2)],
                                     "Bias": [f(5), f(2)]}, {}),
        "fusion_squared_mat_sub": ({"X": [f(3, 4)], "Y": [f(4, 5)]},
                                   {"scalar": 0.5}),
        "fusion_seqconv_eltadd_relu": ({"X": [f(2, 5, 3)],
                                        "Filter": [f(9, 4)],
                                        "Bias": [f(4)],
                                        "SeqLen": [i32v(5, 3)]},
                                       {"contextLength": 3,
                                        "contextStart": -1}),
        "fusion_seqexpand_concat_fc": ({"X": [f(2, 4, 3), f(2, 2), f(2, 1)],
                                        "FCWeight": [f(6, 5)],
                                        "FCBias": [f(5)]},
                                       {"fc_activation": "tanh"}),
        "fusion_seqexpand_concat_fc:relu": (
            {"X": [f(2, 3, 2), f(2, 3)], "FCWeight": [f(5, 4)]},
            {"fc_activation": "relu"}),
        "fusion_seqpool_concat": ({"X": [f(2, 4, 3), f(2, 4, 2)],
                                   "SeqLens": [i32v(2, 4), i32v(4, 1)]},
                                  {"pooltype": "SUM"}),
        "fusion_seqpool_concat:average": ({"X": [f(2, 3, 3), f(2, 3, 1)]},
                                          {"pooltype": "AVERAGE"}),
        "fusion_seqpool_cvm_concat": ({"X": [f(2, 3, 4)],
                                       "CVM": [f(2, 2)]},
                                      {"pooltype": "SUM", "use_cvm": True}),
        "inplace_abn": (bn_ins, {"activation": "leaky_relu", "alpha": 0.1,
                                 "epsilon": 1e-5, "momentum": 0.9}),
        "inplace_abn:elu": (bn_ins, {"activation": "elu", "alpha": 0.7}),
        "inplace_abn:test": (bn_ins, {"activation": "identity",
                                      "is_test": True}),
        # quantize / dequantize
        "fake_quantize_abs_max": ({"X": [f(3, 4)]}, {"bit_length": 8}),
        "fake_channel_wise_quantize_abs_max": ({"X": [f(3, 4, 2)]},
                                               {"quant_axis": 1,
                                                "bit_length": 4}),
        "fake_dequantize_max_abs": ({"X": [np.round(127 * unit(-1, 1, 3, 4))
                                           .astype(np.float32)],
                                     "Scale": [f32v(2.5)]},
                                    {"max_range": 127.0}),
        "fake_channel_wise_dequantize_max_abs": (
            {"X": [np.round(100 * unit(-1, 1, 4, 3)).astype(np.float32)],
             "Scales": [unit(0.5, 2, 4)]},
            {"quant_axis": 0, "quant_bits": [8]}),
        "fake_channel_wise_dequantize_max_abs:two": (
            {"X": [np.round(100 * unit(-1, 1, 4, 3)).astype(np.float32)],
             "Scales": [unit(0.5, 2, 3), f32v(1.5)]},
            {"quant_axis": 1, "quant_bits": [8, 8]}),
        "fake_quantize_range_abs_max": ({"X": [f(3, 4)],
                                         "Iter": [i32v(7)],
                                         "InScales": [unit(0.5, 3, 5)]},
                                        {"window_size": 5}),
        "fake_quantize_range_abs_max:test": ({"X": [f(3, 4)],
                                              "Iter": [i32v(2)],
                                              "InScales": [unit(0.5, 3, 5)]},
                                             {"window_size": 5,
                                              "is_test": True}),
        "fake_quantize_range_abs_max:first": ({"X": [f(3, 4)],
                                               "Iter": [i32v(0)]},
                                              {"window_size": 4}),
        "moving_average_abs_max_scale": ({"X": [f(3, 4)],
                                          "InState": [f32v(1.9)],
                                          "InAccum": [f32v(3.1)]},
                                         {"moving_rate": 0.9}),
        "moving_average_abs_max_scale:first": ({"X": [f(3, 4)]}, {}),
        # random / tensor creation
        "bernoulli": ({"X": [unit(0, 1, 4, 5)]}, {}),
        "randperm": ({}, {"n": 10, "dtype": "int64"}),
        "empty": ({}, {"shape": [2, 3], "dtype": "float32"}),
        "fill": ({}, {"shape": [2, 2], "dtype": "float32",
                      "value": [1.0, 2.5, 3.0, -4.0]}),
        "fill:int": ({}, {"shape": [4], "dtype": "int32",
                          "value": [1.5, 2.0, -3.7, 4.0]}),
        "allclose": ({"Input": [f32v(1.0, 2.0, 3.0)],
                      "Other": [f32v(1.0, 2.00001, 3.0)]},
                     {"rtol": 1e-5, "atol": 1e-8}),
        "allclose:nan": ({"Input": [f32v(1.0, np.nan, np.inf)],
                          "Other": [f32v(1.0, np.nan, np.inf)]},
                         {"equal_nan": True}),
        "allclose:far": ({"Input": [f32v(1.0, 2.0)],
                          "Other": [f32v(1.0, 2.1)]}, {}),
        "uniform_random_batch_size_like": ({"Input": [f(5, 3)]},
                                           {"shape": [-1, 4], "min": -2.0,
                                            "max": 3.0}),
        "gaussian_random_batch_size_like": ({"Input": [f(5, 3)]},
                                            {"shape": [2, -1, 3],
                                             "input_dim_idx": 0,
                                             "output_dim_idx": 1,
                                             "mean": 1.0, "std": 2.0}),
        # control-flow helpers / host interop
        "print": ({"In": [f(3, 2)]}, {"message": "tail op case: "}),
        "py_func": ({"X": [f(2, 3)]},
                    {"forward_callable_id": 2301, "out_shapes": [[2, 3]],
                     "out_dtypes": ["float32"]}),
        "py_func:untyped": ({"X": [f(3, 2)]},
                            {"forward_callable_id": 2302}),
        "coalesce_tensor": ({"Input": [f(2, 3), f(4), f(1, 2)]}, {}),
        "select_input": ({"X": [f(2, 3), f(2, 3), f(2, 3)],
                          "Mask": [i32v(1)]}, {}),
        "select_output": ({"X": [f(2, 3)], "Mask": [i32v(1)]},
                          {"num_outputs": 3}),
        # optimizer tail
        "proximal_gd": ({"Param": [f(3, 4)], "Grad": [f(3, 4)],
                         "LearningRate": [f32v(0.3)]},
                        {"l1": 0.2, "l2": 0.1}),
        "proximal_gd:l2": ({"Param": [f(3, 4)], "Grad": [f(3, 4)],
                            "LearningRate": [f32v(0.3)]}, {"l2": 0.1}),
        "proximal_adagrad": ({"Param": [f(3, 4)], "Grad": [f(3, 4)],
                              "Moment": [unit(0, 1, 3, 4)],
                              "LearningRate": [f32v(0.5)]},
                             {"l1": 0.1, "l2": 0.05}),
        "dgc_clip_by_norm": ({"X": [3 * f(4, 5)],
                              "current_step": [f32v(5.0)]},
                             {"max_norm": 1.0, "rampup_begin_step": 2.0}),
        "dgc_clip_by_norm:warmup": ({"X": [3 * f(4, 5)],
                                     "current_step": [f32v(1.0)]},
                                    {"max_norm": 1.0,
                                     "rampup_begin_step": 2.0}),
        "dgc": (dict(dgc_ins, current_step=[f32v(4.0)]), dgc),
        "dgc:warmup": (dict(dgc_ins, current_step=[f32v(1.0)]), dgc),
        "dgc:begin": (dict(dgc_ins, current_step=[f32v(2.0)]), dgc),
        "dgc:seg3": (dict(dgc_ins, current_step=[f32v(7.0)]), dgc),
        "dgc:last": (dict(dgc_ins, current_step=[f32v(30.0)]), dgc),
        "dgc:strided": ({"U": [big_u], "V": [big_v], "Grad": [big_g],
                         "current_step": [f32v(9.0)]}, dgc),
        "dgc_momentum": (dict(mom_ins, current_step=[f32v(1.0)]), mom),
        "dgc_momentum:dgc": (dict(mom_ins, current_step=[f32v(2.0)]), mom),
        "dgc_momentum:nesterov": (dict(mom_ins, current_step=[f32v(0.0)]),
                                  dict(mom, use_nesterov=True)),
        "dgc_momentum:no_step": (mom_ins, mom),
        # metric tail
        "mean_iou": ({"Predictions": [i32(0, 4, 12)],
                      "Labels": [i32(0, 4, 12)]}, {"num_classes": 5}),
        "positive_negative_pair": ({"Score": [scores],
                                    "Label": [i32(0, 3, 8).astype(
                                        np.float32)],
                                    "QueryID": [i32v(1, 1, 1, 1, 2, 2, 2,
                                                     2)]}, {}),
        "chunk_eval": ({"Inference": [chunk_inf], "Label": [chunk_lab],
                        "SeqLength": [i32v(6, 5, 4)]},
                       {"num_chunk_types": 2, "chunk_scheme": "IOB"}),
        "chunk_eval:ioe": ({"Inference": [chunk_inf], "Label": [chunk_lab]},
                           {"num_chunk_types": 2, "chunk_scheme": "IOE"}),
        "chunk_eval:iobes": ({"Inference": [chunk_inf % 9],
                              "Label": [(chunk_lab + 3) % 9]},
                             {"num_chunk_types": 2,
                              "chunk_scheme": "IOBES"}),
        "chunk_eval:plain": ({"Inference": [chunk_inf % 3],
                              "Label": [chunk_lab % 3]},
                             {"num_chunk_types": 2, "chunk_scheme": "plain",
                              "excluded_chunk_types": [1]}),
        "teacher_student_sigmoid_loss": (
            {"X": [3 * f(6, 1)],
             "Label": [f32v(1, 0, -1.3, -1.9, -1.0, 1).reshape(6, 1)]}, {}),
        # lstmp
        "lstmp": ({"Input": [f(2, 3, 8)], "Weight": [f(3, 8)],
                   "ProjWeight": [f(2, 3)], "Bias": [f(1, 8)]}, {}),
        # aliases
        "write_to_array": ({"X": [f(2, 3)], "I": [i32v(2)],
                            "Array": [(None, np.int32(0))]},
                           {"capacity": 4}),
        "read_from_array": ({"Array": [(f(4, 2, 3), np.int32(3))],
                             "I": [i32v(1)]}, {}),
        "expand_as": ({"X": [f(1, 3)], "target_tensor": [f(4, 3)]}, {}),
    }


def op_of(case):
    return case.split(":")[0]


RANDOM = {"random_crop", "nce", "sample_logits", "sampling_id",
          "shuffle_batch", "bernoulli", "randperm",
          "uniform_random_batch_size_like",
          "gaussian_random_batch_size_like"}
REF_EAGER = {"bilinear_interp_v2", "affine_grid:shape_tensor",
             "py_func:untyped"}
# the differentiable types whose pullback is held: the interpolations,
# the samplers at learned coordinates, the products and fusions, the
# losses and recurrences
VJP_CASES = sorted({
    "linear_interp", "linear_interp_v2:align", "bicubic_interp",
    "bilinear_interp_v2:scale", "nearest_interp_v2", "trilinear_interp_v2",
    "affine_grid", "psroi_pool", "prroi_pool", "deformable_conv",
    "deformable_conv_v1", "match_matrix_tensor", "batch_fc", "tree_conv",
    "conv_shift", "multihead_matmul", "fused_embedding_eltwise_layernorm",
    "fused_embedding_seq_pool", "fusion_gru", "fusion_lstm",
    "fusion_repeated_fc_relu", "fusion_squared_mat_sub",
    "fusion_seqconv_eltadd_relu", "fusion_seqexpand_concat_fc",
    "fusion_seqpool_concat", "inplace_abn", "coalesce_tensor",
    "select_input", "teacher_student_sigmoid_loss", "lstmp", "expand_as"})
BF16_CASES = {
    "linear_interp_v2", "bicubic_interp", "bilinear_interp_v2:scale",
    "nearest_interp_v2", "trilinear_interp_v2:align", "deformable_conv",
    "multihead_matmul", "fused_embedding_eltwise_layernorm", "inplace_abn",
}
# the bf16 pullbacks held: the longer ones (attention, the sampled
# im2col, batch norm's) differ by bf16 rounding in the order of their
# sums (their forwards are held in bf16 above)
VJP_BF16 = {"bicubic_interp", "bilinear_interp_v2:scale", "nearest_interp_v2",
            "fused_embedding_eltwise_layernorm"}
