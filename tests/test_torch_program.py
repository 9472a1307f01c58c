"""PyTorch port, program building and op lowerings: paddle_tpu_torch's
framework / layers / models.bert / optimizer held against the JAX
reference on the CPU.

* The BERT pretrain program (tiny geometry, padding mask, Adam minimize)
  built in both packages from fresh programs has EQUAL descs: op types and
  order, var names, shapes, dtypes and attrs, `__rng_seed__` included;
  likewise its startup program. `Program.from_desc` round-trips the
  reference's desc.
* One parity test per ported lowering against the reference's lowering on
  the same numpy inputs, at f32 and bf16: every type of the reference's
  nn_ops, tensor_ops, metric_ops and math_ops files, several arms of some
  (`<op>:<arm>`), and a vjp case for the ops the image models
  differentiate and the ones whose gradient the port writes out (ties,
  clip bounds, index arithmetic). Tolerances: f32 rtol 1e-5 /
  atol 1e-6 (the frameworks sum in different orders); bf16 compared in f32
  with rtol and atol 1e-2 (one bf16 ulp is 2**-8 relative). Random
  lowerings (dropout, truncated_gaussian_random, uniform_random,
  gaussian_random, randint) draw from different generators in the two
  packages: their shapes, dtypes and statistics are compared instead,
  and the port's draws are checked to be deterministic.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.models import bert as ref_bert
from paddle_tpu.ops import registry as ref_registry

from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.framework import Executor, errors
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.framework.dtype import dtype_name
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.ops import registry as port_registry


def _ref_programs(fused=None):
    main, start = ref_program.Program(), ref_program.Program()
    with ref_program.program_guard(main, start), ref_unique_name.guard():
        cfg = ref_bert.BertConfig.tiny()
        cfg.fused_mlm_head = fused
        _, _, loss = ref_bert.build_pretrain_program(cfg, use_input_mask=True)
        paddle.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    return main, start


def _port_programs(fused=None):
    main, start = port_program.Program(), port_program.Program()
    with port_program.program_guard(main, start), port_unique_name.guard():
        cfg = port_bert.BertConfig.tiny()
        cfg.fused_mlm_head = fused
        _, _, loss = port_bert.build_pretrain_program(cfg,
                                                      use_input_mask=True)
        port_optimizer.Adam(learning_rate=1e-4).minimize(loss)
    return main, start


@pytest.mark.parametrize("fused", [None, True], ids=["dense_head",
                                                     "fused_head"])
def test_bert_pretrain_desc_equal(fused):
    ref_main, ref_start = _ref_programs(fused)
    port_main, port_start = _port_programs(fused)
    rd, pd = ref_main.to_desc(), port_main.to_desc()
    r_ops, p_ops = rd["blocks"][0]["ops"], pd["blocks"][0]["ops"]
    assert [o["type"] for o in p_ops] == [o["type"] for o in r_ops]
    for r, p in zip(r_ops, p_ops):
        assert p == r, (r["type"], r, p)
    assert pd["blocks"][0]["vars"] == rd["blocks"][0]["vars"]
    assert pd == rd
    assert port_start.to_desc() == ref_start.to_desc()
    types = {o["type"] for o in r_ops}
    assert {"fused_attention", "__vjp__", "adam", "dropout"} <= types
    assert ("fused_lm_head_ce" in types) == bool(fused)


def test_from_desc_round_trips_reference_desc():
    ref_main, _ = _ref_programs()
    desc = ref_main.to_desc()
    prog = port_program.Program.from_desc(desc)
    assert prog.to_desc() == desc
    params = {p.name for p in prog.all_parameters()}
    assert {"word_embedding", "enc1_ffn_out_w", "mlm_head_w"} <= params


def test_every_op_of_the_program_is_registered():
    ref_main, ref_start = _ref_programs(True)
    for prog in (ref_main, ref_start):
        for op in prog.global_block().ops:
            assert port_registry.has(op.type), op.type


# ---------------------------------------------------------------------------
# Lowering parity
# ---------------------------------------------------------------------------

def _cast_np(a, dtype):
    if np.issubdtype(a.dtype, np.floating):
        return a.astype(np.float32)
    return a


def _run_ref(op, ins, attrs, dtype):
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jins = {s: [jnp.asarray(a).astype(jd) if np.issubdtype(a.dtype, np.floating)
                else jnp.asarray(a) for a in vs] for s, vs in ins.items()}
    ctx = ref_registry.LowerCtx(rng_key=jax.random.key(0))
    return ref_registry.get(op).lower(ctx, jins, dict(attrs))


def _run_port(op, ins, attrs, dtype):
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    tins = {s: [torch.from_numpy(np.array(a)).to(td)
                if np.issubdtype(a.dtype, np.floating)
                else torch.from_numpy(np.array(a)) for a in vs]
            for s, vs in ins.items()}
    ctx = port_registry.LowerCtx(run_seed=0, device="cpu")
    return port_registry.get(op).lower(ctx, tins, dict(attrs))


def _assert_outs_close(ref, port, dtype, slots=None):
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "f32" \
        else dict(rtol=1e-2, atol=1e-2)
    for slot in slots or ref:
        assert len(port[slot]) == len(ref[slot]), slot
        for r, p in zip(ref[slot], port[slot]):
            assert tuple(p.shape) == tuple(r.shape), (slot, p.shape, r.shape)
            assert dtype_name(p.dtype) == np.dtype(r.dtype).name, slot
            rv = np.asarray(jnp.asarray(r).astype(jnp.float32)) \
                if jnp.issubdtype(r.dtype, jnp.floating) else np.asarray(r)
            pv = p.detach().float().numpy() if p.is_floating_point() \
                else p.numpy()
            np.testing.assert_allclose(pv, rv, err_msg=slot, **tol)


def _lowering_cases():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    ids = rng.randint(0, 50, (2, 6, 1)).astype(np.int32)
    labels = rng.randint(0, 50, (2, 6, 1)).astype(np.int32)
    labels[0, 1, 0] = -100                       # an ignored token
    return {
        "fill_constant": ({}, {"shape": [3, 4], "dtype": "float32",
                               "value": 1.5}),
        "reshape2": ({"X": [f(2, 6, 8)]}, {"shape": [0, 0, 2, 4]}),
        "transpose2": ({"X": [f(2, 6, 2, 4)]}, {"axis": [0, 2, 1, 3]}),
        "unsqueeze2": ({"X": [f(2, 6)]}, {"axes": [1, 2]}),
        "split": ({"X": [f(2, 6, 12)]}, {"num": 3, "sections": [],
                                         "axis": 2}),
        "slice": ({"Input": [f(10, 4)]}, {"axes": [0], "starts": [0],
                                          "ends": [6]}),
        "elementwise_add": ({"X": [f(2, 6, 8)], "Y": [f(8)]}, {"axis": 2}),
        "gelu": ({"X": [f(2, 6, 8)]}, {}),
        "scale": ({"X": [f(2, 6)]}, {"scale": 1e9, "bias": -1e9,
                                     "bias_after_scale": True}),
        "sum": ({"X": [f(3, 4), f(3, 4), f(3, 4)]}, {}),
        "mean": ({"X": [f(2, 6, 8)]}, {}),
        "mul": ({"X": [f(2, 6, 8)], "Y": [f(8, 5)]},
                {"x_num_col_dims": 2, "y_num_col_dims": 1}),
        "softmax_with_cross_entropy": (
            {"Logits": [f(2, 6, 50)], "Label": [labels]},
            {"soft_label": False, "axis": -1, "ignore_index": -100}),
        "layer_norm": ({"X": [f(2, 6, 8)], "Scale": [f(8)], "Bias": [f(8)]},
                       {"epsilon": 1e-5, "begin_norm_axis": 2}),
        "dropout": ({"X": [f(2, 6, 8)]},
                    {"dropout_prob": 0.1, "is_test": True,
                     "dropout_implementation": "upscale_in_train"}),
        "lookup_table": ({"W": [f(50, 8)], "Ids": [ids]},
                         {"padding_idx": -1, "is_sparse": False}),
        "fused_attention": (
            {"Q": [f(2, 2, 6, 8)], "K": [f(2, 2, 6, 8)], "V": [f(2, 2, 6, 8)],
             "Mask": [np.where(rng.rand(2, 1, 1, 6) < 0.3, -1e9,
                               0.0).astype(np.float32)]},
            {"dropout": 0.0, "causal": False, "is_test": False,
             "sequence_parallel": False, "scale": 0.35}),
    }


def _dense_cases():
    """The dense ops of nn_ops, tensor_ops, metric_ops and math_ops. A key
    `<op>:<arm>` is one more arm of op `<op>`. Inputs hold the cases
    where the port writes the reference's arithmetic out by hand: tied
    maxima in pooling, reductions and top_k / argsort, values exactly on
    a clip bound or at 0 of leaky_relu / elu, halves for round."""
    rng = np.random.RandomState(10)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    i32 = lambda lo, hi, *s: rng.randint(lo, hi, s).astype(np.int32)  # noqa
    pos = lambda *s: (np.abs(f(*s)) + 0.5).astype(np.float32)  # noqa: E731
    unit = lambda *s: rng.uniform(-0.9, 0.9, s).astype(np.float32)  # noqa
    ties = lambda *s: np.round(f(*s) * 2).astype(np.float32) / 2  # noqa
    probs = np.exp(f(4, 6))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    relu_ties = np.maximum(ties(2, 3, 9, 9), 0).astype(np.float32)
    bounds = np.array([-2.5, 2.5, -3.0, 3.0, 0.0, 6.0, 0.7, -0.3],
                      np.float32)
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 0.2, 2.7, -2.2],
                      np.float32)
    bn = lambda x, **a: ({"X": [x], "Scale": [f(3)], "Bias": [f(3)],  # noqa
                          "Mean": [f(3) * 0.1], "Variance": [pos(3)]},
                         dict({"momentum": 0.9, "epsilon": 1e-5,
                               "is_test": False, "data_layout": "NCHW"},
                              **a))
    pool = lambda x, **a: ({"X": [x]}, dict(  # noqa: E731
        {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
         "paddings": [1, 1], "global_pooling": False, "exclusive": True,
         "adaptive": False}, **a))
    interp = lambda **a: ({"X": [f(2, 2, 4, 5)]}, a)  # noqa: E731
    bools = lambda *s: rng.rand(*s) < 0.5  # noqa: E731
    c = {
        # nn_ops
        "conv2d": ({"Input": [f(2, 4, 9, 9)], "Filter": [f(6, 2, 3, 3)]},
                   {"strides": [2, 1], "paddings": [1, 2],
                    "dilations": [1, 2], "groups": 2}),
        "depthwise_conv2d": ({"Input": [f(2, 4, 8, 8)],
                              "Filter": [f(4, 1, 3, 3)]},
                             {"strides": [1, 1], "paddings": [1, 1],
                              "dilations": [1, 1]}),
        "conv2d_transpose": ({"Input": [f(2, 4, 5, 5)],
                              "Filter": [f(4, 3, 3, 3)]},
                             {"strides": [2, 2], "paddings": [1, 1],
                              "dilations": [1, 1]}),
        "pool2d": pool(f(2, 3, 9, 9)),
        "pool2d:tied": pool(relu_ties),
        "pool2d:avg_exclusive": pool(f(2, 3, 9, 9), pooling_type="avg"),
        "pool2d:avg_inclusive": pool(f(2, 3, 9, 9), pooling_type="avg",
                                     exclusive=False),
        "pool2d:global_max": pool(relu_ties, global_pooling=True),
        "pool2d:global_avg": pool(f(2, 3, 9, 9), pooling_type="avg",
                                  global_pooling=True),
        "pool2d:adaptive": pool(f(2, 3, 9, 9), pooling_type="avg",
                                adaptive=True),
        "pool2d:aligned_tied": pool(relu_ties[..., :8, :8], ksize=[2, 2],
                                    strides=[2, 2], paddings=[0, 0]),
        "softmax": ({"X": [f(2, 3, 5)]}, {"axis": -1}),
        "log_softmax": ({"X": [f(2, 3, 5)]}, {"axis": 1}),
        "cross_entropy": ({"X": [probs], "Label": [i32(0, 6, 4, 1)]},
                          {"soft_label": False}),
        "cross_entropy:soft": ({"X": [probs], "Label": [probs[::-1].copy()]},
                               {"soft_label": True}),
        "sigmoid_cross_entropy_with_logits": (
            {"X": [f(3, 5)], "Label": [rng.rand(3, 5).astype(np.float32)]},
            {}),
        "huber_loss": ({"X": [f(6, 1)], "Y": [f(6, 1)]}, {"delta": 0.5}),
        "batch_norm": bn(f(4, 3, 5, 5) * 2 + 1),
        "batch_norm:nhwc": bn(f(4, 5, 5, 3) * 2 + 1, data_layout="NHWC"),
        "batch_norm:test": bn(f(4, 3, 5, 5) * 2 + 1, is_test=True),
        "instance_norm": ({"X": [f(2, 3, 4, 4)], "Scale": [f(3)],
                           "Bias": [f(3)]}, {"epsilon": 1e-5}),
        "group_norm": ({"X": [f(2, 4, 3, 3)], "Scale": [f(4)],
                        "Bias": [f(4)]}, {"groups": 2, "epsilon": 1e-5}),
        "lookup_table_v2": ({"W": [f(20, 4)],
                             "Ids": [np.array([[1, 3, 5], [3, 0, 19]],
                                              np.int32)]},
                            {"padding_idx": 3}),
        "one_hot": ({"X": [np.array([[0], [5], [7], [2]], np.int32)]},
                    {"depth": 6}),
        "one_hot_v2": ({"X": [np.array([0, 5, 7, 2], np.int32)]},
                       {"depth": 6}),
        "pad": ({"X": [f(2, 3)]}, {"paddings": [1, 0, 2, 1],
                                   "pad_value": 0.5}),
        "pad2d": ({"X": [f(2, 2, 4, 5)]}, {"paddings": [1, 2, 2, 1],
                                           "mode": "constant",
                                           "pad_value": 0.25}),
        "pad2d:reflect": ({"X": [f(2, 2, 4, 5)]},
                          {"paddings": [1, 2, 2, 1], "mode": "reflect"}),
        "pad2d:edge": ({"X": [f(2, 2, 4, 5)]},
                       {"paddings": [1, 2, 2, 1], "mode": "edge"}),
        "interpolate": interp(interp_method="nearest", out_h=7, out_w=3),
        "interpolate:bilinear": interp(interp_method="bilinear", out_h=7,
                                       out_w=9),
        "interpolate:bicubic": interp(interp_method="bicubic", out_h=6,
                                      out_w=3),
        "nearest_interp": interp(scale=2.0),
        "bilinear_interp": interp(out_h=3, out_w=8),
        # tensor_ops
        "fill_constant_batch_size_like": (
            {"Input": [f(5, 3)]}, {"shape": [1, 4], "dtype": "float32",
                                   "value": 2.0, "input_dim_idx": 0,
                                   "output_dim_idx": 0}),
        "fill_any_like": ({"X": [f(2, 3)]}, {"value": 3.0,
                                             "dtype": "int64"}),
        "shape": ({"Input": [f(2, 3, 4)]}, {}),
        "reshape": ({"X": [f(2, 6)]}, {"shape": [0, 3, -1]}),
        "transpose": ({"X": [f(2, 3, 4)]}, {"axis": [2, 0, 1]}),
        "flatten2": ({"X": [f(2, 3, 4)]}, {"axis": 2}),
        "flatten_contiguous_range": ({"X": [f(2, 3, 4, 5)]},
                                     {"start_axis": 1, "stop_axis": 2}),
        "squeeze2": ({"X": [f(2, 1, 3, 1)]}, {"axes": [1, -1]}),
        "squeeze2:all": ({"X": [f(2, 1, 3, 1)]}, {"axes": []}),
        "concat": ({"X": [f(2, 3), f(2, 4)]}, {"axis": 1}),
        "tile": ({"X": [f(2, 3)]}, {"repeat_times": [2, 1, 2]}),
        "expand_v2": ({"X": [f(3, 1)]}, {"shape": [2, -1, 4]}),
        "expand_as_v2": ({"X": [f(1, 3)], "Y": [f(4, 3)]}, {}),
        "gather_nd": ({"X": [f(4, 5, 3)],
                       "Index": [np.array([[1, 2], [3, 0]], np.int32)]}, {}),
        "scatter": ({"X": [f(6, 3)], "Ids": [np.array([1, 4], np.int32)],
                     "Updates": [f(2, 3)]}, {"overwrite": True}),
        "scatter:add": ({"X": [f(6, 3)],
                         "Ids": [np.array([1, 1, 4], np.int32)],
                         "Updates": [f(3, 3)]}, {"overwrite": False}),
        "strided_slice": ({"Input": [f(6, 5)]},
                          {"axes": [0, 1], "starts": [1, 4], "ends": [6, 0],
                           "strides": [2, -2]}),
        "top_k": ({"X": [ties(3, 8)]}, {"k": 3}),
        "top_k_v2": ({"X": [ties(5, 3)]}, {"k": 2, "axis": 0}),
        "arg_max": ({"X": [ties(3, 8)]}, {"axis": 1, "dtype": "int64"}),
        "arg_max:keepdims": ({"X": [ties(3, 8)]},
                             {"axis": 0, "keepdims": True}),
        "arg_min": ({"X": [ties(3, 8)]}, {"axis": 0}),
        "argsort": ({"X": [ties(3, 8)]}, {"axis": -1, "descending": True}),
        "argsort:ascending": ({"X": [ties(6, 3)]}, {"axis": 0,
                                                    "descending": False}),
        "where_index": ({"Condition": [bools(3, 4)]}, {}),
        "masked_select": ({"X": [f(3, 4)], "Mask": [bools(3, 4)]}, {}),
        "index_select": ({"X": [f(5, 3)],
                          "Index": [np.array([4, 0, 4], np.int32)]},
                         {"dim": 0}),
        "range": ({"Start": [np.array(0.5, np.float32)],
                   "End": [np.array(3.7, np.float32)],
                   "Step": [np.array(0.4, np.float32)]}, {}),
        "linspace": ({"Start": [np.array(-1.0, np.float32)],
                      "Stop": [np.array(2.0, np.float32)],
                      "Num": [np.array(7, np.int32)]}, {}),
        "eye": ({}, {"num_rows": 3, "num_columns": 4, "dtype": "float32"}),
        "tril_triu": ({"X": [f(4, 4)]}, {"diagonal": 1, "lower": True}),
        "tril_triu:upper": ({"X": [f(4, 4)]}, {"diagonal": -1,
                                                "lower": False}),
        "meshgrid": ({"X": [f(3), f(4)]}, {}),
        "flip": ({"X": [f(2, 3, 4)]}, {"axis": [0, 2]}),
        "roll": ({"X": [f(3, 4)]}, {"shifts": [1, -2], "axis": [0, 1]}),
        "roll:flat": ({"X": [f(3, 4)]}, {"shifts": [3], "axis": []}),
        "unique": ({"X": [np.array([3, 1, 3, 0, 1, 7], np.int32)]}, {}),
        # metric_ops
        "accuracy": ({"Out": [f(5, 3)], "Indices": [i32(0, 4, 5, 3)],
                      "Label": [i32(0, 4, 5, 1)]}, {}),
        "auc": ({"Predict": [rng.rand(8, 2).astype(np.float32)],
                 "Label": [i32(0, 2, 8, 1)], "StatPos": [i32(0, 3, 11)],
                 "StatNeg": [i32(0, 3, 11)]}, {"num_thresholds": 10}),
        "precision_recall": ({"Indices": [i32(0, 4, 6, 1)],
                              "Labels": [i32(0, 4, 6, 1)],
                              "Weights": [pos(6, 1)],
                              "StatesInfo": [pos(4, 4)]},
                             {"class_number": 4}),
        "check_finite_and_unscale": (
            {"X": [f(3), np.array([[1.0, np.inf], [2.0, 3.0]], np.float32)],
             "Scale": [np.array([4.0], np.float32)]}, {}),
        "update_loss_scaling": (
            {"X": [f(3)], "FoundInfinite": [np.array(True)],
             "PrevLossScaling": [np.array([1024.0], np.float32)],
             "InGoodSteps": [np.array([5], np.int32)],
             "InBadSteps": [np.array([1], np.int32)]},
            {"incr_every_n_steps": 1000, "decr_every_n_nan_or_inf": 2,
             "incr_ratio": 2.0, "decr_ratio": 0.5}),
        "update_loss_scaling:grow": (
            {"X": [f(3)], "FoundInfinite": [np.array(False)],
             "PrevLossScaling": [np.array([1024.0], np.float32)],
             "InGoodSteps": [np.array([2], np.int32)],
             "InBadSteps": [np.array([0], np.int32)]},
            {"incr_every_n_steps": 3, "decr_every_n_nan_or_inf": 2,
             "incr_ratio": 2.0, "decr_ratio": 0.5}),
        # math_ops
        "elementwise_floordiv": ({"X": [f(3, 4) * 4], "Y": [pos(4)]},
                                 {"axis": -1}),
        "elementwise_floordiv:int": ({"X": [i32(-9, 9, 3, 4)],
                                      "Y": [i32(1, 4, 4)]}, {"axis": -1}),
        "leaky_relu": ({"X": [bounds]}, {"alpha": 0.1}),
        "elu": ({"X": [bounds]}, {"alpha": 1.5}),
        "hard_sigmoid": ({"X": [bounds]}, {"slope": 0.2, "offset": 0.5}),
        "hard_swish": ({"X": [bounds]}, {"threshold": 6.0, "scale": 6.0,
                                         "offset": 3.0}),
        "swish": ({"X": [f(3, 4)]}, {"beta": 1.5}),
        "relu6": ({"X": [bounds * 2]}, {"threshold": 6.0}),
        "reduce_mean": ({"X": [f(2, 3, 4)]}, {"dim": [1, 2],
                                              "keep_dim": True}),
        "reduce_max": ({"X": [ties(3, 4, 5)]}, {"dim": [1], "keep_dim":
                                                False}),
        "reduce_min": ({"X": [ties(3, 4)]}, {"reduce_all": True}),
        "reduce_prod": ({"X": [unit(2, 3, 2) + 1]}, {"dim": [0, 2],
                                                     "keep_dim": True}),
        "reduce_all": ({"X": [bools(3, 4)]}, {"dim": [1]}),
        "reduce_any": ({"X": [bools(3, 4)]}, {"reduce_all": True}),
        "bmm": ({"X": [f(2, 3, 4)], "Y": [f(2, 4, 5)]}, {}),
        "dot": ({"X": [f(3, 4)], "Y": [f(3, 4)]}, {}),
        "p_norm": ({"X": [pos(3, 4)]}, {"porder": 3.0, "axis": 1,
                                        "keepdim": True}),
        "squared_l2_norm": ({"X": [f(3, 4)]}, {}),
        "cumsum": ({"X": [f(3, 4)]}, {"axis": 1}),
        "cumsum:exclusive": ({"X": [f(3, 4)]}, {"axis": 0,
                                                "exclusive": True}),
        "cumsum:reverse": ({"X": [f(3, 4)]}, {"axis": 1, "reverse": True}),
        "cumsum:flatten": ({"X": [f(3, 4)]}, {"flatten": True}),
        "maximum": ({"X": [ties(3, 4)], "Y": [ties(3, 4)]}, {}),
        "minimum": ({"X": [ties(3, 4)], "Y": [ties(3, 4)]}, {}),
        "not_equal": ({"X": [ties(3, 4)], "Y": [ties(3, 4)]}, {}),
        "logical_and": ({"X": [bools(3, 4)], "Y": [bools(3, 4)]}, {}),
        "logical_or": ({"X": [bools(3, 4)], "Y": [bools(3, 4)]}, {}),
        "logical_xor": ({"X": [bools(3, 4)], "Y": [bools(3, 4)]}, {}),
        "logical_not": ({"X": [bools(3, 4)]}, {}),
        "isfinite": ({"X": [np.array([1.0, np.inf, 2.0], np.float32)]}, {}),
        "isfinite_v2": ({"X": [np.array([1.0, np.inf, np.nan], np.float32)]},
                        {}),
        "isnan_v2": ({"X": [np.array([1.0, np.inf, np.nan], np.float32)]},
                     {}),
        "isinf_v2": ({"X": [np.array([1.0, -np.inf, np.nan], np.float32)]},
                     {}),
    }
    for op, x in (("sigmoid", f(3, 4)), ("log", pos(3, 4)),
                  ("log2", pos(3, 4)), ("log10", pos(3, 4)),
                  ("log1p", pos(3, 4) - 0.9), ("rsqrt", pos(3, 4)),
                  ("abs", f(3, 4)), ("reciprocal", pos(3, 4)),
                  ("round", halves), ("sin", f(3, 4)), ("tan", unit(3, 4)),
                  ("asin", unit(3, 4)), ("acos", unit(3, 4)),
                  ("atan", f(3, 4)), ("sinh", f(3, 4)), ("cosh", f(3, 4)),
                  ("softsign", f(3, 4)), ("softplus", f(3, 4) * 8),
                  ("erf", f(3, 4)), ("logsigmoid", f(3, 4))):
        c[op] = ({"X": [x]}, {})
    # ported earlier, emitted by the image models: relu at ties (its
    # gradient at 0), the SE gate's broadcast product, Momentum's assign
    c["relu"] = ({"X": [ties(3, 4)]}, {})
    c["elementwise_mul"] = ({"X": [f(2, 3, 4)], "Y": [f(3)]}, {"axis": 1})
    c["assign"] = ({"X": [f(3, 4)]}, {})
    return c


CASES = _lowering_cases()
CASES.update(_dense_cases())
# random draws differ between the packages: compared by distribution
# (test_dense_random_lowerings)
RANDOM_OPS = ("uniform_random", "gaussian_random", "randint")
# bf16 arms left out: integer or boolean inputs only (the bf16 arm would
# be the f32 one)
F32_ONLY = {
    "one_hot", "one_hot_v2", "unique", "where_index", "eye", "range",
    "linspace", "accuracy", "auc", "precision_recall", "reduce_all",
    "reduce_any", "logical_and", "logical_or", "logical_xor",
    "logical_not", "elementwise_floordiv:int", "update_loss_scaling:grow",
}


def _op(case):
    return case.split(":")[0]


def _arms(cases, bf16):
    """(case, dtype) pairs: f32 for every case, bf16 for those in `bf16`;
    ids `<case>-<dtype>`."""
    return [pytest.param(c, d, id=f"{c}-{d}") for c in cases
            for d in ("f32", "bf16") if d == "f32" or c in bf16]


@pytest.mark.parametrize("op,dtype", _arms(
    sorted(CASES), {c for c in CASES if c not in F32_ONLY}))
def test_lowering_matches_reference(op, dtype):
    ins, attrs = CASES[op]
    op = _op(op)
    ref = _run_ref(op, ins, attrs, dtype)
    port = _run_port(op, ins, attrs, dtype)
    slots = ["Loss"] if op == "softmax_with_cross_entropy" and \
        dtype == "bf16" else None
    if op == "fill_constant":
        ref = {"Out": ref["Out"]}
    _assert_outs_close(ref, port, dtype, slots)


def test_every_dense_op_type_has_a_case():
    """Every type the four reference files register is in CASES or, drawn
    at random, in RANDOM_OPS; and the port registers all of them."""
    import re
    import pathlib
    root = pathlib.Path(ref_registry.__file__).parent
    types = set()
    for name in ("nn_ops", "tensor_ops", "metric_ops", "math_ops"):
        src = (root / f"{name}.py").read_text()
        types |= set(re.findall(r'register\("(\w+)"', src))
        types |= set(re.findall(
            r'_(?:unary|elementwise|reduce|compare|logical)\("(\w+)"', src))
    covered = {_op(c) for c in CASES} | set(RANDOM_OPS)
    # the lowerings of earlier slices, held by their own tests
    earlier = {"fill_constant", "fill_zeros_like", "assign", "assign_value",
               "truncated_gaussian_random", "reshape2", "transpose2",
               "unsqueeze2", "split", "stack", "unstack", "expand", "gather",
               "slice", "where", "increment", "elementwise_add",
               "elementwise_sub", "elementwise_mul", "elementwise_div",
               "elementwise_min", "elementwise_max", "elementwise_pow",
               "elementwise_mod", "relu", "tanh", "exp", "sqrt", "square",
               "floor", "ceil", "sign", "cos", "gelu", "pow", "scale",
               "clip", "clip_by_norm", "cast", "sum", "mean", "reduce_sum",
               "matmul", "matmul_v2", "mul", "equal", "less_than",
               "less_equal", "greater_than", "greater_equal", "dropout",
               "lookup_table", "softmax_with_cross_entropy",
               "square_error_cost", "layer_norm"}
    assert types - covered - earlier == set()
    assert all(port_registry.has(t) for t in types)
    assert len(types) == 163


# vjp arms: the earlier slices' ops; of the dense ops, those the image
# models differentiate and the ones whose gradient the port writes out to
# hold the reference's (ties split among maxima and on clip bounds, the
# slope at 0, custom index and weight arithmetic). The other dense ops are
# torch's own differentiable functions of the same formula, held by the
# forward cases. bf16 arms where AMP hands the op bf16 operands: its
# white-list products (the normalisations run f32 under AMP, and their
# Scale gradients sum N*H*W products that the reference accumulates in
# bf16)
VJP_CASES = ["mul", "layer_norm", "gelu", "fused_attention",
             "softmax_with_cross_entropy", "lookup_table",
             # the image models' other differentiable ops
             "elementwise_add", "mean", "unsqueeze2", "dropout"] + sorted(
    c for c in _dense_cases() if _op(c) in {
        "conv2d", "depthwise_conv2d", "conv2d_transpose", "pool2d",
        "batch_norm", "instance_norm", "group_norm", "softmax",
        "log_softmax", "cross_entropy", "sigmoid_cross_entropy_with_logits",
        "huber_loss", "flatten2", "sigmoid", "top_k", "top_k_v2", "argsort",
        "reduce_max", "reduce_min", "reduce_prod", "maximum", "minimum",
        "hard_sigmoid", "hard_swish", "relu6", "leaky_relu", "elu",
        "softplus", "lookup_table_v2", "interpolate", "bilinear_interp",
        "cumsum", "p_norm", "scatter", "gather_nd", "strided_slice",
        "pad2d", "relu", "elementwise_mul", "assign"})
VJP_BF16 = {"mul", "layer_norm", "gelu", "fused_attention",
            "softmax_with_cross_entropy", "lookup_table", "conv2d",
            "depthwise_conv2d", "conv2d_transpose"}


@pytest.mark.parametrize("op,dtype", _arms(VJP_CASES, VJP_BF16))
def test_vjp_lowering_matches_reference(op, dtype):
    """The generic __vjp__ op: torch.func.vjp over the port's lowering vs
    jax.vjp over the reference's, with the same cotangents. A stateful
    output (batch_norm's running statistics) takes no cotangent, as
    append_backward leaves it out."""
    ins, attrs = CASES[op]
    op = _op(op)
    outs = _run_ref(op, ins, attrs, "f32")
    stateful = ref_registry.get(op).stateful_outputs
    out_slots = [s for s in outs if s not in ("XShape",)
                 and s not in stateful]
    nondiff = ref_registry.get(op).nondiff_slots
    diff = [(s, i) for s, vs in ins.items() if s not in nondiff
            for i, a in enumerate(vs) if np.issubdtype(a.dtype, np.floating)]
    rng = np.random.RandomState(1)
    vjp_ins = dict(ins)
    for s in out_slots:
        vjp_ins[f"OG:{s}"] = [np.asarray(rng.randn(*o.shape), np.float32)
                              for o in outs[s]]
    fake_op = type("Op", (), {"type": op, "attrs": dict(attrs),
                              "inputs": {s: [f"{s}{i}" for i in range(len(v))]
                                         for s, v in ins.items()},
                              "outputs": {s: [f"o{s}{i}" for i in
                                              range(len(outs[s]))]
                                          for s in out_slots}})
    vattrs = ref_registry.make_vjp_attrs(fake_op, diff, out_slots)
    ref = _run_ref("__vjp__", vjp_ins, vattrs, dtype)
    port = _run_port("__vjp__", vjp_ins, vattrs, dtype)
    _assert_outs_close(ref, port, dtype)


@pytest.mark.parametrize("layout", ["hv", "vh"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_lm_head_ce_matches_reference(layout, dtype):
    """Loss and grads (x, w, bias) at a vocabulary of 1000 with chunk 256
    (not a multiple), with an ignored token; the bias stays f32 as AMP's
    keep_f32_slots keeps it."""
    rng = np.random.RandomState(2)
    v, h = 1000, 16
    x = rng.randn(2, 5, h).astype(np.float32)
    w = (rng.randn(h, v) if layout == "hv" else rng.randn(v, h)) \
        .astype(np.float32) * 0.3
    b = rng.randn(v).astype(np.float32) * 0.1
    labels = rng.randint(0, v, (2, 5, 1)).astype(np.int32)
    labels[1, 2, 0] = -100
    g = rng.rand(2, 5, 1).astype(np.float32)
    attrs = {"chunk": 256, "w_layout": layout, "ignore_index": -100}
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    op = ref_registry.get("fused_lm_head_ce")

    def ref_f(x, w, b):
        ins = {"X": [x], "W": [w], "Label": [jnp.asarray(labels)],
               "Bias": [b]}
        return op.lower(ref_registry.LowerCtx(rng_key=jax.random.key(0)),
                        ins, attrs)["Loss"][0]

    out, pull = jax.vjp(ref_f, jnp.asarray(x, jd), jnp.asarray(w, jd),
                        jnp.asarray(b))
    ref = [out] + list(pull(jnp.asarray(g)))
    pop = port_registry.get("fused_lm_head_ce")

    def port_f(x, w, b):
        ins = {"X": [x], "W": [w], "Label": [torch.from_numpy(labels)],
               "Bias": [b]}
        return pop.lower(port_registry.LowerCtx(device="cpu"), ins,
                         attrs)["Loss"][0]

    out, pull = torch.func.vjp(port_f, torch.from_numpy(x).to(td),
                               torch.from_numpy(w).to(td),
                               torch.from_numpy(b))
    port = [out] + list(pull(torch.from_numpy(g)))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "f32" \
        else dict(rtol=2e-2, atol=2e-2)
    for r, p, name in zip(ref, port, ("loss", "dx", "dw", "db")):
        assert dtype_name(p.dtype) == np.dtype(r.dtype).name, name
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   err_msg=name, **tol)
    assert out[0, 0, 0] == out[0, 0, 0]
    assert float(port[0][1, 2, 0]) == 0.0          # ignored: zero loss


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adam_matches_reference_in_place(dtype):
    """The dense adam rule: same ParamOut / moments; the port updates the
    scope's tensors in place (the outputs ARE the inputs)."""
    rng = np.random.RandomState(3)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    ins = {"Param": [f(4, 5)], "Grad": [f(4, 5)],
           "LearningRate": [np.array([1e-3], np.float32)],
           "Moment1": [f(4, 5) * 0.1], "Moment2": [np.abs(f(4, 5)) * 0.01],
           "Beta1Pow": [np.array([0.9 ** 3], np.float32)],
           "Beta2Pow": [np.array([0.999 ** 3], np.float32)]}
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    ref = _run_ref("adam", {k: v for k, v in ins.items()}, attrs, "f32")
    tins = {s: [torch.from_numpy(a.copy()) for a in vs]
            for s, vs in ins.items()}
    if dtype == "bf16":
        tins["Grad"] = [tins["Grad"][0].bfloat16()]
        ref = _run_ref("adam", dict(ins, Grad=[np.asarray(jnp.asarray(
            ins["Grad"][0]).astype(jnp.bfloat16).astype(jnp.float32))]),
            attrs, "f32")
    out = port_registry.get("adam").lower(
        port_registry.LowerCtx(device="cpu"), tins, attrs)
    for slot, src in (("ParamOut", "Param"), ("Moment1Out", "Moment1"),
                      ("Moment2Out", "Moment2")):
        assert out[slot][0] is tins[src][0]
        np.testing.assert_allclose(out[slot][0].numpy(),
                                   np.asarray(ref[slot][0]), rtol=1e-5,
                                   atol=1e-7, err_msg=slot)


def test_random_lowerings_are_deterministic_and_distributed():
    """dropout and truncated_gaussian_random: same key -> same draw, other
    run seed -> other draw; keep rate ~ 1 - p; kept values upscaled; the
    normal is cut at two standard deviations."""
    x = torch.ones(64, 256)
    attrs = {"dropout_prob": 0.1, "is_test": False,
             "dropout_implementation": "upscale_in_train",
             "__rng_seed__": 3}
    low = port_registry.get("dropout").lower
    a = low(port_registry.LowerCtx(run_seed=5), {"X": [x]}, attrs)
    b = low(port_registry.LowerCtx(run_seed=5), {"X": [x]}, attrs)
    c = low(port_registry.LowerCtx(run_seed=6), {"X": [x]}, attrs)
    assert torch.equal(a["Out"][0], b["Out"][0])
    assert not torch.equal(a["Out"][0], c["Out"][0])
    keep = a["Mask"][0].bool()
    assert a["Mask"][0].dtype == torch.uint8
    assert abs(keep.float().mean().item() - 0.9) < 0.01
    assert torch.allclose(a["Out"][0][keep], torch.tensor(1 / 0.9))
    assert (a["Out"][0][~keep] == 0).all()
    tg = port_registry.get("truncated_gaussian_random").lower(
        port_registry.LowerCtx(run_seed=0),
        {}, {"shape": [256, 128], "dtype": "float32", "mean": 0.0,
             "std": 0.02, "__rng_seed__": 1})["Out"][0]
    assert tg.shape == (256, 128) and tg.dtype == torch.float32
    assert tg.abs().max().item() <= 0.04 + 1e-7
    assert abs(tg.std().item() - 0.02 * 0.88) < 0.002   # truncated std


@pytest.mark.parametrize("op", RANDOM_OPS)
def test_dense_random_lowerings(op):
    """uniform_random, gaussian_random and randint draw from the op's
    device key: the reference's shape and dtype; the same run seed and op
    give the same draw, another run seed or op another; the statistics of
    65,536 draws within 5 standard errors (mean, and the variance of a
    uniform / normal), every value in range."""
    attrs = {"uniform_random": {"min": -2.0, "max": 3.0},
             "gaussian_random": {"mean": 0.5, "std": 2.0},
             "randint": {"low": -3, "high": 5, "dtype": "int64"}}[op]
    attrs = dict(attrs, shape=[256, 256], __rng_seed__=4)
    ref = ref_registry.get(op).lower(
        ref_registry.LowerCtx(rng_key=jax.random.key(0)), {},
        dict(attrs))["Out"][0]
    low = port_registry.get(op).lower
    a = low(port_registry.LowerCtx(run_seed=5), {}, attrs)["Out"][0]
    b = low(port_registry.LowerCtx(run_seed=5), {}, attrs)["Out"][0]
    c = low(port_registry.LowerCtx(run_seed=6), {}, attrs)["Out"][0]
    d = low(port_registry.LowerCtx(run_seed=5), {},
            dict(attrs, __rng_seed__=5))["Out"][0]
    assert tuple(a.shape) == tuple(ref.shape)
    assert dtype_name(a.dtype) == np.dtype(ref.dtype).name
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    v = a.double()
    n = v.numel()
    if op == "uniform_random":
        mean, var = 0.5, 25.0 / 12
        assert v.min() >= -2.0 and v.max() < 3.0
    elif op == "gaussian_random":
        mean, var = 0.5, 4.0
    else:
        mean, var = 0.5, (8 ** 2 - 1) / 12
        assert set(v.unique().tolist()) == set(range(-3, 5))
    assert abs(v.mean().item() - mean) < 5 * (var / n) ** 0.5
    # the sample variance's standard error: sqrt(2 / n) var for a normal,
    # below it for the bounded ones
    assert abs(v.var().item() - var) < 5 * var * (2.0 / n) ** 0.5


def test_fleet_honours_amp_and_rejects_the_rest():
    s = port_fleet.DistributedStrategy()
    s.amp = True
    # tensor and sequence parallelism are honoured (tests/test_torch_tp.py
    # runs them); expert parallelism waits for switch_moe (item 12)
    s.tensor_parallel_degree = 2
    s.sequence_parallel_degree = 2
    s.tensor_parallel_degree = s.sequence_parallel_degree = 1
    with pytest.raises(NotImplementedError, match="item 12"):
        s.expert_parallel_degree = 2
    with pytest.raises(AttributeError, match="unknown"):
        s.shardingg = True
    main, start = port_program.Program(), port_program.Program()
    with port_program.program_guard(main, start), port_unique_name.guard():
        _, _, loss = port_bert.build_pretrain_program(
            port_bert.BertConfig.tiny())
        port_fleet.init(is_collective=True)
        port_fleet.distributed_optimizer(port_optimizer.Adam(1e-3),
                                         s).minimize(loss)
    assert main._amp and main._amp_dtype == "bfloat16"


def test_unported_options_raise():
    from paddle_tpu_torch.distributed import fleet as port_fleet
    with pytest.raises(NotImplementedError, match="item 19.2"):
        port_fleet.DistributedStrategy().a_sync = True
    # LocalSGD is ported (tests/test_torch_localsgd.py): the strategy takes
    # it, and minimize refuses it with tp, as the reference does
    s = port_fleet.DistributedStrategy()
    s.localsgd = True
    s.localsgd_configs = {"k_steps": 2}
    s.tensor_parallel_degree = 2
    main, start = port_program.Program(), port_program.Program()
    with port_program.program_guard(main, start), port_unique_name.guard():
        _, _, loss = port_bert.build_pretrain_program(
            port_bert.BertConfig.tiny())
        from paddle_tpu_torch.distributed.fleet.base import \
            DistributedOptimizer
        with pytest.raises(ValueError, match="localsgd"):
            DistributedOptimizer(port_optimizer.Adam(1e-3), s).minimize(loss)
    cfg = port_bert.BertConfig.tiny()
    cfg.moe_experts = 2
    with pytest.raises(NotImplementedError, match="item 12"):
        port_bert.build_pretrain_program(cfg)
    with pytest.raises(errors.UnimplementedError):
        port_registry.get("no_such_op")


def test_executor_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Executor()
