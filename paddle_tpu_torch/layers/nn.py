"""Neural-net layer functions (counterpart of paddle_tpu/layers/nn.py):
the ones BERT, GPT and the image models (ResNet, SE-ResNeXt, LeNet) are
built from, the convolution, pooling, normalisation, activation,
reduction, selection and metric builders over the dense ops, the ones
gradient clipping and weight-decay regularisation append, `cos_sim`,
`chunk_eval`, the CRF pair (`linear_chain_crf`, `crf_decoding`) and the
dense tail's `hsigmoid`, `edit_distance`, `bilinear_tensor_product` and
`add_position_encoding`. Not ported: `switch_moe`, whose op waits
(ROADMAP item 12, row 6), and `cond_take`, which raises in the
reference too."""
from __future__ import annotations

import math

from .. import initializer as init_mod
from ..framework.dtype import convert_dtype, dtype_name
from ..layer_helper import LayerHelper, ParamAttr

__all__ = [
    "data", "fc", "conv2d", "conv2d_transpose", "pool2d", "batch_norm",
    "layer_norm", "group_norm", "instance_norm", "dropout", "embedding",
    "relu", "sigmoid", "tanh", "softmax", "log_softmax", "gelu",
    "leaky_relu", "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "matmul", "mul", "reduce_sum", "reduce_mean",
    "reduce_max", "reduce_min", "reduce_prod", "mean", "scale", "cast",
    "reshape", "transpose", "concat", "split", "stack", "unstack",
    "squeeze", "unsqueeze", "flatten", "slice", "gather", "gather_nd",
    "scatter", "expand", "one_hot", "topk", "argmax", "argmin", "argsort",
    "accuracy", "auc", "clip", "clip_by_norm", "sums", "elementwise_mod",
    "elementwise_floordiv", "l2_normalize", "pad", "pad2d", "image_resize",
    "resize_nearest", "resize_bilinear", "relu6", "softplus", "swish",
    "hard_swish", "hard_sigmoid", "exp", "sqrt", "abs", "square", "log",
    "floor", "ceil", "round", "sign", "pow", "cos", "sin", "equal",
    "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "logical_and", "logical_or", "logical_not",
    "logical_xor", "where", "unique", "cumsum", "prelu", "brelu",
    "fused_attention", "cos_sim", "chunk_eval", "linear_chain_crf",
    "crf_decoding", "hsigmoid", "edit_distance", "bilinear_tensor_product",
    "add_position_encoding",
]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    """Declare an input variable; append_batch_size prepends a -1 dim."""
    helper = LayerHelper("data")
    full_shape = list(shape)
    if append_batch_size and (not full_shape or full_shape[0] != -1):
        full_shape = [-1] + full_shape
    return helper.main_program.global_block().create_var(
        name=name, shape=full_shape, dtype=convert_dtype(dtype), is_data=True,
        stop_gradient=stop_gradient)


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully connected: mul + elementwise_add (+ activation)."""
    helper = LayerHelper("fc")
    in_features = math.prod(input.shape[num_flatten_dims:])
    w = helper.create_parameter(param_attr, [in_features, size],
                                dtype=dtype_name(input.dtype))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("mul", inputs={"X": [input], "Y": [w]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": num_flatten_dims,
                            "y_num_col_dims": 1})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size],
                                    dtype=dtype_name(input.dtype),
                                    is_bias=True)
        tmp = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", inputs={"X": [out], "Y": [b]},
                         outputs={"Out": [tmp]},
                         attrs={"axis": num_flatten_dims})
        out = tmp
    return helper.append_activation(out, act)


def _pair_list(v):
    return [v, v] if isinstance(v, int) else list(v)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           use_cudnn=True, name=None, data_format="NCHW"):
    """NCHW convolution; the filter defaults to N(0, sqrt(2 / fan_in))
    (reference layers/nn.py:86-90)."""
    helper = LayerHelper("conv2d")
    filter_size = _pair_list(filter_size)
    stride, padding = _pair_list(stride), _pair_list(padding)
    dilation = _pair_list(dilation)
    c_in = input.shape[1]
    groups = groups or 1
    fan_in = (c_in // groups) * filter_size[0] * filter_size[1]
    w = helper.create_parameter(
        param_attr, [num_filters, c_in // groups] + filter_size,
        dtype=dtype_name(input.dtype),
        default_initializer=init_mod.Normal(0.0, (2.0 / fan_in) ** 0.5))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv2d", inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups})
    return helper.append_activation(_bias(helper, out, bias_attr,
                                          num_filters, input.dtype), act)


def _bias(helper, out, bias_attr, n, dtype):
    """`out` + a [n] bias on axis 1, unless bias_attr is False."""
    if bias_attr is False:
        return out
    b = helper.create_parameter(bias_attr, [n], dtype=dtype_name(dtype),
                                is_bias=True)
    tmp = helper.create_variable_for_type_inference(dtype)
    helper.append_op("elementwise_add", inputs={"X": [out], "Y": [b]},
                     outputs={"Out": [tmp]}, attrs={"axis": 1})
    return tmp


def conv2d_transpose(input, num_filters, filter_size, stride=1, padding=0,
                     dilation=1, param_attr=None, bias_attr=None, act=None,
                     name=None):
    helper = LayerHelper("conv2d_transpose")
    filter_size = _pair_list(filter_size)
    w = helper.create_parameter(param_attr,
                                [input.shape[1], num_filters] + filter_size,
                                dtype=dtype_name(input.dtype))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv2d_transpose",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": _pair_list(stride),
                            "paddings": _pair_list(padding),
                            "dilations": _pair_list(dilation)})
    return helper.append_activation(_bias(helper, out, bias_attr,
                                          num_filters, input.dtype), act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, name=None, adaptive=False):
    helper = LayerHelper("pool2d")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type,
                            "ksize": _pair_list(pool_size),
                            "strides": _pair_list(pool_stride),
                            "paddings": _pair_list(pool_padding),
                            "global_pooling": global_pooling,
                            "exclusive": exclusive, "adaptive": adaptive})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None,
               use_global_stats=False):
    """Scale and bias are trained; the running mean and variance are
    non-trainable parameters the op writes (MeanOut / VarianceOut name
    them), outside the optimizer and its buckets (reference
    layers/nn.py:150-185)."""
    helper = LayerHelper("batch_norm")
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    dtype = "float32"
    scale = helper.create_parameter(
        param_attr, [c], dtype=dtype,
        default_initializer=init_mod.Constant(1.0))
    bias = helper.create_parameter(bias_attr, [c], dtype=dtype, is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, initializer=init_mod.Constant(0.0),
                  trainable=False), [c], dtype=dtype)
    var = helper.create_parameter(
        ParamAttr(name=moving_variance_name,
                  initializer=init_mod.Constant(1.0), trainable=False),
        [c], dtype=dtype)
    y = helper.create_variable_for_type_inference(input.dtype)
    saved_mean = helper.create_variable_for_type_inference(dtype)
    saved_var = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [var]},
        outputs={"Y": [y], "MeanOut": [mean], "VarianceOut": [var],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test or use_global_stats,
               "data_layout": data_layout})
    return helper.append_activation(y, act)


def _norm_affine(helper, input, param_attr, bias_attr):
    inputs = {"X": [input]}
    c = input.shape[1]
    if param_attr is not False:
        inputs["Scale"] = [helper.create_parameter(
            param_attr, [c], dtype="float32",
            default_initializer=init_mod.Constant(1.0))]
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            bias_attr, [c], dtype="float32", is_bias=True)]
    return inputs


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, name=None):
    helper = LayerHelper("group_norm")
    inputs = _norm_affine(helper, input, param_attr, bias_attr)
    y = helper.create_variable_for_type_inference(input.dtype)
    m = helper.create_variable_for_type_inference("float32")
    v = helper.create_variable_for_type_inference("float32")
    helper.append_op("group_norm", inputs=inputs,
                     outputs={"Y": [y], "Mean": [m], "Variance": [v]},
                     attrs={"groups": groups, "epsilon": epsilon})
    return helper.append_activation(y, act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    helper = LayerHelper("instance_norm")
    inputs = _norm_affine(helper, input, param_attr, bias_attr)
    y = helper.create_variable_for_type_inference(input.dtype)
    sm = helper.create_variable_for_type_inference("float32")
    sv = helper.create_variable_for_type_inference("float32")
    helper.append_op("instance_norm", inputs=inputs,
                     outputs={"Y": [y], "SavedMean": [sm],
                              "SavedVariance": [sv]},
                     attrs={"epsilon": epsilon})
    return y


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm")
    norm_shape = [math.prod(input.shape[begin_norm_axis:])]
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            param_attr, norm_shape, dtype="float32",
            default_initializer=init_mod.Constant(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(
            bias_attr, norm_shape, dtype="float32", is_bias=True)]
    y = helper.create_variable_for_type_inference(input.dtype)
    m = helper.create_variable_for_type_inference("float32")
    v = helper.create_variable_for_type_inference("float32")
    helper.append_op("layer_norm", inputs=inputs,
                     outputs={"Y": [y], "Mean": [m], "Variance": [v]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(y, act)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout")
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference("uint8")
    helper.append_op("dropout", inputs={"X": [x]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "dropout_implementation": dropout_implementation})
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """lookup_table. `is_sparse` gives the table a SelectedRows gradient
    (ops/sparse_grad.py) that the optimizer applies to the touched rows
    only; `is_distributed` only marks the table (`w.is_distributed`), as
    in the reference: the parameter-server pass that reads it is ROADMAP
    item 19.2."""
    helper = LayerHelper("embedding")
    w = helper.create_parameter(param_attr, list(size), dtype=dtype)
    if is_distributed:
        w.is_distributed = True
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("lookup_table", inputs={"W": [w], "Ids": [input]},
                     outputs={"Out": [out]},
                     attrs={"padding_idx": -1 if padding_idx is None
                            else padding_idx,
                            "is_sparse": bool(is_sparse)})
    return out


def _unary_layer(op_type):
    def f(x, name=None):
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]})
        return out
    f.__name__ = op_type
    return f


relu = _unary_layer("relu")
sigmoid = _unary_layer("sigmoid")
tanh = _unary_layer("tanh")
exp = _unary_layer("exp")
sqrt = _unary_layer("sqrt")
abs = _unary_layer("abs")
square = _unary_layer("square")
log = _unary_layer("log")
floor = _unary_layer("floor")
ceil = _unary_layer("ceil")
round = _unary_layer("round")
sign = _unary_layer("sign")
cos = _unary_layer("cos")
sin = _unary_layer("sin")
softplus = _unary_layer("softplus")
swish = _unary_layer("swish")
hard_swish = _unary_layer("hard_swish")
hard_sigmoid = _unary_layer("hard_sigmoid")
relu6 = _unary_layer("relu6")
logical_not = _unary_layer("logical_not")


def softmax(input, axis=-1, name=None, use_cudnn=False):
    helper = LayerHelper("softmax")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("softmax", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def log_softmax(input, axis=-1, name=None):
    helper = LayerHelper("log_softmax")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("log_softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def gelu(x, approximate=False, name=None):
    helper = LayerHelper("gelu")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("gelu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"approximate": approximate})
    return out


def leaky_relu(x, alpha=0.02, name=None):
    helper = LayerHelper("leaky_relu")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("leaky_relu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"alpha": alpha})
    return out


def prelu(x, mode="all", param_attr=None, name=None):
    """max(x, 0) + alpha * min(x, 0) from primitive ops; alpha is one
    value, one a channel, or one an element."""
    helper = LayerHelper("prelu")
    if mode == "all":
        shape = [1]
    elif mode == "channel":
        shape = [x.shape[1]]
    else:
        shape = [math.prod(x.shape[1:])]
    alpha = helper.create_parameter(
        param_attr, shape, dtype="float32",
        default_initializer=init_mod.Constant(0.25))
    pos = relu(x)
    neg = elementwise_mul(elementwise_sub(x, pos), alpha,
                          axis=1 if mode == "channel" else -1)
    return elementwise_add(pos, neg)


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    helper = LayerHelper("brelu")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": t_min, "max": t_max})
    return out


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("pow", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"factor": factor})
    return out


def _binary_layer(op_type):
    def f(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return helper.append_activation(out, act)
    f.__name__ = op_type
    return f


elementwise_add = _binary_layer("elementwise_add")
elementwise_sub = _binary_layer("elementwise_sub")
elementwise_mul = _binary_layer("elementwise_mul")
elementwise_div = _binary_layer("elementwise_div")
elementwise_max = _binary_layer("elementwise_max")
elementwise_min = _binary_layer("elementwise_min")
elementwise_pow = _binary_layer("elementwise_pow")
elementwise_mod = _binary_layer("elementwise_mod")
elementwise_floordiv = _binary_layer("elementwise_floordiv")


def _compare_layer(op_type):
    def f(x, y, cond=None, name=None):
        helper = LayerHelper(op_type)
        out = cond or helper.create_variable_for_type_inference("bool")
        helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]})
        return out
    f.__name__ = op_type
    return f


equal = _compare_layer("equal")
not_equal = _compare_layer("not_equal")
less_than = _compare_layer("less_than")
less_equal = _compare_layer("less_equal")
greater_than = _compare_layer("greater_than")
greater_equal = _compare_layer("greater_equal")
logical_and = _compare_layer("logical_and")
logical_or = _compare_layer("logical_or")
logical_xor = _compare_layer("logical_xor")


def where(condition, x, y, name=None):
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("where",
                     inputs={"Condition": [condition], "X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("expand", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    return out


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"out_dtype": dtype_name(convert_dtype(dtype)),
                            "in_dtype": dtype_name(x.dtype)})
    return out


def _reduce_layer(op_type):
    def f(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(input.dtype)
        if dim is None:
            attrs = {"reduce_all": True, "dim": [0], "keep_dim": keep_dim}
        else:
            attrs = {"dim": dim if isinstance(dim, (list, tuple)) else [dim],
                     "keep_dim": keep_dim, "reduce_all": False}
        helper.append_op(op_type, inputs={"X": [input]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out
    f.__name__ = op_type
    return f


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper("clip")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": min, "max": max})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"max_norm": max_norm})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    out = out or helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("sum", inputs={"X": list(input)}, outputs={"Out": [out]})
    return out


def mean(x, name=None):
    helper = LayerHelper("mean")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": scale, "bias": bias,
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def reshape(x, shape, actual_shape=None, act=None, inplace=False,
            name=None):
    helper = LayerHelper("reshape2")
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("reshape2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out, act)


def transpose(x, perm, name=None):
    return _with_xshape("transpose2", x, {"axis": list(perm)})


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split")
    axis = dim % len(input.shape)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "sections": [], "axis": axis}
    else:
        n = len(num_or_sections)
        attrs = {"num": 0, "sections": list(num_or_sections), "axis": axis}
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n)]
    helper.append_op("split", inputs={"X": [input]}, outputs={"Out": outs},
                     attrs=attrs)
    return outs


def unsqueeze(input, axes, name=None):
    return _with_xshape("unsqueeze2", input, {"axes": list(axes)})


def slice(input, axes, starts, ends, name=None):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def fused_attention(q, k, v, mask=None, scale=None, dropout=0.0,
                    causal=False, name=None, sequence_parallel=False,
                    sp_mode="ring"):
    """Fused multi-head attention on [B, nh, S, hd]: the flash kernels
    B1-B3 on the card (ops/attention.py)."""
    helper = LayerHelper("fused_attention")
    out = helper.create_variable_for_type_inference(q.dtype)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if mask is not None:
        inputs["Mask"] = [mask]
    attrs = {"dropout": dropout, "causal": causal, "is_test": False,
             "sequence_parallel": bool(sequence_parallel),
             "sp_mode": sp_mode}
    if scale is not None:
        attrs["scale"] = scale
    helper.append_op("fused_attention", inputs=inputs,
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def gather(input, index, overwrite=True, axis=0):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat")
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("concat", inputs={"X": list(input)},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def stack(x, axis=0, name=None):
    helper = LayerHelper("stack")
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op("stack", inputs={"X": list(x)}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None, name=None):
    helper = LayerHelper("unstack")
    n = num if num is not None else x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(n)]
    helper.append_op("unstack", inputs={"X": [x]}, outputs={"Y": outs},
                     attrs={"axis": axis})
    return outs


def _with_xshape(op_type, x, attrs):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]}, attrs=attrs)
    return out


def squeeze(input, axes, name=None):
    return _with_xshape("squeeze2", input, {"axes": list(axes)})


def flatten(x, axis=1, name=None):
    return _with_xshape("flatten2", x, {"axis": axis})


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather_nd", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def scatter(input, index, updates, overwrite=True, name=None):
    helper = LayerHelper("scatter")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("scatter", inputs={"X": [input], "Ids": [index],
                                        "Updates": [updates]},
                     outputs={"Out": [out]}, attrs={"overwrite": overwrite})
    return out


def one_hot(input, depth, allow_out_of_range=False):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("one_hot", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"depth": depth})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k")
    vals = helper.create_variable_for_type_inference(input.dtype)
    idxs = helper.create_variable_for_type_inference("int64")
    helper.append_op("top_k", inputs={"X": [input]},
                     outputs={"Out": [vals], "Indices": [idxs]},
                     attrs={"k": k})
    return vals, idxs


def _arg_layer(op_type):
    def f(x, axis=0, name=None):
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference("int64")
        helper.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                         attrs={"axis": axis})
        return out
    return f


argmax = _arg_layer("arg_max")
argmin = _arg_layer("arg_min")


def argsort(input, axis=-1, descending=False, name=None):
    helper = LayerHelper("argsort")
    out = helper.create_variable_for_type_inference(input.dtype)
    idxs = helper.create_variable_for_type_inference("int64")
    helper.append_op("argsort", inputs={"X": [input]},
                     outputs={"Out": [out], "Indices": [idxs]},
                     attrs={"axis": axis, "descending": descending})
    return out, idxs


def accuracy(input, label, k=1, correct=None, total=None):
    """top_k, then the share of rows whose k indices hold the label."""
    helper = LayerHelper("accuracy")
    vals, idxs = topk(input, k)
    acc = helper.create_variable_for_type_inference("float32")
    correct = correct or helper.create_variable_for_type_inference("int32")
    total = total or helper.create_variable_for_type_inference("int32")
    helper.append_op("accuracy",
                     inputs={"Out": [vals], "Indices": [idxs],
                             "Label": [label]},
                     outputs={"Accuracy": [acc], "Correct": [correct],
                              "Total": [total]})
    return acc


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Streaming AUC; the bucket counts are persistable globals."""
    helper = LayerHelper("auc")
    stat_pos = helper.create_global_variable([num_thresholds + 1], "int64")
    stat_neg = helper.create_global_variable([num_thresholds + 1], "int64")
    for v in (stat_pos, stat_neg):
        init_mod.Constant(0)(v)
    auc_out = helper.create_variable_for_type_inference("float64")
    helper.append_op("auc",
                     inputs={"Predict": [input], "Label": [label],
                             "StatPos": [stat_pos], "StatNeg": [stat_neg]},
                     outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                              "StatNegOut": [stat_neg]},
                     attrs={"num_thresholds": num_thresholds})
    return auc_out, [stat_pos, stat_neg]


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    ssum = reduce_sum(square(x), dim=axis, keep_dim=True)
    norm = sqrt(elementwise_max(ssum, fill_constant_like(ssum, epsilon)))
    return elementwise_div(x, norm)


def cos_sim(X, Y, name=None):
    """Row-wise cosine similarity -> [B, 1] (cos_sim_op.cc; the
    recommender-system book model's scorer), with the rows' norms as
    the op's XNorm and YNorm outputs."""
    helper = LayerHelper("cos_sim")
    out = helper.create_variable_for_type_inference(X.dtype)
    xn = helper.create_variable_for_type_inference(X.dtype)
    yn = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op("cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out], "XNorm": [xn], "YNorm": [yn]})
    return out


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """Chunk-level precision, recall and F1 (IOB, IOE, IOBES or plain;
    chunk_eval_op.cc), counted on the host: a program holding it runs
    eagerly. Returns the reference's 6-tuple."""
    helper = LayerHelper("chunk_eval")
    outs = {n: helper.create_variable_for_type_inference("float32")
            for n in ("Precision", "Recall", "F1-Score")}
    for n in ("NumInferChunks", "NumLabelChunks", "NumCorrectChunks"):
        outs[n] = helper.create_variable_for_type_inference("int64")
    ins = {"Inference": [input], "Label": [label]}
    if seq_length is not None:
        ins["SeqLength"] = [seq_length]
    helper.append_op("chunk_eval", inputs=ins,
                     outputs={k: [v] for k, v in outs.items()},
                     attrs={"num_chunk_types": int(num_chunk_types),
                            "chunk_scheme": chunk_scheme,
                            "excluded_chunk_types":
                                list(excluded_chunk_types or [])})
    return (outs["Precision"], outs["Recall"], outs["F1-Score"],
            outs["NumInferChunks"], outs["NumLabelChunks"],
            outs["NumCorrectChunks"])


def linear_chain_crf(input, label, param_attr=None, length=None):
    """The CRF's negative log-likelihood [b, 1] of padded emissions [b, T,
    C] (and a length vector), with a [C + 2, C] transition parameter (rows
    0 / 1 the start / stop weights)."""
    helper = LayerHelper("linear_chain_crf")
    c = int(input.shape[-1])
    trans = helper.create_parameter(param_attr, [c + 2, c],
                                    dtype_name(input.dtype))
    outs = {n: helper.create_variable_for_type_inference(input.dtype)
            for n in ("LogLikelihood", "Alpha", "EmissionExps",
                      "TransitionExps")}
    ins = {"Emission": [input], "Transition": [trans], "Label": [label]}
    if length is not None:
        ins["SeqLen"] = [length]
    helper.append_op("linear_chain_crf", inputs=ins,
                     outputs={k: [v] for k, v in outs.items()})
    return outs["LogLikelihood"]


def crf_decoding(input, param_attr, label=None, length=None):
    """Viterbi decoding against the transitions `param_attr` names (the
    ones linear_chain_crf trains, when the block has them); with `label`,
    the per-token 0/1 correctness of the path."""
    helper = LayerHelper("crf_decoding")
    attr = ParamAttr._to_attr(param_attr)
    block = helper.main_program.global_block()
    if attr and attr.name and block.has_var(attr.name):
        trans = block.var(attr.name)
    else:
        c = int(input.shape[-1])
        trans = helper.create_parameter(attr, [c + 2, c],
                                        dtype_name(input.dtype))
    path = helper.create_variable_for_type_inference("int64")
    ins = {"Emission": [input], "Transition": [trans]}
    if label is not None:
        ins["Label"] = [label]
    if length is not None:
        ins["SeqLen"] = [length]
    helper.append_op("crf_decoding", inputs=ins,
                     outputs={"ViterbiPath": [path]})
    return path


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    """Hierarchical sigmoid: W is [num_classes - 1, D] (the internal nodes
    of the default tree) or, for a custom tree, [path length +
    num_classes, D]. `is_sparse` is accepted and the update stays dense,
    as in the reference."""
    helper = LayerHelper("hsigmoid")
    d = int(input.shape[-1])
    num_nodes = int(num_classes) - 1 if not is_custom else \
        int(path_table.shape[-1]) + num_classes
    w = helper.create_parameter(param_attr, [num_nodes, d],
                                dtype=dtype_name(input.dtype),
                                default_initializer=init_mod.Xavier())
    ins = {"X": [input], "W": [w], "Label": [label]}
    if bias_attr is not False:
        ins["Bias"] = [helper.create_parameter(
            bias_attr, [num_nodes], dtype=dtype_name(input.dtype),
            is_bias=True)]
    if is_custom:
        ins["PathTable"] = [path_table]
        ins["PathCode"] = [path_code]
    outs = {n: helper.create_variable_for_type_inference(input.dtype)
            for n in ("Out", "PreOut", "W_Out")}
    helper.append_op("hierarchical_sigmoid", inputs=ins,
                     outputs={k: [v] for k, v in outs.items()},
                     attrs={"num_classes": int(num_classes)})
    return outs["Out"]


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """Levenshtein distances of padded hyps and refs (and their lengths).
    Returns (distance, sequence_num)."""
    helper = LayerHelper("edit_distance")
    ins = {"Hyps": [input], "Refs": [label]}
    if input_length is not None:
        ins["HypsLength"] = [input_length]
    if label_length is not None:
        ins["RefsLength"] = [label_length]
    out = helper.create_variable_for_type_inference("float32")
    seq = helper.create_variable_for_type_inference("int32")
    helper.append_op("edit_distance", inputs=ins,
                     outputs={"Out": [out], "SequenceNum": [seq]},
                     attrs={"normalized": bool(normalized)})
    return out, seq


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """out[n, k] = x[n] W[k] y[n]^T + b[k] (W [size, Dx, Dy], Xavier),
    then `act`."""
    helper = LayerHelper("bilinear_tensor_product")
    w = helper.create_parameter(
        param_attr, [int(size), int(x.shape[-1]), int(y.shape[-1])],
        dtype=dtype_name(x.dtype), default_initializer=init_mod.Xavier())
    ins = {"X": [x], "Y": [y], "Weight": [w]}
    if bias_attr is not False:
        ins["Bias"] = [helper.create_parameter(
            bias_attr, [1, int(size)], dtype=dtype_name(x.dtype),
            is_bias=True)]
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("bilinear_tensor_product", inputs=ins,
                     outputs={"Out": [out]})
    return helper.append_activation(out, act)


def add_position_encoding(input, alpha, beta, name=None):
    """alpha * input + beta * the sinusoid position encoding."""
    helper = LayerHelper("add_position_encoding")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("add_position_encoding", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"alpha": float(alpha), "beta": float(beta)})
    return out


def fill_constant_like(x, value):
    """A `fill_constant` of x's static shape and dtype (layers.tensor's
    `fill_constant_like` is the `fill_any_like` op instead)."""
    from .tensor import fill_constant
    return fill_constant(shape=list(x.shape), dtype=dtype_name(x.dtype),
                         value=value)


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("pad", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"paddings": list(paddings),
                            "pad_value": pad_value})
    return out


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("pad2d", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"paddings": list(paddings), "mode": mode,
                            "pad_value": pad_value})
    return out


def image_resize(input, out_shape=None, scale=None, resample="BILINEAR",
                 name=None):
    helper = LayerHelper("interpolate")
    out = helper.create_variable_for_type_inference(input.dtype)
    attrs = {"interp_method": {"BILINEAR": "bilinear", "NEAREST": "nearest",
                               "BICUBIC": "bicubic"}[resample]}
    if out_shape is not None:
        attrs["out_h"], attrs["out_w"] = out_shape
    else:
        attrs["scale"] = scale
    helper.append_op("interpolate", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def resize_nearest(input, out_shape=None, scale=None, name=None):
    return image_resize(input, out_shape, scale, "NEAREST")


def resize_bilinear(input, out_shape=None, scale=None, name=None):
    return image_resize(input, out_shape, scale, "BILINEAR")


def unique(x, dtype="int64"):
    helper = LayerHelper("unique")
    out = helper.create_variable_for_type_inference(x.dtype)
    index = helper.create_variable_for_type_inference(dtype)
    helper.append_op("unique", inputs={"X": [x]},
                     outputs={"Out": [out], "Index": [index]})
    return out, index


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    helper = LayerHelper("cumsum")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("cumsum", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis, "exclusive": exclusive,
                            "reverse": reverse})
    return out
