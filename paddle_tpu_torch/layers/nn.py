"""Neural-net layer functions (counterpart of paddle_tpu/layers/nn.py): the
ones BERT is built from, and the ones gradient clipping and weight-decay
regularisation append."""
from __future__ import annotations

import math

from .. import initializer as init_mod
from ..framework.dtype import convert_dtype, dtype_name
from ..layer_helper import LayerHelper

__all__ = [
    "data", "fc", "layer_norm", "dropout", "embedding", "elementwise_add",
    "elementwise_mul", "elementwise_div", "elementwise_max", "sqrt",
    "square", "sign", "reduce_sum", "clip", "clip_by_norm", "sums",
    "mean", "scale", "reshape", "transpose", "split", "unsqueeze", "slice",
    "fused_attention",
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
    """lookup_table; is_sparse (SelectedRows grads) is not ported."""
    if is_sparse or is_distributed:
        raise NotImplementedError(
            "embedding(is_sparse / is_distributed) is not ported yet")
    helper = LayerHelper("embedding")
    w = helper.create_parameter(param_attr, list(size), dtype=dtype)
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


sqrt = _unary_layer("sqrt")
square = _unary_layer("square")
sign = _unary_layer("sign")


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
elementwise_mul = _binary_layer("elementwise_mul")
elementwise_div = _binary_layer("elementwise_div")
elementwise_max = _binary_layer("elementwise_max")


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper("reduce_sum")
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is None:
        attrs = {"reduce_all": True, "dim": [0], "keep_dim": keep_dim}
    else:
        attrs = {"dim": dim if isinstance(dim, (list, tuple)) else [dim],
                 "keep_dim": keep_dim, "reduce_all": False}
    helper.append_op("reduce_sum", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
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
    helper = LayerHelper("transpose2")
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("transpose2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": list(perm)})
    return out


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
    helper = LayerHelper("unsqueeze2")
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("unsqueeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes)})
    return out


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
