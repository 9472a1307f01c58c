"""Tensor creation layer functions (counterpart of
paddle_tpu/layers/tensor.py), and `increment` (the reference's
layers/control_flow.py, which re-exports it here too). `linspace` and
`range` fold to an `assign_value` of their numpy values, as the
reference's do."""
from __future__ import annotations

import numpy as np

from .. import initializer
from ..framework.dtype import convert_dtype, dtype_name
from ..layer_helper import LayerHelper, ParamAttr

__all__ = [
    "fill_constant", "fill_constant_batch_size_like", "fill_constant_like",
    "full_like", "zeros", "ones", "zeros_like", "ones_like", "assign",
    "create_tensor", "create_global_var", "create_parameter", "linspace",
    "eye", "diag", "range", "shape", "uniform_random", "gaussian_random",
    "tril", "triu", "increment",
]


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    helper = LayerHelper("fill_constant")
    out = out or helper.create_variable_for_type_inference(dtype)
    helper.append_op("fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype_name(dtype),
                            "value": float(value)})
    # a build-time constant: array_write sizes its buffer by it
    out._const_value = float(value)
    return out


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    helper = LayerHelper("global_var")
    var = helper.create_global_variable(shape, dtype, persistable=persistable,
                                        name=name)
    initializer.Constant(value)(var)
    return var


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter")
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def zeros_like(x, out=None):
    helper = LayerHelper("fill_zeros_like")
    out = out or helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def assign(input, output=None):
    """Copy a variable (`assign`) or a host array (`assign_value`)."""
    helper = LayerHelper("assign")
    if isinstance(input, np.ndarray):
        output = output or helper.create_variable_for_type_inference(
            str(input.dtype))
        helper.append_op("assign_value", outputs={"Out": [output]},
                         attrs={"shape": list(input.shape),
                                "dtype": str(input.dtype),
                                "values": input.reshape(-1).tolist()})
        return output
    output = output or helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("assign", inputs={"X": [input]},
                     outputs={"Out": [output]})
    return output


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("increment", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"step": value})
    return out


def fill_constant_like(x, value, dtype=None, name=None):
    """The `fill_any_like` op: x's runtime shape."""
    helper = LayerHelper("fill_constant_like")
    out = helper.create_variable_for_type_inference(dtype or x.dtype)
    attrs = {"value": float(value)}
    if dtype is not None:
        attrs["dtype"] = dtype_name(convert_dtype(dtype))
    helper.append_op("fill_any_like", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def full_like(x, fill_value, dtype=None, name=None):
    return fill_constant_like(x, fill_value, dtype, name)


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("fill_constant_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": dtype_name(convert_dtype(dtype)),
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out


def zeros(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def ones_like(x, out=None):
    return fill_constant(list(x.shape), dtype_name(x.dtype), 1.0, out=out)


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor")
    return helper.main_program.current_block().create_var(
        name=name, shape=(), dtype=convert_dtype(dtype),
        persistable=persistable)


def _constant_values(op_type, vals, dtype):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("assign_value", outputs={"Out": [out]},
                     attrs={"shape": [len(vals)],
                            "dtype": dtype_name(convert_dtype(dtype)),
                            "values": vals.tolist()})
    return out


def linspace(start, stop, num, dtype="float32"):
    return _constant_values("linspace", np.linspace(start, stop, num).astype(
        dtype_name(convert_dtype(dtype))), dtype)


def range(start, end, step, dtype="float32"):
    return _constant_values("range", np.arange(start, end, step).astype(
        dtype_name(convert_dtype(dtype))), dtype)


def eye(num_rows, num_columns=None, batch_shape=None, dtype="float32"):
    helper = LayerHelper("eye")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("eye", outputs={"Out": [out]},
                     attrs={"num_rows": num_rows,
                            "num_columns": num_columns or num_rows,
                            "dtype": dtype_name(convert_dtype(dtype))})
    return out


def diag(diagonal):
    if isinstance(diagonal, np.ndarray):
        return assign(np.diag(diagonal))
    raise NotImplementedError("diag of a Variable is not supported in a "
                              "static program")


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference("int32")
    helper.append_op("shape", inputs={"Input": [input]},
                     outputs={"Out": [out]})
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("uniform_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": dtype_name(convert_dtype(dtype)),
                            "min": min, "max": max})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("gaussian_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": dtype_name(convert_dtype(dtype)),
                            "mean": mean, "std": std})
    return out


def _tril_triu(x, diagonal, lower):
    helper = LayerHelper("tril_triu")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("tril_triu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"diagonal": diagonal, "lower": lower})
    return out


def tril(x, diagonal=0):
    return _tril_triu(x, diagonal, True)


def triu(x, diagonal=0):
    return _tril_triu(x, diagonal, False)
