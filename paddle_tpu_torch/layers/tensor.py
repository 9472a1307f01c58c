"""Tensor creation layer functions (counterpart of
paddle_tpu/layers/tensor.py): the subset the BERT program, the optimizer,
gradient clipping, the static LR schedules and gradient merge use, and
`increment` (the reference's layers/control_flow.py)."""
from __future__ import annotations

import numpy as np

from .. import initializer
from ..framework.dtype import dtype_name
from ..layer_helper import LayerHelper, ParamAttr

__all__ = ["assign", "create_global_var", "create_parameter",
           "fill_constant", "increment", "zeros_like"]


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    helper = LayerHelper("fill_constant")
    out = out or helper.create_variable_for_type_inference(dtype)
    helper.append_op("fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype_name(dtype),
                            "value": float(value)})
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
