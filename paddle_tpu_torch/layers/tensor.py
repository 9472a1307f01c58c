"""Tensor creation layer functions (counterpart of
paddle_tpu/layers/tensor.py): the subset the BERT program, the optimizer
and gradient clipping use."""
from __future__ import annotations

from .. import initializer
from ..framework.dtype import dtype_name
from ..layer_helper import LayerHelper, ParamAttr

__all__ = ["create_global_var", "create_parameter", "fill_constant"]


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
