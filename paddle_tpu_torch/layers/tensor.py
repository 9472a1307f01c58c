"""Tensor creation layer functions (counterpart of
paddle_tpu/layers/tensor.py): the subset the BERT program and the
optimizer use."""
from __future__ import annotations

from .. import initializer
from ..layer_helper import LayerHelper, ParamAttr

__all__ = ["create_global_var", "create_parameter"]


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
