"""Parameter initializers (counterpart of paddle_tpu/initializer.py). Each
appends ONE op to the startup program: `Constant` a `fill_constant`,
`Uniform` a `uniform_random`, `Normal` a `gaussian_random`,
`TruncatedNormal` a `truncated_gaussian_random`, `Xavier` and `MSRA` one
of the first two with the bounds their fans give (`_fans`), and
`NumpyArrayInitializer` an `assign_value`. The random ops draw from the
op's device key (ops/tensor_ops.py), so their values differ from the
reference's jax.random draws; the descs are equal."""
from __future__ import annotations

import math

import numpy as np

from .framework.dtype import dtype_name
from .framework.program import default_startup_program


class Initializer:
    def __call__(self, var, block=None):
        raise NotImplementedError


def _startup_block(var):
    b = default_startup_program().global_block()
    if var.name not in b.vars:
        b.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                     persistable=True)
    return b


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block=None):
        b = block if block is not None else _startup_block(var)
        b.append_op("fill_constant", outputs={"Out": [var.name]},
                    attrs={"shape": list(var.shape),
                           "dtype": dtype_name(var.dtype),
                           "value": float(self.value)})


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block=None):
        _uniform(var, block, self.low, self.high)


class Normal(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block=None):
        _normal(var, block, self.loc, self.scale)


def _uniform(var, block, low, high):
    b = block if block is not None else _startup_block(var)
    b.append_op("uniform_random", outputs={"Out": [var.name]},
                attrs={"shape": list(var.shape),
                       "dtype": dtype_name(var.dtype),
                       "min": low, "max": high})


def _normal(var, block, mean, std):
    b = block if block is not None else _startup_block(var)
    b.append_op("gaussian_random", outputs={"Out": [var.name]},
                attrs={"shape": list(var.shape),
                       "dtype": dtype_name(var.dtype),
                       "mean": mean, "std": std})


class TruncatedNormal(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block=None):
        b = block if block is not None else _startup_block(var)
        b.append_op("truncated_gaussian_random", outputs={"Out": [var.name]},
                    attrs={"shape": list(var.shape),
                           "dtype": dtype_name(var.dtype),
                           "mean": self.loc, "std": self.scale})


def _fans(var):
    """(fan_in, fan_out): a matrix's rows and columns; a filter's
    in / out channels times its receptive field; else the element count
    for both."""
    shape = var.shape
    if len(shape) == 2:
        return shape[0], shape[1]
    if len(shape) >= 3:
        rf = int(np.prod(shape[2:]))
        return shape[1] * rf, shape[0] * rf
    n = int(np.prod(shape))
    return n, n


class Xavier(Initializer):
    """Glorot: U(-sqrt(6 / (fi + fo)), +) or N(0, sqrt(2 / (fi + fo)))."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out = uniform, fan_in, fan_out

    def __call__(self, var, block=None):
        fi, fo = _fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            _uniform(var, block, -limit, limit)
        else:
            _normal(var, block, 0.0, math.sqrt(2.0 / (fi + fo)))


class MSRA(Initializer):
    """Kaiming: U(-sqrt(6 / fi), +) or N(0, sqrt(2 / fi))."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in = uniform, fan_in

    def __call__(self, var, block=None):
        fi = self.fan_in if self.fan_in is not None else _fans(var)[0]
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            _uniform(var, block, -limit, limit)
        else:
            _normal(var, block, 0.0, math.sqrt(2.0 / fi))


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block=None):
        b = block if block is not None else _startup_block(var)
        b.append_op("assign_value", outputs={"Out": [var.name]},
                    attrs={"shape": list(self.value.shape),
                           "dtype": dtype_name(var.dtype),
                           "values": self.value.reshape(-1).tolist()})


# paddle.nn.initializer-style aliases
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
XavierInitializer = Xavier
MSRAInitializer = MSRA
KaimingUniform = MSRA
