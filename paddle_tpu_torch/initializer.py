"""Parameter initializers (counterpart of paddle_tpu/initializer.py). Each
appends ONE op to the startup program: `Constant` a `fill_constant`
(:37), `TruncatedNormal` a `truncated_gaussian_random` (:70). The others
(Uniform, Normal, MSRA, NumpyArrayInitializer) are not ported; `Xavier`,
the default of an unnamed weight, raises until `uniform_random` is."""
from __future__ import annotations

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


class TruncatedNormal(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block=None):
        b = block if block is not None else _startup_block(var)
        b.append_op("truncated_gaussian_random", outputs={"Out": [var.name]},
                    attrs={"shape": list(var.shape),
                           "dtype": dtype_name(var.dtype),
                           "mean": self.loc, "std": self.scale})


class Xavier(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        pass

    def __call__(self, var, block=None):
        raise NotImplementedError(
            f"Xavier initialisation (uniform_random / gaussian_random) is "
            f"not ported yet; give {var.name!r} a TruncatedNormal or "
            f"Constant initializer")

