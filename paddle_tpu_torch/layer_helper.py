"""LayerHelper: shared machinery for the `layers` functions (counterpart of
paddle_tpu/layer_helper.py): creates parameters (with their init ops in
the startup program) and temporaries, and appends ops to the current main
program. The dygraph route is not ported."""
from __future__ import annotations

from . import initializer as init_mod
from .framework import unique_name
from .framework.dtype import convert_dtype
from .framework.program import default_main_program, default_startup_program


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=False,
                 need_clip=True):
        if regularizer is not None:
            raise NotImplementedError(
                "ParamAttr(regularizer=...) is not ported yet (ROADMAP)")
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        if isinstance(attr, init_mod.Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"bad param attr: {attr!r}")


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.layer_type = layer_type
        self.kwargs = kwargs

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    def create_parameter(self, attr, shape, dtype="float32", is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        name = attr.name or unique_name.generate(
            f"{self.layer_type}_w" if not is_bias else f"{self.layer_type}_b")
        if default_initializer is None:
            default_initializer = (init_mod.Constant(0.0) if is_bias
                                   else init_mod.Xavier())
        initializer = attr.initializer or default_initializer
        block = self.main_program.current_block()
        p = block.create_parameter(name=name, shape=shape, dtype=dtype,
                                   trainable=attr.trainable,
                                   regularizer=attr.regularizer)
        p.optimize_attrs["learning_rate"] = attr.learning_rate
        initializer(p)  # appends the init op to the startup program
        return p

    def create_variable_for_type_inference(self, dtype="float32", name=None):
        block = self.main_program.current_block()
        return block.create_var(
            name=name or unique_name.generate(f"{self.layer_type}_tmp"),
            shape=(), dtype=convert_dtype(dtype), stop_gradient=False)

    def create_global_variable(self, shape, dtype, persistable=True,
                               name=None, stop_gradient=True):
        block = self.main_program.global_block()
        return block.create_var(
            name=name or unique_name.generate(f"{self.layer_type}_gvar"),
            shape=shape, dtype=convert_dtype(dtype), persistable=persistable,
            stop_gradient=stop_gradient)

    def append_activation(self, out, act):
        if act is None:
            return out
        tmp = self.create_variable_for_type_inference(out.dtype)
        self.append_op(act, inputs={"X": [out]}, outputs={"Out": [tmp]})
        return tmp
