"""Optimizers: emit backward + update ops into the program (counterpart of
paddle_tpu/optimizer.py: `Optimizer.minimize` :160, `AdamOptimizer` :270).

`minimize` = append_backward + one update op per parameter. Adam keeps
the reference's ONE shared beta-pow pair, advanced once per step by a
`scale` op after every update has read it (`_finalize_optimize_ops`).
Not ported yet (ROADMAP): LR schedulers and LR variables, grad clip,
regularization, and the other optimizers.
"""
from __future__ import annotations

from typing import Dict

from . import layers
from .framework import unique_name
from .framework.backward import append_backward
from .framework.dtype import dtype_name
from .framework.program import OpRole, Variable, default_main_program
from .layer_helper import LayerHelper

__all__ = ["Optimizer", "Adam", "AdamOptimizer"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameter_list=None,
                 regularization=None, grad_clip=None, name=None,
                 parameters=None, weight_decay=None):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "only a constant float learning rate is ported; LR "
                "schedulers and LR variables are not yet (ROADMAP)")
        if regularization is not None or weight_decay or grad_clip is not None:
            raise NotImplementedError(
                "regularization / weight_decay / grad_clip are not ported "
                "yet (ROADMAP)")
        self._learning_rate = learning_rate
        self._parameter_list = (parameter_list if parameter_list is not None
                                else parameters)
        self._name = name or unique_name.generate(type(self).__name__)
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._lr_var = None
        self.helper = LayerHelper(type(self).__name__)
        self.type = "sgd"

    def _create_lr_var(self):
        if self._lr_var is None:
            self._lr_var = layers.create_global_var(
                [1], float(self._learning_rate), "float32", persistable=True,
                name=unique_name.generate("learning_rate"))
        return self._lr_var

    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        if param.name in self._accumulators.get(name, {}):
            return self._accumulators[name][param.name]
        var = layers.create_global_var(
            shape or list(param.shape), fill_value,
            dtype or dtype_name(param.dtype), persistable=True,
            name=unique_name.generate(f"{param.name}_{name}"))
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _create_accumulators(self, block, parameters):
        pass

    def _finalize_optimize_ops(self, block):
        """Ops appended once after the per-parameter updates."""
        return []

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return append_backward(loss, parameter_list or self._parameter_list,
                               no_grad_set)

    def apply_gradients(self, params_grads):
        block = default_main_program().global_block()
        self._create_accumulators(block, [p for p, _ in params_grads])
        self._create_lr_var()
        for pg in params_grads:
            op = self._append_optimize_op(block, pg)
            if op is not None:
                op.attrs["op_role"] = OpRole.Optimize
        for op in self._finalize_optimize_ops(block):
            op.attrs["op_role"] = OpRole.Optimize
        return []

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        self.apply_gradients(params_grads)
        return [], params_grads


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "adam"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _shared_pow_accumulator(self, idx, beta):
        """The beta-pow accumulators are shared by all parameters: each
        per-param pow would hold the same beta^t."""
        accs = self._accumulators.setdefault(f"beta{idx}_pow_acc", {})
        if "@SHARED@" not in accs:
            accs["@SHARED@"] = layers.create_global_var(
                [1], beta, "float32", persistable=True,
                name=unique_name.generate(f"{self.type}_beta{idx}_pow_acc"))
        return accs["@SHARED@"]

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
        for idx, beta in ((1, self._beta1), (2, self._beta2)):
            self._shared_pow_accumulator(idx, beta)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            self.type,
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._lr_var],
                    "Moment1": [self._get_accumulator("moment1", p)],
                    "Moment2": [self._get_accumulator("moment2", p)],
                    "Beta1Pow": [self._shared_pow_accumulator(1, self._beta1)],
                    "Beta2Pow": [self._shared_pow_accumulator(2, self._beta2)]},
            outputs={"ParamOut": [p],
                     "Moment1Out": [self._get_accumulator("moment1", p)],
                     "Moment2Out": [self._get_accumulator("moment2", p)]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "op_role": OpRole.Optimize})

    def _finalize_optimize_ops(self, block):
        ops = []
        for idx, beta in ((1, self._beta1), (2, self._beta2)):
            pow_var = self._shared_pow_accumulator(idx, beta)
            if any(op.attrs.get("__adam_pow_advance__") == pow_var.name
                   for op in block.ops):
                continue   # a second apply_gradients must not advance twice
            ops.append(block.append_op(
                "scale", inputs={"X": [pow_var]}, outputs={"Out": [pow_var]},
                attrs={"scale": beta, "op_role": OpRole.Optimize,
                       "__adam_pow_advance__": pow_var.name}))
        return ops


Adam = AdamOptimizer
