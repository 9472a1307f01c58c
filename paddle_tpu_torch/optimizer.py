"""Optimizers: emit backward + update ops into the program (counterpart of
paddle_tpu/optimizer.py: `Optimizer.minimize` :160, `SGDOptimizer` :202,
`MomentumOptimizer` :217, `AdamOptimizer` :270, `AdamW` :353).

`minimize` = append_backward, then `apply_gradients`: the grad clip's ops
(clip.py), each parameter's weight-decay term (regularizer.py, from the
parameter's own regularizer or the optimizer's `regularization` /
`weight_decay`), and one update op per parameter. Adam keeps the
reference's ONE shared beta-pow pair, advanced once per step by a `scale`
op after every update has read it (`_finalize_optimize_ops`).
Not ported yet (ROADMAP): LR schedulers and LR variables, and the
optimizers other than SGD, Momentum, Adam and AdamW.
"""
from __future__ import annotations

from typing import Dict

from . import layers
from .framework import unique_name
from .framework.backward import append_backward
from .framework.dtype import dtype_name
from .framework.program import OpRole, Variable, default_main_program
from .layer_helper import LayerHelper

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum",
           "MomentumOptimizer", "Adam", "AdamOptimizer", "AdamW"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameter_list=None,
                 regularization=None, grad_clip=None, name=None,
                 parameters=None, weight_decay=None):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "only a constant float learning rate is ported; LR "
                "schedulers and LR variables are not yet (ROADMAP)")
        if regularization is None and weight_decay:
            from .regularizer import L2Decay
            regularization = (weight_decay if not isinstance(
                weight_decay, (int, float)) else L2Decay(weight_decay))
        self.regularization = regularization
        self._grad_clip = grad_clip
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
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        params_grads = self._append_regularization(params_grads)
        self._create_accumulators(block, [p for p, _ in params_grads])
        self._create_lr_var()
        for pg in params_grads:
            op = self._append_optimize_op(block, pg)
            if op is not None:
                op.attrs["op_role"] = OpRole.Optimize
        for op in self._finalize_optimize_ops(block):
            op.attrs["op_role"] = OpRole.Optimize
        return []

    def _append_regularization(self, params_grads):
        out = []
        for p, g in params_grads:
            reg = getattr(p, "regularizer", None) or self.regularization
            if reg is not None:
                g = reg._append(p, g)
            out.append((p, g))
        return out

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        self.apply_gradients(params_grads)
        return [], params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "sgd"

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            "sgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p]},
            attrs={"op_role": OpRole.Optimize})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, use_nesterov=False,
                 **kw):
        super().__init__(learning_rate, **kw)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov,
                   "op_role": OpRole.Optimize})


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
                   "epsilon": self._epsilon, "op_role": OpRole.Optimize,
                   **self._extra_attrs()})

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

    def _extra_attrs(self):
        return {}


class AdamW(AdamOptimizer):
    """Adam with decoupled weight decay: the `adamw` rule subtracts
    lr * coeff * param after the Adam step."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self.type = "adamw"
        self._coeff = weight_decay

    def _extra_attrs(self):
        return {"coeff": self._coeff, "with_decay": True}


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
