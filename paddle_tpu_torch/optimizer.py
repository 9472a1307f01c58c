"""Optimizers: emit backward + update ops into the program (counterpart of
paddle_tpu/optimizer.py: `Optimizer` :40 with its LR plumbing :61-95,
`SGDOptimizer` :202, `MomentumOptimizer` :217, `LarsMomentumOptimizer`
:241, `AdamOptimizer` :270, `AdamW` :353, `AdagradOptimizer` :364,
`AdamaxOptimizer` :385, `RMSPropOptimizer` :415, `LambOptimizer` :447,
`ExponentialMovingAverage` :460, `AdadeltaOptimizer` :520,
`DecayedAdagradOptimizer` :547, `FtrlOptimizer` :569,
`DGCMomentumOptimizer` :615).

`minimize` = append_backward, then `apply_gradients`: the grad clip's ops
(clip.py), each parameter's weight-decay term (regularizer.py, from the
parameter's own regularizer, `ParamAttr(regularizer=)`, or the
optimizer's `regularization` / `weight_decay`), and one update op per
parameter (ops/optimizer_ops.py). Adam, AdamW and Lamb keep the
reference's ONE shared beta-pow pair, advanced once per step by a `scale`
op after every update has read it (`_finalize_optimize_ops`).

The learning rate (`_create_lr_var`) is a float (a persistable [1]
variable), an `lr.LRScheduler` (the same variable, bound to the scheduler,
which writes each new LR into it in place), a `Variable` (a static
schedule's output, layers/learning_rate_scheduler.py) or a callable that
builds one. `set_lr` writes in place too, so none of them invalidates a
captured step.

The wrappers (reference :746-790): `PipelineOptimizer` marks the program
with its microbatch count, which the executor runs as GPipe on one device
or, over a mesh with pp > 1, as the 1F1B pipeline
(framework/executor.py, parallel/pipeline.py); `RecomputeOptimizer` and
`GradientMergeOptimizer` are parallel/transforms.py's wrappers.

`DGCMomentumOptimizer` is Deep Gradient Compression's update in one
process (fleet's `dgc` flag is a no-op, as the reference's): per
parameter an optional `dgc_clip_by_norm`, `dgc` (the momentum-corrected
residuals U and V, and the sparsified gradient it emits) and
`dgc_momentum` (momentum before `rampup_begin_step`, SGD on the
sparsified gradient from it on), with one persistable step counter that
an `increment` after the updates advances (ops/tail_ops.py).

Not ported (ROADMAP item 18): Dpsgd, Lookahead and ModelAverage.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import layers
from .framework import unique_name
from .framework.backward import append_backward
from .framework.dtype import dtype_name
from .framework.program import OpRole, Variable, default_main_program
from .layer_helper import LayerHelper

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum",
           "MomentumOptimizer", "Adam", "AdamOptimizer", "AdamW",
           "Adagrad", "AdagradOptimizer", "Adamax", "AdamaxOptimizer",
           "RMSProp", "RMSPropOptimizer", "Lamb", "LambOptimizer",
           "LarsMomentum", "LarsMomentumOptimizer", "Adadelta",
           "AdadeltaOptimizer", "DecayedAdagrad", "DecayedAdagradOptimizer",
           "Ftrl", "FtrlOptimizer", "DGCMomentumOptimizer",
           "ExponentialMovingAverage",
           "PipelineOptimizer", "RecomputeOptimizer",
           "GradientMergeOptimizer"]


def _write_in_place(scope, name, value):
    """`value` into the scope's tensor `name`, on its device, keeping its
    address. Returns False (and binds nothing) when the scope holds no
    tensor under that name."""
    t = scope.find(name)
    if not isinstance(t, torch.Tensor):
        return False
    with torch.no_grad():
        if isinstance(value, (int, float)):
            t.fill_(value)
        else:
            t.copy_(torch.as_tensor(np.asarray(value)).reshape(t.shape))
    return True


class Optimizer:
    def __init__(self, learning_rate=0.001, parameter_list=None,
                 regularization=None, grad_clip=None, name=None,
                 parameters=None, weight_decay=None):
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

    # -- learning rate ------------------------------------------------------
    def _create_lr_var(self):
        if self._lr_var is not None:
            return self._lr_var
        from .lr import LRScheduler
        lr = self._learning_rate
        if isinstance(lr, Variable):
            self._lr_var = lr
        elif isinstance(lr, LRScheduler):
            name = unique_name.generate("learning_rate")
            self._lr_var = layers.create_global_var(
                [1], float(lr()), "float32", persistable=True, name=name)
            lr._bind_static_var(name)
            # the executor attaches every scope it runs this program in
            prog = self._lr_var.block.program
            prog._lr_schedulers = list(getattr(prog, "_lr_schedulers", ()))
            if lr not in prog._lr_schedulers:
                prog._lr_schedulers.append(lr)
        elif callable(lr):
            self._lr_var = lr()
        else:
            self._lr_var = layers.create_global_var(
                [1], float(lr), "float32", persistable=True,
                name=unique_name.generate("learning_rate"))
        return self._lr_var

    @property
    def learning_rate_var(self):
        return self._create_lr_var()

    def set_lr(self, value, scope=None):
        """Write `value` into the LR variable of `scope` (the global scope
        by default), in place."""
        from .framework.scope import global_scope
        self._create_lr_var()
        _write_in_place(scope or global_scope(), self._lr_var.name,
                        float(value))

    def state_dict(self, scope=None):
        """The accumulators' values (host arrays) held in `scope`, and the
        LR scheduler's state under "LR_Scheduler"."""
        from .framework.scope import global_scope, to_numpy
        from .lr import LRScheduler
        scope = scope or global_scope()
        sd = {}
        for accs in self._accumulators.values():
            for v in accs.values():
                val = scope.find(v.name)
                if val is not None:
                    sd[v.name] = to_numpy(val)
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, sd, scope=None):
        """Inverse of `state_dict`: each accumulator is written into the
        scope's tensor in place (a missing tensor raises), and the
        scheduler's state restored, which rewrites the LR variable."""
        from .framework import errors
        from .framework.scope import global_scope
        from .lr import LRScheduler
        scope = scope or global_scope()
        for key, val in sd.items():
            if key == "LR_Scheduler":
                if isinstance(self._learning_rate, LRScheduler):
                    self._learning_rate.set_state_dict(val)
                continue
            if not _write_in_place(scope, key, val):
                raise errors.NotFound(
                    "optimizer state %r has no tensor in the scope: run the "
                    "startup program first", key, var=key)

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
            # a SelectedRows gradient skips regularization, as in the
            # reference (:153-155)
            if reg is not None and not getattr(g, "_is_selected_rows",
                                               False):
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


class LarsMomentumOptimizer(Optimizer):
    """Layer-wise trust-ratio momentum. Per-parameter ops also under ZeRO
    (the rule reads whole-parameter norms)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, epsilon=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "lars_momentum"
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "lars_momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay,
                   "epsilon": self._epsilon, "op_role": OpRole.Optimize})


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


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "adagrad"
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs={"epsilon": self._epsilon, "op_role": OpRole.Optimize})


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "adamax"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            "adamax",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._lr_var],
                    "Moment": [self._get_accumulator("moment", p)],
                    "InfNorm": [self._get_accumulator("inf_norm", p)],
                    "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)]},
            outputs={"ParamOut": [p],
                     "MomentOut": [self._get_accumulator("moment", p)],
                     "InfNormOut": [self._get_accumulator("inf_norm", p)]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "op_role": OpRole.Optimize})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "rmsprop"
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)
            self._add_accumulator("momentum", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        acc = self._get_accumulator
        return block.append_op(
            "rmsprop",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._lr_var],
                    "MeanSquare": [acc("mean_square", p)],
                    "MeanGrad": [acc("mean_grad", p)],
                    "Moment": [acc("momentum", p)]},
            outputs={"ParamOut": [p],
                     "MeanSquareOut": [acc("mean_square", p)],
                     "MeanGradOut": [acc("mean_grad", p)],
                     "MomentOut": [acc("momentum", p)]},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered,
                   "op_role": OpRole.Optimize})


class LambOptimizer(AdamOptimizer):
    """Adam scaled by the layer-wise trust ratio. Per-parameter ops also
    under ZeRO (the rule reads whole-parameter norms)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self.type = "lamb"
        self._weight_decay = lamb_weight_decay

    def _extra_attrs(self):
        return {"weight_decay": self._weight_decay}


class ExponentialMovingAverage:
    """Shadow EMA parameters: `update()` appends, per trainable parameter,
    shadow = decay * shadow + (1 - decay) * param (two `scale` ops and a
    `sum`) to the main program, so the EMA advances inside the training
    step. The shadows start at 0, as in the reference.

    `apply()` puts the shadow values into the parameters and `restore()`
    puts the trained values back. Both copy into the scope's tensors in
    place (the reference swaps the arrays), so a captured step stays
    valid across them."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or "ema"
        self._shadows = {}
        self._backups = {}

    def update(self):
        program = default_main_program()
        block = program.global_block()
        for p in program.all_parameters():
            if not p.trainable:
                continue
            shadow = self._shadows.get(p.name)
            if shadow is None:
                shadow = layers.create_global_var(
                    list(p.shape), 0.0, dtype_name(p.dtype), persistable=True,
                    name=unique_name.generate(f"{p.name}_{self._name}"))
                self._shadows[p.name] = shadow
            scaled = layers.scale(shadow, scale=self._decay)
            contrib = layers.scale(p, scale=1.0 - self._decay)
            layers.sums([scaled, contrib], out=shadow)
            for op in block.ops[-3:]:
                op.attrs["op_role"] = OpRole.Optimize

    def apply(self, executor=None, need_restore=True, scope=None):
        from .framework.scope import global_scope
        scope = scope or global_scope()
        with torch.no_grad():
            for pname, shadow in self._shadows.items():
                p = scope.find(pname)
                self._backups[pname] = p.clone()
                p.copy_(scope.find(shadow.name))

    def restore(self, executor=None, scope=None):
        from .framework.scope import global_scope
        scope = scope or global_scope()
        with torch.no_grad():
            for pname, val in self._backups.items():
                scope.find(pname).copy_(val)
        self._backups.clear()


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate=1.0, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "adadelta"
        self._rho, self._epsilon = rho, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        asg = self._get_accumulator("avg_squared_grad", p)
        asu = self._get_accumulator("avg_squared_update", p)
        return block.append_op(
            "adadelta",
            inputs={"Param": [p], "Grad": [g], "AvgSquaredGrad": [asg],
                    "AvgSquaredUpdate": [asu]},
            outputs={"ParamOut": [p], "AvgSquaredGradOut": [asg],
                     "AvgSquaredUpdateOut": [asu]},
            attrs={"rho": self._rho, "epsilon": self._epsilon,
                   "op_role": OpRole.Optimize})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "decayed_adagrad"
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs={"decay": self._decay, "epsilon": self._epsilon,
                   "op_role": OpRole.Optimize})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "ftrl"
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        acc = self._get_accumulator
        return block.append_op(
            "ftrl",
            inputs={"Param": [p], "Grad": [g],
                    "SquaredAccumulator": [acc("squared", p)],
                    "LinearAccumulator": [acc("linear", p)],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p],
                     "SquaredAccumOut": [acc("squared", p)],
                     "LinearAccumOut": [acc("linear", p)]},
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power,
                   "op_role": OpRole.Optimize})


class DGCMomentumOptimizer(MomentumOptimizer):
    """Deep Gradient Compression's momentum (Lin et al., ICLR 2018; the
    reference's optimizer.py:615): per-parameter accumulators `velocity`,
    `dgc_u` and `dgc_v`, the sparsity ramp `sparsity` over `rampup_step`
    steps from `rampup_begin_step`, an optional local clip, and the step
    counter `dgc_counter` (persistable [1] f32)."""

    def __init__(self, learning_rate, momentum, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 local_grad_clip_norm=None, num_trainers=None, **kw):
        super().__init__(learning_rate, momentum, use_nesterov, **kw)
        self.type = "dgc_momentum"
        self._rampup_begin_step = float(rampup_begin_step)
        self._rampup_step = float(rampup_step)
        self._sparsity = [float(s) for s in sparsity]
        self._local_grad_clip_norm = local_grad_clip_norm
        self._counter_var = None

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)
            self._add_accumulator("dgc_u", p)
            self._add_accumulator("dgc_v", p)
        if self._counter_var is None:
            self._counter_var = layers.create_global_var(
                [1], 0.0, "float32", persistable=True,
                name=unique_name.generate("dgc_counter"))

    def _append_optimize_op(self, block, pg):
        p, g = pg
        u = self._get_accumulator("dgc_u", p)
        v = self._get_accumulator("dgc_v", p)
        vel = self._get_accumulator("velocity", p)
        step = self._counter_var
        if self._local_grad_clip_norm is not None:
            clipped = block.create_var(
                name=unique_name.generate(f"{p.name}_dgc_clip"),
                shape=p.shape, dtype=p.dtype)
            block.append_op(
                "dgc_clip_by_norm",
                inputs={"X": [g], "current_step": [step]},
                outputs={"Out": [clipped]},
                attrs={"max_norm": float(self._local_grad_clip_norm),
                       "rampup_begin_step": self._rampup_begin_step,
                       "op_role": OpRole.Optimize})
            g = clipped
        encoded = block.create_var(
            name=unique_name.generate(f"{p.name}_dgc_encoded"),
            shape=p.shape, dtype=p.dtype)
        block.append_op(
            "dgc",
            inputs={"U": [u], "V": [v], "Grad": [g], "current_step": [step]},
            outputs={"UOut": [u], "VOut": [v], "EncodeGrad": [encoded]},
            attrs={"m": self._momentum,
                   "rampup_begin_step": self._rampup_begin_step,
                   "rampup_step": self._rampup_step,
                   "sparsity": self._sparsity,
                   "op_role": OpRole.Optimize})
        return block.append_op(
            "dgc_momentum",
            inputs={"Param": [p], "Grad": [encoded], "Velocity": [vel],
                    "LearningRate": [self._lr_var], "current_step": [step]},
            outputs={"ParamOut": [p], "VelocityOut": [vel]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov,
                   "rampup_begin_step": self._rampup_begin_step,
                   "op_role": OpRole.Optimize})

    def apply_gradients(self, params_grads):
        out = super().apply_gradients(params_grads)
        block = default_main_program().global_block()
        block.append_op("increment",
                        inputs={"X": [self._counter_var]},
                        outputs={"Out": [self._counter_var]},
                        attrs={"step": 1.0, "op_role": OpRole.Optimize})
        return out


class PipelineOptimizer:
    """GPipe microbatching (reference optimizer.py:746): minimize marks the
    program with the microbatch count. The executor then runs the LR
    schedule ops once a step, the forward and backward ops over
    `num_microbatches` slices of every feed with the gradients summed, and
    the optimizer ops once on their mean; over a mesh with pp > 1 the
    `device_guard` stages run as a 1F1B pipeline (parallel/pipeline.py)."""

    def __init__(self, optimizer, num_microbatches=1, start_cpu_core_id=0):
        self.inner_optimizer = optimizer
        self.num_microbatches = int(num_microbatches)

    def __getattr__(self, item):
        return getattr(self.inner_optimizer, item)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        res = self.inner_optimizer.minimize(loss, startup_program,
                                            parameter_list, no_grad_set)
        program = loss.block.program
        program._microbatch_k = self.num_microbatches
        program.bump_version()
        return res


def RecomputeOptimizer(inner_optimizer, checkpoints=None):
    """Activation checkpointing (reference optimizer.py:772):
    parallel/transforms.py `apply_recompute` before the backward."""
    from .parallel.transforms import RecomputeWrapper
    return RecomputeWrapper(inner_optimizer, checkpoints or [])


def GradientMergeOptimizer(inner_optimizer, k_steps=1, avg=True):
    """Gradient accumulation over `k_steps` steps (reference
    optimizer.py:779)."""
    from .parallel.transforms import GradientMergeWrapper
    return GradientMergeWrapper(inner_optimizer, k_steps, avg=avg)


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
Adagrad = AdagradOptimizer
Adamax = AdamaxOptimizer
RMSProp = RMSPropOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
Adadelta = AdadeltaOptimizer
Ftrl = FtrlOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
