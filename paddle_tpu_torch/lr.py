"""LRScheduler classes, `paddle.optimizer.lr` (counterpart of
paddle_tpu/lr.py; the 13 classes with the reference's formulas, as exact
Python floats).

A scheduler is a host object: `__call__` returns the current LR. In static
mode the optimizer binds it to a persistable float32 [1] LR variable
(`Optimizer._create_lr_var`), and every `step()` / `set_state_dict()`
writes the new LR INTO the scope's existing tensor (`fill_` on its device),
never by rebinding the name. A captured training step
(framework/executor.py `_CapturedStep`) reads that tensor by address, so
it stays valid and the next replay reads the new value: `run_steps(k)`
runs its k steps at the LR of the last `step()` before the call, as in the
reference.

The scopes written are the global scope and every scope an Executor has
run the scheduler's program in (`_attach_scope`, called by run() and
run_steps()), where that scope holds the LR tensor.
"""
from __future__ import annotations

import math
import weakref

import torch

__all__ = [
    "LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
    "InverseTimeDecay", "PolynomialDecay", "ExponentialDecay",
    "MultiStepDecay", "StepDecay", "LambdaDecay", "CosineAnnealingDecay",
    "LinearWarmup", "ReduceOnPlateau",
]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self._static_var_names = []   # static-mode LR vars bound to this
        self._scopes = weakref.WeakSet()
        self.step()                   # initialize last_lr at epoch 0

    def get_lr(self):
        raise NotImplementedError

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = int(epoch)
        self.last_lr = self.get_lr()
        if self.verbose:
            print(f"Epoch {self.last_epoch}: lr set to {self.last_lr}")
        self._sync_static()

    def _bind_static_var(self, name):
        self._static_var_names.append(name)
        self._sync_static()

    def _attach_scope(self, scope):
        """Executor hook: write the LR into `scope` now and on every later
        step()."""
        if scope not in self._scopes:
            self._scopes.add(scope)
            self._sync_scope(scope)

    def _sync_scope(self, scope):
        for name in self._static_var_names:
            t = scope.find(name)
            if isinstance(t, torch.Tensor):
                with torch.no_grad():
                    t.fill_(self.last_lr)   # in place: a capture stays valid

    def _sync_static(self):
        if not self._static_var_names:
            return
        from .framework.scope import global_scope
        scopes = {global_scope(), *self._scopes}
        for scope in scopes:
            self._sync_scope(scope)

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state["last_epoch"]
        self.last_lr = state["last_lr"]
        self._sync_static()

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return (self.base_lr * self.d_model ** -0.5
                * min(step ** -0.5, step * self.warmup_steps ** -1.5))


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1.0 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / steps) if step > 0 else 1
            steps = steps * div
        else:
            step = min(step, steps)
        return ((self.base_lr - self.end_lr)
                * (1 - step / steps) ** self.power + self.end_lr)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min)
                * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)


class LinearWarmup(LRScheduler):
    """Ramp start_lr→end_lr over warmup_steps, then delegate to the wrapped
    scheduler (or constant float)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_after = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        base = (learning_rate if isinstance(learning_rate, (int, float))
                else learning_rate.base_lr)
        super().__init__(base, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.start_lr + (self.end_lr - self.start_lr)
                    * self.last_epoch / self.warmup_steps)
        if isinstance(self.lr_after, LRScheduler):
            self.lr_after.last_epoch = self.last_epoch - self.warmup_steps
            return self.lr_after.get_lr()
        return float(self.lr_after)


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self._current = float(learning_rate)
        super().__init__(learning_rate, -1, verbose)

    def get_lr(self):
        return self._current

    def step(self, metrics=None, epoch=None):
        if metrics is None:           # init call from base __init__
            self.last_epoch += 1
            self.last_lr = self.get_lr()
            self._sync_static()
            return
        value = float(metrics)
        better = self._is_better(value)
        if better:
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        elif self.num_bad > self.patience:
            new = max(self._current * self.factor, self.min_lr)
            if self._current - new > self.epsilon:
                self._current = new
                if self.verbose:
                    print(f"ReduceOnPlateau: lr set to {new}")
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        self.last_epoch += 1
        self.last_lr = self._current
        self._sync_static()

    def _is_better(self, value):
        if self.best is None:
            return True
        if self.mode == "min":
            thr = (self.best * (1 - self.threshold)
                   if self.threshold_mode == "rel"
                   else self.best - self.threshold)
            return value < thr
        thr = (self.best * (1 + self.threshold)
               if self.threshold_mode == "rel" else self.best + self.threshold)
        return value > thr
