"""Static-graph learning-rate schedules (counterpart of
paddle_tpu/layers/learning_rate_scheduler.py).

Each function appends a few scalar ops computing the LR from a persistable
float32 [1] step counter, `@LR_DECAY_COUNTER@`, that an `increment` op at
the head of the schedule advances once per step. The ops carry the
`OpRole.LRSched` role and the program descs equal the reference's.

The counter is device state updated in place like the optimizer state, and
every op of a schedule makes its constants on the device, so a schedule
runs inside the captured step of `Executor.run_steps`: each replay
advances the counter and computes that step's LR, and the update rules read
it through the `LearningRate` input (B8 reads it through a pointer).
"""
from __future__ import annotations

import math

import numpy as np

from ..framework import unique_name
from ..framework.program import OpRole, default_main_program
from . import nn as nn_layers
from . import tensor as tensor_layers

__all__ = [
    "noam_decay", "exponential_decay", "natural_exp_decay",
    "inverse_time_decay", "polynomial_decay", "piecewise_decay",
    "cosine_decay", "linear_lr_warmup",
]

LR_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _mark_lr_sched(block, start_idx):
    for op in block.ops[start_idx:]:
        op.attrs["op_role"] = OpRole.LRSched


def _decay_step_counter(begin=0):
    """The step as a float32 [1] value: `begin` on the first run. One
    persistable counter per (program, begin): noam starts at 1, the rest
    at 0."""
    program = default_main_program()
    block = program.global_block()
    cache = getattr(program, "_lr_step_vars", None)
    if cache is None:
        cache = program._lr_step_vars = {}
    step = cache.get(begin)
    if step is not None:
        return step
    start = len(block.ops)
    counter = tensor_layers.create_global_var(
        [1], float(begin) - 1.0, "float32", persistable=True,
        name=unique_name.generate(LR_COUNTER_NAME))
    tensor_layers.increment(counter, value=1.0, in_place=True)
    step = nn_layers.scale(counter, scale=1.0)  # non-persistable snapshot
    _mark_lr_sched(block, start)
    cache[begin] = step
    return step


def _const(value):
    return tensor_layers.fill_constant([1], "float32", float(value))


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """lr * d^-0.5 * min(step^-0.5, step * warmup^-1.5)."""
    step = _decay_step_counter(begin=1)
    a = nn_layers.pow(step, factor=-0.5)
    b = step * float(warmup_steps ** -1.5)
    m = nn_layers.elementwise_min(a, b)
    return m * float(learning_rate * d_model ** -0.5)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _decay_step_counter()
    ratio = step / float(decay_steps)
    if staircase:
        ratio = nn_layers.floor(ratio)
    # rate^ratio = exp(ratio * ln rate)
    return nn_layers.exp(ratio * math.log(decay_rate)) * float(learning_rate)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _decay_step_counter()
    ratio = step / float(decay_steps)
    if staircase:
        ratio = nn_layers.floor(ratio)
    return nn_layers.exp(ratio * -float(decay_rate)) * float(learning_rate)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = _decay_step_counter()
    ratio = step / float(decay_steps)
    if staircase:
        ratio = nn_layers.floor(ratio)
    denom = ratio * float(decay_rate) + 1.0
    return _const(learning_rate) / denom


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _decay_step_counter()
    if cycle:
        div = nn_layers.ceil(step / float(decay_steps))
        one = _const(1.0)
        zero_step = nn_layers.equal(step, _const(0.0))
        div = nn_layers.where(zero_step, one, div)
        decay_steps_var = div * float(decay_steps)
        frac = step / decay_steps_var
    else:
        capped = nn_layers.elementwise_min(step, _const(float(decay_steps)))
        frac = capped / float(decay_steps)
    base = nn_layers.elementwise_pow(
        _const(1.0) - frac, _const(float(power)))
    return base * (float(learning_rate) - float(end_learning_rate)) \
        + float(end_learning_rate)


def piecewise_decay(boundaries, values):
    """values[i] while step < boundaries[i]: the index is the number of
    boundaries passed, one gather (no Switch)."""
    assert len(values) == len(boundaries) + 1
    step = _decay_step_counter()
    bvar = tensor_layers.assign(np.asarray(boundaries, np.float32))
    vvar = tensor_layers.assign(np.asarray(values, np.float32))
    passed = nn_layers.cast(
        nn_layers.greater_equal(
            nn_layers.expand(step, [len(boundaries)]), bvar), "int32")
    idx = nn_layers.reshape(nn_layers.reduce_sum(passed), [1])
    return nn_layers.gather(vvar, idx)


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _decay_step_counter()
    epoch = nn_layers.floor(step / float(step_each_epoch))
    cosv = nn_layers.cos(epoch * (math.pi / float(epochs)))
    return (cosv + 1.0) * (0.5 * float(learning_rate))


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """Linear ramp start_lr -> end_lr for warmup_steps, then
    `learning_rate` (a float or another schedule's Variable)."""
    step = _decay_step_counter()
    warm = _const(start_lr) + (
        step * (float(end_lr) - float(start_lr)) / float(warmup_steps))
    base = (learning_rate if not isinstance(learning_rate, (int, float))
            else _const(learning_rate))
    in_warmup = nn_layers.less_than(step, _const(float(warmup_steps)))
    return nn_layers.where(in_warmup, warm, base)
