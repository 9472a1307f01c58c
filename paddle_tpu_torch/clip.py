"""Gradient clipping (counterpart of paddle_tpu/clip.py).

`Optimizer.apply_gradients` calls the clip on [(param, grad)] before the
update ops; the clip appends its ops to the program and returns the
clipped gradients, which make their ZeRO buckets `pre_synced`
(parallel/zero.py). The port has no SelectedRows gradients, so every
gradient is clipped."""
from __future__ import annotations

from . import layers

__all__ = ["GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


class GradientClipBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class GradientClipByValue(GradientClipBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        return [(p, layers.clip(g, self.min, self.max))
                for p, g in params_grads]


class GradientClipByNorm(GradientClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        return [(p, layers.clip_by_norm(g, self.clip_norm))
                for p, g in params_grads]


class GradientClipByGlobalNorm(GradientClipBase):
    """Scale every gradient by clip_norm / max(global_norm, clip_norm)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        sums = [layers.reshape(layers.reduce_sum(layers.square(g)), [1])
                for _, g in params_grads]
        global_norm = layers.sqrt(layers.sums(sums))
        clip_var = layers.fill_constant([1], "float32", self.clip_norm)
        scale = layers.elementwise_div(
            clip_var, layers.elementwise_max(global_norm, clip_var))
        return [(p, layers.elementwise_mul(g, scale))
                for p, g in params_grads]


ClipGradByValue = GradientClipByValue
ClipGradByNorm = GradientClipByNorm
ClipGradByGlobalNorm = GradientClipByGlobalNorm
