"""Gradient clipping (counterpart of paddle_tpu/clip.py).

`Optimizer.apply_gradients` calls the clip on [(param, grad)] before the
update ops; the clip appends its ops to the program and returns the
clipped gradients, which make their ZeRO buckets `pre_synced`
(parallel/zero.py). SelectedRows gradients (`embedding(is_sparse=True)`)
pass through unclipped and stay out of the global norm, as in the
reference (clip.py:18-22)."""
from __future__ import annotations

from . import layers

__all__ = ["GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


class GradientClipBase:
    def __call__(self, params_grads):
        raise NotImplementedError


def _split_sparse(params_grads):
    """(dense pairs, SelectedRows pairs)."""
    dense = [(p, g) for p, g in params_grads
             if not getattr(g, "_is_selected_rows", False)]
    sparse = [(p, g) for p, g in params_grads
              if getattr(g, "_is_selected_rows", False)]
    return dense, sparse


class GradientClipByValue(GradientClipBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        dense, sparse = _split_sparse(params_grads)
        return [(p, layers.clip(g, self.min, self.max))
                for p, g in dense] + sparse


class GradientClipByNorm(GradientClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        dense, sparse = _split_sparse(params_grads)
        return [(p, layers.clip_by_norm(g, self.clip_norm))
                for p, g in dense] + sparse


class GradientClipByGlobalNorm(GradientClipBase):
    """Scale every gradient by clip_norm / max(global_norm, clip_norm)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        params_grads, sparse = _split_sparse(params_grads)
        sums = [layers.reshape(layers.reduce_sum(layers.square(g)), [1])
                for _, g in params_grads]
        global_norm = layers.sqrt(layers.sums(sums))
        clip_var = layers.fill_constant([1], "float32", self.clip_norm)
        scale = layers.elementwise_div(
            clip_var, layers.elementwise_max(global_norm, clip_var))
        return [(p, layers.elementwise_mul(g, scale))
                for p, g in params_grads] + sparse


ClipGradByValue = GradientClipByValue
ClipGradByNorm = GradientClipByNorm
ClipGradByGlobalNorm = GradientClipByGlobalNorm
