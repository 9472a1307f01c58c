"""Weight-decay regularizers (counterpart of paddle_tpu/regularizer.py).

`Optimizer.apply_gradients` appends each parameter's decay term to its
gradient before the update op (`_append_regularization`): the update then
consumes a regularised gradient, which makes its ZeRO bucket `pre_synced`
(parallel/zero.py)."""
from __future__ import annotations

from . import layers

__all__ = ["L2Decay", "L1Decay", "L2DecayRegularizer", "L1DecayRegularizer"]


class WeightDecayRegularizer:
    def _append(self, param, grad):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append(self, param, grad):
        decay = layers.scale(param, scale=self._coeff)
        return layers.sums([grad, decay])


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append(self, param, grad):
        decay = layers.scale(layers.sign(param), scale=self._coeff)
        return layers.sums([grad, decay])


L2Decay = L2DecayRegularizer
L1Decay = L1DecayRegularizer
