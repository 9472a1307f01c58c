"""Loss layer functions (counterpart of paddle_tpu/layers/loss.py)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "square_error_cost",
    "sigmoid_cross_entropy_with_logits", "huber_loss", "mse_loss",
    "log_loss", "smooth_l1", "fused_lm_head_ce",
]


def fused_lm_head_ce(x, w, label, chunk=None, bias=None, w_layout="vh",
                     ignore_index=-100):
    """Streaming LM head + cross-entropy without the [B, S, V] logits
    (ops/fused_ce.py). x [B, S, H]; w [V, H] ("vh") or [H, V] ("hv");
    bias [V]; label [B, S, 1]. Returns the per-token loss [B, S, 1] f32."""
    helper = LayerHelper("fused_lm_head_ce")
    loss = helper.create_variable_for_type_inference("float32")
    inputs = {"X": [x], "W": [w], "Label": [label]}
    if bias is not None:
        inputs["Bias"] = [bias]
    helper.append_op("fused_lm_head_ce", inputs=inputs,
                     outputs={"Loss": [loss]},
                     attrs={"chunk": chunk, "w_layout": w_layout,
                            "ignore_index": ignore_index})
    return loss


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1,
                               ignore_index=-100, return_softmax=False):
    """Tokens labelled `ignore_index` contribute zero loss and grads."""
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [softmax], "Loss": [loss]},
                     attrs={"soft_label": soft_label, "axis": axis,
                            "ignore_index": ignore_index})
    if return_softmax:
        return loss, softmax
    return loss


def square_error_cost(input, label):
    """(input - label) ** 2, elementwise."""
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("square_error_cost",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out]})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """-log of the label's probability (`input` holds probabilities)."""
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]}, attrs={})
    return out


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    out = helper.create_variable_for_type_inference(input.dtype)
    res = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("huber_loss", inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out], "Residual": [res]},
                     attrs={"delta": delta})
    return out


def mse_loss(input, label):
    from .nn import mean
    return mean(square_error_cost(input, label))


def log_loss(input, label, epsilon=1e-4, name=None):
    """-label * log(input + eps) - (1 - label) * log(1 - input + eps),
    from primitive ops."""
    from . import nn
    one_m_lab = nn.scale(label, scale=-1.0, bias=1.0)
    one_m_in = nn.scale(input, scale=-1.0, bias=1.0 + epsilon)
    t1 = nn.elementwise_mul(nn.scale(label, -1.0),
                            nn.log(nn.scale(input, 1.0, epsilon)))
    t2 = nn.elementwise_mul(one_m_lab, nn.log(one_m_in))
    return nn.elementwise_sub(t1, t2)


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    return huber_loss(x, y, 1.0 if sigma is None else 1.0 / (sigma * sigma))
