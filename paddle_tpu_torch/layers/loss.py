"""Loss layer functions (counterpart of paddle_tpu/layers/loss.py)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["fused_lm_head_ce", "softmax_with_cross_entropy",
           "square_error_cost"]


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
