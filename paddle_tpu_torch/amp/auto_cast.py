"""Autocast lists (counterpart of paddle_tpu/amp/auto_cast.py:14-34).

Static-graph AMP: the Executor casts a white-list op's floating inputs to
the low dtype (bfloat16) and a black-list op's to float32 as it runs each
op (framework/executor.py `_amp_cast`); grad ops re-derive the policy from
the forward op they differentiate. The dygraph `auto_cast` context is not
ported.
"""
from __future__ import annotations

# ops cast to low precision: the compute-bound matrix products
white_list = {
    "conv2d", "depthwise_conv2d", "conv2d_transpose", "matmul", "matmul_v2",
    # chunked LM head: its products accumulate in f32 and the loss is f32
    "fused_lm_head_ce",
    "mul", "bmm", "fc",
}
# per-op input slots the white-list cast skips: tiny operands whose
# quantisation buys nothing but drifts from the dense path
keep_f32_slots = {
    "fused_lm_head_ce": {"Bias"},
}
# ops forced to float32: reductions and normalisations
black_list = {
    "softmax", "softmax_with_cross_entropy", "cross_entropy", "layer_norm",
    "batch_norm", "mean", "reduce_mean", "reduce_sum", "sum", "exp", "log",
    "square", "p_norm", "sigmoid_cross_entropy_with_logits",
}
