"""INT8 dequantize lowering (counterpart of the `dequantize_abs_max` entry
of paddle_tpu/ops/int8_ops.py; reference dequantize_abs_max_op.cc).

Out = float32(X) * (Scale / max_range), in the reference's order of
operations: the multiplier Scale / max_range is formed first in f32, so
the dequantised bits equal the reference's. The other ops of the
reference module (dequantize_log, lookup_table_dequant, the fused LSTM
family) are not ported yet.
"""
from __future__ import annotations

import torch

from .registry import register


@register("dequantize_abs_max", nondiff_slots=("X", "Scale"))
def _dequantize_abs_max(ctx, ins, attrs):
    x = ins["X"][0]                       # int8 payload
    scale = ins["Scale"][0].reshape(()).to(torch.float32)
    max_range = float(attrs.get("max_range", 127.0))
    return {"Out": [x.to(torch.float32) * (scale / max_range)]}
