"""Serving weight formats (counterpart of paddle_tpu/serving/weights.py).

Decode reads every weight for every generated token, so the resident
format sets the bytes each step moves:

* float32 — the parity/reference arm;
* bfloat16 — half the bytes; layernorm params stay f32 (`_ln` computes in
  f32) and the head accumulates in f32.

int8 weights (per-tensor abs-max, `quantize_params` / `dequant_params` of
the reference) are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..framework.errors import UnimplementedError
from ..models.gpt_decode import as_dtype


def prepare_params(params: Mapping[str, object], dtype: str,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """Every tensor on `device`, float params other than layernorm cast to
    `dtype` ("float32" | "bfloat16")."""
    if dtype == "int8":
        raise UnimplementedError("int8 serving weights are not ported yet")
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"serving dtype {dtype!r} not in "
                         "(float32, bfloat16, int8)")
    compute = as_dtype(dtype)
    out: Dict[str, torch.Tensor] = {}
    for n, a in params.items():
        t = a if isinstance(a, torch.Tensor) else torch.tensor(
            np.asarray(a))
        if "_ln" not in n and t.is_floating_point():
            t = t.to(compute)
        out[n] = t.to(device)
    return out
