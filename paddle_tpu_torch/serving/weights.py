"""Serving weight formats (counterpart of paddle_tpu/serving/weights.py).

Decode reads every weight for every generated token, so the resident
format sets the bytes each step moves:

* float32 — the parity/reference arm;
* bfloat16 — half the bytes; layernorm params stay f32 (`_ln` computes in
  f32) and the head accumulates in f32;
* int8 — per-tensor abs-max quantization of every floating tensor of
  ndim >= 2 that is not layernorm (wte, wpe and every qkv/proj/ffn
  matrix): an int8 payload plus one f32 scale per tensor, dequantized
  inside each window and prefill through the registered
  `dequantize_abs_max` lowering (ops/int8_ops.py) to bf16. The tensors
  left unquantized (the biases, layernorm) stay f32, as in the
  reference, so the bias adds promote the activations to f32: the
  products take the bf16 weights' exact values in f32, and B4 reads the
  bf16 KV pool with an f32 query. The payload is what stays resident: a
  quarter of the f32 bytes.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.gpt_decode import as_dtype
from ..ops import registry

_MAX_RANGE = 127.0


def _quantizable(name: str, t: torch.Tensor) -> bool:
    return ("_ln" not in name and "ln_" not in name.split("/")[-1][:3]
            and t.is_floating_point() and t.dim() >= 2)


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.tensor(np.asarray(a))


def quantize_params(params: Mapping[str, object]
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """-> (payloads, scales): payloads hold int8 for quantized tensors and
    the original tensor otherwise; scales one f32 abs-max (0-d) per
    quantized name. q = clip(round(a / scale * 127), -127, 127), in the
    reference's order of f32 operations (round half to even)."""
    payloads, scales = {}, {}
    for n, a in params.items():
        t = _as_tensor(a)
        if _quantizable(n, t):
            a32 = t.to(torch.float32)
            scale = torch.clamp(torch.max(torch.abs(a32)), min=1e-8)
            q = torch.clamp(torch.round(a32 / scale * _MAX_RANGE),
                            -_MAX_RANGE, _MAX_RANGE).to(torch.int8)
            payloads[n] = q
            scales[n] = scale.to(torch.float32)
        else:
            payloads[n] = t
    return payloads, scales


def dequant_params(payloads: Mapping[str, torch.Tensor],
                   scales: Mapping[str, torch.Tensor],
                   compute_dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The dense parameter dict from int8 payloads, through the registered
    dequantize_abs_max lowering, cast to `compute_dtype`."""
    deq = registry.get("dequantize_abs_max").lower
    out = {}
    for n, a in payloads.items():
        if n in scales:
            d = deq(None, {"X": [a], "Scale": [scales[n]]},
                    {"max_range": _MAX_RANGE})["Out"][0]
            out[n] = d.to(compute_dtype)
        else:
            out[n] = a
    return out


def prepare_params(params: Mapping[str, object], dtype: str,
                   device: torch.device
                   ) -> Tuple[Dict[str, torch.Tensor],
                              Optional[Dict[str, torch.Tensor]],
                              torch.dtype]:
    """-> (payloads, scales, compute_dtype), every tensor on `device`.
    "float32" / "bfloat16": float params other than layernorm cast to
    `dtype`, scales None. "int8": `quantize_params`' payloads and scales
    (compute dtype bf16, the dequantized matrices' type; the unquantized
    biases stay f32)."""
    if dtype in ("float32", "bfloat16"):
        compute = as_dtype(dtype)
        out: Dict[str, torch.Tensor] = {}
        for n, a in params.items():
            t = _as_tensor(a)
            if "_ln" not in n and t.is_floating_point():
                t = t.to(compute)
            out[n] = t.to(device)
        return out, None, compute
    if dtype != "int8":
        raise ValueError(f"serving dtype {dtype!r} not in "
                         "(float32, bfloat16, int8)")
    payloads, scales = quantize_params(params)
    return ({n: t.to(device) for n, t in payloads.items()},
            {n: t.to(device) for n, t in scales.items()}, torch.bfloat16)
