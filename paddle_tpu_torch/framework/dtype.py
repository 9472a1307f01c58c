"""Dtype system (counterpart of paddle_tpu/framework/dtype.py).

Paddle-style dtype specs (strings, numpy dtypes, torch dtypes) normalise to
a `torch.dtype`; `dtype_name` gives the canonical string a desc carries
("float32", "bfloat16", "int64", ...), the same strings the reference's
numpy dtypes print.

Device policy, kept from the reference so that programs and their descs
agree: "int64" is a declaration-level dtype (ids are int64 in the feed
declarations), while VALUES live as int32 on the device. The executor's
feed boundary range-checks int64 feeds and narrows them; build-time shape
inference reports an op's int64 outputs as int32 (`device_dtype`).
"""
from __future__ import annotations

import numpy as np
import torch

_ALIASES = {
    "float32": torch.float32, "fp32": torch.float32, "float": torch.float32,
    "float64": torch.float64, "fp64": torch.float64, "double": torch.float64,
    "float16": torch.float16, "fp16": torch.float16, "half": torch.float16,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int": torch.int32,
    "int64": torch.int64, "long": torch.int64,
    "bool": torch.bool,
}
_NAMES = {d: n for n, d in _ALIASES.items()
          if n in ("float32", "float64", "float16", "bfloat16", "int8",
                   "uint8", "int16", "int32", "int64", "bool")}

FLOAT_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


def convert_dtype(dtype) -> torch.dtype:
    """Normalise a dtype spec (string / numpy / torch) to a torch.dtype."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        if key not in _ALIASES:
            raise TypeError(f"Unsupported dtype string: {dtype!r}")
        return _ALIASES[key]
    name = np.dtype(dtype).name
    if name not in _ALIASES:
        raise TypeError(f"Unsupported dtype: {dtype!r}")
    return _ALIASES[name]


def device_dtype(dtype) -> torch.dtype:
    """convert_dtype + the 64-bit-int -> 32-bit on-device policy."""
    d = convert_dtype(dtype)
    return torch.int32 if d == torch.int64 else d


def dtype_name(dtype) -> str:
    return _NAMES[convert_dtype(dtype)]


def is_floating(dtype) -> bool:
    return convert_dtype(dtype) in FLOAT_DTYPES

