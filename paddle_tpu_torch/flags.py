"""Global flags registry (the serving and ZeRO subset of paddle_tpu/flags.py).

FLAGS_* environment variables seed the initial values at import, as in
the reference registry; `set_flags` changes them at run time.

`FLAGS_pallas_opt` and the `PADDLE_TPU_PALLAS_OPT` toggle of the reference
are left out on purpose: on CUDA tensors the `__zero_update__` funnel
always launches the fused update kernels (ops/kernels/zero_update.py),
which equal the per-op rule bit for bit.
"""
from __future__ import annotations

import os
from typing import Any, Dict

_DEFS: Dict[str, tuple] = {
    # (default, help)
    "FLAGS_serving_window": (8, "decode tokens per serving window "
                             "(serving/engine.py): finished requests retire "
                             "and queued requests admit BETWEEN windows, so "
                             "this is the continuous-batching scheduling "
                             "quantum"),
    "FLAGS_serving_block_size": (16, "paged KV-cache block size in positions "
                                 "(serving/cache.py)"),
    "FLAGS_serving_max_queue": (256, "submit-queue bound per decode engine "
                                "(admission control): a submit past it is "
                                "shed with reason queue_full"),
    "FLAGS_serving_spec_tokens": (4, "speculative decoding draft depth "
                                  "gamma (serving/spec.py SpecConfig."
                                  "tokens = 0): proposals per slot per "
                                  "round"),
    "FLAGS_step_deadline_ms": (0.0, "serving window watchdog; not ported "
                               "yet: DecodeEngine refuses a nonzero value"),
    "FLAGS_zero_stage": (0, "ZeRO sharding stage applied at fleet minimize "
                            "time (parallel/zero.py): 1 moves each gradient "
                            "bucket's optimizer state into flat vars updated "
                            "by one __zero_update__; 2 also keeps the "
                            "bucket's gradient in a resident flat buffer; 3 "
                            "also moves parameter storage into flat buckets "
                            "unpacked on demand by __zero_gather__"),
}

_values: Dict[str, Any] = {}


def _coerce(default, raw: str):
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    return type(default)(raw)


def _init():
    for name, (default, _help) in _DEFS.items():
        raw = os.environ.get(name)
        _values[name] = _coerce(default, raw) if raw is not None else default


_init()


def set_flags(flags: Dict[str, Any]):
    for name, value in flags.items():
        if name not in _DEFS:
            raise KeyError(f"unknown flag {name!r}; known: {sorted(_DEFS)}")
        default = _DEFS[name][0]
        _values[name] = (_coerce(default, value)
                         if isinstance(value, str) else type(default)(value))


def flag(name: str):
    return _values[name]
