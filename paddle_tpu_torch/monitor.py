"""Stat registry (counterpart of paddle_tpu/monitor.py): a view over
observability/metrics.py. `stat_add` records a counter in the registry
the tracer and the flight recorder snapshot and diff; `stat_get` reads
it back. The resilience legs count `resilience.ckpt_fallbacks` here
(resilience/checkpoint.py).
"""
from __future__ import annotations

from .observability import metrics as _metrics


def stat_add(name: str, value: float = 1):
    _metrics.inc(name, value)


def stat_get(name: str) -> float:
    return _metrics.get(name)
