"""Typed metrics registry: counters, gauges, histograms under dotted names
(counterpart of paddle_tpu/observability/metrics.py).

The serving engine records `serving.ttft_ms`, `serving.tpot_ms` and
`serving.window_ms` (histograms) and `serving.tokens_out` (counter) here;
the serving tier adds `serving.failovers`, `serving.sla_trips`,
`serving.recover_ms` and `serving.canary_ms`. The training side's
resilience legs record `resilience.snapshots`, `resilience.snapshot_skips`,
`resilience.snapshot_flushes` and `resilience.recover_{local,disk}`
(counters), `resilience.snapshot_ms`, `resilience.snapshot_host_ms` and
`resilience.snapshot_copy_ms` (histograms), `resilience.ckpt_fallbacks`,
`integrity.rollbacks` and `io.load_rebinds` (counters). `get` reads one
value,
`delta` what moved between two snapshots (the flight recorder's per-step
attribution). monitor.py is a view over this registry. Hot-path cost: one lock plus one dict/float op
per record.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

_lock = threading.Lock()

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# histogram reservoir: percentiles come from the most recent observations
# (a bounded ring), count/sum/min/max from the full stream
_HIST_KEEP = 2048


class _Scalar:
    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value: float = 0.0):
        self.kind = kind
        self.value = value


class _Hist:
    __slots__ = ("count", "total", "min", "max", "ring", "ring_pos")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.ring: List[float] = []
        self.ring_pos = 0

    def observe(self, v: float):
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        if len(self.ring) < _HIST_KEEP:
            self.ring.append(v)
        else:
            self.ring[self.ring_pos] = v
            self.ring_pos = (self.ring_pos + 1) % _HIST_KEEP

    def percentiles(self, *qs: float) -> List[Optional[float]]:
        if not self.ring:
            return [None] * len(qs)
        s = sorted(self.ring)
        return [s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]
                for q in qs]


_scalars: Dict[str, _Scalar] = {}
_hists: Dict[str, _Hist] = {}


def inc(name: str, value: float = 1.0):
    """Counter add (monotonic). First use of `name` types it as a counter."""
    with _lock:
        s = _scalars.get(name)
        if s is None:
            _scalars[name] = _Scalar(COUNTER, value)
        else:
            s.value += value


def set_gauge(name: str, value: float):
    """Gauge set (last value wins). First use types `name` as a gauge."""
    with _lock:
        s = _scalars.get(name)
        if s is None:
            _scalars[name] = _Scalar(GAUGE, value)
        else:
            s.value = value


def observe(name: str, value: float):
    """Histogram observation (p50/p99 over a bounded recent window)."""
    with _lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = _Hist()
        h.observe(float(value))


def get(name: str) -> float:
    """Scalar value (counter total / gauge last value); a histogram name
    returns its observation count; an unknown name returns 0."""
    with _lock:
        s = _scalars.get(name)
        if s is not None:
            return s.value
        h = _hists.get(name)
        return float(h.count) if h is not None else 0


def reset(name: Optional[str] = None):
    with _lock:
        if name is None:
            _scalars.clear()
            _hists.clear()
        else:
            _scalars.pop(name, None)
            _hists.pop(name, None)


def snapshot(percentiles: bool = True) -> Dict[str, dict]:
    """Typed point-in-time view of every metric:
    counters/gauges -> {"type", "value"}; histograms -> {"type", "count",
    "sum", "min", "max"} plus "p50"/"p99" when `percentiles`."""
    with _lock:
        out: Dict[str, dict] = {
            n: {"type": s.kind, "value": s.value}
            for n, s in _scalars.items()}
        for n, h in _hists.items():
            row = {"type": HISTOGRAM, "count": h.count,
                   "sum": h.total, "min": h.min, "max": h.max}
            if percentiles:
                row["p50"], row["p99"] = h.percentiles(0.50, 0.99)
            out[n] = row
        return out


def delta(prev: Dict[str, dict],
          cur: Optional[Dict[str, dict]] = None) -> Dict[str, dict]:
    """What moved between two snapshots: counters and histograms diff
    their monotonic fields, gauges report their current value; metrics
    that did not move are left out."""
    cur = snapshot(percentiles=False) if cur is None else cur
    out: Dict[str, dict] = {}
    for name, c in cur.items():
        p = prev.get(name)
        if c["type"] == HISTOGRAM:
            pc = p["count"] if p and p.get("type") == HISTOGRAM else 0
            ps = p["sum"] if p and p.get("type") == HISTOGRAM else 0.0
            if c["count"] != pc:
                out[name] = {"type": HISTOGRAM, "count": c["count"] - pc,
                             "sum": c["sum"] - ps}
        elif c["type"] == GAUGE:
            if p is None or p.get("value") != c["value"]:
                out[name] = {"type": GAUGE, "value": c["value"]}
        else:
            pv = p["value"] if p and "value" in p else 0.0
            if c["value"] != pv:
                out[name] = {"type": COUNTER, "value": c["value"] - pv}
    return out

