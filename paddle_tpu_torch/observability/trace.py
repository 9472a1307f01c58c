"""Host tracer: spans, instants, counter tracks, flow events and the
bounded ring, with chrome-trace export (counterpart of
paddle_tpu/observability/trace.py).

The serving tier draws every request as one flow (submit -> retire) and
every window as a span with a dispatch -> materialization flow; retries,
sheds, failovers and health changes are instants. On the training side
a checkpoint save is the spans `ckpt.collect`, `ckpt.save` (with
`ckpt.manifest` inside) and `ckpt.publish`, a restore `ckpt.validate`,
`ckpt.read` and `ckpt.apply` (category "resilience";
resilience/checkpoint.py), and a snapshot and a rollback are instants. Device time is torch.profiler's; this ring
holds the host timeline around it.

Storage is a bounded RING (FLAGS_trace_buffer_events; the oldest events
drop, counted in the `trace.dropped_events` metric), so recording stays
on as the flight recorder's backing store (observability/flight.py) with
a hard memory bound. Thread ids are real idents, with thread-name
metadata ("M" phase) at export; flow events ("s"/"f" sharing cat, name
and id) link a dispatch to its later materialization across threads.

Cost: one flag lookup when disabled (FLAGS_trace_events=0); enabled, two
perf_counter_ns calls and a locked deque append per span.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

from ..flags import flag
from . import metrics as _metrics

_lock = threading.Lock()
_events: "collections.deque[dict]" = collections.deque(maxlen=65536)
_thread_names: Dict[int, str] = {}
_flow_ids = itertools.count(1)
_dropped = 0


def now_us() -> float:
    """The trace clock (chrome trace ts unit: microseconds)."""
    return time.perf_counter_ns() / 1000.0


def enabled() -> bool:
    return bool(flag("FLAGS_trace_events"))


def set_buffer_size(n: int):
    """Re-bound the ring (tests; FLAGS_trace_buffer_events seeds the
    initial bound). Existing events are kept up to the new bound."""
    global _events
    with _lock:
        _events = collections.deque(_events, maxlen=max(16, int(n)))


_flag_capacity: Optional[int] = None   # last applied flag value


def _resize_from_flag():
    """Apply FLAGS_trace_buffer_events when it CHANGED — re-checked by
    _append whenever the ring is full, so a runtime set_flags on the
    capacity takes effect without clobbering an explicit
    set_buffer_size() (which wins until the flag moves again)."""
    global _flag_capacity
    n = int(flag("FLAGS_trace_buffer_events"))
    if n and n != _flag_capacity:
        _flag_capacity = n
        set_buffer_size(n)


def _append(ev: dict):
    global _dropped
    tid = threading.get_ident()
    ev["pid"] = os.getpid()
    ev["tid"] = tid
    if len(_events) == _events.maxlen and (_dropped & 0x1FF) == 0:
        # ring full — steady state of a long always-on run — is the one
        # moment a runtime set_flags on the capacity matters. Re-read it
        # BEFORE taking _lock (set_buffer_size locks), but only every 512
        # drops: a per-event flag lookup would tax every span forever.
        _resize_from_flag()
    name = threading.current_thread().name
    with _lock:
        # the latest name: an ident is reused once its thread has exited
        _thread_names[tid] = name
        if len(_events) == _events.maxlen:
            _dropped += 1
        _events.append(ev)


class RecordEvent:
    """RAII host span (reference platform/profiler.h RecordEvent): a
    complete ("X") chrome-trace event over the with-block's wall time.
    `args` ride into the trace verbatim (per-step phase annotations:
    {"step": n, ...}); extra args can be attached mid-span with
    add_args()."""

    __slots__ = ("name", "cat", "args", "_t0", "_on")

    def __init__(self, name: str, cat: str = "host", args: Optional[dict] = None):
        self.name = name
        self.cat = cat
        self.args = args

    def add_args(self, **kw):
        if self.args is None:
            self.args = {}
        self.args.update(kw)
        return self

    def __enter__(self):
        self._on = enabled()
        if self._on:
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *a):
        if self._on:
            t1 = time.perf_counter_ns()
            ev = {"name": self.name, "ph": "X", "cat": self.cat,
                  "ts": self._t0 / 1000.0, "dur": (t1 - self._t0) / 1000.0}
            if self.args:
                ev["args"] = dict(self.args)
            _append(ev)
        return False


def instant(name: str, args: Optional[dict] = None, cat: str = "host"):
    """Point-in-time marker ("i" phase): retries, fallbacks, conflicts."""
    if not enabled():
        return
    ev = {"name": name, "ph": "i", "cat": cat, "ts": now_us(), "s": "t"}
    if args:
        ev["args"] = dict(args)
    _append(ev)


def counter_event(name: str, values: Dict[str, float]):
    """Chrome counter track ("C" phase): a stacked counter lane."""
    if not enabled():
        return
    _append({"name": name, "ph": "C", "cat": "host", "ts": now_us(),
             "args": {k: float(v) for k, v in values.items()}})


# ---- flow events (cross-thread dispatch -> fetch linkage) -------------------

def new_flow() -> int:
    return next(_flow_ids)


def flow_start(name: str, flow_id: int, args: Optional[dict] = None) -> int:
    """Open flow `flow_id` here (an "s" event). The matching flow_end may
    fire on ANY thread — chrome binds s/f pairs by (cat, name, id)."""
    if enabled():
        ev = {"name": name, "ph": "s", "cat": "flow", "id": int(flow_id),
              "ts": now_us()}
        if args:
            ev["args"] = dict(args)
        _append(ev)
    return flow_id


def flow_end(name: str, flow_id: int, args: Optional[dict] = None):
    if not enabled():
        return
    ev = {"name": name, "ph": "f", "bp": "e", "cat": "flow",
          "id": int(flow_id), "ts": now_us()}
    if args:
        ev["args"] = dict(args)
    _append(ev)


# ---- views / export ---------------------------------------------------------

def events(since_ts: Optional[float] = None) -> List[dict]:
    """A copy of the ring (optionally only events ending at/after
    `since_ts`, trace-clock microseconds)."""
    with _lock:
        evs = list(_events)
    if since_ts is None:
        return evs
    return [e for e in evs
            if e["ts"] + e.get("dur", 0.0) >= since_ts]


_dropped_mirrored = 0


def dropped_events() -> int:
    """Drop count; also mirrors it into the `trace.dropped_events` counter.
    The mirror happens HERE (and so at every export/dump, which call this)
    rather than per-drop in _append — a full ring would otherwise pay a
    metrics-lock acquire on every span forever."""
    global _dropped_mirrored
    d = _dropped
    if d != _dropped_mirrored:
        _metrics.inc("trace.dropped_events", d - _dropped_mirrored)
        _dropped_mirrored = d
    return d


def clear():
    global _dropped, _dropped_mirrored
    with _lock:
        _events.clear()
        _dropped = 0
    _dropped_mirrored = 0


def thread_metadata_events() -> List[dict]:
    """One "M" thread_name event per thread seen, so trace viewers label
    lanes with real thread names instead of bare idents."""
    pid = os.getpid()
    with _lock:
        names = dict(_thread_names)
    return [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": name}} for tid, name in sorted(names.items())]


def process_metadata_events() -> List[dict]:
    """Process-lane metadata ("M" process_name / process_sort_index /
    process_labels): rank, role and world size from the launcher's env
    contract (PADDLE_TRAINER_ID / TRAINING_ROLE / PADDLE_TRAINERS_NUM;
    rank 0 of 1 outside a gang), so a trace opens in Perfetto with a
    labeled lane instead of a bare pid."""
    pid = os.getpid()
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1)
    role = os.environ.get("TRAINING_ROLE", "TRAINER").lower()
    return [
        {"name": "process_name", "ph": "M", "pid": pid,
         "args": {"name": f"rank {rank} ({role})"}},
        {"name": "process_sort_index", "ph": "M", "pid": pid,
         "args": {"sort_index": rank}},
        {"name": "process_labels", "ph": "M", "pid": pid,
         "args": {"labels": f"rank={rank},world={world},role={role},"
                            f"pid={pid}"}},
    ]


def export_chrome_trace(path: str,
                        since_ts: Optional[float] = None,
                        extra_events: Optional[List[dict]] = None) -> str:
    """Write a chrome://tracing / Perfetto JSON file: thread-name metadata
    first, then the (optionally windowed) span/flow/instant events."""
    evs = events(since_ts)
    payload = {
        "traceEvents": process_metadata_events() + thread_metadata_events()
        + evs + list(extra_events or []),
        "displayTimeUnit": "ms",
        "otherData": {"dropped_events": dropped_events()},
    }
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


_resize_from_flag()
