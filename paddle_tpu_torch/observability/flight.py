"""Flight recorder: the last N steps' wall windows and metric deltas, always
on, dumped when something dies (counterpart of
paddle_tpu/observability/flight.py).

A step is whatever its owner brackets with begin_step / end_step; the
serving engine brackets each decode window and verify pass, with a lane
per engine (`owner`), so one process's replicas never collide on a step
index. Each closed step keeps its wall window, its status ("ok", "error",
"sla_trip") and the metrics that moved during it (metrics.delta of two
snapshots). `dump` serializes the step ring, the trace-ring events
covering it (observability/trace.py) and the full metrics snapshot; the
FLAGS_step_deadline_ms watchdog (framework/executor.py `_deadline_call`)
dumps at every trip.

Cost when nothing is wrong: two metrics snapshots (a locked dict copy) per
step. FLAGS_flight_recorder=0 turns it off.

Dump location: FLAGS_flight_dump_dir, default
<tmpdir>/paddle_tpu_torch_flight; file name
flight_r<rank>_<pid>_<reason>_<seq>.json. Format:

    {"format": 1, "reason": ..., "rank": ..., "world": ..., "role": ...,
     "pid": ..., "wall_time": ...,
     "clock": {"wall_time_us": ..., "trace_ts_us": ...},
     "dropped_events": ...,
     "steps":  [{"step": k, "exe": <owner>, "t0_us": ..., "t1_us": ...,
                 "status": "ok", "metrics_delta": {...}}, ...],
     "trace_events": [...chrome-trace events covering those steps...],
     "metrics": {...full typed snapshot...},
     "extra": {...}}

`clock` reads the trace clock and the wall clock back to back, so the
trace's perf_counter epoch can be placed on the wall clock. The launcher's
heartbeat mirror and at-exit dump of the reference are not ported (no
launcher in the port yet).
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Optional

from ..flags import flag
from . import metrics as _metrics
from . import trace as _trace

_lock = threading.Lock()
_steps: list = []           # closed step records, oldest first, bounded
_open: dict = {}    # (owner, step idx) -> (t0_us, snapshot), in-flight steps
_dump_seq = 0


def enabled() -> bool:
    return bool(flag("FLAGS_flight_recorder"))


def keep_steps() -> int:
    return max(1, int(flag("FLAGS_flight_steps")))


def begin_step(idx: int, owner: int = 0):
    """Open step `idx` of lane `owner` (every owner counts its own
    steps)."""
    _metrics.inc("executor.steps")
    if not enabled():
        return
    # percentile-free: delta() reads count/sum only
    snap = _metrics.snapshot(percentiles=False)
    with _lock:
        _open[(int(owner), int(idx))] = (_trace.now_us(), snap)


def end_step(idx: int, status: str = "ok", owner: int = 0):
    """Close a step: record (t0, t1, status, metric delta) in the ring. A
    step closed twice records once (the second call finds it closed)."""
    # pop BEFORE the enabled() check: a flag toggle mid-step must not leak
    # a phantom in-flight entry into every later dump()
    with _lock:
        opened = _open.pop((int(owner), int(idx)), None)
    if opened is None or not enabled():
        return
    t0, snap0 = opened
    rec = {"step": int(idx), "exe": int(owner), "t0_us": t0,
           "t1_us": _trace.now_us(), "status": status,
           "metrics_delta": _metrics.delta(snap0)}
    with _lock:
        _steps.append(rec)
        del _steps[:-keep_steps()]


def pod_identity() -> dict:
    """{"rank", "world", "role"} from the launcher env contract (rank 0 of
    1, trainer, outside a gang)."""
    return {
        "rank": int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0),
        "world": int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1),
        "role": os.environ.get("TRAINING_ROLE", "TRAINER").lower(),
    }


def steps() -> list:
    with _lock:
        return [dict(s) for s in _steps]


def clear():
    with _lock:
        _steps.clear()
        _open.clear()


def dump_dir() -> str:
    d = str(flag("FLAGS_flight_dump_dir") or "")
    return d or os.path.join(tempfile.gettempdir(),
                             "paddle_tpu_torch_flight")


def dump(reason: str, path: Optional[str] = None,
         extra: Optional[dict] = None) -> Optional[str]:
    """Serialize the black box: the last N step records (plus every step
    still open, as "in_flight"), the trace-ring events covering them (all
    events when no step is recorded) and the full metrics snapshot.
    Returns the written path, or None when the recorder is off. Never
    raises: a failing dump must not mask the failure it documents."""
    global _dump_seq
    if not enabled():
        return None
    try:
        with _lock:
            step_recs = [dict(s) for s in _steps]
            for (owner, idx), (t0, snap0) in _open.items():
                step_recs.append({"step": idx, "exe": owner, "t0_us": t0,
                                  "t1_us": None, "status": "in_flight",
                                  "metrics_delta": _metrics.delta(snap0)})
            _dump_seq += 1
            seq = _dump_seq
        since = min((s["t0_us"] for s in step_recs), default=None)
        ident = pod_identity()
        clock = {"wall_time_us": time.time() * 1e6,
                 "trace_ts_us": _trace.now_us()}
        payload = {
            "format": 1,
            "reason": reason,
            "pid": os.getpid(),
            "rank": ident["rank"],
            "world": ident["world"],
            "role": ident["role"],
            "wall_time": time.time(),
            "clock": clock,
            "dropped_events": _trace.dropped_events(),
            "steps": step_recs,
            "trace_events": (_trace.process_metadata_events()
                             + _trace.thread_metadata_events()
                             + _trace.events(since)),
            "metrics": _metrics.snapshot(),
        }
        if extra:
            payload["extra"] = extra
        if path is None:
            d = dump_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d,
                f"flight_r{ident['rank']}_{os.getpid()}_{reason}_{seq}.json")
        else:
            pd = os.path.dirname(path)
            if pd:
                os.makedirs(pd, exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f)
        _metrics.inc("observability.flight_dumps")
        return path
    except Exception:   # noqa: BLE001 — documented: never raises
        return None
