"""Pod-scope observability: merge a gang's per-rank flight dumps into one
timeline, with cross-rank collective telemetry and a straggler report
(counterpart of paddle_tpu/observability/podscope.py; stdlib only, as
there, and the port's own copy).

Each rank's dump (observability/flight.py) becomes a Perfetto process
lane (pid = rank, with process_name / process_sort_index metadata). The
collective markers the executor stamps at dispatch
(framework/executor.py `_emit_collective_markers`: the key
`s{step}.b{bucket}.q{seq}`) link equal keys across lanes with flow
arrows: "s" on the first rank to arrive, "t" on the middle ones, "f" on
the last, the one every other rank waited for.

Clocks. Trace timestamps are `perf_counter` microseconds, an epoch per
process. Every dump carries `clock` = {"wall_time_us", "trace_ts_us"},
read back to back, so `wall_time_us - trace_ts_us` places that rank's
events on the shared wall clock. One host's ranks share its wall clock
exactly; across hosts NTP skew adds in. The merged timeline is re-zeroed
at `anchor_us` (the supervisor's rendezvous wall time when given, else
the earliest aligned event).

Telemetry. A marker's time is the rank's host dispatch of the step, so
within one rank a step's markers share it; across ranks the spread of a
key (its arrival skew) names the straggler: the last rank to arrive.
`straggler_score` adds three signals (the share of collectives a rank
arrived last at, its step lag behind the gang, its step time over the
gang's median), so a rank that is slow, behind or stalling shows even
when one signal is missing (a killed rank whose dump stops early still
scores on its lag).

Nothing here has side effects but `write_pod_dump`'s files: the launcher
(distributed/launch.py `--collect-dumps`) and `python -m
paddle_tpu_torch.observability.pod_trace` are the I/O around it.
"""
from __future__ import annotations

import glob
import json
import os
import re
import statistics
from typing import Dict, List, Optional, Tuple

# merged-lane thread id for the synthesized per-rank step band (real thread
# idents are large; 0 is never a live ident in practice)
_STEP_BAND_TID = 0

_DUMP_NAME_RE = re.compile(r"flight_r(\d+)_")


# ---- loading ----------------------------------------------------------------

def load_dump(path: str) -> dict:
    """One flight dump, parsed and minimally validated."""
    with open(path) as f:
        payload = json.load(f)
    if not isinstance(payload, dict) or (
            "steps" not in payload and "trace_events" not in payload):
        raise ValueError(f"{path}: not a flight dump (no steps/trace_events)")
    payload.setdefault("steps", [])
    payload.setdefault("trace_events", [])
    payload["_path"] = path
    return payload


def dump_rank(dump: dict) -> int:
    """The dump's gang rank: the payload field, else the filename tag."""
    r = dump.get("rank")
    if r is not None:
        return int(r)
    m = _DUMP_NAME_RE.search(os.path.basename(dump.get("_path", "")))
    return int(m.group(1)) if m else 0


def find_rank_dumps(dump_dir: str,
                    exclude_reasons=frozenset({"gang_failure"})) \
        -> Dict[int, dict]:
    """Newest loadable flight dump per rank in `dump_dir` (newest by
    payload wall_time, then file mtime — N ranks share the dir, each file
    rank-tagged in payload and name). `gang_failure` dumps are excluded by
    default: they are the SUPERVISOR's own black box (rank 0 by env
    default) and would otherwise shadow worker rank 0's dump."""
    best: Dict[int, Tuple[float, float, dict]] = {}
    for path in sorted(glob.glob(os.path.join(dump_dir, "*.json"))):
        try:
            dump = load_dump(path)
        except (OSError, ValueError, json.JSONDecodeError):
            continue
        if dump.get("reason") in exclude_reasons:
            continue
        rank = dump_rank(dump)
        key = (float(dump.get("wall_time") or 0.0), os.path.getmtime(path))
        if rank not in best or key > best[rank][:2]:
            best[rank] = (*key, dump)
    return {rank: entry[2] for rank, entry in sorted(best.items())}


# ---- clock alignment --------------------------------------------------------

def clock_offset_us(dump: dict) -> float:
    """trace-clock → wall-clock offset (µs) for one dump. Prefers the
    back-to-back `clock` handshake pair; a dump without one (older format)
    falls back to assuming the dump was written at its last event."""
    clock = dump.get("clock") or {}
    if "wall_time_us" in clock and "trace_ts_us" in clock:
        return float(clock["wall_time_us"]) - float(clock["trace_ts_us"])
    last_ts = max(
        [e["ts"] + e.get("dur", 0.0)
         for e in dump.get("trace_events", ()) if "ts" in e]
        + [s["t1_us"] for s in dump.get("steps", ())
           if s.get("t1_us") is not None],
        default=0.0)
    return float(dump.get("wall_time") or 0.0) * 1e6 - last_ts


def aligned_steps(dump: dict) -> List[dict]:
    """The dump's step records with t0/t1 shifted onto the wall clock."""
    off = clock_offset_us(dump)
    out = []
    for s in dump.get("steps", ()):
        rec = dict(s)
        if rec.get("t0_us") is not None:
            rec["t0_us"] = rec["t0_us"] + off
        if rec.get("t1_us") is not None:
            rec["t1_us"] = rec["t1_us"] + off
        out.append(rec)
    return out


def _collective_markers(dump: dict) -> List[dict]:
    """Aligned collective correlation markers: [{key, kind, step, ts}]."""
    off = clock_offset_us(dump)
    out = []
    for e in dump.get("trace_events", ()):
        if e.get("cat") != "collective":
            continue
        args = e.get("args") or {}
        key = args.get("key")
        if not key or "ts" not in e:
            continue
        out.append({"key": str(key), "kind": args.get("kind", "?"),
                    "step": args.get("step"), "ts": e["ts"] + off,
                    "tid": e.get("tid", _STEP_BAND_TID)})
    return out


# ---- timeline merge ---------------------------------------------------------

def merge_timeline(dumps: Dict[int, dict],
                   anchor_us: Optional[float] = None) -> Tuple[List[dict],
                                                               dict]:
    """Merge per-rank dumps into one chrome-trace event list.

    Per-rank process lanes: every event's pid is rewritten to the RANK
    (stable, human-meaningful, collision-free even when two hosts reuse a
    pid) with fresh process_name/process_sort_index/process_labels
    metadata. Timestamps are clock-aligned and re-zeroed at `anchor_us`
    (default: the earliest aligned event). Matching collective correlation
    keys across ranks become lane-crossing flow arrows
    (cat "pod_collective": "s" on the first-arriving rank, "t" steps on
    middles, "f" on the last — the arrow points at who everyone waited
    for). Returns (events, meta)."""
    events: List[dict] = []
    per_rank_offset = {r: clock_offset_us(d) for r, d in dumps.items()}
    if anchor_us is None:
        firsts = []
        for rank, dump in dumps.items():
            off = per_rank_offset[rank]
            firsts += [e["ts"] + off for e in dump.get("trace_events", ())
                       if "ts" in e]
            firsts += [s["t0_us"] + off for s in dump.get("steps", ())
                       if s.get("t0_us") is not None]
        anchor_us = min(firsts, default=0.0)

    key_arrivals: Dict[str, List[dict]] = {}
    for rank, dump in sorted(dumps.items()):
        off = per_rank_offset[rank] - anchor_us
        world = dump.get("world", len(dumps))
        role = dump.get("role", "trainer")
        events += [
            {"name": "process_name", "ph": "M", "pid": rank,
             "args": {"name": f"rank {rank} ({role})"}},
            {"name": "process_sort_index", "ph": "M", "pid": rank,
             "args": {"sort_index": rank}},
            {"name": "process_labels", "ph": "M", "pid": rank,
             "args": {"labels": f"rank={rank},world={world},role={role},"
                                f"pid={dump.get('pid', '?')}"}},
            {"name": "thread_name", "ph": "M", "pid": rank,
             "tid": _STEP_BAND_TID, "args": {"name": "steps"}},
        ]
        for e in dump.get("trace_events", ()):
            if e.get("ph") == "M":
                # per-rank process metadata is re-emitted above with
                # pid=rank; the dumps' own (original-pid) copies would
                # create phantom lanes
                if str(e.get("name", "")).startswith("process_"):
                    continue
                ev = dict(e)
                ev["pid"] = rank
                events.append(ev)
                continue
            if "ts" not in e:
                continue
            ev = dict(e)
            ev["pid"] = rank
            ev["ts"] = e["ts"] + off
            events.append(ev)
            if e.get("cat") == "collective":
                key = (e.get("args") or {}).get("key")
                if key:
                    arr = key_arrivals.setdefault(str(key), [])
                    # first marker per (key, rank) wins — same dedup as
                    # collective_telemetry: a cached-window re-dispatch
                    # re-stamps the key within one rank, and an intra-rank
                    # gap must never become a "cross-rank" arrow/skew
                    if not any(a["rank"] == rank for a in arr):
                        arr.append(
                            {"rank": rank, "ts": ev["ts"],
                             "tid": ev.get("tid", _STEP_BAND_TID),
                             "kind": (e.get("args") or {}).get("kind", "?"),
                             "step": (e.get("args") or {}).get("step")})
        # synthesized per-rank step band: one "X" per closed flight step,
        # so even a spans-sparse dump shows its step cadence at a glance
        for s in dump.get("steps", ()):
            if s.get("t0_us") is None or s.get("t1_us") is None:
                continue
            events.append({
                "name": f"step {s.get('step')}", "ph": "X",
                "cat": "flight_step", "pid": rank, "tid": _STEP_BAND_TID,
                "ts": s["t0_us"] + off, "dur": s["t1_us"] - s["t0_us"],
                "args": {"step": s.get("step"), "exe": s.get("exe"),
                         "status": s.get("status")}})

    flow_pairs = 0
    flow_id = 0
    for key in sorted(key_arrivals):
        arrivals = sorted(key_arrivals[key], key=lambda a: a["ts"])
        if len({a["rank"] for a in arrivals}) < 2:
            continue
        flow_id += 1
        flow_pairs += 1
        skew = arrivals[-1]["ts"] - arrivals[0]["ts"]
        base = {"name": "pod_collective", "cat": "pod_collective",
                "id": flow_id,
                "args": {"key": key, "kind": arrivals[0]["kind"],
                         "step": arrivals[0]["step"],
                         "skew_us": round(skew, 3),
                         "last_rank": arrivals[-1]["rank"]}}
        for i, a in enumerate(arrivals):
            ev = dict(base, pid=a["rank"], tid=a["tid"], ts=a["ts"],
                      ph=("s" if i == 0
                          else "f" if i == len(arrivals) - 1 else "t"))
            if ev["ph"] == "f":
                ev["bp"] = "e"
            events.append(ev)

    meta = {"anchor_us": anchor_us, "ranks": sorted(dumps),
            "flow_pairs": flow_pairs,
            "collective_keys": len(key_arrivals)}
    return events, meta


# ---- collective telemetry ---------------------------------------------------

def collective_telemetry(dumps: Dict[int, dict]) -> List[dict]:
    """Per-correlation-key arrival decomposition across ranks, slowest
    stall first: who arrived when, the spread, and how long each punctual
    rank waited for the last one."""
    arrivals: Dict[str, dict] = {}
    for rank, dump in sorted(dumps.items()):
        for m in _collective_markers(dump):
            rec = arrivals.setdefault(
                m["key"], {"key": m["key"], "kind": m["kind"],
                           "step": m["step"], "arrivals": {}})
            # first marker per (key, rank) wins: run_steps re-dispatch of a
            # cached window re-stamps the same key within one rank
            rec["arrivals"].setdefault(rank, m["ts"])
    rows = []
    for rec in arrivals.values():
        arr = rec["arrivals"]
        if len(arr) < 2:
            continue
        first_rank = min(arr, key=arr.get)
        last_rank = max(arr, key=arr.get)
        last_ts = arr[last_rank]
        rows.append({
            "key": rec["key"], "kind": rec["kind"], "step": rec["step"],
            "arrivals_us": {str(r): round(t, 3) for r, t in sorted(
                arr.items())},
            "skew_us": round(last_ts - arr[first_rank], 3),
            "first_rank": first_rank, "last_rank": last_rank,
            "waits_us": {str(r): round(last_ts - t, 3)
                         for r, t in sorted(arr.items())},
        })
    rows.sort(key=lambda r: -r["skew_us"])
    return rows


# ---- straggler report -------------------------------------------------------

def suspect_from_heartbeats(heartbeats: Dict[int, dict]) \
        -> Optional[Tuple[int, str]]:
    """LIVE straggler naming from the supervisor's heartbeat snapshot
    ({rank: {"step", "step_ms", ...}}): the rank furthest behind in step
    count, else the one with a clearly outlying step duration. Returns
    (rank, reason) or None when nothing stands out."""
    steps = {}
    for r, hb in heartbeats.items():
        if not isinstance(hb, dict) or not hb:
            continue        # never checked in — reported separately
        s = hb.get("step")
        # checked in but no step note yet: the most-behind state there is
        # (a trainer wedged before its first step) — score it as step 0
        steps[r] = int(s) if s is not None else 0
    if steps and any(s > 0 for s in steps.values()) \
            and max(steps.values()) - min(steps.values()) >= 1:
        suspect = min(steps, key=lambda r: (steps[r],
                                            -(heartbeats[r].get("step_ms")
                                              or 0.0)))
        return suspect, (f"last step {steps[suspect]} vs gang max "
                         f"{max(steps.values())}")
    durs = {r: float(hb["step_ms"]) for r, hb in heartbeats.items()
            if isinstance(hb, dict) and hb.get("step_ms") is not None}
    if len(durs) >= 2:
        med = statistics.median(durs.values())
        worst = max(durs, key=durs.get)
        if med > 0 and durs[worst] > 1.5 * med:
            return worst, (f"step_ms {durs[worst]:.1f} vs gang median "
                           f"{med:.1f}")
    return None


def straggler_report(dumps: Dict[int, dict],
                     heartbeats: Optional[Dict[int, dict]] = None,
                     top_k: int = 10,
                     stall_floor_us: float = 1000.0) -> dict:
    """The post-hoc pod health report: per-rank step stats, per-rank collective-stall
    attribution, a `straggler_score` per rank, and the top-K slowest
    collectives by arrival skew. `stall_floor_us` is the significance
    floor for "arrived last" attribution: in a healthy gang SOME rank is
    always trivially last by microseconds, and counting that would name a
    false suspect — only skews past the floor count."""
    heartbeats = heartbeats or {}
    telemetry = collective_telemetry(dumps)

    ranks: Dict[int, dict] = {}
    for rank, dump in sorted(dumps.items()):
        durs_ms = [(s["t1_us"] - s["t0_us"]) / 1000.0
                   for s in dump.get("steps", ())
                   if s.get("t0_us") is not None
                   and s.get("t1_us") is not None]
        step_idxs = [int(s["step"]) for s in dump.get("steps", ())
                     if s.get("step") is not None]
        hb = heartbeats.get(rank) or {}
        last = max(step_idxs, default=None)
        if hb.get("step") is not None:
            last = max(int(hb["step"]), last if last is not None else -1)
        ranks[rank] = {
            "steps_recorded": len(step_idxs),
            "last_step": last,
            "mean_step_ms": (round(statistics.fmean(durs_ms), 3)
                             if durs_ms else None),
            "max_step_ms": round(max(durs_ms), 3) if durs_ms else None,
            "total_step_ms": round(sum(durs_ms), 3) if durs_ms else 0.0,
            "heartbeat_step_ms": hb.get("step_ms"),
            "collectives_last": 0,
            "collective_wait_ms": 0.0,
        }
    for row in telemetry:
        last_rank = row["last_rank"]
        if last_rank in ranks and row["skew_us"] >= stall_floor_us:
            ranks[last_rank]["collectives_last"] += 1
        for r_str, wait_us in row["waits_us"].items():
            r = int(r_str)
            if r in ranks:
                ranks[r]["collective_wait_ms"] = round(
                    ranks[r]["collective_wait_ms"] + wait_us / 1000.0, 3)

    gang_max_step = max(
        (info["last_step"] for info in ranks.values()
         if info["last_step"] is not None), default=0)
    means = [info["mean_step_ms"] for info in ranks.values()
             if info["mean_step_ms"] is not None]
    # gang-median step time also folds in heartbeat-only durations (a rank
    # whose dump died early still reported step_ms through its heartbeat)
    hb_means = [info["heartbeat_step_ms"] for info in ranks.values()
                if info["heartbeat_step_ms"] is not None]
    median_ms = statistics.median(means or hb_means or [0.0])

    n_keys = max(1, len(telemetry))
    for rank, info in ranks.items():
        frac_last = info["collectives_last"] / n_keys
        # no closed step AND no heartbeat step note is the most-wedged
        # state there is (stuck before its first step) — maximal lag, not
        # zero, or the stuck rank would be invisible to the score
        step_lag = (gang_max_step if info["last_step"] is None
                    else gang_max_step - info["last_step"])
        lag_frac = step_lag / max(1, gang_max_step)
        mean_ms = (info["mean_step_ms"]
                   if info["mean_step_ms"] is not None
                   else info["heartbeat_step_ms"])
        slow_frac = (min(3.0, mean_ms / median_ms - 1.0)
                     if mean_ms is not None and median_ms > 0 else 0.0)
        slow_frac = max(0.0, slow_frac)
        info["straggler_score"] = round(frac_last + lag_frac + slow_frac, 4)
        info["score_parts"] = {
            "collectives_last_frac": round(frac_last, 4),
            "step_lag_frac": round(lag_frac, 4),
            "step_time_excess": round(slow_frac, 4)}

    # a genuine straggler scores >= ~0.9 (last at most gated collectives,
    # or a full step behind, or 20%+ slower steps); healthy-gang noise
    # (ms-level jitter on the step-time ratio) stays well under 0.2
    suspect = None
    if ranks:
        best = max(ranks, key=lambda r: ranks[r]["straggler_score"])
        if ranks[best]["straggler_score"] > 0.2:
            suspect = best

    span_us = 0.0
    firsts, lasts = [], []
    for rank, dump in dumps.items():
        for s in aligned_steps(dump):
            if s.get("t0_us") is not None:
                firsts.append(s["t0_us"])
            if s.get("t1_us") is not None:
                lasts.append(s["t1_us"])
    if firsts and lasts:
        span_us = max(lasts) - min(firsts)
    total_skew_us = sum(row["skew_us"] for row in telemetry)
    mean_vals = [v for v in means if v is not None]
    summary = {
        "step_time_spread_ms": (round(max(mean_vals) - min(mean_vals), 3)
                                if len(mean_vals) >= 2 else 0.0),
        "collective_stall_fraction": (
            round(min(1.0, total_skew_us / span_us), 4) if span_us > 0
            else 0.0),
        "timeline_span_ms": round(span_us / 1000.0, 3),
        "collective_keys_matched": len(telemetry),
    }

    return {
        "format": 1,
        "world": len(ranks),
        "stall_floor_us": stall_floor_us,
        "gang_max_step": gang_max_step,
        "ranks": {str(r): info for r, info in sorted(ranks.items())},
        "suspect": suspect,
        "summary": summary,
        "top_stalls": telemetry[:top_k],
    }


# ---- pod dump ---------------------------------------------------------------

def write_pod_dump(dumps: Dict[int, dict], out_dir: str,
                   heartbeats: Optional[Dict[int, dict]] = None,
                   anchor_us: Optional[float] = None,
                   extra_meta: Optional[dict] = None,
                   top_k: int = 10) -> dict:
    """Write the merged pod artifacts next to each other in `out_dir`:
    `pod_trace.json` (one Perfetto timeline, per-rank lanes + cross-rank
    collective flows) and `straggler_report.json`. Returns their paths
    plus the merge meta."""
    os.makedirs(out_dir, exist_ok=True)
    events, meta = merge_timeline(dumps, anchor_us=anchor_us)
    if extra_meta:
        meta = dict(meta, **extra_meta)
    trace_path = os.path.join(out_dir, "pod_trace.json")
    with open(trace_path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": meta}, f)
    report = straggler_report(dumps, heartbeats=heartbeats, top_k=top_k)
    report_path = os.path.join(out_dir, "straggler_report.json")
    with open(report_path, "w") as f:
        json.dump(report, f, indent=1)
    return {"trace": trace_path, "report": report_path, "meta": meta,
            "suspect": report["suspect"], "summary": report["summary"]}


def format_stall_table(telemetry: List[dict], top_k: int = 10) -> str:
    """Human-readable top-K "slowest collectives by stall" table (what
    `python -m paddle_tpu_torch.observability.pod_trace` prints)."""
    lines = [f"{'key':<18} {'kind':<18} {'step':>4} {'skew_ms':>8} "
             f"{'first':>5} {'last':>4}"]
    for row in telemetry[:top_k]:
        lines.append(
            f"{row['key']:<18} {row['kind']:<18} "
            f"{str(row['step']):>4} {row['skew_us'] / 1000.0:>8.3f} "
            f"r{row['first_rank']:<4} r{row['last_rank']:<3}")
    if not telemetry:
        lines.append("(no cross-rank collective keys matched)")
    return "\n".join(lines)
