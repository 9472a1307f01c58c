"""Global flags registry (the executor, serving, observability, resilience,
data loading, process and ZeRO subset of paddle_tpu/flags.py, with the reference's
defaults).

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
    # --- executor (framework/executor.py) ----------------------------------
    "FLAGS_layer_scan": (False, "roll isomorphic per-layer segments into "
                                "one __layer_scan__ op at fleet minimize "
                                "time (parallel/transforms.py "
                                "apply_layer_scan; the same switch as "
                                "DistributedStrategy.layer_scan)"),
    "FLAGS_async_dispatch": (False, "Executor.run/run_steps default to "
                             "sync=False: fetches come back as lazy "
                             "FetchHandles that materialise to numpy only "
                             "on access, so the host never blocks on steps "
                             "nobody reads (framework/fetch.py). Sync stays "
                             "the default; falls back to sync while a fault "
                             "plan is installed"),
    "FLAGS_dispatch_queue_depth": (2, "max pre-staged feed windows held per "
                                   "tag by Executor.stage() (the host-side "
                                   "dispatch queue): while window n runs, "
                                   "window n+1's feeds are coerced and "
                                   "copied to the device ahead of time "
                                   "(counter executor.dispatch_queue_depth)"),
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
    "FLAGS_serving_failover_budget": (2, "re-dispatches one request may "
                                      "take after engine deaths before it "
                                      "fails with RequestFailedError "
                                      "(serving/resilience.py; each "
                                      "re-dispatch replays the "
                                      "deterministic decode on a healthy "
                                      "replica)"),
    "FLAGS_serving_health_interval_ms": (200.0, "ServingFrontend health-"
                                         "loop tick: suspect engines are "
                                         "confirmed dead and dead engines "
                                         "resurrected (reset + canary "
                                         "gate) at this cadence"),
    "FLAGS_serving_resurrect_budget": (3, "canary-gated resurrection "
                                       "attempts per engine death "
                                       "(RetryPolicy max_attempts); "
                                       "exhaustion parks the engine dead "
                                       "(serving.resurrect_gave_up)"),
    "FLAGS_serving_drain_timeout_ms": (30000.0, "graceful-drain bound: how "
                                       "long drain() waits for in-flight "
                                       "slots to decode to completion "
                                       "before stopping the engine"),
    "FLAGS_step_deadline_ms": (0.0, "serving window watchdog: bound each "
                               "window's (and verify pass's) static-input "
                               "copy, graph replay and .cpu() by this "
                               "wall-clock deadline; a trip raises the "
                               "typed DeadlineExceededError with a thread-"
                               "stack dump and a flight-recorder dump "
                               "(framework/executor.py _deadline_call). "
                               "0 disables the watchdog"),
    # --- observability (observability/) -----------------------------------
    "FLAGS_trace_events": (True, "record host RecordEvent spans, flow "
                           "events and instants into the bounded trace "
                           "ring (observability/trace.py); 0 makes span "
                           "recording a no-op"),
    "FLAGS_trace_buffer_events": (65536, "trace ring capacity in events; "
                                  "the oldest drop past it, counted in the "
                                  "trace.dropped_events metric"),
    "FLAGS_flight_recorder": (True, "keep the last FLAGS_flight_steps "
                              "steps' wall windows and metric deltas and "
                              "dump them (with the trace ring) on "
                              "watchdog trips (observability/flight.py)"),
    "FLAGS_flight_steps": (16, "flight-recorder step-ring depth"),
    "FLAGS_flight_dump_dir": ("", "where flight dumps land; empty = "
                              "<tmpdir>/paddle_tpu_torch_flight"),
    # --- resilience (resilience/) ------------------------------------------
    "FLAGS_fault_plan": ("", "fault-injection plan spec, e.g. "
                             "'serving.window:error:at=2'"),
    "FLAGS_fault_seed": (0, "seed for probabilistic (p=) fault rules and "
                            "retry jitter"),
    "FLAGS_snapshot_steps": (0, "in-memory snapshot cadence "
                                "(resilience/snapshot.py): every N training "
                                "steps of a program, a double-buffered copy "
                                "of the portable training state from the "
                                "device to pinned host memory, taken after "
                                "the step or run_steps window (0 = off); "
                                "SIGTERM flushes the newest one to "
                                "FLAGS_snapshot_dir"),
    "FLAGS_snapshot_dir": ("", "root for flushed snapshots and recovery "
                               "stamps; empty resolves PADDLE_SNAPSHOT_DIR, "
                               "then a per-process directory under the "
                               "temp dir"),
    "FLAGS_loss_spike_factor": (10.0, "TrainingGuard: a loss above this "
                                "multiple of the trailing-window median (or "
                                "any NaN/Inf) rolls back to the last good "
                                "snapshot and skips the batch"),
    "FLAGS_rollback_budget": (2, "poison-batch rollbacks TrainingGuard "
                                 "performs before raising "
                                 "RollbackExhausted"),
    "FLAGS_dataloader_max_respawns": (0, "respawn budget for abnormally-"
                                         "dead DataLoader workers "
                                         "(0 = fail fast, naming the "
                                         "worker and its exit code)"),
    # --- processes (distributed/) ------------------------------------------
    "FLAGS_gloo_timeout_ms": (60000.0, "gloo rendezvous and collective "
                              "timeout: the process group's timeout "
                              "(distributed/parallel.py) and each round of "
                              "the host Gloo store (distributed/gloo.py); a "
                              "dead peer raises instead of hanging"),
    "FLAGS_rendezvous_deadline_ms": (60000.0, "gang-launch rendezvous "
                                     "deadline (distributed/launch.py): "
                                     "every worker must check in (create "
                                     "its heartbeat file) within this "
                                     "budget or the supervisor kills the "
                                     "whole gang and raises "
                                     "DeadlineExceededError"),
    "FLAGS_launch_heartbeat_interval_ms": (1000.0, "how often each "
                                           "launched worker's heartbeat "
                                           "thread touches its liveness "
                                           "file; the supervisor treats a "
                                           "file stale past the launcher's "
                                           "--heartbeat_timeout_ms as a "
                                           "hung worker"),
    "FLAGS_fingerprint_steps": (0, "cross-replica divergence sentinel "
                                   "cadence (resilience/integrity.py): "
                                   "fingerprint the training state and "
                                   "all-gather/compare the digests across "
                                   "ranks every N steps (0 = disabled)"),
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
