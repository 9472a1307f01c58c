"""PyTorch port, observability and its small companions
(paddle_tpu_torch/observability/{metrics,trace,flight}.py, monitor.py,
flags.py, framework/errors.py, framework/executor.py `_deadline_call`),
against the reference where the reference has the same function.

* The chrome-trace flow, span and instant events of one served batch:
  names and counts equal to the reference DecodeEngine's on the same
  requests (tiny GPT, f32, all requests queued before the service thread
  starts, so both engines run the same windows).
* Inside the port: the serving metrics and request flows (a mirror of
  tests/test_serving.py:236); metrics `get` / `delta` against the
  reference registry driven by the same operations (equal); the bounded
  trace ring and its drop count; chrome export; flight-recorder lanes,
  in-flight steps and dumps; the watchdog under no_grad, its typed trip
  and its abandoned worker; the error taxonomy and the flag defaults
  against the reference.
"""
import collections
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid

from paddle_tpu_torch import flags as port_flags
from paddle_tpu_torch import monitor as port_monitor
from paddle_tpu_torch import serving as port
from paddle_tpu_torch.framework import errors as port_errors
from paddle_tpu_torch.framework.executor import _deadline_call
from paddle_tpu_torch.models import gpt_decode as port_decode
from paddle_tpu_torch.models.gpt import GPTConfig as PortGPTConfig
from paddle_tpu_torch.observability import flight as port_flight
from paddle_tpu_torch.observability import metrics as port_metrics
from paddle_tpu_torch.observability import trace as port_trace

GEO = dict(max_slots=3, block_size=8, num_blocks=24, max_len=32, window=4)


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, jax params, port cfg, port params on the CPU)."""
    from paddle_tpu.models.gpt import GPTConfig, build_lm_program
    from paddle_tpu.models import gpt_decode
    from paddle_tpu.testing import reset_programs
    reset_programs(seed=0)
    cfg = GPTConfig.tiny()
    cfg.max_position = 64
    build_lm_program(cfg)
    exe = fluid.Executor()
    exe.run(fluid.default_startup_program())
    params = gpt_decode.params_from_scope(cfg)
    port_cfg = PortGPTConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(PortGPTConfig)})
    arrays = {n: np.asarray(a) for n, a in params.items()}
    port_params = port_decode.params_from_numpy(port_cfg, arrays,
                                                device="cpu")
    return cfg, params, port_cfg, port_params


def _requests(cfg, req_cls):
    rng = np.random.RandomState(2)
    return [req_cls(prompt=rng.randint(0, cfg.vocab_size, (n,)),
                    max_new_tokens=m, uid=f"m{i}")
            for i, (n, m) in enumerate(((6, 4), (9, 7), (3, 5)))]


def _serve_queued_first(eng, reqs, monkeypatch):
    """Queue every request before the service thread starts, then start
    it: the windows do not depend on thread timing."""
    monkeypatch.setattr(eng, "_ensure_thread", lambda: None)
    handles = [eng.submit(r, bounded=False) for r in reqs]
    monkeypatch.undo()
    eng.start()
    return [h.result(timeout=240) for h in handles]


def _event_counts(events):
    return collections.Counter(
        (e["ph"], e["name"]) for e in events if e["ph"] in "Xsfi")


def test_served_batch_trace_events_equal_reference(tiny, monkeypatch):
    from paddle_tpu.observability import trace as ref_trace
    from paddle_tpu.serving import DecodeEngine as RefEngine
    from paddle_tpu.serving import Request as RefRequest
    cfg, params = tiny[0], tiny[1]
    ref = RefEngine(params, cfg, decode_kernel=False, **GEO)
    try:
        ref_trace.clear()
        want_tokens = [c.tokens for c in _serve_queued_first(
            ref, _requests(cfg, RefRequest), monkeypatch)]
        want = _event_counts(ref_trace.events())
    finally:
        ref.stop()
    eng = port.DecodeEngine(tiny[3], tiny[2], device="cpu", **GEO)
    try:
        port_trace.clear()
        got_tokens = [c.tokens for c in _serve_queued_first(
            eng, _requests(cfg, port.Request), monkeypatch)]
        got = _event_counts(port_trace.events())
    finally:
        eng.stop()
    assert got_tokens == want_tokens
    assert got == want
    assert got[("X", "serving.window")] >= 2
    assert got[("s", "serving.request")] == got[("f", "serving.request")] \
        == 3


def test_serving_metrics_and_flow_events(tiny):
    for name in ("serving.ttft_ms", "serving.tpot_ms"):
        port_metrics.reset(name)
    port_trace.clear()
    eng = port.DecodeEngine(tiny[3], tiny[2], device="cpu", **GEO)
    rng = np.random.RandomState(2)
    try:
        comps = eng.generate(
            [port.Request(prompt=rng.randint(0, tiny[0].vocab_size, (6,)),
                          max_new_tokens=4, uid=f"m{i}") for i in range(3)],
            timeout=120)
    finally:
        eng.stop()
    assert all(c.ok for c in comps)
    snap = port_metrics.snapshot()
    assert snap["serving.ttft_ms"]["count"] == 3
    assert snap["serving.tpot_ms"]["count"] == 3
    assert port_metrics.get("serving.completed") >= 3
    evs = port_trace.events()
    starts = {e["args"]["uid"] for e in evs
              if e["ph"] == "s" and e["name"] == "serving.request"}
    ends = {e["args"]["uid"] for e in evs
            if e["ph"] == "f" and e["name"] == "serving.request"}
    assert {"m0", "m1", "m2"} <= starts and {"m0", "m1", "m2"} <= ends
    spans = {e["name"] for e in evs if e["ph"] == "X"}
    assert {"serving.window", "serving.prefill"} <= spans
    owners = {s["exe"] for s in port_flight.steps()}
    assert 0x5E0 + eng._id in owners


def _drive(m):
    m.reset()
    m.inc("c", 2.0)
    m.set_gauge("g", 4.0)
    m.observe("h", 1.5)
    snap = m.snapshot(percentiles=False)
    m.inc("c")
    m.inc("new")
    m.set_gauge("g", 5.0)
    m.observe("h", 2.5)
    m.observe("h2", 7.0)
    return (m.delta(snap), m.get("c"), m.get("g"), m.get("h"),
            m.get("absent"))


def test_metrics_get_and_delta_equal_reference():
    from paddle_tpu.observability import metrics as ref_metrics
    try:
        assert _drive(port_metrics) == _drive(ref_metrics)
    finally:
        port_metrics.reset()
        ref_metrics.reset()


def test_monitor_is_a_view_of_the_registry():
    from paddle_tpu import monitor as ref_monitor
    port_metrics.reset()
    port_monitor.stat_add("executor.x", 2)
    port_monitor.stat_add("executor.x")
    assert port_monitor.stat_get("executor.x") == 3
    assert port_metrics.snapshot()["executor.x"] == \
        {"type": "counter", "value": 3}
    assert port_monitor.stat_get("absent") == ref_monitor.stat_get("absent")
    port_metrics.reset()


def test_trace_ring_is_bounded_and_counts_drops():
    port_trace.clear()
    port_trace.set_buffer_size(16)
    try:
        port_metrics.reset("trace.dropped_events")
        for i in range(40):
            port_trace.instant("tick", args={"i": i})
        evs = port_trace.events()
        assert len(evs) == 16 and evs[-1]["args"]["i"] == 39
        assert port_trace.dropped_events() == 24
        assert port_metrics.get("trace.dropped_events") == 24
    finally:
        port_trace.set_buffer_size(
            port_flags.flag("FLAGS_trace_buffer_events"))
        port_trace.clear()


def test_trace_disabled_records_nothing():
    port_trace.clear()
    port_flags.set_flags({"FLAGS_trace_events": False})
    try:
        with port_trace.RecordEvent("x"):
            port_trace.instant("y")
            port_trace.flow_start("f", port_trace.new_flow())
        assert port_trace.events() == []
    finally:
        port_flags.set_flags({"FLAGS_trace_events": True})


def test_chrome_trace_export_links_a_flow_across_threads(tmp_path):
    port_trace.clear()
    fid = port_trace.new_flow()
    with port_trace.RecordEvent("dispatch", args={"step": 1}) as ev:
        ev.add_args(extra=2)
        port_trace.flow_start("step", fid)
    t = threading.Thread(target=port_trace.flow_end, args=("step", fid),
                         name="drainer")
    t.start()
    t.join(10)
    assert not t.is_alive()
    port_trace.counter_event("cost", {"a": 1, "b": 2})
    path = port_trace.export_chrome_trace(str(tmp_path / "t.json"))
    evs = json.load(open(path))["traceEvents"]
    flows = [e for e in evs if e["ph"] in "sf"]
    assert [e["ph"] for e in flows] == ["s", "f"]
    assert flows[0]["id"] == flows[1]["id"] == fid
    assert flows[0]["tid"] != flows[1]["tid"]
    names = {e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "drainer" in names
    (span,) = [e for e in evs if e["ph"] == "X"]
    assert span["args"] == {"step": 1, "extra": 2}


def test_flight_lanes_in_flight_steps_and_dump(tmp_path):
    port_flight.clear()
    port_metrics.reset()
    port_flight.begin_step(1, owner=7)
    port_flight.begin_step(1, owner=8)       # same index, another lane
    port_metrics.inc("serving.windows")
    port_flight.end_step(1, status="ok", owner=7)
    path = port_flight.dump("test", path=str(tmp_path / "d.json"),
                            extra={"why": "pinned"})
    d = json.load(open(path))
    by_lane = {s["exe"]: s for s in d["steps"]}
    assert by_lane[7]["status"] == "ok"
    assert by_lane[7]["metrics_delta"]["serving.windows"]["value"] == 1
    assert by_lane[8]["status"] == "in_flight"
    assert d["reason"] == "test" and d["extra"] == {"why": "pinned"}
    assert d["metrics"]["executor.steps"]["value"] == 2
    port_flight.end_step(1, status="error", owner=8)
    port_flight.end_step(1, status="late", owner=8)   # already closed
    assert [s["status"] for s in port_flight.steps()] == ["ok", "error"]
    port_flags.set_flags({"FLAGS_flight_recorder": False})
    try:
        assert port_flight.dump("off") is None
    finally:
        port_flags.set_flags({"FLAGS_flight_recorder": True})
        port_flight.clear()


def test_flight_ring_keeps_the_last_n_steps():
    port_flight.clear()
    port_flags.set_flags({"FLAGS_flight_steps": 3})
    try:
        for i in range(6):
            port_flight.begin_step(i)
            port_flight.end_step(i)
        assert [s["step"] for s in port_flight.steps()] == [3, 4, 5]
    finally:
        port_flags.set_flags({"FLAGS_flight_steps": 16})
        port_flight.clear()


def test_deadline_call_runs_under_no_grad_on_a_worker():
    seen = {}

    def fn():
        seen["grad"] = torch.is_grad_enabled()
        seen["thread"] = threading.current_thread().name
        return 41 + 1

    assert torch.is_grad_enabled()
    assert _deadline_call(fn, 5000.0, "fn") == 42
    assert seen == {"grad": False, "thread": "executor-step"}
    with pytest.raises(KeyError):
        _deadline_call(lambda: {}["missing"], 5000.0, "raises")


def test_deadline_call_trips_typed_and_leaves_its_worker(tmp_path):
    release = threading.Event()
    tripped = []
    port_flags.set_flags({"FLAGS_flight_dump_dir": str(tmp_path)})
    port_metrics.reset("executor.step_deadline_trips")
    try:
        with pytest.raises(port_errors.DeadlineExceededError) as ei:
            _deadline_call(lambda: release.wait(30.0), 50.0, "wedged",
                           on_trip=tripped.append)
        err = ei.value
        assert isinstance(err, TimeoutError)
        assert isinstance(err, port_errors.ExecutionTimeoutError)
        assert "wedged exceeded FLAGS_step_deadline_ms" in str(err)
        assert tripped == [err.worker]
        assert not err.worker.quiet(0.05)
        release.set()
        assert err.worker.quiet(10.0) and err.worker.value is True
        assert port_metrics.get("executor.step_deadline_trips") == 1
        (dump,) = tmp_path.glob("flight_*_step_deadline_*.json")
        assert json.load(open(dump))["extra"]["what"] == "wedged"
    finally:
        release.set()
        port_flags.set_flags({"FLAGS_flight_dump_dir": ""})


def test_error_taxonomy_matches_reference():
    from paddle_tpu.framework import errors as ref_errors
    for name in ("UNAVAILABLE", "EXECUTION_TIMEOUT", "UNIMPLEMENTED",
                 "INVALID_ARGUMENT", "NOT_FOUND"):
        assert int(getattr(port_errors.ErrorCode, name)) == \
            int(getattr(ref_errors.ErrorCode, name))
    for factory, cls, base in (
            ("Unavailable", "UnavailableError", RuntimeError),
            ("DeadlineExceeded", "DeadlineExceededError", TimeoutError)):
        e = getattr(port_errors, factory)("engine %d: %s", 3, "x")
        assert type(e) is getattr(port_errors, cls)
        assert isinstance(e, base) and str(e) == "engine 3: x"
        assert e.code == getattr(ref_errors, cls).code
    assert issubclass(port_errors.DeadlineExceededError,
                      port_errors.ExecutionTimeoutError)


def test_flag_defaults_equal_reference():
    from paddle_tpu import flags as ref_flags
    for name, (default, _) in port_flags._DEFS.items():
        assert default == ref_flags._DEFS[name][0], name
    for name in ("FLAGS_step_deadline_ms", "FLAGS_serving_failover_budget",
                 "FLAGS_serving_health_interval_ms",
                 "FLAGS_serving_resurrect_budget",
                 "FLAGS_serving_drain_timeout_ms", "FLAGS_trace_events",
                 "FLAGS_trace_buffer_events", "FLAGS_flight_recorder",
                 "FLAGS_flight_steps", "FLAGS_flight_dump_dir",
                 "FLAGS_fault_plan", "FLAGS_fault_seed"):
        assert name in port_flags._DEFS, name
