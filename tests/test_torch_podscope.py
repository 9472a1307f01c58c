"""PyTorch port, pod-scope observability
(paddle_tpu_torch/observability/podscope.py, pod_trace.py and the
executor's collective markers) against the reference's
(paddle_tpu/observability/podscope.py).

* The synthetic dumps of the reference's tests/test_podscope.py (per-rank
  trace epochs, cumulative stragglers, a killed rank with heartbeats, a
  rank with no closed step, an intra-rank re-stamp) go through both
  packages' `merge_timeline`, `collective_telemetry` and
  `straggler_report`; the JSON of each must be equal.
* `suspect_from_heartbeats`, `find_rank_dumps`, `write_pod_dump` and
  `format_stall_table` equal the reference's on the same inputs;
  `python -m paddle_tpu_torch.observability.pod_trace` writes the same
  artifacts.
* The executor's marker plan and keys: a fleet program at ZeRO stage 0
  and 1 (bucket ops) built in both packages gives the same plan and the
  same `s{step}.b{bucket}.q{seq}` keys; the flag turns the markers off.
"""
import copy
import json
import os

import numpy as np
import pytest

import test_podscope as ref_cases
from paddle_tpu.observability import podscope as ref_podscope
from paddle_tpu_torch.observability import podscope, pod_trace, trace

mk = ref_cases._mk_dump


def _restamp():
    d0 = mk(0, 1e9, n_steps=1)
    d1 = mk(1, 2e9, n_steps=1, lag_ms=20.0)
    d0["trace_events"].append(dict(d0["trace_events"][0],
                                   ts=d0["trace_events"][0]["ts"] + 5e5))
    return {0: d0, 1: d1}, None


SCENARIOS = {
    "epochs": lambda: ({0: mk(0, 5e9), 1: mk(1, 9e12)}, None),
    "slow_rank": lambda: ({0: mk(0, 1e9, step_ms=10.0),
                           1: mk(1, 2e9, step_ms=40.0, lag_ms=30.0)}, None),
    "healthy": lambda: ({0: mk(0, 1e9, step_ms=10.0),
                         1: mk(1, 2e9, step_ms=10.0, lag_ms=0.0001)}, None),
    "killed": lambda: ({0: mk(0, 1e9, n_steps=8),
                        1: mk(1, 2e9, n_steps=2, step_ms=300.0)},
                       {0: {"pid": 10, "step": 8, "step_ms": 10.0},
                        1: {"pid": 11, "step": 2, "step_ms": 300.0}}),
    "stepless": lambda: ({0: mk(0, 1e9, n_steps=6), 1: mk(1, 2e9,
                                                          n_steps=0)},
                         None),
    "restamp": _restamp,
    "four_ranks": lambda: ({r: mk(r, 1e9 * (r + 1), world=4,
                                  lag_ms=7.0 if r == 2 else 0.0)
                            for r in range(4)}, None),
}
FUNCS = ("merge_timeline", "collective_telemetry", "straggler_report")


def _call(mod, func, dumps, hb):
    dumps = copy.deepcopy(dumps)
    if func == "merge_timeline":
        return mod.merge_timeline(dumps)
    if func == "collective_telemetry":
        return mod.collective_telemetry(dumps)
    return mod.straggler_report(dumps, heartbeats=copy.deepcopy(hb))


def _json(value):
    return json.loads(json.dumps(value, sort_keys=True))


@pytest.mark.parametrize("func", FUNCS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_equal_to_reference_on_the_same_dumps(scenario, func):
    dumps, hb = SCENARIOS[scenario]()
    got = _json(_call(podscope, func, dumps, hb))
    want = _json(_call(ref_podscope, func, dumps, hb))
    assert got == want


def test_scenarios_read_as_the_reference_reads_them():
    """The port's report on its own names who the reference's tests name."""
    assert podscope.straggler_report(SCENARIOS["slow_rank"]()[0])[
        "suspect"] == 1
    assert podscope.straggler_report(SCENARIOS["healthy"]()[0])[
        "suspect"] is None
    dumps, hb = SCENARIOS["killed"]()
    rep = podscope.straggler_report(dumps, heartbeats=hb)
    assert rep["suspect"] == 1
    assert rep["ranks"]["1"]["score_parts"]["step_lag_frac"] == 0.75
    events, meta = podscope.merge_timeline(SCENARIOS["restamp"]()[0])
    ends = [e for e in events
            if e.get("cat") == "pod_collective" and e["ph"] == "f"]
    assert meta["flow_pairs"] == 1 and ends[0]["pid"] == 1


HEARTBEATS = [
    {0: {"step": 9, "step_ms": 10.0}, 1: {"step": 3, "step_ms": 400.0}},
    {0: {"step": 5, "step_ms": 10.0}, 1: {"step": 5, "step_ms": 99.0}},
    {0: {"step": 5, "step_ms": 10.0}, 1: {"step": 5, "step_ms": 11.0}},
    {0: {}, 1: {}},
    {0: {"pid": 3}, 1: {"pid": 4, "step": 2, "step_ms": 5.0}},
]


@pytest.mark.parametrize("hb", HEARTBEATS, ids=[
    "step_lag", "slow_step", "healthy", "empty", "no_step_note"])
def test_suspect_from_heartbeats_equal(hb):
    assert podscope.suspect_from_heartbeats(copy.deepcopy(hb)) == \
        ref_podscope.suspect_from_heartbeats(copy.deepcopy(hb))


def _write_dumps(d):
    def write(name, payload):
        with open(os.path.join(d, name), "w") as f:
            json.dump(payload, f)
    old, new = mk(0, 1e9), mk(0, 1e9)
    old["wall_time"], new["wall_time"] = 100.0, 200.0
    write("flight_r0_11_exit_1.json", old)
    write("flight_r0_11_exit_2.json", new)
    write("flight_r1_12_exit_1.json", mk(1, 2e9, lag_ms=40.0))
    sup = mk(0, 3e9, reason="gang_failure")
    sup["wall_time"] = 999.0
    write("flight_r0_99_gang_failure_1.json", sup)
    write("not_a_dump.json", {"hello": 1})


def test_find_rank_dumps_and_pod_dump_equal(tmp_path):
    d = str(tmp_path / "dumps")
    os.makedirs(d)
    _write_dumps(d)
    got, want = podscope.find_rank_dumps(d), ref_podscope.find_rank_dumps(d)
    assert sorted(got) == sorted(want) == [0, 1]
    assert got[0]["wall_time"] == want[0]["wall_time"] == 200.0
    hb = {0: {"step": 3, "step_ms": 10.0}, 1: {"step": 3, "step_ms": 10.0}}
    res = podscope.write_pod_dump(got, str(tmp_path / "port"),
                                  heartbeats=hb, anchor_us=5e5,
                                  extra_meta={"status": "ok"})
    ref = ref_podscope.write_pod_dump(want, str(tmp_path / "ref"),
                                      heartbeats=hb, anchor_us=5e5,
                                      extra_meta={"status": "ok"})
    assert res["suspect"] == ref["suspect"] == 1
    for key in ("trace", "report"):
        with open(res[key]) as f, open(ref[key]) as g:
            assert json.load(f) == json.load(g), key
    tel = podscope.collective_telemetry(got)
    assert podscope.format_stall_table(tel) == \
        ref_podscope.format_stall_table(
            ref_podscope.collective_telemetry(want))
    assert podscope.format_stall_table([]) == \
        ref_podscope.format_stall_table([])


def test_pod_trace_module_writes_the_artifacts(tmp_path, capsys):
    d = str(tmp_path / "dumps")
    os.makedirs(d)
    _write_dumps(d)
    with open(os.path.join(d, "heartbeats.json"), "w") as f:
        json.dump({"anchor_us": 5e5, "heartbeats": {
            "0": {"step": 3, "step_ms": 10.0},
            "1": {"step": 3, "step_ms": 10.0}}}, f)
    assert pod_trace.main([d, "--top-k", "5"]) == 0
    out = capsys.readouterr().out
    assert "cross-rank collective flow pairs: 3" in out
    assert "suspect: rank 1" in out
    with open(os.path.join(d, "pod", "straggler_report.json")) as f:
        port_report = json.load(f)
    ref = ref_podscope.straggler_report(
        ref_podscope.find_rank_dumps(d),
        heartbeats={0: {"step": 3, "step_ms": 10.0},
                    1: {"step": 3, "step_ms": 10.0}}, top_k=5)
    assert port_report == _json(ref)
    with pytest.raises(SystemExit):
        pod_trace.main([str(tmp_path / "empty_dir_absent")])


# --- the executor's collective markers --------------------------------------

def _fc_programs(stage):
    """The fc model through fleet at ZeRO `stage` (bucket ops), built in
    both packages."""
    import paddle_tpu as paddle
    import paddle_tpu.fluid as fluid
    from paddle_tpu.distributed import fleet as ref_fleet
    from paddle_tpu.testing import reset_programs as ref_reset
    from paddle_tpu_torch import initializer, layers, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import default_main_program
    from paddle_tpu_torch.layer_helper import ParamAttr
    from paddle_tpu_torch.testing import reset_programs

    reset_programs(0)
    init = initializer.TruncatedNormal(scale=0.3)
    x = layers.data(name="x", shape=[8], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    h = layers.fc(x, 16, act="relu",
                  param_attr=ParamAttr(name="w1", initializer=init),
                  bias_attr=ParamAttr(name="b1"))
    pred = layers.fc(h, 1, param_attr=ParamAttr(name="w2", initializer=init),
                     bias_attr=ParamAttr(name="b2"))
    loss = layers.mean(layers.square_error_cost(pred, y))
    fleet.init(is_collective=True)
    s = fleet.DistributedStrategy()
    s.sharding_stage = stage
    s.fuse_grad_size_in_mb = 0.0003
    fleet.distributed_optimizer(optimizer.Adam(1e-2), s).minimize(loss)
    port_main = default_main_program()

    ref_reset(0)
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(x, 16, act="relu",
                        param_attr=paddle.ParamAttr(name="w1"),
                        bias_attr=paddle.ParamAttr(name="b1"))
    pred = fluid.layers.fc(h, 1, param_attr=paddle.ParamAttr(name="w2"),
                           bias_attr=paddle.ParamAttr(name="b2"))
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    ref_fleet.init(is_collective=True)
    s = ref_fleet.DistributedStrategy()
    s.sharding_stage = stage
    s.fuse_grad_size_in_mb = 0.0003
    ref_fleet.distributed_optimizer(paddle.optimizer.Adam(1e-2),
                                    s).minimize(loss)
    return port_main, fluid.default_main_program()


def _keys(events):
    return [e["args"]["key"] for e in events if e.get("cat") == "collective"]


@pytest.mark.parametrize("stage", [0, 1])
def test_marker_plan_and_keys_equal_reference(stage):
    import paddle_tpu.fluid as fluid
    from paddle_tpu.observability import trace as ref_trace
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.framework import Executor
    port_main, ref_main = _fc_programs(stage)
    exe, ref_exe = Executor("cpu"), fluid.Executor()
    plan = exe._collective_marker_plan(port_main)
    assert plan == ref_exe._collective_marker_plan(ref_main)
    assert plan and {k for k, _ in plan} == (
        {"__bucket_sync__"} if stage == 0 else {"__zero_update__"})
    trace.clear()
    ref_trace.clear()
    exe._emit_collective_markers(port_main, 7)
    ref_exe._emit_collective_markers(ref_main, 7)
    got = _keys(trace.events())
    assert got == _keys(ref_trace.events())
    assert got == [f"s7.b{b}.q{q}" for q, (_, b) in enumerate(plan)]
    trace.clear()
    flags.set_flags({"FLAGS_collective_markers": 0})
    try:
        exe._emit_collective_markers(port_main, 8)
        assert _keys(trace.events()) == []
    finally:
        flags.set_flags({"FLAGS_collective_markers": 1})


def test_a_run_stamps_its_markers_under_its_flight_step():
    """Executor.run brackets each step in the flight recorder (the step
    the markers carry) and stamps them before the step's ops."""
    from paddle_tpu_torch.framework import Executor, default_startup_program
    from paddle_tpu_torch.observability import flight
    port_main, _ = _fc_programs(1)
    exe = Executor("cpu")
    exe.run(default_startup_program())
    trace.clear()
    flight.clear()
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(4, 8).astype(np.float32),
            "y": rng.randn(4, 1).astype(np.float32)}
    for _ in range(2):
        exe.run(port_main, feed=feed)
    steps = [s["step"] for s in flight.steps()
             if s["exe"] == exe._flight_owner]
    plan = exe._collective_marker_plan(port_main)
    want = [f"s{s}.b{b}.q{q}" for s in steps
            for q, (_, b) in enumerate(plan)]
    assert len(steps) == 2 and _keys(trace.events()) == want
