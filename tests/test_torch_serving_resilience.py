"""PyTorch port, the fault-tolerant serving tier
(paddle_tpu_torch/serving/resilience.py, frontend.py, the engine's kill /
drain / resurrect, the watchdog, resilience/faults.py and retry.py), on
the CPU with the tiny GPT at f32.

* Against the reference: `_hash01`, FaultPlan parsing and its fire
  sequence bit for bit over a grid of specs and seeds; RetryPolicy's
  backoff sequence equal; the greedy tokens of a 2-replica port frontend
  whose first dying replica is killed at the 2nd window
  (`serving.window:error:at=2`) equal to the reference's undisturbed
  DecodeEngine, token for token.
* Inside the port (mirrors of tests/test_serving_resilience.py and of
  tests/test_serving.py's watchdog and round-robin tests): one weight copy
  across replicas (per tensor, and for the draft); failover == an
  undisturbed run with seeded top-k rows; one victim counts one
  failover; a spent budget fails typed; the shed taxonomy; least-loaded
  routing; engine and frontend drain; the canary gate and a mismatch that
  keeps the engine dead; an SLA trip that fails over; the watchdog on a
  standalone engine failing requests typed with a flight dump holding
  the `sla_trip` step; resurrection waiting for the abandoned window;
  round robin skipping a dead replica; the draft's ladder.
* The launch-count repair: two threads capture through the B4 wrapper's
  launch path while a third counts replays; no count is lost.

Every wait has a timeout and every engine and frontend is stopped in
`finally`; FLAGS_serving_health_interval_ms is 30 here.
"""
import dataclasses
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid

from paddle_tpu_torch import flags as port_flags
from paddle_tpu_torch import serving as port
from paddle_tpu_torch.framework import errors as port_errors
from paddle_tpu_torch.models import gpt_decode as port_decode
from paddle_tpu_torch.models.gpt import GPTConfig as PortGPTConfig
from paddle_tpu_torch.observability import flight as port_flight
from paddle_tpu_torch.observability import metrics as port_metrics
from paddle_tpu_torch.ops.kernels import paged_attention as port_kernel
from paddle_tpu_torch.resilience import (FaultPlan, RetryPolicy, clear_plan,
                                         install_plan)
from paddle_tpu_torch.resilience import faults as port_faults
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.serving.request import RequestState

GEO = dict(max_slots=3, block_size=8, num_blocks=32, max_len=32, window=4)


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


@pytest.fixture(autouse=True)
def _fast_health_ticks():
    port_flags.set_flags({"FLAGS_serving_health_interval_ms": 30.0})
    yield
    clear_plan()
    port_flags.set_flags({"FLAGS_serving_health_interval_ms": 200.0,
                          "FLAGS_step_deadline_ms": 0.0,
                          "FLAGS_serving_failover_budget": 2,
                          "FLAGS_serving_resurrect_budget": 3})


def _engine(tiny, **kw):
    return port.DecodeEngine(tiny[3], tiny[2], device="cpu",
                             **{**GEO, **kw})


def _replicas(tiny, n=2, **kw):
    return port.replicated_engines(n, tiny[3], tiny[2], device="cpu",
                                   **{**GEO, **kw})


def _mixed_requests(cfg, n=6, seed=3, sampled=True, req_cls=port.Request):
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        s = sampled and i % 2 == 1            # greedy AND seeded top-k
        reqs.append(req_cls(
            prompt=rng.randint(0, cfg.vocab_size,
                               (int(rng.randint(3, 12)),)),
            max_new_tokens=int(rng.randint(4, 9)),
            temperature=0.8 if s else 0.0, top_k=16 if s else 0,
            seed=100 + i, uid=f"r{i}"))
    return reqs


def _oracle(tiny, reqs, **kw):
    clear_plan()
    eng = _engine(tiny, **kw)
    try:
        comps = eng.generate(reqs, timeout=120)
    finally:
        eng.stop()
    assert all(c.ok for c in comps), [(c.uid, c.state) for c in comps]
    return {c.uid: c.tokens for c in comps}


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _serve_staggered(fe, reqs):
    handles = []
    for r in reqs:
        handles.append(fe.submit(r))
        time.sleep(0.002)       # staggered: both replicas get load
    return [h.result(timeout=120, raise_on_error=False) for h in handles]


class _Wedge:
    """Stands in for an engine's `_call`: blocks until released (or 30 s),
    then raises, so an abandoned watchdog worker never runs the window."""

    def __init__(self):
        self.release = threading.Event()

    def __call__(self, *a, **kw):
        self.release.wait(30.0)
        raise RuntimeError("wedged window released")


# ---------------------------------------------------------------------------
# against the reference: fault plans, retry backoff, failover tokens
# ---------------------------------------------------------------------------

FAULT_SPECS = [
    "serving.window:error:at=2",
    "serving.window:error:every=3;serving.prefill:error:p=0.3",
    "serving.admit:error:p=0.5:times=4",
    "a:delay=0:every=2:p=0.7;b:error:p=0.1;a:error:at=5",
    "serving.spec.draft:error:every=1:times=2;serving.window:error:p=0.9",
]


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_fault_plan_fires_as_the_reference(spec):
    """_hash01 bit for bit, and the same spec + seed parse to the same
    rules and fire on the same calls of each site as the reference's
    FaultPlan (40 calls round-robin over the spec's sites, 4 seeds)."""
    from paddle_tpu.resilience import faults as ref_faults
    fires = []
    for seed in (0, 1, 7, 2 ** 40 + 3):
        for site in ("serving.window", "a", "b", "x" * 30):
            for count in range(1, 40):
                assert port_faults._hash01(seed, site, count) == \
                    ref_faults._hash01(seed, site, count)
        p, r = FaultPlan(spec, seed), ref_faults.FaultPlan(spec, seed)
        assert [(x.site, x.action, x.delay_s, x.every, x.at, x.p, x.times)
                for x in p.rules] == \
            [(x.site, x.action, x.delay_s, x.every, x.at, x.p, x.times)
             for x in r.rules]
        sites = sorted({x.site for x in p.rules})
        for i in range(40):
            site = sites[i % len(sites)]
            got = []
            for plan, exc in ((p, port_faults.FaultInjected),
                              (r, ref_faults.FaultInjected)):
                try:
                    plan.fire(site)
                    got.append(False)
                except exc:
                    got.append(True)
            assert got[0] == got[1], (spec, seed, site, i)
            fires.append(got[0])
        assert [x.fired for x in p.rules] == [x.fired for x in r.rules]
    assert any(fires)


@pytest.mark.parametrize("kw", [dict(), dict(seed=5, jitter=0.5,
                                             multiplier=3.0,
                                             base_delay_s=0.01,
                                             max_delay_s=0.4)],
                         ids=["defaults", "custom"])
def test_retry_backoff_equals_reference(kw):
    from paddle_tpu.resilience.retry import RetryPolicy as RefPolicy
    mine, ref = RetryPolicy(**kw), RefPolicy(**kw)
    assert [mine.backoff(a) for a in range(12)] == \
        [ref.backoff(a) for a in range(12)]
    assert (mine.max_attempts, mine.deadline_s) == \
        (ref.max_attempts, ref.deadline_s)


def test_failover_tokens_equal_reference_undisturbed(tiny):
    """The acceptance pin across packages: greedy f32, 2 port replicas,
    the replica that runs the 2nd window killed there; every request
    completes with the reference's undisturbed tokens."""
    from paddle_tpu.serving import DecodeEngine as RefEngine
    from paddle_tpu.serving import Request as RefRequest
    cfg, params = tiny[0], tiny[1]
    ref = RefEngine(params, cfg, decode_kernel=False, **GEO)
    try:
        want = {c.uid: c.tokens for c in ref.generate(
            _mixed_requests(cfg, sampled=False, req_cls=RefRequest),
            timeout=240)}
    finally:
        ref.stop()
    plan = install_plan("serving.window:error:at=2", seed=0)
    engines = _replicas(tiny)
    fe = port.ServingFrontend(engines, resurrect=False)
    try:
        comps = _serve_staggered(fe, _mixed_requests(cfg, sampled=False))
        dead = [e for e in engines if e._dead is not None]
    finally:
        clear_plan()
        fe.stop()
    assert all(c.ok for c in comps), [(c.uid, c.error) for c in comps]
    assert {c.uid: c.tokens for c in comps} == want
    assert sum(r.fired for r in plan.rules) == 1 and len(dead) == 1
    assert fe.failover_total >= 1


# ---------------------------------------------------------------------------
# one weight copy
# ---------------------------------------------------------------------------

def test_clone_prepares_once_and_shares_every_weight(tiny, monkeypatch):
    calls = []
    real = engine_mod.prepare_params

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(engine_mod, "prepare_params", counting)
    engines = _replicas(tiny, n=3)
    try:
        assert len(calls) == 1
        src = engines[0]
        for clone in engines[1:]:
            assert clone.params is src.params
            for k, t in src.params.items():
                assert clone.params[k] is t
                assert clone.params[k].data_ptr() == t.data_ptr()
            assert clone.scales is src.scales
            assert clone.compute_dtype == src.compute_dtype
            # ...and its own pools
            assert clone.cache.k_pool.data_ptr() != \
                src.cache.k_pool.data_ptr()
    finally:
        for e in engines:
            e.stop()


def test_clone_shares_the_draft_weights(tiny):
    engines = _replicas(tiny, spec=port.SpecConfig(tokens=2))
    try:
        a, b = (e.spec.draft for e in engines)
        assert a.scales is not None and b.scales is a.scales
        for k, t in a.params.items():
            assert b.params[k].data_ptr() == t.data_ptr(), k
        assert b.cache.k_pool.data_ptr() != a.cache.k_pool.data_ptr()
    finally:
        for e in engines:
            e.stop()


# ---------------------------------------------------------------------------
# failover: parity with the port's own undisturbed run, budget
# ---------------------------------------------------------------------------

def test_failover_equals_undisturbed_with_seeded_rows(tiny):
    cfg = tiny[0]
    reqs = _mixed_requests(cfg, n=6)
    want = _oracle(tiny, reqs)
    port_metrics.reset()
    plan = install_plan("serving.window:error:at=2", seed=0)
    engines = _replicas(tiny)
    fe = port.ServingFrontend(engines, resurrect=False)
    try:
        comps = _serve_staggered(fe, reqs)
    finally:
        clear_plan()
        fe.stop()
    assert all(c.ok for c in comps), [(c.uid, c.error) for c in comps]
    for c in comps:
        assert c.tokens == want[c.uid], c.uid
    assert sum(r.fired for r in plan.rules) == 1
    assert port_metrics.get("serving.engine_failures") == 1
    assert port_metrics.get("serving.failovers") == len(fe.failover_log) >= 1
    assert port_metrics.get("serving.shed_total") == 0


def test_window_fault_single_victim_counts_one_failover(tiny):
    req = port.Request(prompt=np.arange(2, 8), max_new_tokens=12,
                       uid="solo")
    want = _oracle(tiny, [req])
    port_metrics.reset("serving.failovers")
    install_plan("serving.window:error:at=2", seed=0)
    fe = port.ServingFrontend(_replicas(tiny), resurrect=False)
    try:
        c = fe.submit(req).result(timeout=120)
    finally:
        clear_plan()
        fe.stop()
    assert c.tokens == want["solo"]
    assert port_metrics.get("serving.failovers") == 1
    assert fe.failover_log == ["solo"]


def test_failover_budget_exhausted_raises_typed(tiny):
    port_flags.set_flags({"FLAGS_serving_failover_budget": 1})
    install_plan("serving.window:error:every=1", seed=0)
    engines = _replicas(tiny)
    fe = port.ServingFrontend(engines, resurrect=False)
    try:
        h = fe.submit(port.Request(prompt=np.arange(4), max_new_tokens=6,
                                   uid="doomed"))
        with pytest.raises(port.RequestFailedError) as ei:
            h.result(timeout=60)
        assert ei.value.completion.finish_reason in (
            "failover budget exhausted", "no healthy replica for failover")
        assert _wait(lambda: all(e._dead is not None for e in engines),
                     timeout=10)
        with pytest.raises(port.NoHealthyReplicaError):
            fe.submit(port.Request(prompt=np.arange(4), max_new_tokens=2))
    finally:
        clear_plan()
        fe.stop()


# ---------------------------------------------------------------------------
# admission control, routing
# ---------------------------------------------------------------------------

def test_shed_reason_taxonomy(tiny, monkeypatch):
    for name in ("serving.shed_total", "serving.shed.queue_full",
                 "serving.shed.deadline_unmeetable",
                 "serving.shed.unfundable", "serving.shed.draining",
                 "serving.shed.admit_fault"):
        port_metrics.reset(name)

    def mk(plen=4, new=4, **kw):
        return port.Request(prompt=np.arange(1, 1 + plen), max_new_tokens=new,
                            **kw)

    eng = _engine(tiny, max_queue=3)
    monkeypatch.setattr(eng, "_ensure_thread", lambda: None)
    try:
        install_plan("serving.admit:error:at=1", seed=0)
        h = eng.submit(mk())
        clear_plan()
        with pytest.raises(port.ShedError) as ei:
            h.result(timeout=5)
        assert ei.value.reason == "admit_fault"
        assert eng.submit(mk()).state == RequestState.QUEUED
        assert eng.submit(mk()).state == RequestState.QUEUED
        eng._window_ms_ewma = 1000.0
        assert eng.queue_wait_estimate_ms() > 0
        with pytest.raises(port.ShedError) as ei:
            eng.submit(mk(new=4, deadline_ms=0.5)).result(timeout=5)
        assert ei.value.reason == "deadline_unmeetable"
        assert eng.submit(mk()).state == RequestState.QUEUED
        assert eng.queue_full()
        with pytest.raises(port.ShedError) as ei:
            eng.submit(mk()).result(timeout=5)
        assert ei.value.reason == "queue_full"
        unstarted = eng.drain(timeout_s=5)
        assert len(unstarted) == 3
        with pytest.raises(port.ShedError) as ei:
            eng.submit(mk()).result(timeout=5)
        assert ei.value.reason == "draining"
    finally:
        eng.stop()
    small = _engine(tiny, num_blocks=3)
    try:
        with pytest.raises(port.ShedError) as ei:
            small.submit(mk(plen=9, new=10)).result(timeout=5)
        assert ei.value.reason == "unfundable"
    finally:
        small.stop()
    assert port_metrics.get("serving.shed_total") == 8.0
    for reason in ("queue_full", "deadline_unmeetable", "admit_fault",
                   "unfundable"):
        assert port_metrics.get(f"serving.shed.{reason}") == 1.0, reason
    assert port_metrics.get("serving.shed.draining") == 4.0


def test_least_loaded_routing(tiny, monkeypatch):
    engines = _replicas(tiny)
    for e in engines:
        monkeypatch.setattr(e, "_ensure_thread", lambda: None)
    fe = port.ServingFrontend(engines, resurrect=False)
    try:
        def mk(new, uid):
            return port.Request(prompt=np.arange(4), max_new_tokens=new,
                                uid=uid)
        fe.submit(mk(8, "big"))            # engine A: load 8
        for i in range(4):
            fe.submit(mk(1, f"s{i}"))      # all land on B (loads 1..4)
        fe.submit(mk(1, "s4"))             # B at 4 < A at 8 -> B again
        assert sorted(e.load() for e in engines) == [5, 8]
        assert sorted(len(e._queue) for e in engines) == [1, 5]
    finally:
        fe.stop()


def test_queue_wait_histogram_observed(tiny):
    port_metrics.reset("serving.queue_wait_ms")
    eng = _engine(tiny)
    try:
        comps = eng.generate(_mixed_requests(tiny[0], n=3, seed=9),
                             timeout=120)
    finally:
        eng.stop()
    assert all(c.ok for c in comps)
    snap = port_metrics.snapshot()["serving.queue_wait_ms"]
    assert snap["count"] == 3 and snap["p50"] is not None


# ---------------------------------------------------------------------------
# drain
# ---------------------------------------------------------------------------

def test_engine_drain_finishes_inflight_and_hands_back_unstarted(tiny):
    eng = _engine(tiny, max_slots=1, window=2)
    try:
        a = eng.submit(port.Request(prompt=np.arange(5), max_new_tokens=10,
                                    uid="inflight"))
        assert _wait(lambda: a.state == RequestState.DECODE, timeout=60)
        b = eng.submit(port.Request(prompt=np.arange(5), max_new_tokens=4,
                                    uid="unstarted"))
        unstarted = eng.drain(timeout_s=60)
        ca = a.result(timeout=60)
        assert ca.ok and len(ca.tokens) == 10
        assert [r.uid for r, _ in unstarted] == ["unstarted"]
        with pytest.raises(port.ShedError) as ei:
            b.result(timeout=5)
        assert ei.value.reason == "draining"
    finally:
        eng.stop()


def test_frontend_drain_returns_requests_and_sheds_new(tiny, monkeypatch):
    engines = _replicas(tiny)
    for e in engines:
        monkeypatch.setattr(e, "_ensure_thread", lambda: None)
    fe = port.ServingFrontend(engines, resurrect=False)
    try:
        reqs = _mixed_requests(tiny[0], n=4, seed=5)
        handles = [fe.submit(r) for r in reqs]
        handed_back = fe.drain(timeout_s=10)
        assert sorted(r.uid for r in handed_back) == \
            sorted(r.uid for r in reqs)
        for h in handles:
            with pytest.raises(port.ShedError):
                h.result(timeout=5)
        c = fe.submit(reqs[0]).result(timeout=5, raise_on_error=False)
        assert c.finish_reason == "shed:draining"
    finally:
        fe.stop()


# ---------------------------------------------------------------------------
# resurrection and the canary gate
# ---------------------------------------------------------------------------

def test_resurrection_canary_gate_keeps_pools_and_serves(tiny):
    """live -> suspect -> dead -> resurrecting -> live behind the canary;
    the pools are reset at the same addresses; then it serves the tokens
    an undisturbed engine gives."""
    cfg = tiny[0]
    engines = _replicas(tiny)
    fe = port.ServingFrontend(engines)
    post = port.Request(prompt=np.arange(3, 9), max_new_tokens=5, uid="post")
    want = _oracle(tiny, [post])
    try:
        assert all(c.ok for c in fe.generate(
            _mixed_requests(cfg, n=4, seed=7), timeout=120))
        victim = engines[1]
        k_ptr = victim.cache.k_pool.data_ptr()
        port_metrics.reset("serving.resurrections")
        port_metrics.reset("serving.recover_ms")
        victim.kill("induced death")
        assert _wait(lambda: victim.health != port.Health.LIVE, timeout=30)
        assert _wait(lambda: victim.health == port.Health.LIVE
                     and victim._dead is None, timeout=60), \
            (victim.health, victim._dead, victim.health_history)
        assert victim.health_history == [
            port.Health.LIVE, port.Health.SUSPECT, port.Health.DEAD,
            port.Health.RESURRECTING, port.Health.LIVE]
        assert port_metrics.get("serving.resurrections") >= 1
        assert port_metrics.get("serving.recover_ms") == 1
        assert victim.cache.k_pool.data_ptr() == k_ptr
        assert fe.stats()["live"] == 2
        c = victim.submit(post).result(timeout=120)
        assert c.tokens == want["post"]
    finally:
        fe.stop()


def test_resurrection_canary_mismatch_keeps_engine_dead(tiny):
    port_flags.set_flags({"FLAGS_serving_resurrect_budget": 2})
    engines = _replicas(tiny)
    fe = port.ServingFrontend(engines)
    try:
        port_metrics.reset("serving.resurrect_gave_up")
        fe._canary_tokens = [-1, -1, -1]     # unsatisfiable expectation
        victim = engines[1]
        victim.kill("induced death")
        assert _wait(lambda: id(victim) in fe._gave_up, timeout=60)
        assert victim.health == port.Health.DEAD
        assert "canary" in (victim._dead or "") \
            or "resurrection budget" in (victim._dead or "")
        assert port_metrics.get("serving.resurrect_gave_up") == 1
        assert fe.stats()["live"] == 1
        c = fe.submit(port.Request(prompt=np.arange(4),
                                   max_new_tokens=3)).result(timeout=120)
        assert c.ok
    finally:
        fe.stop()


def test_draft_walks_the_ladder_and_rearms(tiny):
    """A draft fault degrades the engine to plain decode (no failed
    request, the same tokens); the health loop walks the draft through
    suspect -> dead -> resurrecting -> live behind a spec-armed canary."""
    cfg = tiny[0]
    reqs = _mixed_requests(cfg, n=3, seed=4)
    want = _oracle(tiny, reqs)
    port_metrics.reset("serving.spec.rearmed")
    install_plan("serving.spec.draft:error:at=1", seed=0)
    engines = _replicas(tiny, spec=port.SpecConfig(tokens=2))
    fe = port.ServingFrontend(engines)
    try:
        comps = fe.generate(reqs, timeout=120)
        clear_plan()
        assert {c.uid: c.tokens for c in comps} == want
        spec = next(e.spec for e in engines if e.spec._degraded)
        # rearm() makes the draft LIVE before its canary; the counter
        # moves once the canary passed
        assert _wait(lambda: port_metrics.get("serving.spec.rearmed") == 1,
                     timeout=60)
        assert spec.health_history == [
            port.Health.LIVE, port.Health.SUSPECT, port.Health.DEAD,
            port.Health.RESURRECTING, port.Health.LIVE]
    finally:
        clear_plan()
        fe.stop()


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------

def test_engine_config_accepts_step_deadline(tiny):
    """A deadline that is never reached changes nothing: the same
    tokens with the watchdog on."""
    reqs = _mixed_requests(tiny[0], n=3, seed=6)
    want = _oracle(tiny, reqs)
    port_flags.set_flags({"FLAGS_step_deadline_ms": 20000.0})
    assert port.EngineConfig(**GEO).resolve().window == 4
    assert _oracle(tiny, reqs) == want


def test_watchdog_fails_requests_typed_and_dumps_the_trip(tiny, tmp_path):
    """A standalone engine whose window wedges: the watchdog trips, the
    request FAILS typed (no hang), the engine is dead, later submits are
    shed, and the flight dump holds the window's step as `sla_trip`."""
    eng = _engine(tiny)
    wedge = _Wedge()
    eng._call = wedge
    port_flags.set_flags({"FLAGS_step_deadline_ms": 300.0,
                          "FLAGS_flight_dump_dir": str(tmp_path)})
    port_metrics.reset("serving.sla_trips")
    port_metrics.reset("executor.step_deadline_trips")
    try:
        c = eng.submit(port.Request(prompt=np.arange(4), max_new_tokens=6)
                       ).result(timeout=60, raise_on_error=False)
        assert c.state == RequestState.FAILED
        assert "DeadlineExceeded" in (c.error or "")
        assert eng._dead is not None and eng.health == port.Health.DEAD
        h2 = eng.submit(port.Request(prompt=np.arange(4), max_new_tokens=2))
        assert h2.state == RequestState.REJECTED
        assert port_metrics.get("serving.sla_trips") == 1
        assert port_metrics.get("executor.step_deadline_trips") == 1
        (dump,) = tmp_path.glob("flight_*_step_deadline_*.json")
        steps = json.loads(dump.read_text())["steps"]
        assert [s["status"] for s in steps
                if s["exe"] == 0x5E0 + eng._id] == ["sla_trip"]
        assert [s["status"] for s in port_flight.steps()
                if s["exe"] == 0x5E0 + eng._id] == ["sla_trip"]
    finally:
        wedge.release.set()
        port_flags.set_flags({"FLAGS_step_deadline_ms": 0.0,
                              "FLAGS_flight_dump_dir": ""})
        eng.stop()


def test_resurrect_waits_for_the_abandoned_window(tiny, monkeypatch):
    """After a trip the abandoned worker still holds the window: the
    reset raises Unavailable until it has returned, then the engine serves
    an undisturbed engine's tokens again."""
    req = port.Request(prompt=np.arange(3, 9), max_new_tokens=5, uid="p")
    want = _oracle(tiny, [req])
    eng = _engine(tiny)
    wedge = _Wedge()
    eng._call = wedge
    monkeypatch.setattr(engine_mod, "_QUIET_TIMEOUT_S", 0.05)
    port_flags.set_flags({"FLAGS_step_deadline_ms": 200.0})
    try:
        c = eng.submit(port.Request(prompt=np.arange(4), max_new_tokens=6)
                       ).result(timeout=60, raise_on_error=False)
        assert c.state == RequestState.FAILED
        port_flags.set_flags({"FLAGS_step_deadline_ms": 0.0})
        with pytest.raises(port_errors.UnavailableError):
            eng.resurrect()
        wedge.release.set()
        del eng._call                      # the real window again
        eng.resurrect()
        assert eng._dead is None and eng._abandoned is None
        assert eng.submit(req).result(timeout=60).tokens == want["p"]
    finally:
        wedge.release.set()
        eng.stop()


def test_sla_trip_fails_over_instead_of_failing_requests(tiny):
    engines = _replicas(tiny)
    fe = port.ServingFrontend(engines, resurrect=False)
    victim = engines[0]
    wedge = _Wedge()
    try:
        assert all(c.ok for c in fe.generate(
            _mixed_requests(tiny[0], n=4, seed=11), timeout=120))
        victim._call = wedge
        # far above a healthy window: only the wedged replica trips
        port_flags.set_flags({"FLAGS_step_deadline_ms": 1000.0})
        req = port.Request(prompt=np.arange(6), max_new_tokens=6, uid="sla")
        h = victim.submit(req)          # force it onto the wedged replica
        c = h.result(timeout=120)       # raises if it FAILED
        assert c.ok and len(c.tokens) == 6
        assert h.failovers >= 1 and victim._dead is not None
    finally:
        wedge.release.set()
        port_flags.set_flags({"FLAGS_step_deadline_ms": 0.0})
        fe.stop()


# ---------------------------------------------------------------------------
# round robin
# ---------------------------------------------------------------------------

RR = dict(max_slots=2, num_blocks=16)


def test_round_robin_frontend(tiny):
    engines = _replicas(tiny, **RR)
    assert engines[0].params is engines[1].params   # one weight copy
    fe = port.RoundRobinFrontend(engines)
    rng = np.random.RandomState(1)
    try:
        comps = fe.generate(
            [port.Request(prompt=rng.randint(0, tiny[0].vocab_size, (6,)),
                          max_new_tokens=4) for _ in range(6)], timeout=120)
    finally:
        fe.stop()
    assert all(c.ok for c in comps)
    st = fe.stats()
    assert st["live"] == 2
    assert all(s["completed"] > 0 for s in st["per_replica"])


def test_round_robin_skips_dead_replica(tiny):
    engines = _replicas(tiny, **RR)
    fe = port.RoundRobinFrontend(engines)
    engines[0].kill("induced death")
    rng = np.random.RandomState(8)
    try:
        comps = fe.generate(
            [port.Request(prompt=rng.randint(0, tiny[0].vocab_size, (6,)),
                          max_new_tokens=3) for _ in range(4)], timeout=120)
    finally:
        fe.stop()
    assert all(c.ok for c in comps), [(c.uid, c.state) for c in comps]
    assert engines[0].stats()["completed"] == 0
    assert engines[1].stats()["completed"] == 4
    assert fe.stats()["live"] == 1


def test_round_robin_all_dead_raises_typed(tiny):
    engines = _replicas(tiny, **RR)
    fe = port.RoundRobinFrontend(engines)
    for e in engines:
        e.kill("induced death")
    try:
        with pytest.raises(port.NoHealthyReplicaError, match="2 replicas"):
            fe.submit(port.Request(prompt=np.arange(4), max_new_tokens=2))
    finally:
        fe.stop()


def test_lowering_registry_loads_once_across_threads(monkeypatch):
    """Two replicas reach the op registry from their service threads at
    once: a thread that arrives while another imports the lowering
    modules waits for the load instead of finding the op missing."""
    import importlib
    from paddle_tpu_torch.ops import registry
    registry._load_lowerings()   # the real modules, whatever ran first
    name = "dequantize_abs_max"
    saved = registry._REGISTRY[name]
    entered = threading.Event()

    def slow_import(mod, *a, **kw):
        if mod.endswith("ops.int8_ops"):
            entered.set()
            time.sleep(0.3)
            registry._REGISTRY[name] = saved    # "registers on import"
        return sys.modules[mod]

    monkeypatch.setattr(registry, "_REGISTRY",
                        {k: v for k, v in registry._REGISTRY.items()
                         if k != name})
    monkeypatch.setattr(registry, "_loaded", False)
    monkeypatch.setattr(importlib, "import_module", slow_import)
    got, errs = [], []

    def reach():
        try:
            got.append(registry.get(name))
        except Exception as e:   # noqa: BLE001 — reported below
            errs.append(e)

    loader = threading.Thread(target=reach)
    loader.start()
    assert entered.wait(10)
    reach()                          # arrives mid-load
    loader.join(10)
    assert not loader.is_alive()
    assert not errs and got == [saved, saved]


# ---------------------------------------------------------------------------
# the launch-count repair
# ---------------------------------------------------------------------------

class _NullLibrary:
    """The kernel library's interface, launching nothing."""

    def paged_decode_chunk(self):
        return 128

    def paged_decode(self, *args):
        return 0


def test_launch_counts_survive_concurrent_captures_and_replays():
    """Two threads capture (record) B4 launches through the wrapper's
    launch path while a third counts replays: each capture records exactly
    its own launches and the global count is exactly the replays'."""
    lib = _NullLibrary()
    q = torch.zeros(1, 1, 1, 64)
    pool = torch.zeros(1, 2, 1, 16, 64)
    pt = torch.ones(1, 1, dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    n_launch, n_replay, delta = 300, 3000, {"paged_decode_f32": 3}
    recorded, errs = [], []
    start = threading.Barrier(3)

    def capture():
        try:
            start.wait(10)
            with port_kernel.capture_launches() as rec:
                for _ in range(n_launch):
                    port_kernel.launch(lib, q, pool, pool, pt, pos,
                                       stream=0, block_size=16)
            recorded.append(dict(rec))
        except BaseException as e:     # noqa: BLE001 — reported below
            errs.append(e)

    def replay():
        try:
            start.wait(10)
            for _ in range(n_replay):
                port_kernel.count_replay(delta)
        except BaseException as e:     # noqa: BLE001 — reported below
            errs.append(e)

    port_kernel.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=f)
                   for f in (capture, capture, replay)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errs, errs
    assert recorded == [{"paged_decode_f32": n_launch, "paged_decode_bf16": 0,
                         "paged_decode_int8": 0}] * 2
    assert port_kernel.launches["paged_decode_f32"] == 3 * n_replay
    port_kernel.reset_launches()
