"""PyTorch port, in-memory snapshots and the poison-batch guard:
paddle_tpu_torch's resilience/snapshot.py and resilience/integrity.py and
the executor's `_maybe_snapshot` hook, on the CPU. Modelled on the
reference's tests/test_snapshot.py and tests/test_integrity.py; every
check is exact (no tolerance): a restore and replay lands bit for bit on
the uninterrupted run.

* Cadence and the double buffer; the payload carries the run-seed counter
  (`__rng_counter__`); restore-and-replay equals the straight run.
* The executor captures on the FLAGS_snapshot_steps cadence, tagged with
  the program's own step count (the startup program does not count); a
  run_steps(k) window snapshots at its end when it crossed a multiple of
  the interval.
* ZeRO stage 1: the snapshot holds the per-parameter (unsharded) entries,
  and a restore packs them back into the scope's flat tensors in place.
* Flush and the recovery ladder (local rung, disk rung, fresh start);
  SIGTERM flushes the newest snapshot; a torn flush (the `ckpt.write`
  fault), direct or inside the signal handler, keeps the previous one.
* The peer entry points raise a typed error naming ROADMAP item 19.
* TrainingGuard: a NaN batch (and, on GPT-tiny at stage 1 with dropout,
  a NaN written into a row of `wte`) rolls back to the last snapshot and
  skips the batch, bit for bit the run that never saw it; a loss spike
  rolls back; the budget runs out into RollbackExhausted, and so does a
  poison before any snapshot; `steps` rewinds and skips.
"""
import os
import signal

import numpy as np
import pytest
import torch

from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch import layers
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.framework import (Executor, Program, Scope, errors,
                                        program_guard, unique_name)
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.resilience import (CheckpointManager, FaultInjected,
                                         RollbackExhausted, Snapshot,
                                         SnapshotManager, TrainingGuard,
                                         clear_plan, fingerprint,
                                         install_plan, read_recovery_stamps,
                                         recover)


def _build_net(stage=None):
    """(exe, main, scope, loss): fc 4 -> 8 gelu -> fc 1, Adam, startup
    run on the CPU."""
    main, start = Program(), Program()
    with program_guard(main, start), unique_name.guard():
        init = port_init.TruncatedNormal(0.0, 0.5)
        x = layers.data(name="x", shape=[4], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        h = layers.fc(x, 8, act="gelu", param_attr=init)
        p = layers.fc(h, 1, param_attr=init)
        loss = layers.mean(layers.square(layers.elementwise_sub(p, y)))
        o = optimizer.Adam(learning_rate=0.01)
        if stage is not None:
            fleet.init(is_collective=True)
            s = fleet.DistributedStrategy()
            s.sharding_stage = stage
            s.fuse_grad_size_in_mb = 0.0001
            o = fleet.distributed_optimizer(o, s)
        o.minimize(loss)
    exe, scope = Executor("cpu"), Scope()
    exe.run(start, scope=scope)
    return exe, main, scope, loss


def _feed(step, poison=False):
    x = np.random.RandomState(100 + step).randn(8, 4).astype(np.float32)
    y = np.random.RandomState(200 + step).randn(8, 1).astype(np.float32)
    if poison:
        x = x.copy()
        x[0, 0] = np.nan
    return {"x": x, "y": y}


def _run(exe, prog, scope, loss, step, **kw):
    out, = exe.run(prog, feed=_feed(step, **kw), fetch_list=[loss],
                   scope=scope)
    return float(out)


def _state(prog, scope):
    return {v.name: scope.numpy(v.name)
            for v in prog.global_block().vars.values()
            if v.persistable and scope.find(v.name) is not None}


# ---------------------------------------------------------------------------
# capture, restore
# ---------------------------------------------------------------------------

def test_capture_cadence_and_double_buffer(tmp_path):
    exe, prog, scope, loss = _build_net()
    metrics.reset()
    mgr = SnapshotManager(interval=2, root=str(tmp_path), rank=0, world=1)
    try:
        seen = []
        for s in range(1, 7):
            _run(exe, prog, scope, loss, s)
            if mgr.maybe_capture(prog, scope, s, sync=True):
                seen.append(mgr.latest().step)
        assert seen == [2, 4, 6]
        assert metrics.get("resilience.snapshots") == 3
        snap = mgr.latest()
        assert snap.step == 6
        # the run-seed counter: startup + 6 steps
        assert int(snap.arrays["__rng_counter__"]) == 7
        steps = sorted(b.step for b in mgr._buffers if b is not None)
        assert steps == [4, 6]
        # a snapshot is a copy: the next step does not change it
        w = snap.arrays["fc_w_0"].copy()
        _run(exe, prog, scope, loss, 7)
        assert np.array_equal(snap.arrays["fc_w_0"], w)
    finally:
        mgr.close()


def test_restore_and_replay_is_bit_identical(tmp_path):
    exe, prog, scope, loss = _build_net()
    mgr = SnapshotManager(interval=3, root=str(tmp_path), rank=0, world=1)
    try:
        for s in range(1, 6):
            _run(exe, prog, scope, loss, s)
            mgr.maybe_capture(prog, scope, s, sync=True)
        oracle = fingerprint(prog, scope)
        bound = {n: scope.find(n) for n in _state(prog, scope)}
        snap = mgr.latest()
        assert snap.step == 3
        assert snap.restore(scope) == 3
        assert scope.find("__rng_state__") == 4
        assert all(scope.find(n) is t for n, t in bound.items())
        for s in range(4, 6):
            _run(exe, prog, scope, loss, s)
        assert fingerprint(prog, scope) == oracle
    finally:
        mgr.close()


def test_fingerprint_is_exact():
    _, prog, scope, _ = _build_net()
    base = fingerprint(prog, scope)
    assert fingerprint(prog, scope) == base
    w = scope.find("fc_w_0")
    orig = w.clone()
    w.view(-1)[0] = float(np.nextafter(np.float32(orig.view(-1)[0]),
                                       np.float32(np.inf)))
    assert fingerprint(prog, scope) != base
    w.copy_(orig)
    assert fingerprint(prog, scope) == base
    scope.set("__rng_state__", scope.find("__rng_state__") + 1)
    assert fingerprint(prog, scope) != base


def test_zero_stage1_snapshot_is_unsharded_and_restores_in_place(tmp_path):
    exe, prog, scope, loss = _build_net(stage=1)
    buckets = prog._grad_buckets["zero_buckets"]
    assert len(buckets) >= 2
    flat = [f for b in buckets for f in b["flat"].values()]
    mgr = SnapshotManager(interval=2, root=str(tmp_path), rank=0, world=1)
    try:
        for s in range(1, 5):
            _run(exe, prog, scope, loss, s)
            mgr.maybe_capture(prog, scope, s, sync=True)
        want = _state(prog, scope)
        snap = mgr.latest()
        assert not set(flat) & set(snap.arrays)
        assert "fc_w_0_moment1_0" in snap.arrays
        bound = {n: scope.find(n) for n in flat}
        _run(exe, prog, scope, loss, 5)
        snap.restore(scope, program=prog)        # packed on the host
        for n, t in bound.items():
            assert scope.find(n) is t
        got = _state(prog, scope)
        for n in want:
            assert np.array_equal(got[n], want[n]), n
        # without the program the per-parameter entries wait in the scope
        # and the next run packs them (the executor's adoption)
        _run(exe, prog, scope, loss, 5)
        snap.restore(scope, device="cpu")
        assert scope.find("fc_w_0_moment1_0") is not None
        out1 = _run(exe, prog, scope, loss, 5)
        assert scope.find("fc_w_0_moment1_0") is None
        for n, t in bound.items():
            assert scope.find(n) is t
        snap.restore(scope, program=prog)
        assert _run(exe, prog, scope, loss, 5) == out1
    finally:
        mgr.close()


def test_executor_drives_capture_via_flag(tmp_path):
    set_flags({"FLAGS_snapshot_steps": 3,
               "FLAGS_snapshot_dir": str(tmp_path)})
    try:
        # flags on before startup: the startup run is not a training step
        exe, prog, scope, loss = _build_net()
        for s in range(1, 5):
            _run(exe, prog, scope, loss, s)
        exe.snapshots.wait()
        snap = exe.snapshots.latest()
        assert snap.step == 3
        want = {n: a for n, a in snap.arrays.items()
                if n != "__rng_counter__"}
        snap.restore(scope)
        _run(exe, prog, scope, loss, 4)
        exe.snapshots.wait()
        # the program has run 5 steps (the replayed step 4 counts too);
        # run_steps(2) windows end at 7, 9, 11: the ones crossing a
        # multiple of 3 (6 and 9) capture, tagged with their end
        feeds = {k: np.stack([_feed(s)[k] for s in (5, 6)])
                 for k in ("x", "y")}
        for want_step in (7, 9, 9):
            exe.run_steps(2, prog, feed=feeds, fetch_list=[loss],
                          scope=scope)
            exe.snapshots.wait()
            assert exe.snapshots.latest().step == want_step
        assert want and all(isinstance(a, np.ndarray) for a in want.values())
    finally:
        set_flags({"FLAGS_snapshot_steps": 0, "FLAGS_snapshot_dir": ""})
        exe.close()


# ---------------------------------------------------------------------------
# flush, recover, SIGTERM
# ---------------------------------------------------------------------------

def test_flush_recover_ladder_local_rung(tmp_path):
    exe, prog, scope, loss = _build_net()
    mgr = SnapshotManager(interval=2, root=str(tmp_path), rank=0, world=1)
    try:
        for s in range(1, 5):
            _run(exe, prog, scope, loss, s)
            mgr.maybe_capture(prog, scope, s, sync=True)
        want = {n: np.array(a) for n, a in mgr.latest().arrays.items()}
        assert mgr.flush("test") is not None
    finally:
        mgr.close()
    scope2 = Scope()
    rung, step = recover(scope2, root=str(tmp_path), rank=0, device="cpu")
    assert (rung, step) == ("local", 4)
    for n, a in want.items():
        if n == "__rng_counter__":
            assert scope2.find("__rng_state__") == int(a)
        else:
            np.testing.assert_array_equal(scope2.numpy(n), a)
    stamps = read_recovery_stamps(str(tmp_path))
    assert [(r["rank"], r["rung"], r["step"]) for r in stamps] \
        == [(0, "local", 4)]


def test_recover_disk_rung_and_empty_ladder(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), max_keep=2)
    ckpt.save(7, arrays={"w": np.float32([1, 1])})
    scope = Scope()
    rung, step = recover(scope, root=str(tmp_path / "snap"), rank=0,
                         ckpt_manager=ckpt, stamp=False, device="cpu")
    assert (rung, step) == ("disk", 7)
    assert scope.numpy("w").tolist() == [1, 1]
    rung, step = recover(scope, root=str(tmp_path / "nothing"), rank=0,
                         stamp=False, device="cpu")
    assert (rung, step) == (None, None)


def test_sigterm_flushes_newest_snapshot(tmp_path):
    mgr = SnapshotManager(root=str(tmp_path), rank=0, world=1)
    mgr._buffers[0] = Snapshot(3, {"w": np.float32([1, 2, 3])})
    mgr._newest = 0
    mgr.install_sigterm_flush()
    try:
        with pytest.raises(SystemExit) as exc:
            os.kill(os.getpid(), signal.SIGTERM)
        assert exc.value.code == 128 + signal.SIGTERM
    finally:
        mgr.close()
    scope = Scope()
    rung, step = recover(scope, root=str(tmp_path), rank=0, stamp=False,
                         device="cpu")
    assert (rung, step) == ("local", 3)
    assert scope.numpy("w").tolist() == [1, 2, 3]


def test_torn_flush_keeps_previous_snapshot_bit_for_bit(tmp_path):
    good = {"w": np.float32([[1.5, -2.5], [3.5, 4.5]]),
            "m": np.arange(6, dtype=np.float32)}
    mgr = SnapshotManager(root=str(tmp_path), rank=0, world=1)
    try:
        mgr._buffers[0] = Snapshot(2, good)
        mgr._newest = 0
        assert mgr.flush("clean") is not None
        mgr._buffers[1] = Snapshot(4, {"w": np.zeros((2, 2), np.float32),
                                       "m": np.zeros(6, np.float32)})
        mgr._newest = 1
        install_plan("ckpt.write:error:at=1")
        with pytest.raises(FaultInjected):
            mgr.flush("torn")
    finally:
        clear_plan()
        mgr.close()
    scope = Scope()
    rung, step = recover(scope, root=str(tmp_path), rank=0, stamp=False,
                         device="cpu")
    assert (rung, step) == ("local", 2)
    for n, a in good.items():
        np.testing.assert_array_equal(scope.numpy(n), a)


def test_sigterm_mid_write_falls_back_via_handler(tmp_path):
    good = {"w": np.float32([9, 8, 7])}
    mgr = SnapshotManager(root=str(tmp_path), rank=0, world=1)
    mgr._buffers[0] = Snapshot(1, good)
    mgr._newest = 0
    mgr.flush("clean")
    mgr._buffers[1] = Snapshot(3, {"w": np.zeros(3, np.float32)})
    mgr._newest = 1
    mgr.install_sigterm_flush()
    install_plan("ckpt.write:error:at=1")
    try:
        with pytest.raises(SystemExit):
            os.kill(os.getpid(), signal.SIGTERM)
    finally:
        clear_plan()
        mgr.close()
    scope = Scope()
    rung, step = recover(scope, root=str(tmp_path), rank=0, stamp=False,
                         device="cpu")
    assert (rung, step) == ("local", 1)
    np.testing.assert_array_equal(scope.numpy("w"), good["w"])


def test_peer_entry_points_raise_naming_item_19(tmp_path):
    mgr = SnapshotManager(root=str(tmp_path), rank=0, world=2)
    try:
        for call in (lambda: mgr.replicate(object()),
                     mgr.peer_payload,
                     lambda: recover(Scope(), root=str(tmp_path), peer=True)):
            with pytest.raises(errors.UnimplementedError, match="item 19"):
                call()
    finally:
        mgr.close()


# ---------------------------------------------------------------------------
# TrainingGuard
# ---------------------------------------------------------------------------

def test_nan_rollback_is_bit_identical_to_skipping_the_batch(tmp_path):
    poison = 5
    exe, prog, scope, loss = _build_net()
    metrics.reset()
    mgr = SnapshotManager(interval=2, root=str(tmp_path), rank=0, world=1)
    guard = TrainingGuard(mgr, program=prog, scope=scope, budget=2)
    losses_a = {}
    try:
        for s in guard.steps(9, start=1):
            lv = _run(exe, prog, scope, loss, s, poison=(s == poison))
            if not guard.observe(s, lv):
                losses_a[s] = lv
                mgr.maybe_capture(prog, scope, s, sync=True)
        fp_a = fingerprint(prog, scope)
    finally:
        mgr.close()
    assert guard.rollbacks == 1 and guard.skip == {poison}
    assert metrics.get("integrity.rollbacks") == 1
    exe, prog, scope, loss = _build_net()
    losses_b = {s: _run(exe, prog, scope, loss, s)
                for s in range(1, 9) if s != poison}
    assert {s: v for s, v in losses_a.items() if s > poison} \
        == {s: v for s, v in losses_b.items() if s > poison}
    assert fp_a == fingerprint(prog, scope)


def _gpt_net():
    main, start = Program(), Program()
    with program_guard(main, start), unique_name.guard():
        cfg = gpt.GPTConfig.tiny()
        cfg.hidden_dropout = cfg.attention_dropout = 0.1
        _, loss = gpt.build_lm_program(cfg)
        lr = layers.linear_lr_warmup(layers.cosine_decay(1e-3, 2, 4), 2,
                                     1e-4, 1e-3)
        fleet.init(is_collective=True)
        s = fleet.DistributedStrategy()
        s.sharding_stage = 1
        s.fuse_grad_size_in_mb = 0.05
        fleet.distributed_optimizer(optimizer.AdamW(learning_rate=lr),
                                    s).minimize(loss)
    exe, scope = Executor("cpu"), Scope()
    exe.run(start, scope=scope)
    rng = np.random.RandomState(3)
    toks = rng.randint(0, cfg.vocab_size, (9, 2, cfg.seq_len))
    return exe, main, scope, loss, toks


def test_nan_in_wte_rolls_back_bitwise_on_gpt_at_stage1(tmp_path):
    """The chip phase's rollback arm at the CPU's size: NaN written into
    one row of `wte` before step 5, dropout on, a static LR schedule."""
    poison = 5
    exe, prog, scope, loss, toks = _gpt_net()
    mgr = SnapshotManager(interval=2, root=str(tmp_path), rank=0, world=1)
    guard = TrainingGuard(mgr, program=prog, scope=scope, budget=1)
    losses_a = {}
    try:
        for s in guard.steps(9, start=1):
            if s == poison and poison not in guard.skip:
                with torch.no_grad():
                    scope.find("wte")[7].fill_(float("nan"))
            out, = exe.run(prog, feed={"tokens": toks[s]},
                           fetch_list=[loss], scope=scope)
            if not guard.observe(s, float(out)):
                losses_a[s] = float(out)
                mgr.maybe_capture(prog, scope, s, sync=True)
        fp_a = fingerprint(prog, scope)
    finally:
        mgr.close()
    assert guard.skip == {poison} and guard.rollbacks == 1
    exe, prog, scope, loss, toks = _gpt_net()
    losses_b = {}
    for s in range(1, 9):
        if s == poison:
            continue
        out, = exe.run(prog, feed={"tokens": toks[s]}, fetch_list=[loss],
                       scope=scope)
        losses_b[s] = float(out)
    assert losses_a == losses_b
    assert fp_a == fingerprint(prog, scope)


def test_loss_spike_triggers_rollback():
    mgr = SnapshotManager(rank=0, world=1)
    guard = TrainingGuard(mgr, spike_factor=10.0, budget=1,
                          scope=Scope(), program=Program())
    try:
        mgr._buffers[0] = Snapshot(2, {})
        mgr._newest = 0
        for s, lv in [(1, 1.0), (2, 0.9)]:
            assert not guard.observe(s, lv)
        assert guard.observe(3, 50.0)
        assert guard.skip == {3}
    finally:
        mgr.close()


def test_rollback_budget_exhaustion_raises():
    mgr = SnapshotManager(rank=0, world=1)
    mgr._buffers[0] = Snapshot(1, {})
    mgr._newest = 0
    guard = TrainingGuard(mgr, budget=0, scope=Scope(), program=Program())
    try:
        with pytest.raises(RollbackExhausted, match="budget"):
            guard.observe(2, float("nan"))
    finally:
        mgr.close()


def test_rollback_without_snapshot_raises():
    mgr = SnapshotManager(rank=0, world=1)
    guard = TrainingGuard(mgr, budget=3, scope=Scope(), program=Program())
    try:
        with pytest.raises(RollbackExhausted, match="no snapshot"):
            guard.observe(2, float("inf"))
    finally:
        mgr.close()


def test_steps_generator_rewinds_and_skips():
    mgr = SnapshotManager(rank=0, world=1)
    guard = TrainingGuard(mgr, budget=3, scope=Scope(), program=Program())
    mgr._buffers[0] = Snapshot(2, {})
    mgr._newest = 0
    visited = []
    try:
        for s in guard.steps(7, start=1):
            visited.append(s)
            if s == 4 and 4 not in guard.skip:
                guard.observe(4, float("nan"))
            else:
                guard.observe(s, 1.0)
    finally:
        mgr.close()
    assert visited == [1, 2, 3, 4, 3, 5, 6]
