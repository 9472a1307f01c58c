"""PyTorch port, checkpoints: paddle_tpu_torch's io.py, resilience/
checkpoint.py and the ZeRO round trip of parallel/zero.py, held against
the JAX reference on the CPU, and the resume contract inside the port.

GPT-tiny (2 layers, hidden 64) trained through fleet with AdamW at ZeRO
stage 0 or 1 (`fuse_grad_size_in_mb` 0.05, so stage 1 has several flat
buckets), f32.

* Portable format: the port's `_portable_arrays` has the reference's key
  set for the same program, at stage 0 and at stage 1 (flat buckets split
  into the per-parameter names a stage-0 program uses); a port file adds
  only the RNG entry `__rng_counter__`.
* Across packages, dropout off: a checkpoint written by one package after
  2 steps loads into the other (fresh scope after its startup run), and
  both then train 3 steps: losses within 1e-6 relative, every persistable
  within atol 1e-5, the limit of tests/test_torch_zero.py (the gradients'
  sums run in other orders, and Adam turns a last-bit difference of a tiny
  gradient into a difference of up to ~lr). Stage 1 -> stage 0 and stage
  0 -> stage 1 in both directions. `save_inference_model` of one package loads and runs in the
  other (logits within 1e-5 relative).
* The RNG entry, both ways: a port file loaded into the reference leaves
  its `__rng_state__` key chain alone and its next runs train; a reference
  snapshot file (which carries `__rng_state__`) loaded into the port keeps
  the port's own counter.
* Inside the port, dropout 0.1, a static LR schedule, global-norm clip,
  stage 1: save after 3 steps through CheckpointManager, restore into a
  fresh executor and scope, 3 more steps == 6 steps straight, bit for
  bit (losses, every persistable, the counter), through run() and through
  run_steps. A stage-1 checkpoint resumes a stage-0 program and the other
  way round, bit for bit against the straight run of that stage.
* Loads write in place: after `load_persistables` and a host scheduler's
  `step()`, every tensor a captured step binds is still the scope's
  (`scope.find(n) is t`); a load of another shape rebinds and is counted.
* Crash safety: a torn save (the `ckpt.write` fault) keeps the previous
  checkpoint, a corrupted newest checkpoint falls back to the older one
  (`resilience.ckpt_fallbacks`), a corrupted `save_persistables` file
  raises PreconditionNotMetError, keep-N prunes, and the sparse-table
  arguments raise a typed error naming ROADMAP item 19.
* On the card (`cuda` marker): after a load and a scheduler step the
  captured step replays without a second capture.
"""
import importlib
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu import io as ref_io
from paddle_tpu import layers as ref_layers
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu.models import gpt as ref_gpt
from paddle_tpu.resilience import CheckpointManager as RefCkpt

from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import lr as port_lr
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.framework import Executor, Scope, errors
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.framework.executor import _state_names
from paddle_tpu_torch.models import gpt as port_gpt
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.resilience import (CheckpointManager, FaultInjected,
                                         clear_plan, install_plan)

ref_clip = importlib.import_module("paddle_tpu.clip")
port_clip = importlib.import_module("paddle_tpu_torch.clip")

BATCH, BUCKET_MB = 2, 0.05
_PKG = {
    "ref": dict(prog=ref_program, names=ref_unique_name, gpt=ref_gpt,
                fleet=ref_fleet, opt=paddle.optimizer, clip=ref_clip,
                layers=ref_layers),
    "port": dict(prog=port_program, names=port_unique_name, gpt=port_gpt,
                 fleet=port_fleet, opt=port_optimizer, clip=port_clip,
                 layers=port_layers),
}


def build(pkg, stage=0, dropout=0.0, schedule=False, clip=False,
          host_sched=None):
    """(main, startup, loss, lr var) of GPT-tiny, AdamW through fleet."""
    m = _PKG[pkg]
    main, start = m["prog"].Program(), m["prog"].Program()
    with m["prog"].program_guard(main, start), m["names"].guard():
        cfg = m["gpt"].GPTConfig.tiny()
        cfg.hidden_dropout = cfg.attention_dropout = dropout
        _, loss = m["gpt"].build_lm_program(cfg)
        lr = 1e-3
        if schedule:
            L = m["layers"]
            lr = L.linear_lr_warmup(L.cosine_decay(1e-3, 2, 4), 2, 1e-4,
                                    1e-3)
        if host_sched is not None:
            lr = host_sched
        o = m["opt"].AdamW(
            learning_rate=lr, weight_decay=0.01,
            grad_clip=(m["clip"].GradientClipByGlobalNorm(1.0) if clip
                       else None))
        m["fleet"].init(is_collective=True)
        s = m["fleet"].DistributedStrategy()
        s.sharding_stage = stage
        s.fuse_grad_size_in_mb = BUCKET_MB
        d = m["fleet"].distributed_optimizer(o, s)
        d.minimize(loss)
    return main, start, loss, o.learning_rate_var


def tokens(steps, seed=0):
    cfg = port_gpt.GPTConfig.tiny()
    rng = np.random.RandomState(seed)
    return rng.randint(0, cfg.vocab_size,
                       (steps, BATCH, cfg.seq_len)).astype(np.int64)


def _persistables(main):
    return sorted(v.name for v in main.global_block().vars.values()
                  if v.persistable)


def _close(got, want, what, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rtol * scale, (what, err, scale)


# the reference's programs with their executor, by (stage, build kw): a
# run starts from a fresh scope and its startup program either way, and
# the executor keeps each program's compiled step (XLA's compile is most
# of a reference run's time on the CPU)
_REF_BUILT = {}


class _Run:
    """One package's executor, scope and program."""

    def __init__(self, pkg, stage=0, **kw):
        self.pkg = pkg
        if pkg == "ref":
            key = (stage, tuple(sorted(kw.items())))
            if key not in _REF_BUILT:
                _REF_BUILT[key] = build(pkg, stage, **kw) \
                    + (fluid.Executor(),)
            self.main, self.start, self.loss, self.lr, self.exe = \
                _REF_BUILT[key]
            self.scope = RefScope()
        else:
            self.main, self.start, self.loss, self.lr = build(pkg, stage,
                                                              **kw)
            self.exe, self.scope = Executor("cpu"), Scope()
        self.exe.run(self.start, scope=self.scope)

    def step(self, toks):
        out = self.exe.run(self.main, feed={"tokens": toks},
                           fetch_list=[self.loss], scope=self.scope)
        return float(np.asarray(out[0]).ravel()[0])

    def save(self, d):
        io = ref_io if self.pkg == "ref" else port_io
        if self.pkg == "ref":
            io.save_persistables(self.exe, d, self.main)
        else:
            io.save_persistables(self.exe, d, self.main, scope=self.scope)

    def load(self, d):
        if self.pkg == "ref":
            # the reference's loaders write the global scope
            from paddle_tpu.framework import scope as ref_scope_mod
            ref_scope_mod._global_scope = self.scope
            try:
                ref_io.load_persistables(self.exe, d, self.main)
            finally:
                ref_scope_mod._reset_global_scope()
        else:
            port_io.load_persistables(self.exe, d, self.main,
                                      scope=self.scope)

    def arrays(self):
        if self.pkg == "ref":
            return ref_io._portable_arrays(self.main, self.scope)
        return port_io._portable_arrays(self.main, self.scope)


def _ref_save(run, d):
    from paddle_tpu.framework import scope as ref_scope_mod
    ref_scope_mod._global_scope = run.scope
    try:
        ref_io.save_persistables(run.exe, d, run.main)
    finally:
        ref_scope_mod._reset_global_scope()


# ---------------------------------------------------------------------------
# the portable format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", [0, 1])
def test_checkpoint_key_set_equals_reference(stage, tmp_path):
    ref, port = _Run("ref", stage), _Run("port", stage)
    toks = tokens(1)
    ref.step(toks[0])
    port.step(toks[0])
    r, p = ref.arrays(), port.arrays()
    assert sorted(p) == sorted(r)
    for n in r:
        assert p[n].shape == np.asarray(r[n]).shape, n
    if stage:
        assert port.main._grad_buckets["zero_buckets"]
        flat = {f for b in port.main._grad_buckets["zero_buckets"]
                for f in b["flat"].values()}
        assert not flat & set(p)          # no flat bucket in the file
    port.save(str(tmp_path))
    with np.load(tmp_path / "persistables.npz") as data:
        assert sorted(data.files) == sorted(set(p) | {"__rng_counter__"})
        assert int(data["__rng_counter__"]) == 2    # startup + one step


@pytest.fixture(scope="module")
def writers(tmp_path_factory):
    """One writer a (package, stage), shared by the readers at both
    stages: after 2 steps its checkpoint, then its losses over 3 more
    steps and its portable arrays after them. Dropout is off, so a
    writer's run is the same whichever reader it is compared with."""
    cache = {}

    def get(pkg, stage):
        if (pkg, stage) not in cache:
            src, toks = _Run(pkg, stage), tokens(5, seed=1)
            for b in range(2):
                src.step(toks[b])
            d = str(tmp_path_factory.mktemp(f"{pkg}_s{stage}"))
            src.save(d) if pkg == "port" else _ref_save(src, d)
            losses = [src.step(toks[b]) for b in range(2, 5)]
            arrays = {n: np.array(v) for n, v in src.arrays().items()}
            cache[(pkg, stage)] = (d, losses, arrays)
        return cache[(pkg, stage)]
    return get


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
@pytest.mark.parametrize("stages", [(0, 0), (1, 1), (1, 0), (0, 1)],
                         ids=["s0_s0", "s1_s1", "s1_s0", "s0_s1"])
def test_checkpoint_loads_across_packages(direction, stages, writers):
    """Writer at stages[0], reader at stages[1]; the writer goes on
    training from its own state beside the reader."""
    src_pkg, dst_pkg = direction.split("_to_")
    d, a, want = writers(src_pkg, stages[0])
    dst = _Run(dst_pkg, stages[1])
    toks = tokens(5, seed=1)
    dst.load(d)
    b = [dst.step(toks[b]) for b in range(2, 5)]
    _close(b, a, "losses", 1e-6)
    got = dst.arrays()
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(np.asarray(got[n], np.float32),
                                   np.asarray(want[n], np.float32),
                                   rtol=0, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_inference_model_loads_across_packages(direction, tmp_path):
    src_pkg, dst_pkg = direction.split("_to_")
    src = _Run(src_pkg, 0)
    toks = tokens(2, seed=2)
    src.step(toks[0])
    # the LM program's target is its loss (computed from the tokens alone)
    target, prog = src.loss, src.main
    d = str(tmp_path / "infer")
    if src_pkg == "ref":
        from paddle_tpu.framework import scope as ref_scope_mod
        ref_scope_mod._global_scope = src.scope
        try:
            ref_io.save_inference_model(d, ["tokens"], [target], src.exe,
                                        main_program=prog)
        finally:
            ref_scope_mod._reset_global_scope()
        want = src.exe.run(prog.clone(for_test=True),
                           feed={"tokens": toks[1]},
                           fetch_list=[target.name], scope=src.scope)[0]
        scope = Scope()
        p, feeds, fetch = port_io.load_inference_model(
            d, Executor("cpu"), scope=scope)
        got = Executor("cpu").run(p, feed={"tokens": toks[1]},
                                  fetch_list=fetch, scope=scope)[0]
    else:
        port_io.save_inference_model(d, ["tokens"], [target], src.exe,
                                     main_program=prog, scope=src.scope)
        want = src.exe.run(prog.clone(for_test=True),
                           feed={"tokens": toks[1]},
                           fetch_list=[target.name], scope=src.scope)[0]
        from paddle_tpu.framework import scope as ref_scope_mod
        scope = ref_scope_mod._reset_global_scope()
        try:
            p, feeds, fetch = ref_io.load_inference_model(d,
                                                          fluid.Executor())
            got = fluid.Executor().run(p, feed={"tokens": toks[1]},
                                       fetch_list=fetch, scope=scope)[0]
        finally:
            ref_scope_mod._reset_global_scope()
    assert feeds == ["tokens"]
    types = [op.type for op in p.global_block().ops]
    assert types[-1] == "mean" and "__vjp__" not in types \
        and "adamw" not in types
    _close(got, want, "inference output", 1e-5)


# ---------------------------------------------------------------------------
# the RNG entry
# ---------------------------------------------------------------------------

def test_port_file_leaves_the_reference_key_chain_alone(tmp_path):
    port = _Run("port", 0, dropout=0.1)
    port.step(tokens(1)[0])
    port.save(str(tmp_path))
    ref = _Run("ref", 0, dropout=0.1)
    ref.step(tokens(1)[0])
    key_before = np.asarray(
        __import__("jax").random.key_data(ref.scope.find("__rng_state__")))
    ref.load(str(tmp_path))
    key_after = np.asarray(
        __import__("jax").random.key_data(ref.scope.find("__rng_state__")))
    assert np.array_equal(key_before, key_after)
    assert int(np.asarray(ref.scope.find("__rng_counter__"))) == 2
    losses = [ref.step(t) for t in tokens(2, seed=3)]
    assert all(np.isfinite(losses))


def test_reference_snapshot_keeps_the_port_counter(tmp_path):
    from paddle_tpu.resilience.snapshot import _portable_state
    ref = _Run("ref", 0, dropout=0.1)
    ref.step(tokens(1)[0])
    arrays = _portable_state(ref.main, ref.scope)
    assert "__rng_state__" in arrays          # the reference's key data
    RefCkpt(str(tmp_path), max_keep=1).save(1, arrays=arrays)
    port = _Run("port", 0, dropout=0.1)
    for t in tokens(3, seed=4):
        port.step(t)
    assert port.scope.find("__rng_state__") == 4
    step = CheckpointManager(str(tmp_path)).restore_latest(
        program=port.main, scope=port.scope, device="cpu")
    assert step == 1
    assert port.scope.find("__rng_state__") == 4   # kept
    wte = port.scope.numpy("wte")
    np.testing.assert_array_equal(wte, np.asarray(ref.scope.find("wte")))


# ---------------------------------------------------------------------------
# resume inside the port
# ---------------------------------------------------------------------------

def _run_steps(run, toks, captured):
    if captured:
        out, = run.exe.run_steps(len(toks), run.main,
                                 feed={"tokens": toks},
                                 fetch_list=[run.loss], scope=run.scope)
        return [float(x) for x in out]
    return [run.step(t) for t in toks]


def _state(run):
    return {n: run.scope.numpy(n) for n in _persistables(run.main)
            if run.scope.find(n) is not None}


@pytest.mark.parametrize("captured", [False, True],
                         ids=["run", "run_steps"])
def test_resume_equals_the_straight_run_bitwise(captured, tmp_path):
    kw = dict(dropout=0.1, schedule=True, clip=True)
    toks = tokens(6, seed=5)
    straight = _Run("port", 1, **kw)
    want = _run_steps(straight, toks, captured)
    first = _Run("port", 1, **kw)
    got = _run_steps(first, toks[:3], captured)
    mgr = CheckpointManager(str(tmp_path), max_keep=2)
    mgr.save(3, program=first.main, scope=first.scope)
    del first
    resumed = _Run("port", 1, **kw)
    assert mgr.restore_latest(program=resumed.main, scope=resumed.scope,
                              executor=resumed.exe) == 3
    assert resumed.scope.find("__rng_state__") == 4
    got += _run_steps(resumed, toks[3:], captured)
    assert got == want
    a, b = _state(straight), _state(resumed)
    assert sorted(a) == sorted(b)
    for n in a:
        assert np.array_equal(a[n], b[n]), n
    assert straight.scope.find("__rng_state__") \
        == resumed.scope.find("__rng_state__")


@pytest.mark.parametrize("stages", [(1, 0), (0, 1)], ids=["s1_s0", "s0_s1"])
def test_resume_across_zero_stages_bitwise(stages, tmp_path):
    toks = tokens(5, seed=6)
    straight = _Run("port", stages[1], dropout=0.1)
    want = [straight.step(t) for t in toks]
    first = _Run("port", stages[0], dropout=0.1)
    got = [first.step(t) for t in toks[:2]]
    port_io.save(first.main, str(tmp_path / "model"), scope=first.scope)
    resumed = _Run("port", stages[1], dropout=0.1)
    port_io.load(resumed.main, str(tmp_path / "model"),
                 scope=resumed.scope, device="cpu")
    got += [resumed.step(t) for t in toks[2:]]
    assert got == want
    a, b = _state(straight), _state(resumed)
    for n in a:
        assert np.array_equal(a[n], b[n]), n


# ---------------------------------------------------------------------------
# loads keep a capture bound (the repair)
# ---------------------------------------------------------------------------

def test_load_and_scheduler_step_keep_every_bound_tensor(tmp_path):
    sched = port_lr.LinearWarmup(1e-3, warmup_steps=3, start_lr=1e-4,
                                 end_lr=1e-3)
    run = _Run("port", 1, host_sched=sched)
    toks = tokens(3, seed=7)
    run.step(toks[0])
    run.save(str(tmp_path))
    run.step(toks[1])
    block = run.main.global_block()
    bound = {n: run.scope.find(n) for n in _state_names(block, run.scope)}
    assert len(bound) > 10
    metrics.reset()
    run.load(str(tmp_path))
    sched.step()
    assert set(_state_names(block, run.scope)) == set(bound)
    for n, t in bound.items():
        assert run.scope.find(n) is t, n
    assert metrics.get("io.load_rebinds") == 0
    # the loaded values are there, and the new LR
    with np.load(tmp_path / "persistables.npz") as data:
        assert np.array_equal(run.scope.numpy("wte"), data["wte"])
    assert run.scope.numpy(run.lr.name).tolist() == [np.float32(sched())]
    # a value of another shape rebinds, and is counted
    port_io.restore_arrays(run.scope, {"wte": np.zeros((3, 3), np.float32)})
    assert run.scope.find("wte") is not bound["wte"]
    assert metrics.get("io.load_rebinds") == 1


# ---------------------------------------------------------------------------
# crash safety
# ---------------------------------------------------------------------------

def test_torn_save_keeps_the_previous_checkpoint(tmp_path):
    run = _Run("port", 0)
    toks = tokens(2, seed=8)
    run.step(toks[0])
    mgr = CheckpointManager(str(tmp_path), max_keep=3)
    mgr.save(1, program=run.main, scope=run.scope)
    want = run.scope.numpy("wte")
    run.step(toks[1])
    install_plan("ckpt.write:error:at=1")
    try:
        with pytest.raises(FaultInjected):
            mgr.save(2, program=run.main, scope=run.scope)
    finally:
        clear_plan()
    assert mgr.steps() == [1]
    assert any(".tmp." in d for d in os.listdir(tmp_path))
    fresh = _Run("port", 0)
    assert mgr.restore_latest(program=fresh.main, scope=fresh.scope,
                              device="cpu") == 1
    np.testing.assert_array_equal(fresh.scope.numpy("wte"), want)


def test_corrupted_checkpoint_falls_back_and_is_counted(tmp_path):
    run = _Run("port", 0)
    toks = tokens(2, seed=9)
    mgr = CheckpointManager(str(tmp_path), max_keep=3)
    run.step(toks[0])
    mgr.save(1, program=run.main, scope=run.scope)
    want = run.scope.numpy("wte")
    run.step(toks[1])
    mgr.save(2, program=run.main, scope=run.scope)
    with open(os.path.join(mgr.path(2), "params.npz"), "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02\x03")
    metrics.reset()
    fresh = _Run("port", 0)
    assert mgr.restore_latest(program=fresh.main, scope=fresh.scope,
                              device="cpu") == 1
    assert metrics.get("resilience.ckpt_fallbacks") == 1
    np.testing.assert_array_equal(fresh.scope.numpy("wte"), want)


def test_corrupted_persistables_raise_the_typed_error(tmp_path):
    run = _Run("port", 0)
    run.step(tokens(1)[0])
    path = run.save(str(tmp_path)) or str(tmp_path / "persistables.npz")
    with open(path, "r+b") as f:
        f.seek(64)
        f.write(b"\xff\xfe")
    with pytest.raises(errors.PreconditionNotMetError, match="checksum"):
        run.load(str(tmp_path))


def test_keep_n_and_the_sparse_arguments(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_keep=2)
    for s in range(4):
        mgr.save(s, arrays={"w": np.full(3, s, np.float32)})
    assert mgr.steps() == [2, 3]
    with pytest.raises(errors.UnimplementedError, match="item 19"):
        mgr.save(5, arrays={}, sparse_client=object(), sparse_tables=[0])
    with pytest.raises(errors.UnimplementedError, match="item 19"):
        mgr.restore_latest(scope=Scope(), sparse_tables=[0])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured step runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_load_and_scheduler_step_keep_one_capture_on_the_card(cuda_card,
                                                              tmp_path):
    cfg = port_gpt.GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                             num_heads=2, intermediate_size=256,
                             max_position=64, seq_len=64,
                             hidden_dropout=0.1, attention_dropout=0.1)
    sched = port_lr.LinearWarmup(1e-3, warmup_steps=4, start_lr=1e-4,
                                 end_lr=1e-3)
    main, start = port_program.Program(), port_program.Program()
    with port_program.program_guard(main, start), \
            port_unique_name.guard():
        _, loss = port_gpt.build_lm_program(cfg)
        port_fleet.init(is_collective=True)
        s = port_fleet.DistributedStrategy()
        s.sharding_stage = 1
        port_fleet.distributed_optimizer(
            port_optimizer.AdamW(learning_rate=sched), s).minimize(loss)
    exe, scope = Executor("cuda"), Scope()
    exe.run(start, scope=scope)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (3, 2, cfg.seq_len))
    exe.run_steps(3, main, feed={"tokens": toks}, fetch_list=[loss],
                  scope=scope)
    port_io.save_persistables(exe, str(tmp_path), main, scope=scope)
    lrs = []
    for _ in range(3):
        # the file's LR comes back with the load; the scheduler's step
        # then writes the next one, in place
        port_io.load_persistables(exe, str(tmp_path), main, scope=scope)
        sched.step()
        out, = exe.run_steps(3, main, feed={"tokens": toks},
                             fetch_list=[loss], scope=scope)
        assert np.isfinite(out).all()
        lrs.append(scope.numpy(main.global_block().var(
            [v for v in main.global_block().vars
             if v.startswith("learning_rate")][0]).name).tolist())
    assert exe.stats["captures"] == 1
    assert exe.stats["eager_steps"] == 1           # the startup program
    assert exe.stats["graph_replays"] == 12
    assert len({tuple(x) for x in lrs}) == 3
