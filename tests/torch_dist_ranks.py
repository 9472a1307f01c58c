"""Rank bodies of the port's data-parallel tests: each runs inside a rank
of a `paddle_tpu_torch.testing.gloo_gang` (one CPU process per rank,
joined by gloo) and returns plain numpy/JSON values. torch and the port
only: the ranks never import jax. The reference's side of every
comparison is tests/torch_dist_reference.py."""
import os

import numpy as np
import torch

from paddle_tpu_torch import initializer, io, layers, optimizer
from paddle_tpu_torch.distributed import collective as coll
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.framework import (Executor, default_main_program,
                                        default_startup_program, errors)
from paddle_tpu_torch.framework.scope import global_scope
from paddle_tpu_torch.layer_helper import ParamAttr
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.parallel import zero
from paddle_tpu_torch.testing import reset_programs

FC_PARAMS = ("w1", "b1", "w2", "b2")
FC_BUCKET_MB = 0.0003      # two buckets: [b2, w2, b1] and [w1]
RULES = {"adam": lambda: optimizer.Adam(learning_rate=1e-2),
         "sgd": lambda: optimizer.SGD(learning_rate=0.05),
         "momentum": lambda: optimizer.Momentum(learning_rate=0.05,
                                                momentum=0.9)}


def rank():
    return int(os.environ["PADDLE_TRAINER_ID"])


# --- collectives -------------------------------------------------------------

def collectives(x):
    """Each collective on this rank's block of the global array `x`
    ([world * 2, 3] f32), the reference's dp-sharded array."""
    world, r = coll.get_world_size(), coll.get_rank()
    mine = torch.from_numpy(coll.split_batch(x).copy())
    out = {}
    for op in ("sum", "max", "min", "prod"):
        out[f"all_reduce_{op}"] = coll.all_reduce(mine.clone(), op).numpy()
    out["all_gather"] = np.stack([t.numpy()
                                  for t in coll.all_gather(None, mine)])
    out["broadcast"] = coll.broadcast(mine.clone(), src=world - 1).numpy()
    red = coll.reduce(mine.clone(), dst=0)
    out["reduce"] = red.numpy() if r == 0 else None
    pieces = [torch.full((2, 3), float(10 * i + 1)) for i in range(world)]
    out["scatter"] = coll.scatter(torch.empty(2, 3), pieces
                                  if r == 0 else None, src=0).numpy()
    flat = torch.from_numpy(x.reshape(-1).copy()) * (r + 1)
    out["reduce_scatter_flat"] = coll.reduce_scatter_flat(flat).numpy()
    out["all_gather_flat"] = coll.all_gather_flat(mine.reshape(-1)).numpy()
    coll.barrier()
    out["counters"] = dict(coll.counters)
    return out


def dead_peer():
    """Rank 1 leaves at once; rank 0's all-reduce must raise within the
    group's timeout, not hang."""
    import time
    if rank() != 0:
        return None
    t0 = time.monotonic()
    try:
        coll.all_reduce(torch.ones(4))
    except Exception as e:          # noqa: BLE001 - the error is the result
        return {"raised": type(e).__name__,
                "elapsed_s": time.monotonic() - t0}
    return {"raised": None}


# --- the fc regression model ---------------------------------------------------

def build_fc(stage, rule, bucket_mb=FC_BUCKET_MB):
    """x[8] -> fc 16 relu -> fc 1 -> square_error_cost -> mean through
    fleet (tests/test_distributed.py:47), ZeRO `stage`."""
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
    s.fuse_grad_size_in_mb = bucket_mb
    fleet.distributed_optimizer(RULES[rule](), s).minimize(loss)
    exe = Executor("cpu")
    exe.run(default_startup_program())
    return exe, default_main_program(), loss


def state_bytes(prog, scope):
    """Bytes of the optimizer state this rank holds: the flat bucket
    state and every per-parameter accumulator."""
    names = set()
    for b in zero.zero_buckets(prog):
        names |= set(b["flat"].values())
    for op in prog.global_block().ops:
        for in_slot, _ in zero._UPDATE_STATE_SLOTS.get(op.type, {}).values():
            names |= set(op.inputs.get(in_slot, ()))
    return int(sum(scope.find(n).numel() * scope.find(n).element_size()
                   for n in names if scope.has(n)))


def plan(prog):
    meta = prog._grad_buckets
    return {"sync": len(meta["sync_buckets"]),
            "zero": len(meta["zero_buckets"]),
            "pre_synced": [b["pre_synced"] for b in meta["zero_buckets"]],
            "padded": [b["padded"] for b in meta["zero_buckets"]]}


def fc_arm(stage, rule, init, batches, bucket_mb=FC_BUCKET_MB):
    """3 steps of the fc model from `init` on this rank's block of each
    global batch: losses, the unsharded final state, the collective
    counts of the last step, state bytes and the plan."""
    exe, prog, loss = build_fc(stage, rule, bucket_mb)
    scope = global_scope()
    io.restore_arrays(scope, init, program=prog, device="cpu")
    losses = []
    for xv, yv in batches:
        coll.reset_counters()
        out, = exe.run(prog, feed={"x": coll.split_batch(xv),
                                   "y": coll.split_batch(yv)},
                       fetch_list=[loss])
        losses.append(float(out))
    calls = {k: v for k, v in coll.counters.items() if k.endswith(".calls")}
    from paddle_tpu_torch.io import _portable_arrays
    portable = _portable_arrays(prog, scope)
    dp = coll.get_world_size()
    return {"losses": losses,
            "params": {n: portable[n] for n in FC_PARAMS},
            "counters": calls,
            "state_bytes": state_bytes(prog, scope),
            "bytes_plan": zero.optimizer_state_bytes(prog, dp),
            "plan": plan(prog)}


def fc_arms(arms, init, batches, bucket_mb=FC_BUCKET_MB):
    metrics.reset()
    out = {f"{s}_{r}": fc_arm(s, r, init, batches, bucket_mb)
           for s, r in arms}
    out["fallbacks"] = {k: metrics.get(k) for k in (
        "executor.zero_manual_fallbacks",
        "executor.zero_manual_fallbacks.indivisible_padding")}
    return out


def run_steps_arm(init, batches):
    """run_steps(3) against three run() calls, ZeRO stage 1."""
    got = {}
    for arm in ("runs", "run_steps"):
        exe, prog, loss = build_fc(1, "adam")
        io.restore_arrays(global_scope(), init, program=prog, device="cpu")
        feeds = [{"x": coll.split_batch(xv), "y": coll.split_batch(yv)}
                 for xv, yv in batches]
        metrics.reset("executor.uncaptured_collective_steps")
        eager0 = exe.stats["eager_steps"]
        if arm == "runs":
            losses = [float(exe.run(prog, feed=f, fetch_list=[loss])[0])
                      for f in feeds]
        else:
            stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
            out, = exe.run_steps(3, prog, feed=stacked, fetch_list=[loss])
            losses = [float(v) for v in np.asarray(out)]
        from paddle_tpu_torch.io import _portable_arrays
        got[arm] = {"losses": losses,
                    "state": _portable_arrays(prog, global_scope()),
                    "eager_steps": exe.stats["eager_steps"] - eager0,
                    "uncaptured": metrics.get(
                        "executor.uncaptured_collective_steps")}
    return got


def cross_batch_arm():
    """A dp > 1 program holding a cross-batch op raises, naming the
    cause, and counts it."""
    exe, prog, loss = build_fc(0, "sgd")
    block = prog.global_block()
    block.append_op("batch_norm", inputs={"X": ["x"]},
                    outputs={"Y": ["bn_out"]}, attrs={})
    metrics.reset()
    try:
        exe.run(prog, feed={"x": np.zeros((2, 8), np.float32),
                            "y": np.zeros((2, 1), np.float32)},
                fetch_list=[loss])
    except errors.UnimplementedError as e:
        return {"raised": str(e), "counted": metrics.get(
            "executor.zero_manual_fallbacks.batch_norm")}
    return {"raised": None}


# --- GPT-tiny ----------------------------------------------------------------

def gpt_tiny_arm(init, tokens, stage=1, bucket_mb=0.05):
    """GPT-tiny (dropout 0), Adam 1e-4 through fleet at ZeRO `stage`, 3
    steps on this rank's block of each global batch of tokens."""
    from paddle_tpu_torch.models import gpt
    reset_programs(0)
    cfg = gpt.GPTConfig.tiny()
    _, loss = gpt.build_lm_program(cfg)
    fleet.init(is_collective=True)
    s = fleet.DistributedStrategy()
    s.sharding_stage = stage
    s.fuse_grad_size_in_mb = bucket_mb
    fleet.distributed_optimizer(optimizer.Adam(learning_rate=1e-4),
                                s).minimize(loss)
    prog = default_main_program()
    exe = Executor("cpu")
    exe.run(default_startup_program())
    io.restore_arrays(global_scope(), init, program=prog, device="cpu")
    losses = [float(exe.run(prog, feed={"tokens": coll.split_batch(t)},
                            fetch_list=[loss])[0]) for t in tokens]
    from paddle_tpu_torch.io import _portable_arrays
    state = _portable_arrays(prog, global_scope())
    return {"losses": losses,
            "params": {n: state[n] for n in init},
            "b8_width": [b["padded"] // coll.get_world_size()
                         for b in zero.zero_buckets(prog)]}


def dp_suite(init, batches, gpt_init, gpt_tokens):
    """Everything test_torch_dp.py asks of the dp-2 gang, in one gang."""
    arms = [(s, r) for s in range(4) for r in ("adam", "sgd", "momentum")]
    out = {"fc": fc_arms(arms, init, batches),
           "run_steps": run_steps_arm(init, batches),
           "cross_batch": cross_batch_arm()}
    if gpt_init is not None:
        out["gpt"] = gpt_tiny_arm(gpt_init, gpt_tokens)
    return out


def fc_suite(init, batches, stages=range(4),
             rules=("adam", "sgd", "momentum")):
    return fc_arms([(s, r) for s in stages for r in rules], init, batches)


# --- the elastic resize drill ------------------------------------------------

def resize(phase, workdir, stages=(1, 2, 3)):
    """paddle_tpu_torch.testing.zero_resize_case's `phase` for each stage,
    each stage's checkpoints under workdir/stage<k>."""
    from paddle_tpu_torch import testing
    return {stage: testing.zero_resize_case(
        testing.zero_resize_flat_build, stage,
        os.path.join(workdir, f"stage{stage}"), phase)
        for stage in stages}


# --- the divergence sentinel and global_shuffle -------------------------------

def sentinel(init, batches, snap_root, paths):
    """ZeRO stage 1 at the group's dp: fingerprints after startup and after
    every step, agreeing across ranks; then rank 1's `w1` perturbed: a
    sentinel without snapshots raises naming rank 1; one with the
    snapshots heals every rank to the quorum's newest snapshot. Then
    `global_shuffle(fleet)` over this rank's share of `paths`."""
    from paddle_tpu_torch import dataset as port_dataset
    from paddle_tpu_torch.distributed import gloo
    from paddle_tpu_torch.resilience import (DivergenceSentinel,
                                             ReplicaDivergenceError,
                                             SnapshotManager, fingerprint)
    exe, prog, loss = build_fc(1, "adam")
    scope = global_scope()
    host = gloo.from_env()
    strict = DivergenceSentinel(host, interval=1, heal=False)
    out = {"startup": fingerprint(prog, scope)}
    io.restore_arrays(scope, init, program=prog, device="cpu")
    mgr = SnapshotManager(interval=1, root=snap_root)
    digests = []
    try:
        for step, (xv, yv) in enumerate(batches):
            exe.run(prog, feed={"x": coll.split_batch(xv),
                                "y": coll.split_batch(yv)},
                    fetch_list=[loss])
            assert strict.check(prog, scope, step) is None
            digests.append(strict.last_digests)
            mgr.maybe_capture(prog, scope, step, sync=True)
        out["digests"] = digests
        out["shard_width"] = int(scope.find(
            zero.zero_buckets(prog)[0]["flat"]["moment1"]).numel())
        before = fingerprint(prog, scope)
        if rank() == 1:
            w = scope.find("w1")
            w.view(-1)[0] += 1.0
        try:
            strict.check(prog, scope, len(batches))
            out["raised"] = None
        except ReplicaDivergenceError as e:
            out["raised"] = {"minority": e.minority_ranks, "step": e.step}
        healer = DivergenceSentinel(host, interval=1)
        out["healed_to"] = healer.check(prog, scope, len(batches),
                                        snapshots=mgr)
        out["after_heal"] = fingerprint(prog, scope)
        out["before"] = before
        out["healed_agree"] = healer.check(prog, scope,
                                           len(batches) + 1) is None
    finally:
        mgr.close()
        host.close()
    ds = port_dataset.DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_batch_size(4)
    ds.set_use_var(_slot_vars())
    ds.set_filelist(paths)
    ds.load_into_memory()
    ds.global_shuffle(fleet=fleet)
    out["shuffled"] = [b["x"] for b in ds]
    return out


def _slot_vars():
    from paddle_tpu_torch.framework import program as pm, unique_name
    main, start = pm.Program(), pm.Program()
    with pm.program_guard(main, start), unique_name.guard():
        x = layers.data(name="x", shape=[2], dtype="float32")
        ids = layers.data(name="ids", shape=[3], dtype="int64")
    return [x, ids]
