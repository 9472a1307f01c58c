"""Test and drill helpers for the port (counterpart of paddle_tpu/testing.py).

`gloo_gang` is the counterpart of the reference's `cpu_mesh_env` (:17):
where the reference runs a dp mesh of virtual CPU devices in one
subprocess, the port runs N CPU processes joined by gloo, one per rank.
The rendezvous is a `FileStore` under a fresh temporary directory, so
gangs started in parallel (the test suite's workers) never share a port.
Ranks are forked from a forkserver that has torch imported, run with one
intra-op thread each, and are killed when the gang's timeout passes.

`zero_resize_flat_build` / `zero_resize_case` port the reference's
train-on-N / resume-on-M drill (:73-156): run them inside a gang's ranks.
"""
from __future__ import annotations

import shutil
import tempfile
from typing import Callable, List, Optional

import numpy as np
import torch

__all__ = ["gloo_gang", "zero_resize_flat_build", "zero_resize_case",
           "reset_programs"]


def _rank_main(func, args, threads, group_timeout_s):
    from .distributed import parallel
    torch.set_num_threads(threads)
    parallel.init_parallel_env(timeout_s=group_timeout_s)
    try:
        return func(*args)
    finally:
        parallel.destroy()


def gloo_gang(func: Callable, nprocs: int, args=(), timeout_s: float = 120.0,
              env: Optional[dict] = None, threads: int = 1,
              group_timeout_s: Optional[float] = None) -> List:
    """Run `func(*args)` on `nprocs` CPU ranks joined by a gloo group
    (`init_parallel_env` runs first in each, with `group_timeout_s` as the
    group's timeout, default FLAGS_gloo_timeout_ms); returns each rank's
    result, by rank. `func` must be importable by module name. A rank's
    error, or the gang's `timeout_s`, kills the gang and raises
    RuntimeError."""
    import multiprocessing as mp
    from .distributed.spawn import spawn
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    tmp = tempfile.mkdtemp(prefix="paddle_gloo_gang_")
    try:
        full_env = {"PADDLE_DIST_INIT_METHOD": f"file://{tmp}/store",
                    "PADDLE_DIST_BACKEND": "gloo",
                    "PADDLE_DIST_DEVICE": "cpu"}
        full_env.update(env or {})
        sctx = spawn(_rank_main,
                     args=(func, tuple(args), threads, group_timeout_s),
                     nprocs=nprocs, join=False, start_method="forkserver",
                     env=full_env)
        sctx.join(timeout_s)
        return [sctx.results[r] for r in range(nprocs)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def reset_programs(seed: int = 0) -> None:
    """Fresh default main/startup programs, global scope and name
    counters."""
    from .framework import program as pm, scope as sm, unique_name
    pm._main_program = pm.Program()
    pm._startup_program = pm.Program()
    sm._global_scope = sm.Scope()
    unique_name.switch()
    pm._main_program.random_seed = seed
    pm._startup_program.random_seed = seed


# --- the ZeRO dp-resize drill ----------------------------------------------

def zero_resize_flat_build(stage: int, device: str = "cpu"):
    """The flat resize model: 8 -> 32 (tanh) -> 1 fc regression, Adam,
    buckets of 0.001 MB so every stage has several. Run in a rank of a
    group of any size (the dp is the group's). Returns (exe, prog, loss,
    feed), `feed(step)` being this rank's block of the step's global batch
    of 8 rows."""
    from . import initializer, layers, optimizer
    from .distributed import fleet
    from .distributed.collective import split_batch
    from .framework import Executor, default_main_program, \
        default_startup_program
    from .layer_helper import ParamAttr

    reset_programs(0)
    init = initializer.TruncatedNormal(scale=0.5)
    x = layers.data(name="x", shape=[8], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    h = layers.fc(x, 32, act="tanh", param_attr=ParamAttr(initializer=init))
    pred = layers.fc(h, 1, param_attr=ParamAttr(initializer=init))
    loss = layers.mean(layers.square_error_cost(pred, y))
    fleet.init(is_collective=True)
    s = fleet.DistributedStrategy()
    s.sharding_stage = stage
    s.fuse_grad_size_in_mb = 0.001
    fleet.distributed_optimizer(optimizer.Adam(learning_rate=1e-2),
                                s).minimize(loss)
    prog = default_main_program()
    exe = Executor(device)
    exe.run(default_startup_program())

    def feed(step):
        rng = np.random.RandomState(100 + step)
        xv = rng.randn(8, 8).astype(np.float32)
        yv = xv.sum(1, keepdims=True).astype(np.float32)
        return {"x": split_batch(xv), "y": split_batch(yv)}

    return exe, prog, loss, feed


def zero_resize_case(build, stage: int, workdir: str, phase: str,
                     steps: int = 3) -> dict:
    """One phase of the drill, in every rank of a gang:

    * phase "train" (the dp_from gang): `steps` steps under ZeRO `stage`,
      then a portable checkpoint of the last step in `workdir` (rank 0
      writes it, every rank waits);
    * phase "resume" (the dp_to gang): from that checkpoint, `steps` more
      steps under ZeRO `stage` and again replicated (stage 0), the
      oracle.

    Returns {"losses": ...} for "train" and {losses_equal, mismatched,
    l_zero, l_repl} for "resume"; bit for bit means losses_equal and an
    empty mismatched list."""
    from .framework.scope import global_scope
    from .io import _portable_arrays
    from .resilience import CheckpointManager

    def arm(arm_stage, resume):
        exe, prog, loss, feed = build(arm_stage)
        mgr = CheckpointManager(workdir, max_keep=2)
        start = 0
        if resume:
            restored = mgr.restore_latest(program=prog,
                                          scope=global_scope(),
                                          executor=exe)
            assert restored is not None, "no checkpoint to resume"
            start = restored + 1
        losses = []
        for step in range(start, start + steps):
            out, = exe.run(prog, feed=feed(step), fetch_list=[loss])
            losses.append(repr(float(np.asarray(out).ravel()[0])))
        return losses, prog, exe

    if phase == "train":
        losses, prog, _ = arm(stage, False)
        CheckpointManager(workdir, max_keep=2).save(
            steps - 1, program=prog, scope=global_scope())
        return {"losses": losses}
    l_zero, prog, _ = arm(stage, True)
    p_zero = _portable_arrays(prog, global_scope())
    l_repl, prog, _ = arm(0, True)
    p_repl = _portable_arrays(prog, global_scope())
    mismatched = sorted(set(p_zero) ^ set(p_repl)) + [
        k for k in sorted(set(p_zero) & set(p_repl))
        if not np.array_equal(p_zero[k], p_repl[k])]
    return {"losses_equal": l_zero == l_repl, "mismatched": mismatched,
            "l_zero": l_zero, "l_repl": l_repl}
