"""The reference's side of the port's data-parallel tests: run as

    python tests/torch_dist_reference.py <task> <inputs.npz> <outputs.npz>

in a `cpu_mesh_env(dp)` subprocess (a dp-device CPU mesh), where fleet
builds a `dp` mesh and the reference's executor runs its manual-dp path
(shard_map over dp). Global batches go in; losses, final parameters,
state bytes and plans come out. Inputs and outputs are npz files (nested
values as JSON under `__json__`)."""
import json
import sys

import numpy as np

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu.distributed import fleet
from paddle_tpu.io import _portable_arrays
from paddle_tpu.parallel.zero import optimizer_state_bytes
from paddle_tpu.testing import reset_programs

FC_PARAMS = ("w1", "b1", "w2", "b2")
RULES = {"adam": lambda: paddle.optimizer.Adam(learning_rate=1e-2),
         "sgd": lambda: paddle.optimizer.SGD(learning_rate=0.05),
         "momentum": lambda: paddle.optimizer.Momentum(learning_rate=0.05,
                                                       momentum=0.9)}


def _manual(exe):
    return bool(getattr(list(exe._cache.values())[-1], "manual_dp", False))


def _load(init):
    sc = paddle.global_scope()
    for n, a in init.items():
        sc.set(n, jnp.asarray(a))


def fc_arm(stage, rule, init, xs, ys, bucket_mb):
    reset_programs(0)
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(x, 16, act="relu",
                        param_attr=paddle.ParamAttr(name="w1"),
                        bias_attr=paddle.ParamAttr(name="b1"))
    pred = fluid.layers.fc(h, 1, param_attr=paddle.ParamAttr(name="w2"),
                           bias_attr=paddle.ParamAttr(name="b2"))
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    fleet.init(is_collective=True)
    s = fleet.DistributedStrategy()
    s.sharding_stage = stage
    s.fuse_grad_size_in_mb = bucket_mb
    fleet.distributed_optimizer(RULES[rule](), s).minimize(loss)
    exe = fluid.Executor()
    exe.run(fluid.default_startup_program())
    _load(init)
    losses = []
    for xv, yv in zip(xs, ys):
        out, = exe.run(feed={"x": xv, "y": yv}, fetch_list=[loss])
        losses.append(float(np.asarray(out)))
    prog = fluid.default_main_program()
    state = _portable_arrays(prog, paddle.global_scope())
    meta = prog._grad_buckets
    return ({"losses": losses, "manual": _manual(exe),
             "bytes": optimizer_state_bytes(prog, jax.device_count()),
             "plan": {"sync": len(meta["sync_buckets"]),
                      "zero": len(meta.get("zero_buckets") or []),
                      "pre_synced": [b["pre_synced"] for b in
                                     meta.get("zero_buckets") or []]}},
            {n: np.asarray(state[n]) for n in FC_PARAMS})


def gpt_arm(init, tokens, stage=1, bucket_mb=0.05):
    from paddle_tpu.models import gpt
    reset_programs(0)
    cfg = gpt.GPTConfig.tiny()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    _, loss = gpt.build_lm_program(cfg)
    fleet.init(is_collective=True)
    s = fleet.DistributedStrategy()
    s.sharding_stage = stage
    s.fuse_grad_size_in_mb = bucket_mb
    fleet.distributed_optimizer(paddle.optimizer.Adam(learning_rate=1e-4),
                                s).minimize(loss)
    exe = fluid.Executor()
    exe.run(fluid.default_startup_program())
    _load(init)
    losses = [float(np.asarray(exe.run(feed={"tokens": t},
                                       fetch_list=[loss])[0]))
              for t in tokens]
    state = _portable_arrays(fluid.default_main_program(),
                             paddle.global_scope())
    return ({"losses": losses, "manual": _manual(exe)},
            {n: np.asarray(state[n]) for n in init})


def main(task, src, dst):
    with np.load(src) as f:
        data = {n: f[n] for n in f.files}
    cfg = json.loads(str(data.pop("__json__")))
    init = {n[5:]: v for n, v in data.items() if n.startswith("init/")}
    out_json, out_arrays = {"devices": jax.device_count()}, {}
    if task == "fc":
        for stage in cfg["stages"]:
            for rule in cfg["rules"]:
                key = f"{stage}_{rule}"
                res, params = fc_arm(stage, rule, init, data["xs"],
                                     data["ys"], cfg["bucket_mb"])
                out_json[key] = res
                out_arrays.update({f"{key}/{n}": v
                                   for n, v in params.items()})
    if task == "fc" and cfg.get("gpt"):
        gpt_init = {n[4:]: v for n, v in data.items()
                    if n.startswith("gpt/")}
        res, params = gpt_arm(gpt_init, data["tokens"])
        out_json["gpt"] = res
        out_arrays.update({f"gpt/{n}": v for n, v in params.items()})
    if task == "collective":
        import paddle_tpu.distributed as dist
        from paddle_tpu.parallel import build_mesh, set_mesh
        set_mesh(build_mesh(dp=jax.device_count()))
        x = data["x"]
        for op in ("sum", "max", "min", "prod"):
            t = paddle.Tensor(dist.split_batch(x))
            out_arrays[f"all_reduce_{op}"] = np.asarray(
                dist.all_reduce(t, op).value)
        out_arrays["all_gather"] = np.stack(
            [np.asarray(p) for p in dist.all_gather(
                None, paddle.Tensor(dist.split_batch(x)))])
        out_arrays["split_batch"] = np.asarray(dist.split_batch(x))
    np.savez(dst, __json__=json.dumps(out_json), **out_arrays)


if __name__ == "__main__":
    main(*sys.argv[1:4])
