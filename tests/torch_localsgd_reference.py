"""The reference's side of the port's LocalSGD tests: run as

    python tests/torch_localsgd_reference.py <inputs.npz> <outputs.npz>

in a `cpu_mesh_env(2)` subprocess, where fleet builds a dp 2 mesh and the
reference's executor runs `_LocalSGDBlock` (every replica's copy a slice
of one [dp, ...] array, the average a pmean). Global batches go in;
losses, the synced view after every step and the replica copies come
out (nested values as JSON under `__json__`)."""
import json
import sys

import numpy as np

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu.distributed import fleet
from paddle_tpu.testing import reset_programs

LR = {("fc", "sgd"): 0.05, ("fc", "adam"): 1e-2,
      ("gpt", "sgd"): 0.1, ("gpt", "adam"): 1e-3}


def build(model, rule, k):
    reset_programs(0)
    if model == "fc":
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, 16, act="relu",
                            param_attr=paddle.ParamAttr(name="w1"),
                            bias_attr=paddle.ParamAttr(name="b1"))
        pred = fluid.layers.fc(h, 1, param_attr=paddle.ParamAttr(name="w2"),
                               bias_attr=paddle.ParamAttr(name="b2"))
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    else:
        from paddle_tpu.models import gpt
        _, loss = gpt.build_lm_program(gpt.GPTConfig.tiny())
    fleet.init(is_collective=True)
    s = fleet.DistributedStrategy()
    s.localsgd = True
    s.localsgd_configs = {"k_steps": k}
    lr = LR[(model, rule)]
    opt = (paddle.optimizer.SGD(learning_rate=lr) if rule == "sgd"
           else paddle.optimizer.Adam(learning_rate=lr))
    fleet.distributed_optimizer(opt, s).minimize(loss)
    exe = fluid.Executor()
    exe.run(fluid.default_startup_program())
    return exe, loss


def arm(model, rule, k, init, batches):
    exe, loss = build(model, rule, k)
    sc = paddle.global_scope()
    for n, a in init.items():
        sc.set(n, jnp.asarray(a))
    names = sorted(init)
    losses, views = [], []
    for b in batches:
        feed = ({"x": b[0], "y": b[1]} if model == "fc" else {"tokens": b})
        out, = exe.run(feed=feed, fetch_list=[loss])
        losses.append(float(np.asarray(out)))
        views.append({n: np.asarray(sc.find(n)).tolist() for n in names})
    copies = {n: np.asarray(sc.find(n + "@LOCALSGD")) for n in names}
    return {"losses": losses, "views": views}, copies


def main(src, dst):
    with np.load(src) as f:
        data = {n: f[n] for n in f.files}
    cfg = json.loads(str(data.pop("__json__")))
    fc_init = {n[3:]: v for n, v in data.items() if n.startswith("fc/")}
    gpt_init = {n[4:]: v for n, v in data.items() if n.startswith("gpt/")}
    fc_batches = list(zip(data["xs"], data["ys"]))
    out_json, out_arrays = {}, {}
    for model, rule, k in cfg["arms"]:
        key = f"{model}_{rule}_k{k}"
        res, copies = arm(model, rule, k,
                          fc_init if model == "fc" else gpt_init,
                          fc_batches if model == "fc" else list(
                              data["tokens"]))
        out_json[key] = res
        out_arrays.update({f"{key}/{n}": v for n, v in copies.items()})
    np.savez(dst, __json__=json.dumps(out_json), **out_arrays)


if __name__ == "__main__":
    main(*sys.argv[1:3])
