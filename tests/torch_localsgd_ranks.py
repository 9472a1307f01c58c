"""Rank bodies of the port's LocalSGD tests: each runs inside a rank of a
`paddle_tpu_torch.testing.gloo_gang` (one CPU process per rank, joined by
gloo) and returns plain numpy/JSON values; torch and the port only. The
reference's side is tests/torch_localsgd_reference.py. Every rank feeds
the global batch, as the reference's single controller does."""
import numpy as np
import torch

from paddle_tpu_torch import initializer, io, layers, optimizer
from paddle_tpu_torch.distributed import collective as coll
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.framework import (Executor, default_main_program,
                                        default_startup_program)
from paddle_tpu_torch.framework.scope import global_scope
from paddle_tpu_torch.layer_helper import ParamAttr
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.parallel import zero
from paddle_tpu_torch.testing import reset_programs

LR = {("fc", "sgd"): 0.05, ("fc", "adam"): 1e-2,
      ("gpt", "sgd"): 0.1, ("gpt", "adam"): 1e-3}


def _rule(model, rule):
    lr = LR[(model, rule)]
    return (optimizer.SGD(learning_rate=lr) if rule == "sgd"
            else optimizer.Adam(learning_rate=lr))


def build(model, rule, k, stage=0):
    """The fc model (x[8] -> fc 16 relu -> fc 1, square error, mean) or
    GPT-tiny (dropout 0) through fleet with LocalSGD k steps."""
    reset_programs(0)
    if model == "fc":
        init = initializer.TruncatedNormal(scale=0.3)
        x = layers.data(name="x", shape=[8], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        h = layers.fc(x, 16, act="relu",
                      param_attr=ParamAttr(name="w1", initializer=init),
                      bias_attr=ParamAttr(name="b1"))
        pred = layers.fc(h, 1,
                         param_attr=ParamAttr(name="w2", initializer=init),
                         bias_attr=ParamAttr(name="b2"))
        loss = layers.mean(layers.square_error_cost(pred, y))
    else:
        from paddle_tpu_torch.models import gpt
        _, loss = gpt.build_lm_program(gpt.GPTConfig.tiny())
    fleet.init(is_collective=True)
    s = fleet.DistributedStrategy()
    s.localsgd = True
    s.localsgd_configs = {"k_steps": k}
    s.sharding_stage = stage
    fleet.distributed_optimizer(_rule(model, rule), s).minimize(loss)
    exe = Executor("cpu")
    exe.run(default_startup_program())
    return exe, default_main_program(), loss


def _feeds(model, batch):
    return ({"x": batch[0], "y": batch[1]} if model == "fc"
            else {"tokens": batch})


def arm(model, rule, k, init, batches, via_dataset=False):
    """len(batches) steps from `init`: losses, the synced view after every
    step, this rank's copies at the end, and the marker plan."""
    exe, prog, loss = build(model, rule, k)
    scope = global_scope()
    io.restore_arrays(scope, init, program=prog, device="cpu")
    names = sorted(init)
    feeds = [_feeds(model, b) for b in batches]
    views, losses = [], []
    if via_dataset:
        last = exe.train_from_dataset(prog, feeds, fetch_list=[loss],
                                      steps_per_loop=3)
        losses = [float(np.asarray(last[0]))]
    else:
        for f in feeds:
            out, = exe.run(prog, feed=f, fetch_list=[loss])
            losses.append(float(out))
            views.append({n: scope.numpy(n) for n in names})
    return {"losses": losses, "views": views,
            "view": {n: scope.numpy(n) for n in names},
            "copies": {n: scope.numpy(n + "@LOCALSGD") for n in names},
            "step": int(scope.find("__localsgd_step__")),
            "plan": exe._collective_marker_plan(prog),
            "buckets": len(zero.zero_buckets(prog))}


def suite(arms, fc_init, fc_batches, gpt_init, gpt_tokens):
    """Every (model, rule, k) arm, the dataset arm, and the sharding
    request's fallback count."""
    torch.manual_seed(0)
    data = {"fc": (fc_init, fc_batches), "gpt": (gpt_init, gpt_tokens)}
    out = {}
    for model, rule, k in arms:
        out[f"{model}_{rule}_k{k}"] = arm(model, rule, k, *data[model])
    out["dataset"] = arm("fc", "adam", 2, fc_init, fc_batches,
                         via_dataset=True)
    metrics.reset("executor.zero_manual_fallbacks.localsgd")
    exe, prog, _ = build("fc", "adam", 2, stage=1)
    out["sharded"] = {
        "fallbacks": metrics.get("executor.zero_manual_fallbacks.localsgd"),
        "buckets": len(zero.zero_buckets(prog)),
        "grad_buckets": bool(getattr(prog, "_grad_buckets", None))}
    out["rank"] = coll.get_rank()
    return out


def flush_alone(root):
    """Rank 1 alone flushes its snapshot and a held peer payload, rank 0
    calls nothing: a snapshot flush is this rank's own write and waits for
    no other rank. Returns the dirs under `root` after rank 1's flush."""
    import os
    from paddle_tpu_torch.resilience import snapshot
    if coll.get_rank() != 1:
        return None
    mgr = snapshot.SnapshotManager(root=root, rank=1, world=2)
    try:
        mgr._buffers[0] = snapshot.Snapshot(
            4, {"w": np.full(3, 1.0, np.float32)}, rank=1)
        mgr._newest = 0
        mgr._peer = snapshot.Snapshot(4, {"w": np.zeros(3, np.float32)},
                                      rank=0)
        mgr.flush("unit")
    finally:
        mgr.close()
    return sorted(os.listdir(root))
