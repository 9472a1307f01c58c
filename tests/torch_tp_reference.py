"""The reference's side of the port's tensor- and sequence-parallel tests:
run as

    python tests/torch_tp_reference.py <task> <inputs.npz> <outputs.npz>

in a `cpu_mesh_env(n)` subprocess (an n-device CPU mesh), where the
reference attaches a DistConfig and GSPMD shards the step. Task "tp"
(4 devices): the Megatron fc case at dp 2 x tp 2 (tests/test_distributed.py
`test_tp_sharding_runs_and_matches`, 5 SGD steps, and its unsharded run),
and tiny GPT and tiny BERT at tp 2 from the given weights (3 Adam steps).
Task "sp" (2 devices): tiny GPT with ring and with Ulysses attention at
sp 2, and `ring_attention` / `ulysses_attention` alone with a key-padding
mask and dropout. Inputs and outputs are npz files (nested values as JSON
under `__json__`)."""
import json
import sys

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu.io import _portable_arrays
from paddle_tpu.parallel import DistConfig, ShardingRules, attach, build_mesh
from paddle_tpu.testing import reset_programs


def _load(init):
    sc = paddle.global_scope()
    for n, a in init.items():
        sc.set(n, jnp.asarray(a))


def fc_arm(init, xv, rules):
    reset_programs(0)
    x = fluid.layers.data(name="x", shape=[16], dtype="float32")
    h = fluid.layers.fc(x, 32, act="relu",
                        param_attr=paddle.ParamAttr(name="w1"),
                        bias_attr=paddle.ParamAttr(name="b1"))
    o = fluid.layers.fc(h, 4, param_attr=paddle.ParamAttr(name="w2"),
                        bias_attr=paddle.ParamAttr(name="b2"))
    loss = fluid.layers.mean(o)
    paddle.optimizer.SGD(learning_rate=0.1).minimize(loss)
    if rules is not None:
        attach(fluid.default_main_program(),
               DistConfig(mesh=build_mesh(dp=2, tp=2), param_rules=rules))
    exe = fluid.Executor()
    exe.run(fluid.default_startup_program())
    _load(init)
    return [float(np.asarray(exe.run(feed={"x": xv},
                                     fetch_list=[loss])[0]))
            for _ in range(5)]


def model_arm(kind, init, feeds, mesh, sp_mode=None):
    """Tiny GPT / BERT from `init`, Adam(1e-3), over `mesh` with the
    model's tp rules; (losses, final parameters)."""
    reset_programs(0)
    if kind == "gpt":
        from paddle_tpu.models import gpt as model
        cfg = model.GPTConfig.tiny()
        if sp_mode:
            cfg.sequence_parallel, cfg.sp_mode = True, sp_mode
        _, loss = model.build_lm_program(cfg)
    else:
        from paddle_tpu.models import bert as model
        cfg = model.BertConfig.tiny()
        cfg.hidden_dropout = cfg.attention_dropout = 0.0
        _, _, loss = model.build_pretrain_program(cfg, use_input_mask=True)
    paddle.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    prog = fluid.default_main_program()
    attach(prog, DistConfig(mesh=mesh, param_rules=model.tp_sharding_rules()))
    exe = fluid.Executor()
    exe.run(fluid.default_startup_program())
    _load(init)
    losses = [float(np.asarray(exe.run(feed=f, fetch_list=[loss])[0]))
              for f in feeds]
    state = _portable_arrays(prog, paddle.global_scope())
    return losses, {n: np.asarray(state[n]) for n in init}


def attention_alone(data, mesh):
    """ring_attention and ulysses_attention with a key-padding mask,
    causal, dropout 0.1, seed 5: outputs and the q, k, v gradients of
    <out, do>."""
    from paddle_tpu.parallel.ring_attention import (ring_attention,
                                                    ulysses_attention)
    q, k, v, do, mask = (jnp.asarray(data[n])
                         for n in ("q", "k", "v", "do", "mask"))
    out = {}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        def f(q, k, v):
            return fn(q, k, v, mesh=mesh, causal=True, mask=mask,
                      dropout=0.1, seed=5)

        @jax.jit
        def fwd_bwd(q, k, v, do):
            o, pull = jax.vjp(f, q, k, v)
            return o, pull(do)
        o, grads = fwd_bwd(q, k, v, do)
        out[f"{name}/out"] = np.asarray(o)
        for n, g in zip("qkv", grads):
            out[f"{name}/d{n}"] = np.asarray(g)
    return out


def main(task, src, dst):
    with np.load(src) as f:
        data = {n: f[n] for n in f.files}
    cfg = json.loads(str(data.pop("__json__")))
    out_json, out_arrays = {"devices": jax.device_count()}, {}

    def arrays(prefix):
        return {n[len(prefix):]: v for n, v in data.items()
                if n.startswith(prefix)}

    if task == "tp":
        fc_init = arrays("fc/")
        tp_rules = ShardingRules([("w1", P(None, "tp")), ("w2", P("tp", None))])
        out_json["fc_plain"] = fc_arm(fc_init, data["xv"], None)
        out_json["fc_tp"] = fc_arm(fc_init, data["xv"], tp_rules)
        mesh = build_mesh(dp=1, tp=2, devices=jax.devices()[:2])
        gpt_feeds = [{"tokens": t} for t in data["gpt_tokens"]]
        bert_feeds = [{"input_ids": a, "mlm_labels": b, "input_mask": c}
                      for a, b, c in zip(data["bert_ids"],
                                         data["bert_labels"],
                                         data["bert_mask"])]
        for kind, feeds in (("gpt", gpt_feeds), ("bert", bert_feeds)):
            losses, params = model_arm(kind, arrays(f"{kind}/"), feeds, mesh)
            out_json[kind] = losses
            out_arrays.update({f"{kind}/{n}": v for n, v in params.items()})
    if task == "sp":
        mesh = build_mesh(sp=2)
        feeds = [{"tokens": t} for t in data["gpt_tokens"]]
        for mode in cfg["modes"]:
            losses, _ = model_arm("gpt", arrays("gpt/"), feeds, mesh, mode)
            out_json[mode] = losses
        out_arrays.update(attention_alone(data, mesh))
    np.savez(dst, __json__=json.dumps(out_json), **out_arrays)


if __name__ == "__main__":
    main(*sys.argv[1:4])
