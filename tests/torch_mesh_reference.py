"""The reference's side of the port's composed-mesh tests
(tests/test_torch_{zero_tp,layer_scan_tp,pipeline_tp}.py): run as

    python tests/torch_mesh_reference.py <inputs.npz> <outputs.npz>

in a `cpu_mesh_env(n)` subprocess (an n-device CPU mesh), where fleet
builds the reference's mesh from the strategy (dp takes what tp, sp and pp
leave of the n devices), attaches its DistConfig and GSPMD shards the
step. Every arm trains the tiny GPT (or tiny BERT) from the given weights
with Adam(1e-3) on the given feeds. The inputs name the arms under
`__json__` as {"arms": {name: {"kind", "strategy", "feeds"}}}, each
feed set `f` stacked per step under `f:<feed name>`, and the weights under
`<kind>/<name>`; the outputs
hold each arm's losses (JSON) and final parameters and, for an arm with
"checkpoint", its unsharded checkpoint arrays (`<name>/ckpt/<entry>`)."""
import json
import sys

import numpy as np

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu.io import _portable_arrays
from paddle_tpu.testing import reset_programs

# a rolled program's stacks as per-layer entries, as the port's side reads
# them (a dict transform: nothing of the port is imported)
from torch_mesh_ranks import unstacked


def _load(init):
    sc = paddle.global_scope()
    for n, a in init.items():
        sc.set(n, jnp.asarray(a))


def arm(kind, init, feeds, strategy):
    """One fleet-built run: (losses, final parameters, program)."""
    from paddle_tpu.distributed import fleet
    reset_programs(0)
    st = dict(strategy)
    if kind == "gpt":
        from paddle_tpu.models import gpt as model
        cfg = model.GPTConfig.tiny()
        if st.pop("sp_mode", None) is not None:
            cfg.sequence_parallel, cfg.sp_mode = True, strategy["sp_mode"]
        cfg.pipeline_stages = st.get("pipeline_parallel_degree", 0)
        _, loss = model.build_lm_program(cfg)
    else:
        from paddle_tpu.models import bert as model
        cfg = model.BertConfig.tiny()
        cfg.hidden_dropout = cfg.attention_dropout = 0.0
        _, _, loss = model.build_pretrain_program(cfg, use_input_mask=True)
    fleet.init(is_collective=True)
    s = fleet.DistributedStrategy()
    for k, v in st.items():
        setattr(s, k, v)
    if s.tensor_parallel_degree > 1:
        s.tensor_parallel_rules = model.tp_sharding_rules()
    fleet.distributed_optimizer(paddle.optimizer.Adam(learning_rate=1e-3),
                                s).minimize(loss)
    prog = fluid.default_main_program()
    exe = fluid.Executor()
    exe.run(fluid.default_startup_program())
    _load(init)
    losses = [float(np.asarray(exe.run(feed=f, fetch_list=[loss])[0]))
              for f in feeds]
    state = _portable_arrays(prog, paddle.global_scope())
    params = {p.name: np.asarray(state[p.name])
              for p in prog.all_parameters() if p.name in state}
    return losses, unstacked(prog, params), state


def main(src, dst):
    with np.load(src) as f:
        data = {n: f[n] for n in f.files}
    cfg = json.loads(str(data.pop("__json__")))
    out_json, out_arrays = {}, {}
    for name, a in cfg["arms"].items():
        init = {n[len(a["kind"]) + 1:]: v for n, v in data.items()
                if n.startswith(a["kind"] + "/")}
        fd = a["feeds"]
        keys = [k for k in data if k.startswith(fd + ":")]
        feeds = [{k[len(fd) + 1:]: data[k][i] for k in keys}
                 for i in range(len(data[keys[0]]))]
        losses, params, state = arm(a["kind"], init, feeds, a["strategy"])
        out_json[name] = losses
        out_arrays.update({f"{name}/{n}": v for n, v in params.items()})
        if a.get("checkpoint"):
            out_arrays.update({f"{name}/ckpt/{n}": np.asarray(v)
                               for n, v in state.items()})
    np.savez(dst, __json__=json.dumps(out_json), **out_arrays)


if __name__ == "__main__":
    main(*sys.argv[1:3])
