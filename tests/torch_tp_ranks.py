"""Rank bodies of the port's tensor- and sequence-parallel tests
(tests/test_torch_tp.py, tests/test_torch_sequence_parallel.py): each runs
inside a rank of `paddle_tpu_torch.testing.gloo_gang` (CPU ranks joined
by gloo) and returns plain Python / numpy values. The one-process runs
the tests compare against use the same builders (`model_run`)."""
import numpy as np
import torch

LR = 1e-3


def _load_init(scope, init):
    from paddle_tpu_torch.framework.scope import load_arrays
    load_arrays(scope, init)


def _whole(main, scope):
    from paddle_tpu_torch.framework.scope import to_numpy
    return {p.name: to_numpy(scope.find(p.name))
            for p in main.all_parameters()}


def build_model(kind, tp=1, sp=1, dropout=0.0, sp_mode=None, vocab=None):
    """(main, startup, loss) of tiny GPT or tiny BERT through fleet (Adam
    1e-3), at `tensor_parallel_degree` tp with the model's rules and
    `sequence_parallel_degree` sp."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import Program, program_guard, \
        unique_name
    from paddle_tpu_torch.models import bert, gpt
    main, start = Program(), Program()
    with program_guard(main, start), unique_name.guard():
        if kind == "gpt":
            model = gpt
            cfg = gpt.GPTConfig.tiny()
            cfg.vocab_size = vocab or cfg.vocab_size
            cfg.hidden_dropout = cfg.attention_dropout = dropout
            if sp_mode:
                cfg.sequence_parallel, cfg.sp_mode = True, sp_mode
            _, loss = gpt.build_lm_program(cfg)
        else:
            model = bert
            cfg = bert.BertConfig.tiny()
            cfg.hidden_dropout = cfg.attention_dropout = dropout
            _, _, loss = bert.build_pretrain_program(cfg,
                                                     use_input_mask=True)
        fleet.init(is_collective=True)
        s = fleet.DistributedStrategy()
        s.tensor_parallel_degree = tp
        s.sequence_parallel_degree = sp
        if tp > 1:
            s.tensor_parallel_rules = model.tp_sharding_rules()
        fleet.distributed_optimizer(optimizer.Adam(learning_rate=LR),
                                    s).minimize(loss)
    return main, start, loss


def model_run(kind, init, feeds, tp=1, sp=1, dropout=0.0, sp_mode=None,
              run_steps=False, vocab=None):
    """Startup, `init` loaded over it, one step per feed (or one
    run_steps over them all): (losses, whole parameters, main, scope,
    exe)."""
    from paddle_tpu_torch.framework import Executor, Scope
    main, start, loss = build_model(kind, tp, sp, dropout, sp_mode, vocab)
    scope, exe = Scope(), Executor("cpu")
    exe.run(start, scope=scope)
    _load_init(scope, init)
    if run_steps:
        stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
        got, = exe.run_steps(len(feeds), main, feed=stacked,
                             fetch_list=[loss], scope=scope)
        losses = [float(x) for x in np.asarray(got).ravel()]
    else:
        losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                           scope=scope)[0]))
                  for f in feeds]
    return losses, _whole(main, scope), main, scope, exe


def fc_megatron(init, xv, steps=5):
    """The reference's Megatron fc case (tests/test_distributed.py
    `test_tp_sharding_runs_and_matches`) at dp 2 x tp 2: column-parallel
    w1, row-parallel w2, SGD 0.1, every rank feeding the global batch."""
    from paddle_tpu_torch import initializer, layers, optimizer
    from paddle_tpu_torch.framework import Executor, Scope, Program, \
        program_guard, unique_name
    from paddle_tpu_torch.layer_helper import ParamAttr

    def attr(name):     # the value is the test's, loaded after startup
        return ParamAttr(name=name,
                         initializer=initializer.TruncatedNormal(scale=0.1))
    from paddle_tpu_torch.parallel import mesh as M, spmd
    main, start = Program(), Program()
    with program_guard(main, start), unique_name.guard():
        x = layers.data(name="x", shape=[16], dtype="float32")
        h = layers.fc(x, 32, act="relu", param_attr=attr("w1"),
                      bias_attr=ParamAttr(name="b1"))
        o = layers.fc(h, 4, param_attr=attr("w2"),
                      bias_attr=ParamAttr(name="b2"))
        loss = layers.mean(o)
        optimizer.SGD(learning_rate=0.1).minimize(loss)
    rules = M.ShardingRules([("w1", M.P(None, "tp")),
                             ("w2", M.P("tp", None))])
    mesh = M.build_mesh(dp=2, tp=2)
    spmd.attach(main, spmd.DistConfig(mesh=mesh, param_rules=rules))
    scope, exe = Scope(), Executor("cpu")
    exe.run(start, scope=scope)
    _load_init(scope, init)
    losses = [float(np.asarray(exe.run(main, feed={"x": xv},
                                       fetch_list=[loss], scope=scope)[0]))
              for _ in range(steps)]
    from paddle_tpu_torch.parallel import gspmd
    w1 = scope.find("w1")
    return {"losses": losses, "w1_placements": [repr(p) for p in
                                                 w1.placements],
            "w1_local": list(w1.to_local().shape),
            "mesh": repr(mesh), "coords": [mesh.coordinate(a)
                                           for a in ("dp", "tp")],
            "param_elements": gspmd.local_param_elements(main, scope)}


def tp_suite(gpt_init, gpt_feeds, bert_init, bert_feeds, ckpt_dir):
    """tp 2: tiny GPT and BERT from the given weights (dropout 0), the
    collectives of GPT's last step, run_steps == sequential runs at
    dropout 0.1, dropout 0.1 losses, and a checkpoint written at tp 2 then
    loaded back at tp 2 into a fresh scope."""
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.parallel import gspmd
    from paddle_tpu_torch.resilience import CheckpointManager
    out = {}
    gspmd.by_op.clear()
    coll.reset_counters()
    losses, params, main, scope, _ = model_run("gpt", gpt_init, gpt_feeds,
                                               tp=2)
    out["gpt"] = {"losses": losses, "params": params,
                  "param_elements": gspmd.local_param_elements(main, scope),
                  "wte_placements": [repr(p) for p in
                                     scope.find("wte").placements]}
    losses, params, main, scope, _ = model_run("bert", bert_init,
                                               bert_feeds, tp=2)
    out["bert"] = {"losses": losses, "params": params,
                   "fused_head": any(op.type == "fused_lm_head_ce"
                                     for op in main.global_block().ops)}
    seq, p_seq, *_ = model_run("gpt", gpt_init, gpt_feeds, tp=2,
                               dropout=0.1)
    stk, p_stk, main, scope, exe = model_run("gpt", gpt_init, gpt_feeds,
                                             tp=2, dropout=0.1,
                                             run_steps=True)
    out["dropout"] = {"losses": seq, "run_steps_losses": stk,
                      "params_bitwise": all(np.array_equal(p_seq[n],
                                                           p_stk[n])
                                            for n in p_seq)}
    # the collectives of a step of GPT with a whole vocab table (511
    # rows), by (op, collective, bytes), as chip_smoke's plan reads them
    gspmd.by_op.clear()
    model_run("gpt", {}, gpt_feeds, tp=2, vocab=511)
    out["plan"] = {f"{k[0]} {k[1]} {k[2]}": v for k, v in
                   gspmd.by_op.items()}
    # DTensor's functional collectives as synchronous c10d calls (what a
    # gloo mesh on CUDA installs), here on the CPU
    from paddle_tpu_torch.distributed.collective import \
        install_gloo_functionals
    from paddle_tpu_torch.observability import metrics
    install_gloo_functionals("CPU")
    sync, *_ = model_run("gpt", gpt_init, gpt_feeds, tp=2, dropout=0.1)
    out["sync_functionals"] = {
        "losses": sync, "all_gathers": metrics.get(
            "executor.collective_emulated.all_gather")}
    CheckpointManager(ckpt_dir, max_keep=1).save(
        len(gpt_feeds) - 1, program=main, scope=scope)
    out["saved"] = p_stk
    # back at tp 2 into a fresh scope: the whole arrays redistributed
    from paddle_tpu_torch.framework import Executor, Scope
    main2, start2, _ = build_model("gpt", tp=2, dropout=0.1)
    scope2, exe2 = Scope(), Executor("cpu")
    exe2.run(start2, scope=scope2)
    CheckpointManager(ckpt_dir, max_keep=1).restore_latest(
        program=main2, scope=scope2, executor=exe2)
    exe2._prepare(main2, scope2)
    out["reloaded_tp2"] = _whole(main2, scope2)
    out["reloaded_is_dtensor"] = gspmd.is_dtensor(scope2.find("wte"))
    return out


def sp_suite(gpt_init, gpt_feeds, attn):
    """sp 2: tiny GPT with ring and with Ulysses attention (dropout 0; at
    dropout 0.1 with its activations' local shapes and dropout masks; with
    the fused LM head), and ring_attention / ulysses_attention alone on
    `attn`'s q, k, v,
    key-padding mask and output cotangent (causal, dropout 0.1, seed 5):
    outputs and q, k, v gradients, whole."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.parallel import mesh as M
    import importlib
    ra = importlib.import_module("paddle_tpu_torch.parallel.ring_attention")
    from torch_mesh_ranks import sp_activations
    out = {}
    for mode in ("ring", "ulysses"):
        coll.reset_counters()
        losses, *_ = model_run("gpt", gpt_init, gpt_feeds, sp=2,
                               sp_mode=mode)
        out[mode] = {"losses": losses, "calls": {
            k: v for k, v in coll.counters.items() if k.endswith(".calls")}}
        # the activations' layout and the dropout masks at dropout 0.1,
        # and the fused LM head (a vocabulary of two 8192 chunks)
        out[mode]["dropout"] = sp_activations(gpt_init, gpt_feeds, mode,
                                              dropout=0.1)
        out[mode]["fused_head"] = sp_activations({}, gpt_feeds, mode,
                                                 vocab=16384)[0]
    mesh = M.build_mesh(sp=2)
    dm = mesh.device_mesh
    rep = [Replicate()]

    def dt(name, grad=False):
        t = distribute_tensor(torch.from_numpy(attn[name]), dm, rep,
                              src_data_rank=None)
        return t.requires_grad_() if grad else t

    for name, fn in (("ring", ra.ring_attention),
                     ("ulysses", ra.ulysses_attention)):
        q, k, v = (dt(n, True) for n in "qkv")
        o = fn(q, k, v, mesh=mesh, causal=True, mask=dt("mask"),
               dropout=0.1, seed=5)
        do = distribute_tensor(torch.from_numpy(attn["do"]), dm,
                               o.placements, src_data_rank=None)
        grads = torch.autograd.grad(o, (q, k, v), do)
        out[f"{name}/out"] = o.full_tensor().detach().numpy()
        for n, g in zip("qkv", grads):
            out[f"{name}/d{n}"] = g.full_tensor().numpy()
    try:
        ra.ring_attention(dt("q"), dt("k"), dt("v"), mesh=mesh,
                          mask=dt("full_mask"))
        out["full_mask_raised"] = False
    except ValueError as e:
        out["full_mask_raised"] = "KEY-PADDING" in str(e)
    return out
