"""Rank bodies of the port's composed-mesh tests
(tests/test_torch_{zero_tp,layer_scan_tp,pipeline_tp}.py and the
sequence-sharded activations of tests/test_torch_sequence_parallel.py):
each runs inside a rank of `paddle_tpu_torch.testing.gloo_gang` (CPU ranks
joined by gloo) and returns plain Python / numpy values. `mesh_run` is
also the one-process run the tests compare against."""
import numpy as np

LR = 1e-3


def build(kind="gpt", tp=1, sp=1, stage=0, sp_mode=None, dropout=0.0,
          layer_scan=False, recompute=False, pp=0, micro=0, merge=0,
          vocab=None):
    """(main, startup, loss) of tiny GPT or tiny BERT through fleet (Adam
    1e-3) on a dp x tp x sp mesh of the gang (dp: what tp and sp leave),
    with ZeRO `stage`, `layer_scan` (remat = `recompute`), `pp` pipeline
    stages on CPU stage devices, `micro` GPipe / pipeline microbatches and
    `merge` gradient-merge steps."""
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
            cfg.pipeline_stages = pp
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
        s.sharding_stage = stage
        if layer_scan:
            s.layer_scan = True
            s.recompute = recompute
        if pp > 1:
            s.pipeline_parallel_degree = pp
            s.pipeline_configs = {"accumulate_steps": micro or 1,
                                  "stage_devices": ["cpu"] * pp}
        if micro > 1:
            s.pipeline = True
            s.pipeline_configs = dict(s.pipeline_configs,
                                      accumulate_steps=micro)
        if merge > 1:
            s.gradient_merge = True
            s.gradient_merge_configs = {"k_steps": merge, "avg": True}
        fleet.distributed_optimizer(optimizer.Adam(learning_rate=LR),
                                    s).minimize(loss)
    return main, start, loss


def unstacked(main, params):
    """A rolled program's `@LAYERS` stacks as their per-layer entries (of
    either package's program: `_layer_stacks` names them)."""
    stacks = getattr(main, "_layer_stacks", None) or {}
    out = {}
    for n, v in params.items():
        if n in stacks:
            out.update(zip(stacks[n], v))
        else:
            out[n] = v
    return out


def mesh_run(init, feeds, **kw):
    """Startup, `init` loaded over it, one Executor.run per feed:
    (losses, whole parameters (a rolled program's per layer), main,
    scope)."""
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.framework.scope import load_arrays, to_numpy
    main, start, loss = build(**kw)
    scope, exe = Scope(), Executor("cpu")
    exe.run(start, scope=scope)
    load_arrays(scope, init, device="cpu")
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope)[0])) for f in feeds]
    params = {p.name: to_numpy(scope.find(p.name))
              for p in main.all_parameters()}
    return losses, unstacked(main, params), main, scope


def card_functionals():
    """DTensor's functional collectives as the synchronous c10d calls a
    gloo mesh on the card installs (distributed/collective.py), here for
    CPU tensors: the suites run the card's collective path."""
    from paddle_tpu_torch.distributed.collective import \
        install_gloo_functionals
    install_gloo_functionals("CPU")


def state_bytes(main, scope):
    """Bytes of optimizer state this rank holds (parallel/zero.py
    `held_state_bytes`)."""
    from paddle_tpu_torch.parallel import zero
    return zero.held_state_bytes(main, scope)["state_bytes_per_device"]


def _program_desc(main):
    return main.to_desc()


def zero_suite(gpt_init, gpt_feeds, bert_init, bert_feeds, ckpt_dir):
    """dp 2 x tp 2 and dp 2 x sp 2 (Ulysses), 4 ranks: GPT at ZeRO
    stages 0-2 (losses, whole parameters, the desc, the state bytes a rank
    holds), BERT at stages 0 and 1 on dp 2 x tp 2, gradient merge (k 2) at
    stages 0 and 1 on dp 2 x tp 2 (its fallback count and the
    accumulators' placements), the shard each rank's B8 update took at
    stage 1, and a stage-1 checkpoint written at dp 2 x tp 2 and loaded
    back there into a fresh scope."""
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.parallel import zero
    card_functionals()
    out = {}
    seen = []
    apply_rule = zero._apply_update_rule

    def spy(ctx, op_type, inner_ins, attrs):
        p = inner_ins["Param"][0]
        seen.append((int(p.storage_offset()), int(p.numel())))
        return apply_rule(ctx, op_type, inner_ins, attrs)

    for mesh_name, kw in (("tp", {"tp": 2}),
                          ("sp", {"sp": 2, "sp_mode": "ulysses"})):
        for stage in (0, 1, 2):
            seen.clear()
            zero._apply_update_rule = spy
            try:
                losses, params, main, scope = mesh_run(
                    gpt_init, gpt_feeds, stage=stage, **kw)
            finally:
                zero._apply_update_rule = apply_rule
            zb = zero.zero_buckets(main)
            out[f"gpt_{mesh_name}_s{stage}"] = {
                "losses": losses, "params": params,
                "desc": _program_desc(main) if mesh_name == "tp" else None,
                "state_bytes": state_bytes(main, scope),
                "padded": [int(b["padded"]) for b in zb],
                "update_shards": list(seen),
                "state_specs": dict(main._dist_config.state_specs)}
            if mesh_name == "tp" and stage == 1:
                from paddle_tpu_torch.resilience import CheckpointManager
                CheckpointManager(ckpt_dir, max_keep=1).save(
                    len(gpt_feeds) - 1, program=main, scope=scope)
    for stage in (0, 1):
        losses, params, main, scope = mesh_run(
            bert_init, bert_feeds, kind="bert", tp=2, stage=stage)
        out[f"bert_tp_s{stage}"] = {"losses": losses, "params": params}
    for stage in (0, 1):
        metrics.reset()
        losses, params, main, scope = mesh_run(
            gpt_init, gpt_feeds + gpt_feeds, tp=2, stage=stage, merge=2)
        m = scope.find("dec0_attn_qkv_w_moment1_0")
        out[f"gpt_merge_s{stage}"] = {
            "losses": losses, "params": params,
            "fallbacks": metrics.get(
                "executor.zero_manual_fallbacks.grad_merge"),
            "moment_placements": [repr(p) for p in m.placements],
            "state_bytes": state_bytes(main, scope)}
    # the stage-1 checkpoint back at dp 2 x tp 2 into a fresh scope
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.framework.scope import to_numpy
    from paddle_tpu_torch.resilience import CheckpointManager
    main, start, _ = build(tp=2, stage=1)
    scope, exe = Scope(), Executor("cpu")
    exe.run(start, scope=scope)
    CheckpointManager(ckpt_dir, max_keep=1).restore_latest(
        program=main, scope=scope, executor=exe)
    exe._prepare(main, scope)
    out["reloaded"] = {p.name: to_numpy(scope.find(p.name))
                       for p in main.all_parameters()}
    flat = sorted(zero.zero_buckets(main)[0]["flat"].values())[0]
    out["reloaded_flat_local"] = int(scope.find(flat).to_local().numel())
    return out


class ActivationSpy:
    """While installed, records the local shape of each residual
    `elementwise_add` output a step computes: the layout of the
    activations after attention."""

    def __init__(self):
        from paddle_tpu_torch.ops import registry
        self.adds = []
        self._op = registry.get("elementwise_add")
        self._lower = self._op.lower

    def __enter__(self):
        from paddle_tpu_torch.parallel import gspmd

        def add(ctx, ins, attrs):
            out = self._lower(ctx, ins, attrs)
            o = out["Out"][0]
            if o.dim() == 3 and ins["Y"][0].dim() == 3:
                self.adds.append(tuple((o.to_local() if gspmd.is_dtensor(o)
                                        else o).shape))
            return out

        self._op.lower = add
        return self

    def __exit__(self, *exc):
        self._op.lower = self._lower
        return False


def sp_activations(init, feeds, mode, dropout=0.0, vocab=None):
    """Runs at sp 2 (or sp 1 for mode None) under an ActivationSpy:
    (losses, local shapes of the residual adds, every dropout op's keep
    mask of every step, fetched whole)."""
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.framework.scope import load_arrays
    main, start, loss = build(sp=2 if mode else 1, sp_mode=mode,
                              dropout=dropout, vocab=vocab)
    masks = [op.outputs["Mask"][0] for op in main.global_block().ops
             if op.type == "dropout"]
    scope, exe = Scope(), Executor("cpu")
    exe.run(start, scope=scope)
    load_arrays(scope, init, device="cpu")
    losses, got = [], []
    with ActivationSpy() as spy:
        for f in feeds:
            out = exe.run(main, feed=f, fetch_list=[loss] + masks,
                          scope=scope)
            losses.append(float(np.asarray(out[0])))
            got.extend(np.asarray(m) for m in out[1:])
    return losses, spy.adds, got


def layer_scan_suite(init, feeds):
    """tp 2, and sp 2 with ring and with Ulysses attention, 2 ranks: tiny
    GPT unrolled, rolled and rolled with remat (losses, whole per-layer
    parameters), the stacked QKV weight's placements and local shape at
    tp 2, and the calls of the flash wrapper (its plain version on CPU
    tensors) a run made."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    card_functionals()
    calls = [0]
    wrapper = fa.flash_attention

    def counted(q, *a, **k):
        # the runs' calls (the program build infers shapes on meta
        # tensors)
        calls[0] += q.device.type != "meta"
        return wrapper(q, *a, **k)

    out = {}
    for name, kw in (("tp", {"tp": 2}),
                     ("ring", {"sp": 2, "sp_mode": "ring"}),
                     ("ulysses", {"sp": 2, "sp_mode": "ulysses"})):
        for arm, extra in (("unrolled", {}), ("rolled", {"layer_scan": True}),
                           ("remat", {"layer_scan": True,
                                      "recompute": True})):
            calls[0] = 0
            fa.flash_attention = counted
            try:
                losses, params, main, scope = mesh_run(init, feeds, **kw,
                                                       **extra)
            finally:
                fa.flash_attention = wrapper
            row = {"losses": losses, "params": params,
                   "flash_calls": calls[0]}
            stacked = scope.find("dec0_attn_qkv_w@LAYERS")
            if stacked is not None:
                row["qkv_placements"] = [repr(p) for p in
                                         stacked.placements]
                row["qkv_local"] = list(stacked.to_local().shape)
            out[f"{name}/{arm}"] = row
    return out


def pipeline_suite(init, feeds):
    """tp 2 and sp 2 (Ulysses), 2 ranks: tiny GPT with 4 microbatches as
    GPipe on one stage and over pp 2 stage devices ("cpu" twice): losses,
    whole parameters, the stage homes and the placements of a stage-1
    parameter."""
    card_functionals()
    out = {}
    for name, kw in (("tp", {"tp": 2}),
                     ("sp", {"sp": 2, "sp_mode": "ulysses"})):
        for arm, extra in (("gpipe", {"micro": 4}),
                           ("pp2", {"micro": 4, "pp": 2})):
            from paddle_tpu_torch.framework import Executor, Scope
            from paddle_tpu_torch.framework.scope import load_arrays, \
                to_numpy
            main, start, loss = build(**kw, **extra)
            scope, exe = Scope(), Executor("cpu")
            exe.run(start, scope=scope)
            load_arrays(scope, init, device="cpu")
            losses = [float(np.asarray(exe.run(
                main, feed=f, fetch_list=[loss], scope=scope)[0]))
                for f in feeds]
            pb, = exe._pipelines.values()
            w = scope.find("dec1_ffn_in_w")
            out[f"{name}/{arm}"] = {
                "losses": losses,
                "params": {p.name: to_numpy(scope.find(p.name))
                           for p in main.all_parameters()},
                "num_stages": pb.num_stages,
                "homes": {n: pb.var_stage[n] for n in
                          ("wte", "dec0_attn_qkv_w", "dec1_ffn_in_w")},
                "ffn_in_placements": [repr(p) for p in w.placements],
                "max_live_envs": pb.last_max_live_envs}
    return out
