"""PyTorch port, pipeline training: `device_guard`, PipelineOptimizer's
GPipe run on one device and the 1F1B pipeline over a pp mesh (both
parallel/pipeline.py `_PipelineBlock`), held against
the JAX reference on the CPU (pytest's conftest gives the reference 8
virtual CPU devices; the port's stages run on "cpu" P times).

* `device_guard` stage attrs, and the descs of a 2-stage MLP and of
  GPT-tiny and BERT-tiny at pipeline_stages 2 (the `__vjp__` ops carry the stage in
  `fwd_attrs`), equal the reference's; the reference's staged desc
  round-trips through the port's `Program.from_desc`.
* GPipe with 4 microbatches against the reference's
  `_run_block_microbatched`, SGD and Adam, 5 steps from the reference's
  startup arrays: rtol 1e-5 on the losses, atol 1e-6 on every
  persistable (f32; the frameworks sum in other orders). An indivisible
  batch raises `InvalidArgumentError`; fleet's `pipeline` strategy makes
  the same program and the same losses. `fleet.init()` and then
  `distributed_optimizer` with `pipeline_parallel_degree` 2 attaches a
  pp-2 mesh, and the run equals the one-device GPipe run bit for bit.
* A persistable the forward writes (an in-place `increment` counter that
  scales the loss) is carried from one microbatch to the next: the
  counter and the losses equal the reference's. Likewise batch_norm's
  running mean advances once per microbatch (the reference's
  tests/test_pipeline.py:124).
* pp 2 against the reference at pp 2: the 2-stage MLP (Adam), a
  parameter shared by both stages (SGD; its two gradients are summed by
  a `sum` on stage 0) and GPT-tiny with its tied `wte` (Adam 1e-2, 2
  microbatches): rtol 1e-4 on the losses, 5e-4 on `wte` (the reference's
  own tolerances, tests/test_pipeline_pp.py:230,236) and atol 1e-4 on
  every parameter of GPT-tiny (1% of its Adam lr, see the test).
* GPT-8L at pp 4 with 6 microbatches: S <= last_max_live_envs <= S + 1,
  the losses equal the port's one-device GPipe run (rtol 1e-5), the
  stage of every parameter and moment equals the reference's, and each
  tensor sits on its stage's device.
* dp 2 x pp 2: two gloo ranks (`testing.gloo_gang`), each pipelining its
  8 rows of a global batch of 16 in 4 microbatches over pp 2 ("cpu"
  twice), SGD 0.1, 4 steps of the reference's 2-stage model
  (tests/test_pipeline_pp.py `_build_2stage`) from the reference's
  startup: the losses and parameters equal the reference's pp2 x dp2 run
  and the port's one-device GPipe run at the reference's 1e-4
  (tests/test_pipeline_pp.py:93); one dp all-reduce a step (plus the
  loss's mean); a planted fault that skips the dp average moves the
  parameters past that limit and the ranks apart.
* A program of 2 stages over a pp 4 mesh raises `InvalidArgumentError`;
  a dp 2 mesh in a one-process job raises; pp > 1 without `devices=` and
  without cards raises; run_steps refuses a pp program; DistConfig takes
  the mesh only (sharding rules and state specs raise naming item 16).
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu import initializer as ref_init
from paddle_tpu import parallel as ref_parallel
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu.models import bert as ref_bert
from paddle_tpu.models import gpt as ref_gpt
from paddle_tpu.parallel import pipeline as ref_pipeline

from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.framework import Executor, Scope, errors, load_numpy
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.layer_helper import ParamAttr as PortParamAttr
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.models import gpt as port_gpt
from paddle_tpu_torch.parallel import mesh as port_mesh
from paddle_tpu_torch.parallel import pipeline as port_pipeline
from paddle_tpu_torch.parallel import spmd as port_spmd
from paddle_tpu_torch.testing import gloo_gang

import torch_dist_ranks as ranks

REF = types.SimpleNamespace(
    prog=ref_program, names=ref_unique_name, L=fluid.layers,
    opt=paddle.optimizer, fleet=ref_fleet, gpt=ref_gpt,
    attr=paddle.ParamAttr, init=ref_init, guard=fluid.device_guard)
PORT = types.SimpleNamespace(
    prog=port_program, names=port_unique_name, L=port_layers,
    opt=port_optimizer, fleet=port_fleet, gpt=port_gpt, attr=PortParamAttr,
    init=port_init, guard=port_program.device_guard)


def _attr(ns, name):
    # the runs load the reference's startup arrays, so the initialiser
    # only fills the startup program
    return ns.attr(name=name, initializer=ns.init.TruncatedNormal(0.0, 0.5))


def mlp(ns, hidden=8):
    """The reference's 2-stage MLP (tests/test_pipeline.py `_build`)."""
    L = ns.L
    x = L.data(name="x", shape=[4], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    with ns.guard("gpu:0"):
        h = L.fc(x, size=hidden, act="tanh", param_attr=_attr(ns, "w0"),
                 bias_attr=ns.attr(name="b0"))
    with ns.guard("gpu:1"):
        pred = L.fc(h, size=1, param_attr=_attr(ns, "w1"),
                    bias_attr=ns.attr(name="b1"))
    return L.mean(L.square_error_cost(pred, y))


def shared(ns):
    """A weight read by both stages, the second use transposed like a
    tied LM head (tests/test_pipeline_pp.py:158)."""
    L = ns.L
    x = L.data(name="x", shape=[8], dtype="float32")
    y = L.data(name="y", shape=[8], dtype="float32")
    w = L.create_parameter([8, 8], "float32", attr=_attr(ns, "wshared"))
    with ns.guard("gpu:0"):
        h = L.tanh(L.matmul(x, w))
    with ns.guard("gpu:1"):
        pred = L.matmul(h, w, transpose_y=True)
    return L.mean(L.square_error_cost(pred, y))


def counted(ns):
    """The MLP whose loss is scaled by a persistable counter that the
    forward increments in place: microbatch m sees the count after m."""
    L = ns.L
    c = L.create_global_var([1], 0.0, "float32", persistable=True,
                            name="counter")
    L.increment(c, value=1.0, in_place=True)
    return L.elementwise_mul(mlp(ns), c)


def build(ns, model, opt="adam", k=4, strategy=None):
    """(main, startup, loss) of `model` minimised by `opt`, wrapped in
    PipelineOptimizer(k) (k > 1) or through fleet with `strategy`."""
    main, start = ns.prog.Program(), ns.prog.Program()
    with ns.prog.program_guard(main, start), ns.names.guard():
        loss = model(ns)
        o = (ns.opt.Adam(learning_rate=1e-2) if opt == "adam"
             else ns.opt.SGD(learning_rate=0.1))
        if strategy is not None:
            ns.fleet.init(is_collective=True)
            s = ns.fleet.DistributedStrategy()
            for key, val in strategy.items():
                setattr(s, key, val)
            o = ns.fleet.distributed_optimizer(o, s)
        elif k > 1:
            o = ns.opt.PipelineOptimizer(o, num_microbatches=k)
        o.minimize(loss)
    return main, start, loss


def ref_attach(main, pp):
    mesh = ref_parallel.build_mesh(dp=1, pp=pp, devices=jax.devices()[:pp])
    ref_parallel.attach(main, ref_parallel.DistConfig(mesh=mesh))


def port_attach(main, pp):
    mesh = port_mesh.build_mesh(pp=pp, devices=["cpu"] * pp)
    port_spmd.attach(main, port_spmd.DistConfig(mesh=mesh))


def ref_start(start):
    scope = RefScope()
    fluid.Executor().run(start, scope=scope)
    return {n: np.asarray(scope.find(n)) for n in scope.local_names()
            if not n.startswith("__")}


def ref_train(main, loss, feeds, init):
    scope = RefScope()
    for n, a in init.items():
        scope.set(n, jnp.asarray(a))
    exe = fluid.Executor()
    losses = [np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                 scope=scope)[0]).item() for f in feeds]
    return exe, losses, {n: np.asarray(scope.find(n)) for n in init}


def port_train(main, loss, feeds, init):
    exe, scope = Executor("cpu"), load_numpy(Scope(), init, "cpu")
    losses = [exe.run(main, feed=f, fetch_list=[loss],
                      scope=scope)[0].item() for f in feeds]
    return exe, losses, {n: scope.numpy(n) for n in init}, scope


def mlp_feeds(steps, b=16, seed=0, width=4):
    out = []
    for i in range(steps):
        rng = np.random.RandomState(seed + i)
        xb = rng.randn(b, width).astype(np.float32)
        yb = (np.tanh(xb.sum(1, keepdims=True)) * 0.7).astype(np.float32)
        out.append({"x": xb, "y": yb})
    return out


def assert_state(port, ref, atol, rtol=0.0):
    assert set(port) == set(ref)
    for n in ref:
        np.testing.assert_allclose(port[n], ref[n], rtol=rtol, atol=atol,
                                   err_msg=n)


def test_device_guard_stage_attrs_and_descs_equal():
    rm, _, _ = build(REF, mlp)
    pm, _, _ = build(PORT, mlp)
    stages = [op.attrs.get("pipeline_stage")
              for op in pm.global_block().ops if op.type == "mul"]
    assert sorted(stages) == [0, 1]
    vjp = [op.attrs["fwd_attrs"].get("pipeline_stage")
           for op in pm.global_block().ops
           if op.type == "__vjp__" and op.attrs["fwd_type"] == "mul"]
    assert sorted(vjp) == [0, 1]
    assert pm.to_desc() == rm.to_desc()
    assert pm._microbatch_k == rm._microbatch_k == 4
    cfg_r, cfg_p = ref_gpt.GPTConfig.tiny(), port_gpt.GPTConfig.tiny()
    cfg_r.pipeline_stages = cfg_p.pipeline_stages = 2
    rd = build(REF, lambda ns: ref_gpt.build_lm_program(cfg_r)[1], k=2)[0]
    pd = build(PORT, lambda ns: port_gpt.build_lm_program(cfg_p)[1], k=2)[0]
    assert pd.to_desc() == rd.to_desc()
    assert port_program.Program.from_desc(rd.to_desc()).to_desc() \
        == rd.to_desc()
    seen = {op.attrs.get("pipeline_stage") for op in pd.global_block().ops}
    assert {0, 1} <= seen
    bert_r, bert_p = ref_bert.BertConfig.tiny(), port_bert.BertConfig.tiny()
    bert_r.pipeline_stages = bert_p.pipeline_stages = 2
    rb = build(REF, lambda ns: ref_bert.build_pretrain_program(bert_r)[2],
               k=2)[0]
    pb = build(PORT, lambda ns: port_bert.build_pretrain_program(bert_p)[2],
               k=2)[0]
    assert pb.to_desc() == rb.to_desc()
    head = [op for op in pb.global_block().ops if op.type == "mean"]
    assert [op.attrs["pipeline_stage"] for op in head] == [1]


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_gpipe_matches_reference_microbatched(opt):
    feeds = mlp_feeds(5)
    rm, rs, rloss = build(REF, mlp, opt)
    init = ref_start(rs)
    _, ref_losses, ref_state = ref_train(rm, rloss, feeds, init)
    pm, _, ploss = build(PORT, mlp, opt)
    _, losses, state, _ = port_train(pm, ploss, feeds, init)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert_state(state, ref_state, atol=1e-6)
    assert losses[-1] < losses[0]


def test_indivisible_batch_raises():
    pm, ps, ploss = build(PORT, mlp, k=3)
    exe, scope = Executor("cpu"), Scope()
    exe.run(ps, scope=scope)
    with pytest.raises(errors.InvalidArgumentError, match="divisible"):
        exe.run(pm, feed=mlp_feeds(1)[0], fetch_list=[ploss], scope=scope)


def test_fleet_pipeline_strategy():
    strategy = {"pipeline": True,
                "pipeline_configs": {"accumulate_steps": 2,
                                     "micro_batch_size": 8}}
    rm, rs, rloss = build(REF, mlp, strategy=strategy)
    pm, _, ploss = build(PORT, mlp, strategy=strategy)
    assert pm._microbatch_k == rm._microbatch_k == 2
    assert pm.to_desc() == rm.to_desc()
    feeds = mlp_feeds(4)
    init = ref_start(rs)
    _, ref_losses, ref_state = ref_train(rm, rloss, feeds, init)
    _, losses, state, _ = port_train(pm, ploss, feeds, init)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert_state(state, ref_state, atol=1e-6)


def test_fleet_pipeline_parallel_degree_after_init_attaches_pp_mesh():
    """The usual order: `fleet.init()` with the default strategy, then
    `distributed_optimizer(opt, s)` with `pipeline_parallel_degree` 2.
    `distributed_optimizer` rebuilds the mesh from `s` (reference
    fleet/base.py:209-212), so `minimize` attaches the pp-2 mesh, and the
    run equals the same program attached by hand and the one-device GPipe
    run bit for bit (one device here, the same sums in the same order)."""
    strategy = {"pipeline": True, "pipeline_parallel_degree": 2,
                "pipeline_configs": {"accumulate_steps": 4,
                                     "stage_devices": ["cpu", "cpu"]}}
    feeds = mlp_feeds(4)
    init = ref_start(build(REF, mlp)[1])
    try:
        fm, _, floss = build(PORT, mlp, strategy=strategy)
    finally:
        port_mesh.set_mesh(None)
    assert fm._dist_config.pp == 2 and fm._microbatch_k == 4
    assert fm._dist_config.resolve_mesh().devices == [torch.device("cpu")] * 2
    exe, losses, state, _ = port_train(fm, floss, feeds, init)
    pb, = exe._pipelines.values()
    assert pb.num_stages == 2 and 2 <= pb.last_max_live_envs <= 3
    hm, _, hloss = build(PORT, mlp)
    port_attach(hm, 2)
    _, hand, hand_state, _ = port_train(hm, hloss, feeds, init)
    gm, _, gloss = build(PORT, mlp)
    _, one, one_state, _ = port_train(gm, gloss, feeds, init)
    assert losses == hand == one
    for n in init:
        assert np.array_equal(state[n], hand_state[n]), n
        assert np.array_equal(state[n], one_state[n]), n


def test_body_written_persistable_threads_across_microbatches():
    feeds = mlp_feeds(2)
    rm, rs, rloss = build(REF, counted, "sgd")
    init = ref_start(rs)
    _, ref_losses, ref_state = ref_train(rm, rloss, feeds, init)
    pm, _, ploss = build(PORT, counted, "sgd")
    _, losses, state, _ = port_train(pm, ploss, feeds, init)
    assert state["counter"].tolist() == ref_state["counter"].tolist() \
        == [8.0]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert_state(state, ref_state, atol=1e-6)


def test_gpipe_threads_bn_stats_through_microbatches():
    """The reference's test_pipeline_threads_bn_stats_through_scan on the
    port's GPipe runner: after one step of 4 microbatches the running mean
    is the sequential one, running = 0.9 * running + 0.1 * mean(m) for
    each microbatch m in turn (rtol 1e-5 / atol 1e-6, f32)."""
    main, start = port_program.Program(), port_program.Program()
    with port_program.program_guard(main, start), port_unique_name.guard():
        x = port_layers.data(name="x", shape=[3, 4, 4], dtype="float32")
        loss = port_layers.reduce_mean(port_layers.batch_norm(x))
        mean_name = [op for op in main.global_block().ops
                     if op.type == "batch_norm"][0].inputs["Mean"][0]
        port_optimizer.PipelineOptimizer(
            port_optimizer.SGD(learning_rate=0.0),
            num_microbatches=4).minimize(loss)
    scope, exe = Scope(), Executor("cpu")
    exe.run(start, scope=scope)
    xs = np.random.RandomState(0).randn(16, 3, 4, 4).astype(np.float32)
    exe.run(main, feed={"x": xs}, fetch_list=[loss], scope=scope)
    expect = np.zeros(3, np.float32)
    for m in range(4):
        expect = 0.9 * expect + 0.1 * xs[4 * m:4 * m + 4].mean(
            axis=(0, 2, 3))
    np.testing.assert_allclose(scope.numpy(mean_name), expect, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("model,opt", [(mlp, "adam"), (shared, "sgd")],
                         ids=["mlp_adam", "shared_param_sgd"])
def test_pp2_matches_reference_pp2(model, opt):
    k = 4 if model is mlp else 2
    feeds = (mlp_feeds(4) if model is mlp
             else mlp_feeds(3, b=8, seed=3, width=8))
    if model is shared:
        for f in feeds:
            f["y"] = np.random.RandomState(7).randn(8, 8).astype(np.float32)
    rm, rs, rloss = build(REF, model, opt, k=k)
    ref_attach(rm, 2)
    init = ref_start(rs)
    _, ref_losses, ref_state = ref_train(rm, rloss, feeds, init)
    pm, _, ploss = build(PORT, model, opt, k=k)
    port_attach(pm, 2)
    exe, losses, state, _ = port_train(pm, ploss, feeds, init)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4, atol=1e-6)
    assert_state(state, ref_state, atol=1e-6, rtol=1e-4)
    pb, = exe._pipelines.values()
    assert pb.num_stages == 2 and 2 <= pb.last_max_live_envs <= 3
    if model is shared:
        # the two contributions meet in one sum, on the earliest stage
        sums = [(i, op) for i, op in enumerate(pm.global_block().ops)
                if op.type == "sum"]
        assert len(sums) == 1 and sums[0][1].inputs["X"][0].startswith(
            "wshared@GRAD")
        assert pb.var_stage["wshared"] == 0
        assert any(i == sums[0][0] for seg in pb.bwd_segs
                   if seg.stage == 0 for i, _ in seg.ops)


def _gpt_cfg(ns, pp, **kw):
    cfg = ns.gpt.GPTConfig.tiny()
    for key, val in kw.items():
        setattr(cfg, key, val)
    cfg.pipeline_stages = pp if pp > 1 else 0
    return cfg


def test_gpt_tiny_pp2_tied_wte_matches_reference():
    def model(pp):
        return lambda ns: ns.gpt.build_lm_program(_gpt_cfg(ns, pp))[1]
    cfg = _gpt_cfg(PORT, 2)
    rng = np.random.RandomState(0)
    feeds = [{"tokens": rng.randint(0, cfg.vocab_size, (8, cfg.seq_len))
              .astype(np.int64)}] * 3
    rm, rs, rloss = build(REF, model(2), k=2)
    ref_attach(rm, 2)
    init = ref_start(rs)
    _, ref_losses, ref_state = ref_train(rm, rloss, feeds, init)
    pm, _, ploss = build(PORT, model(2), k=2)
    port_attach(pm, 2)
    exe, losses, state, _ = port_train(pm, ploss, feeds, init)
    # the reference's own tolerances (tests/test_pipeline_pp.py:230,236)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(state["wte"], ref_state["wte"], rtol=5e-4,
                               atol=5e-6)
    # every parameter: Adam's first steps at lr 1e-2 turn a near-zero
    # gradient's last-bit difference into a step difference of up to lr;
    # held to 1% of lr
    for n in (v.name for v in pm.all_parameters()):
        np.testing.assert_allclose(state[n], ref_state[n], rtol=0,
                                   atol=1e-4, err_msg=n)
    assert losses[-1] < losses[0]
    pb, = exe._pipelines.values()
    assert pb.var_stage["wte"] == 0 and 2 <= pb.last_max_live_envs <= 3


def test_gpt_8l_pp4_1f1b_window_and_stage_homes():
    S, K = 4, 6
    kw = dict(vocab_size=512, hidden_size=32, num_layers=8, num_heads=2,
              intermediate_size=64, max_position=32, seq_len=16)

    def model(pp):
        return lambda ns: ns.gpt.build_lm_program(_gpt_cfg(ns, pp, **kw))[1]
    rng = np.random.RandomState(0)
    feeds = [{"tokens": rng.randint(0, 512, (12, 16)).astype(np.int64)}] * 3
    rm, rs, rloss = build(REF, model(S), k=K)
    ref_attach(rm, S)
    init = ref_start(rs)
    rexe, _, _ = ref_train(rm, rloss, feeds[:1], init)
    ref_pb, = [c for c in rexe._cache.values()
               if isinstance(c, ref_pipeline._PipelineBlock)]

    pm, _, ploss = build(PORT, model(S), k=K)
    port_attach(pm, S)
    exe, losses, state, scope = port_train(pm, ploss, feeds, init)
    pb, = exe._pipelines.values()
    assert pb.num_stages == S
    assert S <= pb.last_max_live_envs <= S + 1, pb.last_max_live_envs
    homes = {n: s for n, s in ref_pb.var_stage.items() if n in init}
    assert {n: pb.var_stage[n] for n in homes} == homes
    assert {homes[f"dec{2 * s}_attn_qkv_w"] for s in range(S)} == set(
        range(S)) and homes["wte"] == 0
    for n, s in homes.items():
        assert [scope.find(n).device] == port_pipeline.stage_devices(pb, s)

    gm, _, gloss = build(PORT, model(1), k=K)
    _, one, one_state, _ = port_train(gm, gloss, feeds, init)
    np.testing.assert_allclose(losses, one, rtol=1e-5)
    np.testing.assert_allclose(state["wte"], one_state["wte"], rtol=1e-5,
                               atol=1e-6)
    assert losses[-1] < losses[0]


def test_dp2_pp2_matches_reference_and_one_device():
    fs = [dict(zip(("x", "y"), pp_feed(seed=i))) for i in range(4)]
    rm, rs, rloss = build(REF, ranks.two_stage, "sgd", k=4)
    mesh = ref_parallel.build_mesh(dp=2, pp=2, devices=jax.devices()[:4])
    ref_parallel.attach(rm, ref_parallel.DistConfig(mesh=mesh))
    init = ref_start(rs)
    _, ref_losses, ref_state = ref_train(rm, rloss, fs, init)
    om, _, oloss = build(PORT, ranks.two_stage, "sgd", k=4)
    _, one_losses, one_state, _ = port_train(om, oloss, fs, init)

    res = gloo_gang(ranks.dp_pp_arm, 2, args=(init, fs))
    for r in res:
        assert r["num_stages"] == 2 and r["dp_collectives_per_step"] == 1
        assert r["all_reduce_calls"] == [2] * len(fs)   # average + loss
        for want_losses, want_state in ((ref_losses, ref_state),
                                        (one_losses, one_state)):
            np.testing.assert_allclose(r["losses"], want_losses, rtol=1e-4,
                                       atol=1e-6)
            for n in ("w0", "b0", "w1", "b1", "w2", "b2"):
                np.testing.assert_allclose(r["params"][n], want_state[n],
                                           rtol=1e-4, atol=1e-6, err_msg=n)
    assert res[0]["losses"] == res[1]["losses"]
    assert res[0]["losses"][-1] < res[0]["losses"][0]

    fault = gloo_gang(ranks.dp_pp_arm, 2, args=(init, fs, 4, 0.1, True))
    w = one_state["w0"]
    readings = [float(np.abs(f["params"]["w0"] - w).max()
                      / np.abs(w).max()) for f in fault]
    assert min(readings) > 1e-4, readings
    assert not np.array_equal(fault[0]["params"]["w0"],
                              fault[1]["params"]["w0"])


def pp_feed(b=16, seed=0):
    """tests/test_pipeline_pp.py `_feed`."""
    rng = np.random.RandomState(seed)
    xb = rng.randn(b, 6).astype(np.float32)
    return xb, (np.tanh(xb.sum(1, keepdims=True)) * 0.7).astype(np.float32)


def test_stage_mesh_mismatch_and_unported_meshes_raise(monkeypatch):
    pm, ps, ploss = build(PORT, mlp, "sgd", k=2)
    port_attach(pm, 4)
    exe, scope = Executor("cpu"), Scope()
    exe.run(ps, scope=scope)
    with pytest.raises(errors.InvalidArgumentError, match="stage"):
        exe.run(pm, feed=mlp_feeds(1)[0], fetch_list=[ploss], scope=scope)
    # dp x pp builds (test_dp2_pp2_matches_reference_and_one_device runs
    # it); on one process dp 2 is not the group's size
    with pytest.raises(ValueError, match="one process per dp rank"):
        port_mesh.build_mesh(dp=2, pp=2, devices=["cpu", "cpu"])
    with pytest.raises(errors.UnimplementedError, match="pipeline"):
        exe.run_steps(2, pm, feed=mlp_feeds(1)[0], fetch_list=[ploss],
                      scope=scope)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(errors.UnavailableError, match="devices="):
        port_mesh.build_mesh(pp=2)
    # tp and sp are process axes (tests/test_torch_tp.py runs them): one
    # process holds no tp 2 mesh, with pp or without it (pp with tp or sp
    # builds in a gang: tests/test_torch_pipeline_tp.py); what stays
    # refused: ZeRO stage 3 with tp (as in the reference), a rolled
    # stage-3 bucket's stacked (None, "dp") spec on a tp mesh (item 16),
    # and ep (item 12)
    with pytest.raises(ValueError, match="per tp and sp rank"):
        port_mesh.build_mesh(dp=1, tp=2)
    with pytest.raises(ValueError, match="tp \\* sp must divide it"):
        port_mesh.build_mesh(tp=2, pp=2, devices=["cpu", "cpu"])
    from paddle_tpu_torch.distributed.fleet import base as fleet_base
    s = port_fleet.DistributedStrategy()
    s.tensor_parallel_degree = 2
    with pytest.raises(ValueError, match="cannot compose with tensor"):
        fleet_base._check_stage3_tp(3, s)
    tp_mesh = port_mesh.Mesh(1, tp=2, device_mesh=object())
    with pytest.raises(NotImplementedError, match="item 16"):
        port_spmd.DistConfig(mesh=tp_mesh,
                             state_specs={"w@LAYERS": (None, "dp")})
    assert port_spmd.DistConfig(mesh=tp_mesh, state_specs={
        "w": ("dp",)}).state_specs == {"w": ("dp",)}
    with pytest.raises(NotImplementedError, match="item 12"):
        port_mesh.build_mesh(ep=2)
    with pytest.raises(TypeError, match="ShardingRules"):
        port_spmd.DistConfig(mesh=None, param_rules=object())
    cfg = port_spmd.DistConfig(mesh=None, batch_axes=("dp",))
    assert cfg.batch_axes == ("dp",) and not cfg.mixed
