"""PyTorch port, gradient merge: parallel/transforms.py
`GradientMergeWrapper`, reached through fleet's `gradient_merge` strategy
and GradientMergeOptimizer, with the `elementwise_mod` and
`fill_zeros_like` lowerings it emits, held against the JAX reference on
the CPU.

* `elementwise_mod` (floor modulo, the divisor's sign, as jnp.mod) and
  `fill_zeros_like` against the reference's lowerings on the same numpy
  inputs, exactly.
* The merged program's desc equals the reference's (the step counter,
  the mask, the accumulators, the inner Adam ops writing temporaries and
  the `where` gates), and training matches it for k = 2 and 4, `avg` on
  and off: a 2-layer fc regression, Adam 1e-2, 2k + 1 steps of batch 4
  (the last window left half merged), every loss rtol 1e-5 and every
  persistable (the counter, the accumulators, moments, beta pows) atol
  1e-6 (f32; the frameworks sum in other orders).
* The bucket pass leaves a gated program as it is.
* Adam's moments and beta pows move on merge steps only: equal bit for
  bit to the step before on the others, and the beta pows equal
  0.9^(n+1) and 0.999^(n+1) after n merges (they start at beta); the
  parameters too.
* k = 4 at batch 8 over the 32 rows of each plain batch-32 step: after 2
  merged steps the parameters equal 2 plain steps within atol 1e-6.
* GPT-tiny's merged program through run_steps(k) equals k run() calls
  bit for bit, losses and every persistable, dropout on.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu.ops import registry as ref_registry

from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.framework import Executor, Scope, load_numpy
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.layer_helper import ParamAttr as PortParamAttr
from paddle_tpu_torch.models import gpt as port_gpt
from paddle_tpu_torch.ops import registry as port_registry
from paddle_tpu_torch.parallel import zero as port_zero

from paddle_tpu import initializer as ref_init

_PKGS = {
    "ref": dict(prog=ref_program, names=ref_unique_name, L=fluid.layers,
                fleet=ref_fleet, opt=paddle.optimizer,
                attr=paddle.ParamAttr, init=ref_init),
    "port": dict(prog=port_program, names=port_unique_name, L=port_layers,
                 fleet=port_fleet, opt=port_optimizer, attr=PortParamAttr,
                 init=port_init),
}


def build(pkg, k, avg=True, via="fleet"):
    """(main, startup, loss) of the fc regression minimised by Adam(1e-2)
    with k-step gradient merge (k 1: plain)."""
    m = _PKGS[pkg]
    L = m["L"]
    main, start = m["prog"].Program(), m["prog"].Program()
    with m["prog"].program_guard(main, start), m["names"].guard():
        x = L.data(name="x", shape=[8], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        init = m["init"].TruncatedNormal(0.0, 0.5)
        h = L.fc(x, 16, act="relu",
                 param_attr=m["attr"](name="w1", initializer=init),
                 bias_attr=m["attr"](name="b1"))
        pred = L.fc(h, 1, param_attr=m["attr"](name="w2", initializer=init),
                    bias_attr=m["attr"](name="b2"))
        loss = L.mean(L.square_error_cost(pred, y))
        opt = m["opt"].Adam(learning_rate=1e-2)
        if via == "optimizer":
            opt = m["opt"].GradientMergeOptimizer(opt, k_steps=k, avg=avg)
        else:
            m["fleet"].init(is_collective=True)
            s = m["fleet"].DistributedStrategy()
            if k > 1:
                s.gradient_merge = True
                s.gradient_merge_configs = {"k_steps": k, "avg": avg}
            opt = m["fleet"].distributed_optimizer(opt, s)
        opt.minimize(loss)
    return main, start, loss


def fc_feeds(steps, b=4, seed=2):
    rng = np.random.RandomState(seed)
    xs = rng.rand(steps, b, 8).astype(np.float32)
    return [{"x": x, "y": x.sum(1, keepdims=True) * 0.2} for x in xs]


def persistables(main):
    return sorted(v.name for v in main.global_block().vars.values()
                  if v.persistable)


def ref_run(main, start, loss, feeds):
    scope = RefScope()
    exe = fluid.Executor()
    exe.run(start, scope=scope)
    init = {n: np.asarray(scope.find(n)) for n in scope.local_names()
            if not n.startswith("__")}
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in feeds]
    return init, losses, {n: np.asarray(scope.find(n)) for n in init}


@pytest.mark.parametrize("op_type,make", [
    ("elementwise_mod", lambda r: {
        "X": (r.standard_normal((3, 5)) * 7).astype(np.float32),
        "Y": np.array([3.0, -2.5, 1.5, -4.0, 2.0], np.float32)}),
    ("fill_zeros_like", lambda r: {
        "X": r.standard_normal((4, 3)).astype(np.float32)}),
])
def test_lowerings_match_reference(op_type, make):
    ins = make(np.random.RandomState(5))
    want = ref_registry.get(op_type).lower(
        ref_registry.LowerCtx(), {s: [jnp.asarray(v)] for s, v in
                                  ins.items()}, {"axis": -1})["Out"][0]
    got = port_registry.get(op_type).lower(
        port_registry.LowerCtx(device="cpu"),
        {s: [torch.from_numpy(v)] for s, v in ins.items()},
        {"axis": -1})["Out"][0]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("avg", [True, False], ids=["avg", "sum"])
@pytest.mark.parametrize("k", [2, 4])
def test_gradient_merge_matches_reference(k, avg):
    feeds = fc_feeds(2 * k + 1)
    rm, rs, rloss = build("ref", k, avg)
    init, ref_losses, ref_final = ref_run(rm, rs, rloss, feeds)
    pm, _, ploss = build("port", k, avg)
    assert pm.to_desc() == rm.to_desc()
    assert persistables(pm) == sorted(ref_final)
    exe, scope = Executor("cpu"), load_numpy(Scope(), init, "cpu")
    losses = [float(exe.run(pm, feed=f, fetch_list=[ploss], scope=scope)[0])
              for f in feeds]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for n, want in ref_final.items():
        np.testing.assert_allclose(scope.numpy(n), want, rtol=0, atol=1e-6,
                                   err_msg=n)
    assert scope.numpy(next(n for n in init if n.startswith("gm_step"))) \
        .tolist() == [2.0 * k + 1]


def test_state_moves_on_merge_steps_only():
    k = 4
    pm, ps, ploss = build("port", k, via="optimizer")
    exe, scope = Executor("cpu"), Scope()
    exe.run(ps, scope=scope)
    state = [n for n in persistables(pm)
             if "moment" in n or "pow_acc" in n or n in ("w1", "b1",
                                                         "w2", "b2")]
    pows = sorted(n for n in state if "pow_acc" in n)
    assert len(pows) == 2 and len(state) == 4 * 3 + 2
    # the gated update is not one the bucket pass may rewrite
    ops = len(pm.global_block().ops)
    assert port_zero.apply_grad_bucketing(
        pm, ps, [(p, p) for p in pm.all_parameters()], 1 << 20,
        stage=1) is None and len(pm.global_block().ops) == ops
    before = {n: scope.numpy(n) for n in state}
    for step, f in enumerate(fc_feeds(3 * k), start=1):
        exe.run(pm, feed=f, fetch_list=[ploss], scope=scope)
        now = {n: scope.numpy(n) for n in state}
        merged = step % k == 0
        for n in state:
            assert np.array_equal(now[n], before[n]) != merged, (step, n)
        # the pows start at beta and advance once a merge
        n = step // k + 1
        np.testing.assert_allclose(scope.numpy(pows[0]),
                                   [np.float32(0.9) ** n], rtol=1e-6)
        np.testing.assert_allclose(scope.numpy(pows[1]),
                                   [np.float32(0.999) ** n], rtol=1e-6)
        before = now


def test_k4_batch8_equals_plain_batch32():
    big = fc_feeds(2, b=32, seed=9)
    rm, rs, _ = build("ref", 1)
    init = ref_run(rm, rs, None, [])[0]
    pm, _, ploss = build("port", 1)
    exe, plain = Executor("cpu"), load_numpy(Scope(), init, "cpu")
    for f in big:
        exe.run(pm, feed=f, fetch_list=[ploss], scope=plain)
    gm, _, gloss = build("port", 4)
    merged = load_numpy(Scope(), {**init, **{
        n: np.zeros_like(v) for n, v in ref_run(
            *build("ref", 4)[:2], None, [])[0].items()
        if n not in init}}, "cpu")
    for f in big:
        for i in range(4):
            exe.run(gm, feed={n: v[8 * i:8 * (i + 1)] for n, v in f.items()},
                    fetch_list=[gloss], scope=merged)
    for n in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(merged.numpy(n), plain.numpy(n), rtol=0,
                                   atol=1e-6, err_msg=n)
        assert not np.array_equal(plain.numpy(n), init[n])


def test_run_steps_equals_run():
    k = 2
    cfg = port_gpt.GPTConfig.tiny()
    cfg.hidden_dropout = cfg.attention_dropout = 0.1
    main, start = port_program.Program(), port_program.Program()
    with port_program.program_guard(main, start), port_unique_name.guard():
        _, loss = port_gpt.build_lm_program(cfg)
        port_fleet.init(is_collective=True)
        s = port_fleet.DistributedStrategy()
        s.gradient_merge = True
        s.gradient_merge_configs = {"k_steps": k, "avg": True}
        port_fleet.distributed_optimizer(
            port_optimizer.Adam(learning_rate=1e-3), s).minimize(loss)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, cfg.vocab_size,
                       (2 * k, 2, cfg.seq_len)).astype(np.int64)
    exe = Executor("cpu")
    sa, sb = Scope(), Scope()
    exe.run(start, scope=sa)
    exe.run(start, scope=sb)
    want = [exe.run(main, feed={"tokens": t}, fetch_list=[loss],
                    scope=sa)[0] for t in toks]
    got = []
    for w in range(2):
        got.extend(exe.run_steps(k, main,
                                 feed={"tokens": toks[w * k:(w + 1) * k]},
                                 fetch_list=[loss], scope=sb)[0])
    assert [float(x) for x in got] == [float(x) for x in want]
    for n in persistables(main):
        if isinstance(sa.find(n), torch.Tensor):
            assert torch.equal(sa.find(n), sb.find(n)), n
