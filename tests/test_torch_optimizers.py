"""PyTorch port, the update rules beyond SGD / Momentum / Adam / AdamW:
paddle_tpu_torch's optimizer.py classes and ops/optimizer_ops.py
lowerings, held against the JAX reference on the CPU.

The rules: LarsMomentum, Lamb, Adagrad, Adamax, RMSProp (plain, centered
with momentum), Adadelta, DecayedAdagrad and Ftrl, each under a constant
LR and under a static schedule; `ParamAttr(regularizer=)` (L2 on one
parameter, L1 on the other, the optimizer's own L2 elsewhere); and
ExponentialMovingAverage (`update` in the program, `apply` / `restore`
from the host). The reference's startup arrays are carried across as
numpy, three steps run on the same seeded batches, and the program descs
are equal.

* The rule program: two parameters w1 [4, 16] and w2 [16], loss =
  sum(w1 * x1) + sum(w2 * x2). Its gradients are the fed x1 and x2
  exactly in both frameworks, so the update rules alone meet: every
  persistable within 1e-6 relative (`|a - b| <= 1e-6 * max|b|` per
  array), the losses too.
* The two-layer net (fc 4 -> 16 gelu -> fc 1, squared error): the
  gradients differ in their last bits (the frameworks sum in other
  orders), and RMSProp, Adamax and Ftrl divide by running magnitudes of
  them, so the persistables are held to 1e-5 relative and the losses to
  1e-6.

Inside the port: each rule updates the scope's tensors in place (the
objects a captured step binds stay the scope's), and Lamb and Lars keep
their per-parameter ops at ZeRO stage 1, as in the reference.
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu import initializer as ref_init
from paddle_tpu import layers as ref_layers
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu.layer_helper import ParamAttr as RefParamAttr

from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch import regularizer as port_reg
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.framework import Executor, Scope, load_numpy
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.layer_helper import ParamAttr as PortParamAttr

ref_reg = importlib.import_module("paddle_tpu.regularizer")

STEPS = 3
_PKG = {
    "ref": dict(prog=ref_program, names=ref_unique_name, layers=ref_layers,
                opt=paddle.optimizer, init=ref_init, reg=ref_reg,
                attr=RefParamAttr, fleet=ref_fleet),
    "port": dict(prog=port_program, names=port_unique_name,
                 layers=port_layers, opt=port_optimizer, init=port_init,
                 reg=port_reg, attr=PortParamAttr, fleet=port_fleet),
}

_RULES = {
    "lars": lambda o, lr: o.LarsMomentum(lr, momentum=0.9, lars_coeff=0.01,
                                         lars_weight_decay=0.001),
    "lamb": lambda o, lr: o.Lamb(lr, lamb_weight_decay=0.01),
    "adagrad": lambda o, lr: o.Adagrad(lr),
    "adamax": lambda o, lr: o.Adamax(lr),
    "rmsprop": lambda o, lr: o.RMSProp(lr),
    "rmsprop_centered": lambda o, lr: o.RMSProp(lr, momentum=0.5,
                                                centered=True),
    "adadelta": lambda o, lr: o.Adadelta(epsilon=1e-4),
    "decayed_adagrad": lambda o, lr: o.DecayedAdagrad(lr),
    "ftrl": lambda o, lr: o.Ftrl(lr, l1=1e-3, l2=1e-3),
}


def _net(m, kind="rule", regularized=False):
    L = m["layers"]
    init = m["init"].TruncatedNormal(0.0, 0.5)
    attr1 = attr2 = init
    if regularized:
        attr1 = m["attr"](initializer=init,
                          regularizer=m["reg"].L2Decay(0.05))
        attr2 = m["attr"](initializer=init,
                          regularizer=m["reg"].L1Decay(0.02))
    if kind == "rule":
        x1 = L.data(name="x1", shape=[4, 16], dtype="float32",
                    append_batch_size=False)
        x2 = L.data(name="x2", shape=[16], dtype="float32",
                    append_batch_size=False)
        w1 = L.create_parameter([4, 16], "float32", attr=attr1)
        w2 = L.create_parameter([16], "float32", attr=attr2)
        return L.elementwise_add(
            L.reduce_sum(L.elementwise_mul(w1, x1)),
            L.reduce_sum(L.elementwise_mul(w2, x2)))
    x = L.data(name="x", shape=[4], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    h = L.fc(x, 16, act="gelu", param_attr=attr1)
    p = L.fc(h, 1, param_attr=attr2)
    return L.mean(L.square(L.elementwise_sub(p, y)))


def build(pkg, rule=None, schedule=False, regularized=False, ema=False,
          stage=None, kind="rule"):
    m = _PKG[pkg]
    main, start = m["prog"].Program(), m["prog"].Program()
    with m["prog"].program_guard(main, start), m["names"].guard():
        loss = _net(m, kind, regularized)
        lr = 0.05
        if schedule:
            lr = m["layers"].exponential_decay(0.05, 2, 0.5)
        if regularized:
            o = m["opt"].Momentum(lr, momentum=0.9,
                                  regularization=m["reg"].L2Decay(0.01))
        else:
            o = _RULES[rule](m["opt"], lr)
        if stage is not None:
            m["fleet"].init(is_collective=True)
            s = m["fleet"].DistributedStrategy()
            s.sharding_stage = stage
            s.fuse_grad_size_in_mb = 0.001
            o = m["fleet"].distributed_optimizer(o, s)
        o.minimize(loss)
        e = None
        if ema:
            e = m["opt"].ExponentialMovingAverage(0.8)
            e.update()
    return main, start, loss, e


def feeds(steps=STEPS, seed=0, kind="rule"):
    rng = np.random.RandomState(seed)
    if kind == "rule":
        return [{"x1": rng.randn(4, 16).astype(np.float32),
                 "x2": rng.randn(16).astype(np.float32)}
                for _ in range(steps)]
    return [{"x": rng.randn(8, 4).astype(np.float32),
             "y": rng.randn(8, 1).astype(np.float32)}
            for _ in range(steps)]


def _persistables(main):
    return sorted(v.name for v in main.global_block().vars.values()
                  if v.persistable)


def run_both(**kw):
    """(ref losses, ref persistables, port losses, port persistables,
    port main, port scope) over STEPS steps from the reference's startup
    arrays."""
    rm, rs, rloss, _ = build("ref", **kw)
    pm, ps, ploss, _ = build("port", **kw)
    assert pm.to_desc() == rm.to_desc()
    assert ps.to_desc() == rs.to_desc()
    exe, scope = fluid.Executor(), RefScope()
    exe.run(rs, scope=scope)
    init = {n: np.asarray(scope.find(n)) for n in scope.local_names()
            if not n.startswith("__")}
    kind = kw.get("kind", "rule")
    ref_losses = [float(np.asarray(exe.run(rm, feed=f, fetch_list=[rloss],
                                           scope=scope)[0]).ravel()[0])
                  for f in feeds(kind=kind)]
    ref_final = {n: np.asarray(scope.find(n), np.float32)
                 for n in _persistables(rm)}
    pscope = load_numpy(Scope(), init, "cpu")
    pexe = Executor("cpu")
    port_losses = [float(pexe.run(pm, feed=f, fetch_list=[ploss],
                                  scope=pscope)[0])
                   for f in feeds(kind=kind)]
    port_final = {n: pscope.numpy(n) for n in _persistables(pm)}
    return ref_losses, ref_final, port_losses, port_final, pm, pscope


def assert_close(got, want, what, rtol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rtol * scale, (what, err, scale)


@pytest.mark.parametrize("schedule", [False, True], ids=["const", "sched"])
@pytest.mark.parametrize("rule", sorted(_RULES))
def test_rule_matches_reference(rule, schedule):
    rl, rf, pl, pf, main, scope = run_both(rule=rule, schedule=schedule)
    assert sorted(pf) == sorted(rf)
    assert_close(pl, rl, "losses")
    for n, want in rf.items():
        assert_close(pf[n], want, n)
    types = [op.type for op in main.global_block().ops]
    want_type = {"lars": "lars_momentum", "rmsprop_centered": "rmsprop"} \
        .get(rule, rule)
    assert types.count(want_type) == 2


@pytest.mark.parametrize("rule", sorted(_RULES))
def test_rule_trains_the_two_layer_net_as_the_reference(rule):
    rl, rf, pl, pf, main, scope = run_both(rule=rule, kind="mlp")
    assert sorted(pf) == sorted(rf)
    assert_close(pl, rl, "losses")
    for n, want in rf.items():
        assert_close(pf[n], want, n, rtol=1e-5)


@pytest.mark.parametrize("kind", ["rule", "mlp"])
def test_param_attr_regularizer_matches_reference(kind):
    rl, rf, pl, pf, main, _ = run_both(regularized=True, kind=kind)
    types = [op.type for op in main.global_block().ops]
    assert "sign" in types          # the L1 term
    assert types.count("scale") >= 2
    assert sorted(pf) == sorted(rf)
    assert_close(pl, rl, "losses")
    for n, want in rf.items():
        assert_close(pf[n], want, n)


def test_ema_update_apply_restore_matches_reference():
    rm, rs, rloss, rema = build("ref", rule="adagrad", ema=True, kind="mlp")
    pm, ps, ploss, pema = build("port", rule="adagrad", ema=True,
                                kind="mlp")
    assert pm.to_desc() == rm.to_desc()
    exe, rscope = fluid.Executor(), paddle.global_scope()
    exe.run(rs)
    init = {n: np.asarray(rscope.find(n)) for n in rscope.local_names()
            if not n.startswith("__")}
    pscope = load_numpy(Scope(), init, "cpu")
    pexe = Executor("cpu")
    for f in feeds(kind="mlp"):
        exe.run(rm, feed=f, fetch_list=[rloss])
        pexe.run(pm, feed=f, fetch_list=[ploss], scope=pscope)
    params = [p.name for p in pm.all_parameters()]
    trained = {n: pscope.numpy(n) for n in params}
    bound = {n: pscope.find(n) for n in params}
    rema.apply(exe)
    pema.apply(pexe, scope=pscope)
    for n in params:
        assert pscope.find(n) is bound[n]       # in place
        assert_close(pscope.numpy(n), np.asarray(rscope.find(n)), n,
                     rtol=1e-5)
        shadow = pema._shadows[n].name
        assert np.array_equal(pscope.numpy(n), pscope.numpy(shadow))
    f = feeds(1, seed=9, kind="mlp")[0]
    want = np.asarray(exe.run(rm.clone(for_test=True), feed=f,
                              fetch_list=[rloss.name])[0])
    got = pexe.run(pm.clone(for_test=True), feed=f,
                   fetch_list=[ploss.name], scope=pscope)[0]
    assert_close(got, want, "loss with the EMA weights", rtol=1e-5)
    rema.restore(exe)
    pema.restore(pexe, scope=pscope)
    for n in params:
        assert pscope.find(n) is bound[n]
        assert np.array_equal(pscope.numpy(n), trained[n])


@pytest.mark.parametrize("rule", ["lamb", "lars", "adagrad", "ftrl"])
def test_rules_update_the_scope_tensors_in_place(rule):
    main, start, loss, _ = build("port", rule=rule)
    scope = Scope()
    exe = Executor("cpu")
    exe.run(start, scope=scope)
    names = _persistables(main)
    before = {n: scope.find(n) for n in names}
    values = {n: scope.numpy(n) for n in names}
    for f in feeds(2):
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    assert all(scope.find(n) is t for n, t in before.items())
    moved = [n for n in names if not np.array_equal(scope.numpy(n),
                                                    values[n])]
    assert len(moved) >= 4


@pytest.mark.parametrize("rule", ["lamb", "lars"])
def test_lamb_and_lars_stay_per_parameter_under_zero(rule):
    main, _, _, _ = build("port", rule=rule, stage=1)
    types = [op.type for op in main.global_block().ops]
    assert "__zero_update__" not in types
    assert types.count({"lars": "lars_momentum"}.get(rule, rule)) == 2
    ref_main, _, _, _ = build("ref", rule=rule, stage=1)
    assert main.to_desc() == ref_main.to_desc()
