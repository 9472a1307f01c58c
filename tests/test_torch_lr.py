"""PyTorch port, learning-rate schedules: paddle_tpu_torch's lr.py (the 13
host LRScheduler classes), layers/learning_rate_scheduler.py (the 8
static schedules), the lowerings those emit, and the optimizer's LR
plumbing, held against the JAX reference on the CPU.

* Host schedulers: each class's trajectory over 20 steps equals the
  reference's as exact Python floats, across a `state_dict` /
  `set_state_dict` round trip into a fresh instance at step 10;
  ReduceOnPlateau on a given metric sequence.
* Static schedules: the program descs (ops, vars, attrs, roles) and the
  startup descs equal the reference's; the LR over 12 runs within 1e-6
  relative of the reference's (f32 scalar ops, the frameworks' exp / cos /
  pow may differ in the last bit).
* `run_steps(3)` equals 3 `run()` calls bit for bit under a static
  schedule (losses, the fetched LR, the counter, every persistable).
* A host scheduler bound to the optimizer writes each new LR into the
  scope's tensor in place (the tensor object is kept, so a captured step
  stays bound), in every scope the executor ran the program in; all k
  steps of one run_steps call use one LR. `set_lr` and the optimizer's
  `state_dict` / `set_state_dict` (with the scheduler) likewise.
* Under fleet AMP bf16 the schedule's ops stay f32: the LR the update
  reads equals the f32 program's bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu import layers as ref_layers
from paddle_tpu import lr as ref_lr
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.framework.scope import Scope as RefScope

from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import lr as port_lr
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.framework import Executor, Scope
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.framework.program import OpRole

# ---------------------------------------------------------------------------
# host schedulers
# ---------------------------------------------------------------------------

_HOST = {
    "LRScheduler": None,   # the base class: get_lr is abstract
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=5,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([3, 8, 14],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, gamma=0.3),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, gamma=0.7),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, decay_steps=6,
                                                   end_lr=0.001, power=2.0,
                                                   cycle=True),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, [4, 9, 15], 0.5),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=3, gamma=0.7),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, T_max=7, eta_min=0.001),
    "LinearWarmup": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=10), warmup_steps=5,
        start_lr=0.0, end_lr=0.1),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.1, factor=0.5, patience=2, cooldown=1, threshold=0.01),
}
# a loss curve that plateaus twice
_METRICS = [5.0, 4.0, 3.5, 3.49, 3.49, 3.5, 3.2, 3.2, 3.19, 3.25, 3.3, 3.3,
            2.0, 2.0, 2.0, 2.0, 1.99, 1.5, 1.5, 1.5]


def _make(mod, name):
    if name == "LRScheduler":
        class Const(mod.LRScheduler):
            def get_lr(self):
                return self.base_lr * (1.0 + 0.1 * self.last_epoch)
        return Const(0.05)
    return _HOST[name](mod)


def _trajectory(mod, name, steps=20, resume_at=10):
    """The LR after each of `steps` steps; at `resume_at` the state moves
    into a fresh instance through state_dict / set_state_dict."""
    sched = _make(mod, name)
    out = [sched()]
    for i in range(steps):
        if i == resume_at:
            fresh = _make(mod, name)
            fresh.set_state_dict(sched.state_dict())
            if name == "ReduceOnPlateau":   # its counters are attributes
                for k in ("best", "num_bad", "cooldown_counter", "_current"):
                    setattr(fresh, k, getattr(sched, k))
            sched = fresh
        if name == "ReduceOnPlateau":
            sched.step(_METRICS[i])
        else:
            sched.step()
        out.append(sched())
    return out, sched.state_dict()


@pytest.mark.parametrize("name", sorted(_HOST))
def test_host_scheduler_trajectory_equals_reference(name):
    assert len(port_lr.__all__) == 13 and name in port_lr.__all__
    got, got_sd = _trajectory(port_lr, name)
    want, want_sd = _trajectory(ref_lr, name)
    assert got == want            # exact Python floats
    assert got_sd == want_sd
    assert all(isinstance(v, float) for v in got)
    assert len(set(got)) > 1      # the schedule moves


def test_reduce_on_plateau_reduces_on_the_given_metrics():
    got, _ = _trajectory(port_lr, "ReduceOnPlateau", resume_at=99)
    want, _ = _trajectory(ref_lr, "ReduceOnPlateau", resume_at=99)
    assert got == want
    assert got[0] == 0.1 and got[-1] < 0.1 / 3


# ---------------------------------------------------------------------------
# static schedules
# ---------------------------------------------------------------------------

_STATIC = {
    "noam_decay": lambda L: L.noam_decay(64, 4, 2.0),
    "exponential_decay": lambda L: L.exponential_decay(0.1, 3, 0.5,
                                                       staircase=True),
    "natural_exp_decay": lambda L: L.natural_exp_decay(0.1, 3, 0.5),
    "inverse_time_decay": lambda L: L.inverse_time_decay(0.1, 3, 0.5),
    "polynomial_decay": lambda L: L.polynomial_decay(0.1, 5, 0.001, 2.0,
                                                     cycle=True),
    "piecewise_decay": lambda L: L.piecewise_decay([2, 5], [0.1, 0.05,
                                                            0.01]),
    "cosine_decay": lambda L: L.cosine_decay(0.1, 2, 6),
    "linear_lr_warmup": lambda L: L.linear_lr_warmup(
        L.cosine_decay(0.1, 2, 6), 3, 0.0, 0.1),
}
_PKG = {"ref": (ref_program, ref_unique_name, ref_layers),
        "port": (port_program, port_unique_name, port_layers)}


def _static(pkg, name):
    prog, names, layers = _PKG[pkg]
    main, start = prog.Program(), prog.Program()
    with prog.program_guard(main, start), names.guard():
        lr = _STATIC[name](layers)
    return main, start, lr


def _static_values(pkg, name, runs=12):
    main, start, lr = _static(pkg, name)
    if pkg == "ref":
        exe, scope = fluid.Executor(), RefScope()
    else:
        exe, scope = Executor("cpu"), Scope()
    exe.run(start, scope=scope)
    return [float(np.asarray(exe.run(main, fetch_list=[lr],
                                     scope=scope)[0]).ravel()[0])
            for _ in range(runs)]


@pytest.mark.parametrize("name", sorted(_STATIC))
def test_static_schedule_desc_and_values_equal_reference(name):
    rm, rs, _ = _static("ref", name)
    pm, ps, _ = _static("port", name)
    rd, pd = rm.to_desc(), pm.to_desc()
    for r, p in zip(rd["blocks"][0]["ops"], pd["blocks"][0]["ops"]):
        assert p == r, (r, p)
    assert pd == rd
    assert ps.to_desc() == rs.to_desc()
    # the counter's increment and its snapshot carry the LRSched role
    ops = pm.global_block().ops
    assert [op.type for op in ops[:2]] == ["increment", "scale"]
    assert all(op.attrs["op_role"] == OpRole.LRSched for op in ops[:2])
    want = _static_values("ref", name)
    got = _static_values("port", name)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert len(set(got)) > 1


# ---------------------------------------------------------------------------
# schedules driving training steps
# ---------------------------------------------------------------------------

def _net(layers, lr, opt="sgd", amp=False, fleet=None):
    x = layers.data(name="x", shape=[4], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    init = port_init.TruncatedNormal(0.0, 0.5)
    h = layers.fc(x, 8, act="gelu", param_attr=init)
    p = layers.fc(h, 1, param_attr=init)
    loss = layers.mean(layers.square(layers.elementwise_sub(p, y)))
    if callable(lr) and not isinstance(lr, (port_lr.LRScheduler, float)):
        lr = lr(layers)
    o = (port_optimizer.Adam(learning_rate=lr) if opt == "adam"
         else port_optimizer.SGD(learning_rate=lr))
    if amp:
        fleet.init(is_collective=True)
        s = fleet.DistributedStrategy()
        s.amp = True
        o = fleet.distributed_optimizer(o, s)
    o.minimize(loss)
    return loss, o


def _feeds(steps, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(steps, 8, 4).astype(np.float32),
            "y": rng.randn(steps, 8, 1).astype(np.float32)}


def _port_build(lr, **kw):
    main, start = port_program.Program(), port_program.Program()
    with port_program.program_guard(main, start), port_unique_name.guard():
        loss, o = _net(port_layers, lr, **kw)
    return main, start, loss, o


def _persist(main, scope):
    return {v.name: scope.numpy(v.name)
            for v in main.global_block().vars.values()
            if v.persistable and scope.find(v.name) is not None}


def test_run_steps_equals_runs_under_a_static_schedule():
    sched = lambda L: L.linear_lr_warmup(  # noqa: E731
        L.cosine_decay(0.1, 1, 4), 2, 0.01, 0.1)
    main, start, loss, o = _port_build(sched, opt="adam")
    lr_var = o.learning_rate_var
    feeds = _feeds(3)
    sa, sb = Scope(), Scope()
    Executor("cpu").run(start, scope=sa)
    for n in sa.local_names():
        v = sa.find(n)
        sb.set(n, v.clone() if isinstance(v, torch.Tensor) else v)
    exe = Executor("cpu")
    eager = [exe.run(main, feed={k: v[b] for k, v in feeds.items()},
                     fetch_list=[loss, lr_var], scope=sa)
             for b in range(3)]
    losses, lrs = Executor("cpu").run_steps(3, main, feed=feeds,
                                            fetch_list=[loss, lr_var],
                                            scope=sb)
    assert [float(e[0]) for e in eager] == losses.tolist()
    assert [e[1].tolist() for e in eager] == lrs.tolist()
    assert len({v[0] for v in lrs.tolist()}) == 3   # a new LR every step
    a, b = _persist(main, sa), _persist(main, sb)
    assert sorted(a) == sorted(b)
    counter = [n for n in a if n.startswith("@LR_DECAY_COUNTER@")]
    assert counter and a[counter[0]].tolist() == [2.0]
    for n in a:
        assert np.array_equal(a[n], b[n]), n


def test_host_scheduler_writes_in_place_in_every_attached_scope():
    sched = port_lr.StepDecay(0.1, step_size=1, gamma=0.5)
    main, start, loss, o = _port_build(sched)
    name = o.learning_rate_var.name
    feeds = _feeds(3)
    scopes = [Scope(), Scope()]
    exe = Executor("cpu")
    for s in scopes:
        exe.run(start, scope=s)
        exe.run(main, feed={k: v[0] for k, v in feeds.items()},
                fetch_list=[loss], scope=s)
    bound = [s.find(name) for s in scopes]
    sched.step()
    for s, t in zip(scopes, bound):
        assert s.find(name) is t                 # the same tensor object
        assert t.tolist() == [np.float32(0.05)]
    # run_steps(k): every step of one call runs at one LR
    lrs, = exe.run_steps(3, main, feed=feeds,
                         fetch_list=[o.learning_rate_var],
                         scope=scopes[0])
    assert lrs.tolist() == [[np.float32(0.05)]] * 3
    sched.step()
    lrs, = exe.run_steps(3, main, feed=feeds,
                         fetch_list=[o.learning_rate_var],
                         scope=scopes[0])
    assert lrs.tolist() == [[np.float32(0.025)]] * 3
    assert scopes[0].find(name) is bound[0]


def test_set_lr_and_optimizer_state_dict_with_scheduler():
    sched = port_lr.LinearWarmup(0.1, warmup_steps=4, start_lr=0.0,
                                 end_lr=0.1)
    main, start, loss, o = _port_build(sched, opt="adam")
    scope = Scope()
    exe = Executor("cpu")
    exe.run(start, scope=scope)
    feeds = _feeds(2)
    exe.run_steps(2, main, feed=feeds, fetch_list=[loss], scope=scope)
    for _ in range(3):
        sched.step()
    sd = o.state_dict(scope=scope)
    assert sd["LR_Scheduler"] == sched.state_dict()
    assert sd["LR_Scheduler"]["last_epoch"] == 3
    moments = [k for k in sd if "moment" in k]
    assert moments and all(isinstance(sd[k], np.ndarray) for k in moments)
    lr_t = scope.find(o.learning_rate_var.name)
    # set_lr writes in place
    o.set_lr(0.5, scope=scope)
    assert scope.find(o.learning_rate_var.name) is lr_t
    assert lr_t.tolist() == [0.5]
    # a fresh scheduler and scope take the state back
    sched2 = port_lr.LinearWarmup(0.1, warmup_steps=4, start_lr=0.0,
                                  end_lr=0.1)
    main2, start2, loss2, o2 = _port_build(sched2, opt="adam")
    scope2 = Scope()
    exe2 = Executor("cpu")
    exe2.run(start2, scope=scope2)
    exe2.run(main2, feed={k: v[0] for k, v in feeds.items()},
             fetch_list=[loss2], scope=scope2)
    o2.set_state_dict(sd, scope=scope2)
    assert sched2.state_dict() == sd["LR_Scheduler"]
    assert scope2.numpy(o2.learning_rate_var.name).tolist() \
        == [np.float32(sched())]
    for k in moments:
        assert np.array_equal(scope2.numpy(k), sd[k])


def test_schedule_stays_f32_under_fleet_amp():
    sched = lambda L: L.polynomial_decay(0.1, 4, 0.001, 2.0)  # noqa: E731
    out = {}
    for amp in (False, True):
        main, start, loss, o = _port_build(sched, amp=amp, fleet=port_fleet)
        assert getattr(main, "_amp", False) == amp
        lr_var = o.learning_rate_var
        assert lr_var.dtype == torch.float32
        scope = Scope()
        exe = Executor("cpu")
        exe.run(start, scope=scope)
        lrs, = exe.run_steps(4, main, feed=_feeds(4),
                             fetch_list=[lr_var], scope=scope)
        assert lrs.dtype == np.float32
        out[amp] = lrs.tolist()
    assert out[True] == out[False]
    assert out[False][0] == [np.float32(0.1)]
