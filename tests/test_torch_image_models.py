"""PyTorch port, the static image models: paddle_tpu_torch's
models/{resnet,se_resnext,lenet}.py over the dense ops, trained through
fleet, held against the JAX reference on the CPU.

* The full ResNet-50, SE-ResNeXt-50 and LeNet programs (Momentum
  minimize, and ResNet-50 through fleet AMP at ZeRO stage 1) built in
  both packages have EQUAL main and startup descs. They are built, not
  run.
* Training parity, 2 Momentum (lr 0.01, mu 0.9) steps on one batch
  through fleet at ZeRO stages 0 and 1 against the reference's Momentum
  run, the reference's startup scope carried across as numpy: a ResNet of one `_static_bottleneck` a stage at 32x32, batch 4;
  one SE-ResNeXt `_bottleneck` a stage (cardinality 4, the head's dropout
  at 0 so the two packages' masks do not enter); LeNet at 28x28. Losses
  of every step and every persistable after the last, the batch-norm
  running statistics included. Tolerances: losses rtol 1e-4, persistables
  atol 1e-4 (f32 convolutions sum over C*kh*kw in another order in
  oneDNN than in XLA, and batch norm and lr 0.1 carry the difference into
  the parameters). In the port stage 1 equals stage 0 bit for bit.
* The batch-norm state: one step writes each running statistic once,
  `0.9 * old + 0.1 * batch`, though the grad op recomputes the forward;
  `clone(for_test)` reads the running statistics and writes none; the
  non-trainable statistics stay out of the optimizer and its buckets.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu import layers as ref_layers
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu.models import lenet as ref_lenet
from paddle_tpu.models import resnet as ref_resnet
from paddle_tpu.models import se_resnext as ref_se

from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.framework import Executor, Scope, load_numpy
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.models import lenet as port_lenet
from paddle_tpu_torch.models import resnet as port_resnet
from paddle_tpu_torch.models import se_resnext as port_se
from paddle_tpu_torch.parallel import zero

REF = types.SimpleNamespace(
    prog=ref_program, names=ref_unique_name, L=ref_layers, opt=paddle.optimizer,
    fleet=ref_fleet, resnet=ref_resnet, se=ref_se, lenet=ref_lenet)
PORT = types.SimpleNamespace(
    prog=port_program, names=port_unique_name, L=port_layers,
    opt=port_optimizer, fleet=port_fleet, resnet=port_resnet, se=port_se,
    lenet=port_lenet)

STEPS, BATCH, LR, MU = 2, 4, 0.01, 0.9


def tiny_resnet(ns):
    """A ResNet of one bottleneck a stage (widths 4-32, x4 out) at 32x32."""
    L, res = ns.L, ns.resnet
    img = L.data(name="image", shape=[3, 32, 32], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    x = res._static_conv_bn(img, 8, 3, act="relu")
    x = L.pool2d(x, pool_size=3, pool_type="max", pool_stride=2,
                 pool_padding=1)
    for ch, stride in ((4, 1), (8, 2), (16, 2), (32, 2)):
        x = res._static_bottleneck(x, ch, stride)
    x = L.pool2d(x, pool_type="avg", global_pooling=True)
    logits = L.fc(L.flatten(x, axis=1), 10)
    return L.mean(L.softmax_with_cross_entropy(logits, label))


def tiny_se_resnext(ns):
    """One SE-ResNeXt bottleneck a stage (grouped 3x3 at cardinality 4,
    squeeze-excitation at ratio 4) at 32x32, the softmax head behind a
    dropout of 0, cross_entropy and accuracy."""
    L, se = ns.L, ns.se
    img = L.data(name="image", shape=[3, 32, 32], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    x = se._conv_bn(img, 16, 3, name="stem")
    x = L.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                 pool_type="max")
    for si, filters in enumerate((8, 16, 32, 64)):
        x = se._bottleneck(x, filters, stride=2 if si else 1, cardinality=4,
                           reduction_ratio=4, name=f"s{si}b0")
    x = L.pool2d(x, pool_type="avg", global_pooling=True)
    out = L.fc(L.dropout(x, dropout_prob=0.0), size=10, act="softmax")
    L.accuracy(input=out, label=label)
    return L.mean(L.cross_entropy(input=out, label=label))


def lenet(ns):
    img = ns.L.data(name="image", shape=[1, 28, 28], dtype="float32")
    label = ns.L.data(name="label", shape=[1], dtype="int64")
    return ns.lenet.build_static(img, label)[1]


MODELS = {"resnet": (tiny_resnet, 32, 3), "se_resnext": (tiny_se_resnext,
                                                         32, 3),
          "lenet": (lenet, 28, 1)}


def build(ns, model, stage=None, amp=False, opt="momentum"):
    """(main, startup, loss): `model` minimised by Momentum, through fleet
    at ZeRO `stage` with 0.05 MB buckets when a stage is given."""
    main, start = ns.prog.Program(), ns.prog.Program()
    with ns.prog.program_guard(main, start), ns.names.guard():
        loss = model(ns)
        o = ns.opt.Momentum(learning_rate=LR, momentum=MU)
        if stage is not None:
            ns.fleet.init(is_collective=True)
            s = ns.fleet.DistributedStrategy()
            s.amp = amp
            s.sharding_stage = stage
            s.fuse_grad_size_in_mb = 0.05
            o = ns.fleet.distributed_optimizer(o, s)
        o.minimize(loss)
    return main, start, loss


def feeds(size, channels, steps=STEPS, seed=0):
    rng = np.random.RandomState(seed)
    return [{"image": rng.randn(BATCH, channels, size,
                                size).astype(np.float32),
             "label": rng.randint(0, 10, (BATCH, 1)).astype(np.int64)}
            for _ in range(steps)]


def persistables(main):
    return sorted(v.name for v in main.global_block().vars.values()
                  if v.persistable)


def assert_descs_equal(ref, port):
    rd, pd = ref.to_desc(), port.to_desc()
    r_ops, p_ops = rd["blocks"][0]["ops"], pd["blocks"][0]["ops"]
    assert [o["type"] for o in p_ops] == [o["type"] for o in r_ops]
    for r, p in zip(r_ops, p_ops):
        assert p == r, (r["type"], r, p)
    assert pd == rd


def _full(name):
    if name == "resnet50":
        return lambda ns: ns.resnet.build_resnet50_program()[2]
    if name == "se_resnext50":
        return lambda ns: ns.se.build_se_resnext_program()[2]
    return lenet


@pytest.mark.parametrize("name,stage,amp", [
    ("resnet50", None, False), ("resnet50", 1, True),
    ("se_resnext50", None, False), ("lenet", None, False)])
def test_full_model_descs_equal_reference(name, stage, amp):
    ref_main, ref_start, _ = build(REF, _full(name), stage, amp)
    port_main, port_start, _ = build(PORT, _full(name), stage, amp)
    assert_descs_equal(ref_main, port_main)
    assert port_start.to_desc() == ref_start.to_desc()
    ops = [op.type for op in port_main.global_block().ops]
    if name == "resnet50":
        assert ops.count("conv2d") == ops.count("batch_norm") == 53
        assert ("__zero_update__" in ops) == (stage == 1)
    if name == "se_resnext50":
        assert {"dropout", "sigmoid", "softmax", "cross_entropy", "top_k",
                "accuracy"} <= set(ops)
        grouped = [op for op in port_main.global_block().ops
                   if op.type == "conv2d" and op.attrs["groups"] == 32]
        assert len(grouped) == 16


def _reference_run(model, data):
    """The reference's plain Momentum program (no fleet: one device, the
    update of fleet's stages 0 and 1 without their bucket ops)."""
    main, start, loss = build(REF, model)
    exe, scope = fluid.Executor(), RefScope()
    exe.run(start, scope=scope)
    init = {n: np.asarray(scope.find(n)) for n in scope.local_names()
            if not n.startswith("__")}
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in data]
    final = {n: np.asarray(scope.find(n), np.float32)
             for n in persistables(main)}
    return init, losses, final


def _port_run(model, stage, init, data):
    main, _, loss = build(PORT, model, stage)
    scope = load_numpy(Scope(), init, "cpu")
    exe = Executor("cpu")
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in data]
    return main, scope, losses


@pytest.mark.parametrize("name", sorted(MODELS))
def test_momentum_steps_match_reference(name):
    """The port through fleet at stages 0 and 1 against the reference's
    Momentum run, one batch STEPS times (tolerances in the module
    docstring): losses and every persistable the reference holds, the
    running statistics and the velocities (unpacked from stage 1's flat
    buckets) included; the loss falls; the port's stage 1 equals its
    stage 0 bit for bit."""
    model, size, channels = MODELS[name]
    data = feeds(size, channels, steps=1) * STEPS
    init, ref_losses, ref_final = _reference_run(model, data)
    runs = {}
    for stage in (0, 1):
        main, scope, losses = _port_run(model, stage, init, data)
        # stage 1's velocities live in flat buckets: unpacked per parameter
        state = zero.unbucket_state_for_save(main, {
            n: scope.numpy(n) for n in persistables(main)})
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
        for n, want in ref_final.items():
            np.testing.assert_allclose(state[n], want, rtol=0, atol=1e-4,
                                       err_msg=n)
        types_ = [op.type for op in main.global_block().ops]
        assert ("__zero_update__" in types_) == (stage == 1)
        runs[stage] = (losses, {n: state[n] for n in ref_final})
    bn_state = [op.inputs[s][0] for op in main.global_block().ops
                if op.type == "batch_norm" for s in ("Mean", "Variance")]
    assert set(bn_state) <= set(ref_final)
    assert bool(bn_state) == (name != "lenet")
    assert ref_losses[-1] < ref_losses[0]
    assert runs[1][0] == runs[0][0]
    for n, v in runs[0][1].items():
        assert np.array_equal(runs[1][1][n], v), n


def _bn_names(main):
    return [(op.inputs["X"][0], op.inputs["Mean"][0], op.inputs["Variance"][0])
            for op in main.global_block().ops if op.type == "batch_norm"]


def test_running_statistics_written_once_a_step():
    """After one step each running mean is 0.9 * 0 + 0.1 * the batch mean
    of its input and each variance 0.9 * 1 + 0.1 * the biased batch
    variance, though every batch_norm grad op recomputes its forward; the
    grad op's batch statistics are the forward's (its input gradient
    equals autograd through the forward)."""
    main, start, loss = build(PORT, tiny_resnet, 0)
    scope = Scope()
    Executor("cpu").run(start, scope=scope)
    bns = _bn_names(main)
    xs = [x for x, _, _ in bns]
    data = feeds(32, 3, steps=1)[0]
    got = Executor("cpu").run(main, feed=data, fetch_list=[loss] + xs,
                              scope=scope)
    for (x, m, v), xv in zip(bns, got[1:]):
        want_m = 0.1 * xv.mean(axis=(0, 2, 3))
        want_v = 0.9 + 0.1 * xv.var(axis=(0, 2, 3))
        np.testing.assert_allclose(scope.numpy(m), want_m, rtol=1e-5,
                                   atol=1e-6, err_msg=m)
        np.testing.assert_allclose(scope.numpy(v), want_v, rtol=1e-5,
                                   err_msg=v)
    grad_ops = [op for op in main.global_block().ops
                if op.type == "__vjp__" and op.attrs["fwd_type"] ==
                "batch_norm"]
    assert len(grad_ops) == len(bns)
    assert all("MeanOut" not in op.attrs["fwd_output_slots"]
               for op in grad_ops)


def test_clone_for_test_reads_the_running_statistics():
    """The test program normalises by the running statistics, writes none
    of them and prunes the optimizer; its logits are those of the
    training program's forward at is_test."""
    main, start, loss = build(PORT, tiny_resnet, 0)
    test_prog = main.clone(for_test=True)
    bn_ops = [op for op in test_prog.global_block().ops
              if op.type == "batch_norm"]
    assert bn_ops and all(op.attrs["is_test"] for op in bn_ops)
    assert not any(op.type in ("momentum", "__vjp__", "__bucket_sync__")
                   for op in test_prog.global_block().ops)
    scope = Scope()
    exe = Executor("cpu")
    exe.run(start, scope=scope)
    data = feeds(32, 3, steps=2)
    exe.run(main, feed=data[0], fetch_list=[loss], scope=scope)
    stats = {m: scope.numpy(m) for _, m, _ in _bn_names(main)}
    stats.update({v: scope.numpy(v) for _, _, v in _bn_names(main)})
    out = exe.run(test_prog, feed=data[1], fetch_list=[loss], scope=scope)
    assert np.isfinite(out[0]).all()
    for n, v in stats.items():
        assert np.array_equal(scope.numpy(n), v), n


def test_running_statistics_stay_out_of_the_buckets():
    """The bucket pass sees the trainable parameters only: 4-D conv
    filters and 1-D BN scales and biases, never a running statistic; at
    stage 1 every bucket is one __zero_update__ of the momentum rule."""
    main, _, _ = build(PORT, tiny_resnet, 1)
    meta = main._grad_buckets
    bucketed = [n for b in meta["zero_buckets"] for n in b["params"]]
    params = {p.name: p for p in main.all_parameters()}
    stats = {m for _, m, _ in _bn_names(main)} | {
        v for _, _, v in _bn_names(main)}
    assert not stats & set(bucketed)
    assert sorted(bucketed) == sorted(n for n, p in params.items()
                                      if p.trainable)
    ranks = {len(params[n].shape) for n in bucketed}
    assert {1, 2, 4} <= ranks
    zero = [op for op in main.global_block().ops
            if op.type == "__zero_update__"]
    assert len(zero) == len(meta["zero_buckets"]) >= 3
    assert {op.attrs["update_op"] for op in zero} == {"momentum"}
    assert not any(op.type == "momentum" for op in main.global_block().ops)


def test_amp_tiny_resnet_trains():
    """The tiny ResNet through fleet AMP at stage 1 (bf16 convolutions,
    batch norm in f32 by the black list): finite, falling losses over 4
    steps on one batch, the running statistics f32."""
    main, start, loss = build(PORT, tiny_resnet, 1, amp=True)
    scope = Scope()
    exe = Executor("cpu")
    exe.run(start, scope=scope)
    data = feeds(32, 3, steps=1) * 4
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in data]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert torch.float32 == scope.find(_bn_names(main)[0][1]).dtype
