"""PyTorch port, the recurrent models of chip_smoke.py's phase 17, held
against the JAX reference on the CPU at a small width (T 8, width 32,
batch 4):

* DRNN: PaddlePaddle Fluid's stacked_dynamic_lstm (a DynamicRNN whose
  step is an LSTM of 8 fcs) with Adam, and the same through fleet at
  ZeRO stage 1;
* BOOK: the Paddle book's understand_sentiment stacked_lstm_net (3
  dynamic_lstm layers of alternating direction) with Adagrad, its
  embedding `is_sparse` as the book's (Adagrad's SelectedRows rule).

Built in both packages from fresh programs, the main and startup descs
are EQUAL (every block). From the reference's startup arrays, 3 steps on
one batch agree with the reference's: losses rtol 1e-4, every
persistable atol 1e-5 (f32; the frameworks sum the GEMMs in other
orders). In the port: E (3 run() calls) == C (run_steps(3), and the
step body in its captured form) bit for bit, and the DRNN at stage 1
(the flat-bucket Adam, one `__zero_update__` a bucket) == stage 0 bit
for bit. The reference's fleet accepts a program whose gradients come
out of the `__while__` op's grad op, and so does the port's. Under AMP
the loop body's products run in bf16 (the white list reaches into the
sub-block) and the DRNN's losses stay within 1e-2 of f32's.
"""
import types

import numpy as np
import pytest

import paddle_tpu.fluid as fluid
from paddle_tpu import layers as ref_layers
from paddle_tpu import optimizer as ref_optimizer
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.framework.scope import Scope as RefScope

import chip_smoke
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.framework import Executor, Scope, load_numpy
from paddle_tpu_torch.framework import executor as port_executor
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.ops import registry as port_registry
from paddle_tpu_torch.parallel import zero

REF = types.SimpleNamespace(prog=ref_program, names=ref_unique_name,
                            L=ref_layers, opt=ref_optimizer, fleet=ref_fleet)
PORT = types.SimpleNamespace(prog=port_program, names=port_unique_name,
                             L=port_layers, opt=port_optimizer,
                             fleet=port_fleet)
T, WIDTH, BATCH, STEPS = 8, 32, 4, 3
MODELS = {"drnn": ("adam", chip_smoke.DRNN_LR),
          "book": ("adagrad", chip_smoke.BOOK_LR)}


def build(pkg, model, stage=None):
    opt, lr = MODELS[model]
    return chip_smoke.build_seq(pkg, model, (T, WIDTH), opt, lr, stage)


def feed():
    return chip_smoke.seq_feed(BATCH, T, chip_smoke.SEQ_VOCAB)


def persistables(main):
    return sorted(v.name for v in main.global_block().vars.values()
                  if v.persistable)


def assert_descs_equal(ref, port):
    rd, pd = ref.to_desc(), port.to_desc()
    assert len(pd["blocks"]) == len(rd["blocks"])
    for rb, pb in zip(rd["blocks"], pd["blocks"]):
        for r, p in zip(rb["ops"], pb["ops"]):
            assert p == r, (rb["idx"], r["type"], r, p)
    assert pd == rd


def reference_run(model):
    main, start, loss = build(REF, model)
    exe, scope = fluid.Executor(), RefScope()
    exe.run(start, scope=scope)
    init = {n: np.asarray(scope.find(n)) for n in scope.local_names()
            if not n.startswith("__")}
    f = feed()
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(STEPS)]
    final = {n: np.asarray(scope.find(n), np.float32)
             for n in persistables(main)}
    return init, losses, final


@pytest.fixture(scope="module")
def ref_runs():
    return {m: reference_run(m) for m in MODELS}


def port_run(model, init, stage=None):
    main, _, loss = build(PORT, model, stage)
    scope = load_numpy(Scope(), init, "cpu")
    exe = Executor("cpu")
    f = feed()
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(STEPS)]
    return main, scope, losses


@pytest.mark.parametrize("model,stage", [("drnn", None), ("drnn", 1),
                                         ("book", None)])
def test_descs_equal_reference(model, stage):
    rm, rs, _ = build(REF, model, stage)
    pm, ps, _ = build(PORT, model, stage)
    assert_descs_equal(rm, pm)
    assert ps.to_desc() == rs.to_desc()
    types_ = [op.type for op in pm.global_block().ops]
    if model == "drnn":
        assert len(pm.blocks) == 2 and types_.count("__while__") == 1
        assert pm.global_block().ops[types_.index("__while__")].attrs[
            "trip_bound"] == T
        assert [op.type for op in pm.blocks[1].ops].count("mul") == 8
        assert ("__zero_update__" in types_) == (stage == 1)
    else:
        assert types_.count("lstm") == chip_smoke.BOOK_STACKED
        assert [op.attrs["is_reverse"] for op in pm.global_block().ops
                if op.type == "lstm"] == [False, True, False]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_steps_match_reference(model, ref_runs):
    init, ref_losses, ref_final = ref_runs[model]
    main, scope, losses = port_run(model, init)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert losses[-1] < losses[0]
    for n, want in ref_final.items():
        np.testing.assert_allclose(scope.numpy(n), want, rtol=0, atol=1e-5,
                                   err_msg=n)


def _state(main, scope):
    return {n: scope.numpy(n) for n in persistables(main)}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_eager_equals_captured_bitwise(model, ref_runs):
    """E: 3 run() calls; C: run_steps(3) (the CPU runs its step body), and
    3 steps of the body in its captured form (`LowerCtx.capturing`)."""
    init = ref_runs[model][0]
    main, _, loss = build(PORT, model)
    f = feed()
    exe = Executor("cpu")
    e = load_numpy(Scope(), init, "cpu")
    e_losses = [exe.run(main, feed=f, fetch_list=[loss], scope=e)[0]
                for _ in range(STEPS)]
    c = load_numpy(Scope(), init, "cpu")
    c_losses, = exe.run_steps(STEPS, main, feed=f, fetch_list=[loss],
                              scope=c)
    k = load_numpy(Scope(), init, "cpu")
    block = main.global_block()
    env = {n: port_executor._coerce_feed_value(block, n, v, exe.device)
           for n, v in f.items()}
    k_losses = []
    for b in range(STEPS):
        ctx = port_registry.LowerCtx(run_seed=b, device="cpu",
                                     capturing=True)
        k_losses.append(exe._step(main, dict(env), k, ctx,
                                  [loss.name])[0].numpy())
    assert np.array_equal(np.stack(e_losses), c_losses)
    assert np.array_equal(np.stack(k_losses), c_losses)
    es, cs, ks = _state(main, e), _state(main, c), _state(main, k)
    for n in es:
        assert np.array_equal(es[n], cs[n]) and np.array_equal(es[n], ks[n])


def test_drnn_stage1_equals_stage0_bitwise(ref_runs):
    """Arm Z: fleet's bucket pass takes the gradients of the parameters
    read inside the loop body (the __while__ grad op's IG:Free) into its
    buckets, one flat-bucket Adam a bucket; the losses and every
    parameter and moment equal stage 0's, bit for bit, and the
    reference's within the tolerances."""
    init, ref_losses, ref_final = ref_runs["drnn"]
    m0, s0, l0 = port_run("drnn", init, stage=0)
    m1, s1, l1 = port_run("drnn", init, stage=1)
    assert l0 == l1
    np.testing.assert_allclose(l1, ref_losses, rtol=1e-4)
    meta = m1._grad_buckets
    bucketed = {n for b in meta["zero_buckets"] for n in b["params"]}
    inner = {n for op in m1.blocks[1].ops for n in op.input_names()
             if n in {p.name for p in m1.all_parameters()}}
    assert inner and inner <= bucketed
    state1 = zero.unbucket_state_for_save(m1, _state(m1, s1))
    state0 = _state(m0, s0)
    for n, v in state0.items():
        if n in state1:
            assert np.array_equal(state1[n], v), n
    for n, want in ref_final.items():
        np.testing.assert_allclose(state1[n], want, rtol=0, atol=1e-5,
                                   err_msg=n)


def test_drnn_under_amp_stays_near_f32(ref_runs):
    """The AMP casts reach the loop body's `mul` ops (bf16 products)
    while the arrays pass through untouched; 3 steps of losses within
    rtol 1e-2 of the f32 run's (one bf16 ulp is 2**-8 relative)."""
    init = ref_runs["drnn"][0]
    losses = {}
    for amp in (False, True):
        main, _, loss = build(PORT, "drnn")
        main._amp = amp
        scope, exe = load_numpy(Scope(), init, "cpu"), Executor("cpu")
        f = feed()
        losses[amp] = [float(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scope)[0]) for _ in range(STEPS)]
    assert losses[True] != losses[False]
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-2)
