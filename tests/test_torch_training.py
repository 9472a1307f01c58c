"""PyTorch port, the training step: BERT pretraining through Program /
Executor.run in paddle_tpu_torch held against the JAX reference on the CPU.

* `BertConfig.tiny()` with dropout 0 and the padding mask on. The
  reference's startup scope is carried across as numpy, both packages run
  3 `Executor.run` steps of Adam on the same feeds, and the losses of every
  step and every persistable value after the last step (parameters, Adam
  moments, the shared beta-pow pair) are compared. Arms: f32 with the
  dense MLM head, f32 with `fused_mlm_head=True`, and fleet AMP bf16.
* With dropout on (hidden and attention), the port's gradients (the
  executor keeps the forward's pullback for its `__vjp__` op, or
  recomputes the forward in it) equal the plain autograd of the same
  masked forward: the forward ops and their gradients draw the same masks.

Tolerances, stated per arm where they are used: f32 losses rtol 1e-5 and
persistables atol 1e-5 (the frameworks sum in different orders, and Adam's
normalised update carries the difference into the parameters at the
learning rate's scale); AMP bf16 losses rtol 1e-4 and persistables atol
5e-4 (the bf16 products round at the same points in both packages, but
their f32 sums differ in order, and one bf16 ulp is 2**-8 relative).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu.models import bert as ref_bert

from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.framework import Executor, Scope, load_numpy
from paddle_tpu_torch.framework import executor as port_executor
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.framework.program import OpRole
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.ops import registry as port_registry

LR, STEPS, BATCH = 1e-3, 3, 2


def _cfg(cls, fused, dropout=0.0):
    cfg = cls.tiny()
    cfg.hidden_dropout = cfg.attention_dropout = dropout
    cfg.fused_mlm_head = fused
    return cfg


def _feeds(cfg, steps=STEPS, seed=0):
    """bench.py's BERT feeds at the tiny size: random ids and labels,
    per-example lengths uniform in [S/2, S]."""
    rng = np.random.RandomState(seed)
    s, out = cfg.seq_len, []
    for _ in range(steps):
        lens = rng.randint(s // 2, s + 1, size=(BATCH, 1))
        out.append({
            "input_ids": rng.randint(0, cfg.vocab_size,
                                     (BATCH, s)).astype(np.int64),
            "mlm_labels": rng.randint(0, cfg.vocab_size,
                                      (BATCH, s, 1)).astype(np.int64),
            "input_mask": (np.arange(s)[None] < lens).astype(np.float32)})
    return out


def _build(pkg, cfg, amp):
    """(main, startup, loss) of `pkg`'s BERT pretrain program with Adam,
    through fleet when `amp` (as bench.py's bench_bert builds it)."""
    if pkg == "ref":
        prog, names, bert, fleet = (ref_program, ref_unique_name, ref_bert,
                                    ref_fleet)
        opt = paddle.optimizer.Adam(learning_rate=LR)
    else:
        prog, names, bert, fleet = (port_program, port_unique_name,
                                    port_bert, port_fleet)
        opt = port_optimizer.Adam(learning_rate=LR)
    main, start = prog.Program(), prog.Program()
    with prog.program_guard(main, start), names.guard():
        _, _, loss = bert.build_pretrain_program(cfg, use_input_mask=True)
        if amp:
            fleet.init(is_collective=True)
            strategy = fleet.DistributedStrategy()
            strategy.amp = True
            opt = fleet.distributed_optimizer(opt, strategy)
        opt.minimize(loss)
    return main, start, loss


def _persistables(main):
    return sorted(v.name for v in main.global_block().vars.values()
                  if v.persistable)


@pytest.mark.parametrize("fused,amp", [(False, False), (True, False),
                                       (None, True)],
                         ids=["f32_dense_head", "f32_fused_head", "amp_bf16"])
def test_three_steps_match_reference(fused, amp):
    feeds = _feeds(_cfg(ref_bert.BertConfig, fused))

    main, start, loss = _build("ref", _cfg(ref_bert.BertConfig, fused), amp)
    exe, rscope = fluid.Executor(), RefScope()
    exe.run(start, scope=rscope)
    init = {n: np.asarray(rscope.find(n)) for n in rscope.local_names()
            if not n.startswith("__")}
    ref_losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=rscope)[0]) for f in feeds]
    names = _persistables(main)
    ref_final = {n: np.asarray(rscope.find(n), np.float32) for n in names}

    pmain, _, ploss = _build("port", _cfg(port_bert.BertConfig, fused), amp)
    assert _persistables(pmain) == names
    assert set(init) == set(names)
    pexe, pscope = Executor("cpu"), load_numpy(Scope(), init, "cpu")
    port_losses = [float(pexe.run(pmain, feed=f, fetch_list=[ploss],
                                  scope=pscope)[0]) for f in feeds]

    # f32: rtol 1e-5 / atol 1e-5; AMP bf16: rtol 1e-4 / atol 5e-4 (module
    # docstring)
    loss_rtol, atol = (1e-4, 5e-4) if amp else (1e-5, 1e-5)
    np.testing.assert_allclose(port_losses, ref_losses, rtol=loss_rtol)
    assert port_losses[-1] < port_losses[0]          # Adam moved the loss
    for n in names:
        np.testing.assert_allclose(pscope.numpy(n), ref_final[n], rtol=0,
                                   atol=atol, err_msg=n)
    moved = [n for n in names if n.endswith("_w")
             and not np.array_equal(pscope.numpy(n), init[n])]
    assert len(moved) == sum(n.endswith("_w") for n in names)


def _plain_autograd_grads(main, loss_name, arrays, feed, run_seed, params):
    """The forward ops of `main` as plain PyTorch with autograd, on the
    run seed the executor uses, then d loss / d params."""
    block = main.global_block()
    env = {n: torch.from_numpy(np.array(a)).requires_grad_(n in params)
           for n, a in arrays.items()}
    env.update({n: port_executor._coerce_feed_value(block, n, v, "cpu")
                for n, v in feed.items()})
    ctx = port_registry.LowerCtx(run_seed=run_seed, device="cpu")
    masks = []
    for op in block.ops:
        if op.attrs.get("op_role", OpRole.Forward) != OpRole.Forward:
            break
        ins = {s: [env[n] for n in names] for s, names in op.inputs.items()}
        outs = port_registry.get(op.type).lower(ctx, ins, op.attrs)
        for s, names in op.outputs.items():
            for n, v in zip(names, outs.get(s, ())):
                env[n] = v
        if op.type == "dropout":
            masks.append(outs["Mask"][0])
    loss = env[loss_name]
    grads = torch.autograd.grad(loss, [env[p] for p in params])
    return float(loss.detach()), [g.numpy() for g in grads], masks


@pytest.mark.parametrize("path", ["kept_pullback", "recompute"])
def test_dropout_masks_of_forward_and_vjp_agree(path, monkeypatch):
    """Dropout 0.1 in the hidden layers and in attention: the executor's
    gradients equal the plain autograd of the same masked forward
    (tolerance: f32 rtol 1e-5 / atol 1e-6, sums in another order)."""
    cfg = _cfg(port_bert.BertConfig, None, dropout=0.1)
    main, start, loss = _build("port", cfg, amp=False)
    sscope = Scope()
    Executor("cpu").run(start, scope=sscope)
    arrays = {n: sscope.numpy(n) for n in sscope.local_names()
              if not n.startswith("__")}
    params = [p.name for p in main.all_parameters()]
    feed = _feeds(cfg, steps=1)[0]
    if path == "recompute":        # every __vjp__ re-runs its forward op
        monkeypatch.setattr(port_executor, "_grad_plan", lambda block: {})
    fetches = Executor("cpu").run(
        main, feed=feed, fetch_list=[loss] + [p + "@GRAD" for p in params],
        scope=load_numpy(Scope(), arrays, "cpu"))

    run_seed = port_executor._next_run_seed(Scope(), main.random_seed)
    want_loss, want_grads, masks = _plain_autograd_grads(
        main, loss.name, arrays, feed, run_seed, params)
    assert masks and all(0 < int((m == 0).sum()) < m.numel() for m in masks)
    np.testing.assert_allclose(fetches[0], want_loss, rtol=1e-5)
    for name, got, want in zip(params, fetches[1:], want_grads):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
