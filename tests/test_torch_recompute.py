"""PyTorch port, recompute: parallel/transforms.py `apply_recompute` and the
`__segment__` op, reached through fleet's `recompute` strategy with the
models' per-layer checkpoints (`loss._layer_checkpoints`), held against
the JAX reference on the CPU.

* The recompute program (GPT-tiny and BERT-tiny) equals the reference's
  desc for desc: the `__segment__` ops, their `sub_ops`, `in_names` and
  `out_names`, and the `__vjp__` ops over them; the reference's desc
  round-trips through the port's `Program.from_desc`.
* GPT-tiny (f32 and fleet AMP bf16) and BERT-tiny (f32, padding mask)
  recompute, 3 Adam steps from the reference's startup arrays, dropout
  off, against the reference: f32 rtol 1e-5 on the losses and atol 1e-5
  on every persistable; AMP rtol 1e-4 / atol 5e-4 (the limits of
  tests/test_torch_gpt_lm.py, which says why). AMP pins the per-sub-op
  casts: without them the segment's ops would run in f32.
* Inside the port with dropout 0.1: recompute against the same program
  without it. The first loss is equal bit for bit (the same forward), the
  later ones within rtol 1e-6 and the parameters within atol 1e-6: the
  re-run forward draws the dropout masks of the first (a different mask
  would move the gradients by far more). Each segment's forward launches
  once more in the backward: the segment grad ops are not paired with
  their forward ops.
* `clone(for_test)` of a segmented program sets `is_test` in the
  `sub_ops` (as the reference's does, desc for desc), and evaluating the
  clone equals the reference's evaluation (rtol 1e-5).
* Recompute at ZeRO stage 1 keeps the bucket pass (`__zero_update__`
  ops) and matches the reference over 3 steps (f32 tolerances).
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
from paddle_tpu.models import gpt as ref_gpt

from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.framework import Executor, Scope, load_numpy
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.models import gpt as port_gpt
from paddle_tpu_torch.ops import registry as port_registry

LR, STEPS, BATCH = 1e-4, 3, 2

_PKGS = {
    "ref": dict(prog=ref_program, names=ref_unique_name, gpt=ref_gpt,
                bert=ref_bert, fleet=ref_fleet, opt=paddle.optimizer),
    "port": dict(prog=port_program, names=port_unique_name, gpt=port_gpt,
                 bert=port_bert, fleet=port_fleet, opt=port_optimizer),
}


def build(pkg, model="gpt", recompute=True, amp=False, dropout=0.0,
          stage=0):
    """(main, startup, loss) of `model`-tiny minimised by Adam through
    fleet, with the per-layer checkpoints recomputed."""
    m = _PKGS[pkg]
    main, start = m["prog"].Program(), m["prog"].Program()
    with m["prog"].program_guard(main, start), m["names"].guard():
        if model == "gpt":
            cfg = m["gpt"].GPTConfig.tiny()
            cfg.hidden_dropout = cfg.attention_dropout = dropout
            _, loss = m["gpt"].build_lm_program(cfg)
        else:
            cfg = m["bert"].BertConfig.tiny()
            cfg.hidden_dropout = cfg.attention_dropout = dropout
            _, _, loss = m["bert"].build_pretrain_program(
                cfg, use_input_mask=True)
        m["fleet"].init(is_collective=True)
        s = m["fleet"].DistributedStrategy()
        s.amp = amp
        s.sharding_stage = stage
        if recompute:
            s.recompute = True
            s.recompute_configs = {"checkpoints": loss._layer_checkpoints}
        if not stage:
            s.fuse_grad_size_in_mb = 0
        m["fleet"].distributed_optimizer(
            m["opt"].Adam(learning_rate=LR), s).minimize(loss)
    return main, start, loss


def feeds(model, steps=STEPS, seed=0):
    rng = np.random.RandomState(seed)
    if model == "gpt":
        cfg = port_gpt.GPTConfig.tiny()
        return [{"tokens": rng.randint(0, cfg.vocab_size,
                                       (BATCH, cfg.seq_len)).astype(np.int64)}
                for _ in range(steps)]
    cfg = port_bert.BertConfig.tiny()
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


def persistables(main):
    return sorted(v.name for v in main.global_block().vars.values()
                  if v.persistable)


def ref_run(main, start, loss, fs):
    scope = RefScope()
    exe = fluid.Executor()
    exe.run(start, scope=scope)
    init = {n: np.asarray(scope.find(n)) for n in scope.local_names()
            if not n.startswith("__")}
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in fs]
    return init, losses, {n: np.asarray(scope.find(n), np.float32)
                          for n in persistables(main)}


def port_run(main, loss, fs, init):
    exe, scope = Executor("cpu"), load_numpy(Scope(), init, "cpu")
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in fs]
    return losses, scope


def segment_ops(main):
    return [op for op in main.global_block().ops if op.type == "__segment__"]


@pytest.mark.parametrize("model", ["gpt", "bert"])
def test_segment_structure_equals_reference(model):
    rm, rs, _ = build("ref", model)
    pm, ps, _ = build("port", model)
    assert pm.to_desc() == rm.to_desc()
    assert ps.to_desc() == rs.to_desc()
    # the reference's desc crosses into the port with its sub_ops
    assert port_program.Program.from_desc(rm.to_desc()).to_desc() \
        == rm.to_desc()
    segs = segment_ops(pm)
    layers = (port_gpt.GPTConfig.tiny().num_layers if model == "gpt"
              else port_bert.BertConfig.tiny().num_layers)
    assert len(segs) == layers + 1          # one a layer, then the head
    assert all(s.attrs["remat"] for s in segs)
    inner = [d["type"] for s in segs for d in s.attrs["sub_ops"]]
    assert inner.count("fused_attention") == layers
    vjps = [op for op in pm.global_block().ops if op.type == "__vjp__"
            and op.attrs["fwd_type"] == "__segment__"]
    assert len(vjps) == len(segs)


@pytest.mark.parametrize("model,amp", [("gpt", False), ("gpt", True),
                                       ("bert", False)],
                         ids=["gpt_f32", "gpt_amp_bf16", "bert_f32"])
def test_recompute_matches_reference(model, amp):
    fs = feeds(model)
    rm, rs, rloss = build("ref", model, amp=amp)
    init, ref_losses, ref_final = ref_run(rm, rs, rloss, fs)
    pm, _, ploss = build("port", model, amp=amp)
    assert persistables(pm) == sorted(ref_final)
    losses, scope = port_run(pm, ploss, fs, init)
    loss_rtol, atol = (1e-4, 5e-4) if amp else (1e-5, 1e-5)
    np.testing.assert_allclose(losses, ref_losses, rtol=loss_rtol)
    for n, want in ref_final.items():
        np.testing.assert_allclose(scope.numpy(n), want, rtol=0, atol=atol,
                                   err_msg=n)
    weights = [v.name for v in pm.all_parameters() if v.name.endswith("_w")]
    assert weights and all(not np.array_equal(scope.numpy(n), init[n])
                           for n in weights)


def test_recompute_equals_no_recompute_with_dropout(monkeypatch):
    fs = feeds("gpt")
    init = ref_run(*build("ref", "gpt", dropout=0.1), [])[0]
    launches = {}
    real = port_registry.get("__segment__").lower

    def counting(ctx, ins, attrs):
        key = tuple(attrs["out_names"])
        launches[key] = launches.get(key, 0) + 1
        return real(ctx, ins, attrs)
    monkeypatch.setattr(port_registry.get("__segment__"), "lower", counting)
    out = {}
    for rc in (False, True):
        launches.clear()
        main, _, loss = build("port", "gpt", recompute=rc, dropout=0.1)
        losses, scope = port_run(main, loss, fs, init)
        out[rc] = (losses, {n: scope.numpy(n) for n in init})
        if rc:
            # every segment ran twice a step: its forward and the re-run
            # under its grad op
            assert sorted(launches.values()) == [2 * STEPS] * len(
                segment_ops(main))
    (a, sa), (b, sb) = out[False], out[True]
    assert a[0] == b[0]
    np.testing.assert_allclose(b, a, rtol=1e-6)
    for n in sa:
        np.testing.assert_allclose(sb[n], sa[n], rtol=0, atol=1e-6,
                                   err_msg=n)


def test_clone_for_test_of_segmented_program():
    rm, rs, rloss = build("ref", "gpt", dropout=0.1)
    pm, _, ploss = build("port", "gpt", dropout=0.1)
    rt, pt = rm.clone(for_test=True), pm.clone(for_test=True)
    assert pt.to_desc() == rt.to_desc()
    inner = [d for s in segment_ops(pt) for d in s.attrs["sub_ops"]
             if "is_test" in d["attrs"]]
    assert inner and all(d["attrs"]["is_test"] for d in inner)
    # the training program's own segments are untouched
    assert not any(d["attrs"]["is_test"] for s in segment_ops(pm)
                   for d in s.attrs["sub_ops"] if "is_test" in d["attrs"])
    f = feeds("gpt", steps=1)[0]
    scope = RefScope()
    fluid.Executor().run(rs, scope=scope)
    init = {n: np.asarray(scope.find(n)) for n in scope.local_names()
            if not n.startswith("__")}
    want, = fluid.Executor().run(rt, feed=f, fetch_list=[rloss.name],
                                 scope=scope)
    got, = Executor("cpu").run(pt, feed=f, fetch_list=[ploss.name],
                               scope=load_numpy(Scope(), init, "cpu"))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)


def test_recompute_at_zero_stage1_matches_reference():
    fs = feeds("bert")
    rm, rs, rloss = build("ref", "bert", stage=1)
    init, ref_losses, ref_final = ref_run(rm, rs, rloss, fs)
    pm, _, ploss = build("port", "bert", stage=1)
    types = [op.type for op in pm.global_block().ops]
    assert "__segment__" in types and "__zero_update__" in types
    assert pm.to_desc() == rm.to_desc()
    losses, scope = port_run(pm, ploss, fs, init)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for n, want in ref_final.items():
        np.testing.assert_allclose(scope.numpy(n), want, rtol=0, atol=1e-5,
                                   err_msg=n)


def test_segment_lowering_casts_per_sub_op():
    """Under AMP the segment's matmul-like sub-ops see bf16 inputs, the
    black-listed ones f32, as the executor's op loop casts them."""
    pm, _, _ = build("port", "gpt")
    seg = segment_ops(pm)[1]
    seen = {}
    orig = {}
    for t in ("mul", "layer_norm"):
        od = port_registry.get(t)
        orig[t] = od.lower

        def spy(ctx, ins, attrs, _t=t, _f=od.lower):
            seen.setdefault(_t, set()).update(
                v.dtype for vs in ins.values() for v in vs
                if isinstance(v, torch.Tensor) and v.is_floating_point())
            return _f(ctx, ins, attrs)
        od.lower = spy
    try:
        rng = np.random.RandomState(0)
        block = pm.global_block()
        ins = [torch.from_numpy(rng.standard_normal(
            [d if d > 0 else BATCH for d in block.var(n).shape])
            .astype(np.float32)) for n in seg.attrs["in_names"]]
        ctx = port_registry.LowerCtx(device="cpu", amp_dtype=torch.bfloat16)
        port_registry.get("__segment__").lower(ctx, {"X": ins}, seg.attrs)
    finally:
        for t, f in orig.items():
            port_registry.get(t).lower = f
    assert seen["mul"] == {torch.bfloat16}
    assert seen["layer_norm"] == {torch.float32}
