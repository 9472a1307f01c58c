"""PyTorch port, gradient bucketing and ZeRO stages 0-3: paddle_tpu_torch's
parallel/zero.py pass and lowerings, reached through fleet, held against
the JAX reference on the CPU. BERT-tiny throughout, dropout 0, the
padding mask on, `fuse_grad_size_in_mb=0.02` so that the program has at
least 3 buckets.

* Main and startup descs equal the reference's under fleet at stages 0-3,
  f32 and AMP: op types, order, names and attrs of every `__bucket_sync__`,
  `__zero_update__`, `__zero_gather__` and `__zero_pack__`, and the flat
  state vars. Stage 0 pins the repaired fault: the port's fleet used to
  leave the bucket pass out, so its program lacked the `__bucket_sync__`
  ops.
* 3 steps against the reference at stages 1-3, the reference's startup
  scope carried across as numpy. Tolerances are those of
  test_torch_training.py: losses rtol 1e-5, every persistable atol 1e-5.
* Inside the port: stages 1, 2 and 3 equal stage 0 bit for bit on the CPU,
  in losses and parameters (the flat update is elementwise, and every rule
  is one torch op per reference op).
* SGD, Momentum (nesterov) and AdamW + L2Decay + GlobalNorm clip at stages
  0 and 1 against the reference, same tolerances; the clipped/regularised
  buckets are `pre_synced` and keep their `__bucket_sync__`.
* Fleet raises on stage 4 and on stage 3 with tensor parallelism; a
  `_layer_stacks` record without a layer scan takes the flat stage-3
  path, as the reference's does; disabled bucketing under a sharding
  request is counted as a fallback.
"""
import importlib

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu.models import bert as ref_bert

from paddle_tpu_torch import clip as port_clip
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch import regularizer as port_reg
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.framework import Executor, Scope, load_numpy
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.observability import metrics

# the package namespace binds `clip` to the tensor function: take the modules
ref_clip = importlib.import_module("paddle_tpu.clip")
ref_reg = importlib.import_module("paddle_tpu.regularizer")

LR, STEPS, BATCH, BUCKET_MB = 1e-3, 3, 2, 0.02

_PKGS = {
    "ref": dict(prog=ref_program, names=ref_unique_name, bert=ref_bert,
                fleet=ref_fleet, opt=paddle.optimizer, clip=ref_clip,
                reg=ref_reg),
    "port": dict(prog=port_program, names=port_unique_name, bert=port_bert,
                 fleet=port_fleet, opt=port_optimizer, clip=port_clip,
                 reg=port_reg),
}


def _optimizer(pkg, kind):
    m = _PKGS[pkg]
    if kind == "adam":
        return m["opt"].Adam(learning_rate=LR)
    if kind == "sgd":
        return m["opt"].SGD(learning_rate=0.1)
    if kind == "momentum":
        return m["opt"].Momentum(learning_rate=0.05, momentum=0.9,
                                 use_nesterov=True)
    assert kind == "adamw_l2_clip"
    return m["opt"].AdamW(
        learning_rate=LR, weight_decay=0.01,
        regularization=m["reg"].L2Decay(1e-4),
        grad_clip=m["clip"].GradientClipByGlobalNorm(1.0))


def _build(pkg, stage, amp=False, kind="adam", bucket_mb=BUCKET_MB,
           layer_stacks=None, **strategy):
    """(main, startup, loss) of BERT-tiny minimised through fleet."""
    m = _PKGS[pkg]
    main, start = m["prog"].Program(), m["prog"].Program()
    with m["prog"].program_guard(main, start), m["names"].guard():
        cfg = m["bert"].BertConfig.tiny()
        cfg.hidden_dropout = cfg.attention_dropout = 0.0
        _, _, loss = m["bert"].build_pretrain_program(cfg,
                                                      use_input_mask=True)
        if layer_stacks is not None:
            main._layer_stacks = layer_stacks
        m["fleet"].init(is_collective=True)
        s = m["fleet"].DistributedStrategy()
        s.amp = amp
        s.sharding_stage = stage
        s.fuse_grad_size_in_mb = bucket_mb
        for k, v in strategy.items():
            object.__setattr__(s, k, v)
        m["fleet"].distributed_optimizer(_optimizer(pkg, kind),
                                         s).minimize(loss)
    return main, start, loss


def _feeds(steps=STEPS, seed=0):
    cfg = port_bert.BertConfig.tiny()
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


def _persistables(main):
    return sorted(v.name for v in main.global_block().vars.values()
                  if v.persistable)


def _op_types(main):
    return [op.type for op in main.global_block().ops]


# ---------------------------------------------------------------------------
# Program structure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_descs_equal_reference(stage, amp):
    ref_main, ref_start, _ = _build("ref", stage, amp)
    port_main, port_start, _ = _build("port", stage, amp)
    rd, pd = ref_main.to_desc(), port_main.to_desc()
    r_ops, p_ops = rd["blocks"][0]["ops"], pd["blocks"][0]["ops"]
    assert [o["type"] for o in p_ops] == [o["type"] for o in r_ops]
    for r, p in zip(r_ops, p_ops):
        assert p == r, (r["type"], r, p)
    assert pd == rd
    assert port_start.to_desc() == ref_start.to_desc()
    types = _op_types(port_main)
    if stage == 0:
        # the repaired fault: one grouped sync per bucket, no per-param
        # update op touched
        assert types.count("__bucket_sync__") >= 3
        assert "__zero_update__" not in types and "adam" in types
    else:
        assert types.count("__zero_update__") >= 3
        assert "adam" not in types and "__bucket_sync__" not in types
    assert ("__zero_gather__" in types) == (stage == 3)
    assert any(op.type == "__zero_pack__"
               for op in port_start.global_block().ops) == (stage == 3)


def test_bucket_ops_sink_into_the_backward():
    """Each bucket op sits right after the last op producing its
    gradients, interleaved with the backward, not after it."""
    main, _, _ = _build("port", 1)
    ops = main.global_block().ops
    upd = [i for i, op in enumerate(ops) if op.type == "__zero_update__"]
    last_vjp = max(i for i, op in enumerate(ops) if op.type == "__vjp__")
    assert upd[0] < last_vjp
    for i in upd:
        grads = set(ops[i].inputs["Grad"])
        producer = max(j for j in range(i)
                       if grads & set(ops[j].output_names()))
        assert producer == i - 1 or all(
            ops[k].type == "__zero_update__" for k in range(producer + 1, i))


# ---------------------------------------------------------------------------
# Training steps
# ---------------------------------------------------------------------------

def _ref_run(stage, kind="adam", feeds=None):
    feeds = feeds or _feeds()
    main, start, loss = _build("ref", stage, kind=kind)
    exe, scope = fluid.Executor(), RefScope()
    exe.run(start, scope=scope)
    init = {n: np.asarray(scope.find(n)) for n in scope.local_names()
            if not n.startswith("__")}
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in feeds]
    final = {n: np.asarray(scope.find(n), np.float32)
             for n in _persistables(main)}
    return init, losses, final


def _port_run(stage, init, kind="adam", feeds=None):
    feeds = feeds or _feeds()
    main, _, loss = _build("port", stage, kind=kind)
    exe, scope = Executor("cpu"), load_numpy(Scope(), init, "cpu")
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in feeds]
    return main, scope, losses


def _assert_matches_reference(stage, kind):
    init, ref_losses, ref_final = _ref_run(stage, kind)
    main, scope, losses = _port_run(stage, init, kind)
    assert _persistables(main) == sorted(ref_final)
    # f32: losses rtol 1e-5, persistables atol 1e-5 (module docstring)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    for n, want in ref_final.items():
        np.testing.assert_allclose(scope.numpy(n), want, rtol=0, atol=1e-5,
                                   err_msg=n)
    return main


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_three_steps_match_reference(stage):
    main = _assert_matches_reference(stage, "adam")
    assert _op_types(main).count("__zero_update__") >= 3


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("kind", ["sgd", "momentum", "adamw_l2_clip"])
def test_optimizers_match_reference(kind, stage):
    main = _assert_matches_reference(stage, kind)
    types = _op_types(main)
    if kind == "adamw_l2_clip":
        assert {"elementwise_max", "reduce_sum", "sqrt"} <= set(types)
        # clipped + regularised gradients: every bucket is pre-synced and
        # its raw gradients keep a grouped sync
        assert types.count("__bucket_sync__") >= 3
    if stage == 1:
        zero = [op for op in main.global_block().ops
                if op.type == "__zero_update__"]
        assert len(zero) >= 3
        assert all(op.attrs["pre_synced"] == (kind == "adamw_l2_clip")
                   for op in zero)


def _params_by_name(main, scope):
    """{param name: value}, unpacking stage-3 flat parameter storage."""
    out = {p.name: scope.numpy(p.name) for p in main.all_parameters()
           if p.persistable}
    for b in getattr(main, "_grad_buckets", {}).get("zero_buckets", []):
        if b["flat_param"]:
            flat, off = scope.numpy(b["flat_param"]), 0
            for n, size, shape in zip(b["params"], b["sizes"], b["shapes"]):
                out[n] = flat[off:off + size].reshape(shape)
                off += size
    return out


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
def test_stages_equal_stage0_bitwise(amp):
    """Stages 1, 2 and 3 train exactly as stage 0 in the port: same losses
    and parameters, bit for bit, from the same startup values."""
    feeds = _feeds()
    runs = {}
    init = None
    for stage in (0, 1, 2, 3):
        main, start, loss = _build("port", stage, amp)
        scope = Scope()
        Executor("cpu").run(start, scope=scope)
        if init is None:       # every stage starts from stage 0's values
            init = {p.name: scope.numpy(p.name)
                    for p in main.all_parameters()}
        else:
            assert all(np.array_equal(v, init[n]) for n, v in
                       _params_by_name(main, scope).items())
        exe = Executor("cpu")
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)[0]) for f in feeds]
        runs[stage] = (losses, _params_by_name(main, scope))
    base_losses, base_params = runs[0]
    for stage in (1, 2, 3):
        losses, params = runs[stage]
        assert losses == base_losses, (stage, losses, base_losses)
        assert sorted(params) == sorted(base_params)
        for n, v in base_params.items():
            assert np.array_equal(params[n], v), (stage, n)


# ---------------------------------------------------------------------------
# What fleet refuses
# ---------------------------------------------------------------------------

def test_fleet_raises_on_unsupported_stages():
    with pytest.raises(ValueError, match="sharding stage 4 is not supported"):
        _build("port", 4)
    with pytest.raises(ValueError, match="cannot compose with tensor"):
        _build("port", 3, tensor_parallel_degree=2)
    # a `_layer_stacks` record without a layer scan op takes the flat
    # stage-3 path, as the reference's pass does (the stacked buckets are
    # tests/test_torch_zero_stacked.py's)
    stacks = {"enc_w@LAYERS": ["enc0_w"]}
    pm, _, _ = _build("port", 3, layer_stacks=stacks)
    rm, _, _ = _build("ref", 3, layer_stacks=stacks)
    assert pm.to_desc() == rm.to_desc()
    assert {b["layout"] for b in pm._grad_buckets["zero_buckets"]} \
        == {"flat"}
    # sharding=True with the stage from sharding_configs
    main, _, _ = _build("port", 0, sharding=True,
                        sharding_configs={"stage": 2})
    assert main._grad_buckets["stage"] == 2


def test_disabled_bucketing_counts_a_fallback():
    metrics.reset()
    main, _, _ = _build("port", 1, bucket_mb=0)
    assert "__zero_update__" not in _op_types(main)
    snap = metrics.snapshot()
    assert snap["executor.zero_manual_fallbacks.bucketing_disabled"][
        "value"] == 1
