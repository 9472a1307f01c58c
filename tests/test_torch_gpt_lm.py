"""PyTorch port, GPT LM training: paddle_tpu_torch's models.gpt
(`build_lm_program`), its `matmul` / `gather` lowerings and layers, and the
trained model served by the port's DecodeEngine, held against the JAX
reference on the CPU.

* The GPT LM program (GPTConfig.tiny(), Adam minimize) built in both
  packages has EQUAL descs, with the dense head, the fused head forced,
  and the fused head auto-selected at a vocabulary of two 8192 chunks;
  likewise its startup program; at `pipeline_stages` 2 the staged
  program's desc equals the reference's, and more stages than layers
  raises.
* `matmul` (every transpose pair, alpha 1 and 0.5, batched broadcast),
  `matmul_v2` and `gather` (axis 0 and 1, 1-D and 2-D indices), and their
  VJPs, against the reference lowerings on the same numpy inputs: f32
  rtol 1e-5 / atol 1e-6 (the frameworks sum in different orders); gather
  is a copy and its VJP a sum of copies, held to the same tolerance.
* Three Adam steps from the reference's startup arrays, dropout off: f32
  with the dense head and the fused head, rtol 1e-5 on the losses and atol
  1e-5 on every persistable; fleet AMP bf16 rtol 1e-4 / atol 5e-4 (the
  bf16 products round at the same points, their f32 sums in other
  orders; tests/test_torch_training.py states the same limits). The
  learning rate is bench_gpt's 1e-4: a bf16 gradient of ~1e-6 can take
  the other sign in the other framework (one bf16 ulp of the largest
  gradients is 1.2e-4), and Adam's first steps turn it into a step of
  about +-lr either way, so the persistables can differ by ~2 lr.
* Causality (changing the last token leaves every earlier position's
  logits unchanged, rtol 1e-5 / atol 1e-6, and changes the last
  position's) and tied embeddings (one `wte` receives the gather's and the
  head's gradients, summed; it equals the reference's, atol 1e-6).
* `params_from_scope`: GPT-tiny trained two steps by the port's Executor
  serves in the port's DecodeEngine with greedy tokens equal to the dense
  `generate` on the same weights (exact: the same f32 ops on one device).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu.models import gpt as ref_gpt
from paddle_tpu.ops import registry as ref_registry

from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch import serving as port_serving
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.framework import Executor, Scope, load_numpy
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.models import gpt as port_gpt
from paddle_tpu_torch.models import gpt_decode as port_decode
from paddle_tpu_torch.ops import registry as port_registry

# bench.py bench_gpt trains with Adam(1e-4); see the AMP note in the docstring
LR, STEPS, BATCH = 1e-4, 3, 2


def _cfg(pkg, vocab=None):
    cfg = (ref_gpt if pkg == "ref" else port_gpt).GPTConfig.tiny()
    if vocab:
        cfg.vocab_size = vocab
    return cfg


def build(pkg, cfg, fused=None, amp=False, opt=True):
    """(main, startup, tokens, loss) of `pkg`'s GPT LM program, Adam
    minimised (through fleet with `amp`, as bench.py's bench_gpt)."""
    if pkg == "ref":
        prog, names, gpt, fleet = (ref_program, ref_unique_name, ref_gpt,
                                   ref_fleet)
        make = lambda: paddle.optimizer.Adam(learning_rate=LR)  # noqa
    else:
        prog, names, gpt, fleet = (port_program, port_unique_name, port_gpt,
                                   port_fleet)
        make = lambda: port_optimizer.Adam(learning_rate=LR)  # noqa
    main, start = prog.Program(), prog.Program()
    with prog.program_guard(main, start), names.guard():
        tokens, loss = gpt.build_lm_program(cfg, fused_head=fused)
        if opt:
            o = make()
            if amp:
                fleet.init(is_collective=True)
                strategy = fleet.DistributedStrategy()
                strategy.amp = True
                o = fleet.distributed_optimizer(o, strategy)
            o.minimize(loss)
    return main, start, tokens, loss


def token_batches(cfg, steps=STEPS, batch=BATCH, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, cfg.vocab_size,
                       (steps, batch, cfg.seq_len)).astype(np.int64)


def reference_start(start):
    """The reference's startup scope as numpy arrays."""
    scope = RefScope()
    fluid.Executor().run(start, scope=scope)
    return scope, {n: np.asarray(scope.find(n)) for n in scope.local_names()
                   if not n.startswith("__")}


@pytest.mark.parametrize("fused,vocab", [(None, None), (True, None),
                                         (None, 16384)],
                         ids=["dense_head", "fused_forced", "fused_auto"])
def test_gpt_lm_desc_equal(fused, vocab):
    rm, rs, _, _ = build("ref", _cfg("ref", vocab), fused)
    pm, ps, _, _ = build("port", _cfg("port", vocab), fused)
    rd, pd = rm.to_desc(), pm.to_desc()
    r_ops, p_ops = rd["blocks"][0]["ops"], pd["blocks"][0]["ops"]
    assert [o["type"] for o in p_ops] == [o["type"] for o in r_ops]
    for r, p in zip(r_ops, p_ops):
        assert p == r, (r["type"], r, p)
    assert pd == rd
    assert ps.to_desc() == rs.to_desc()
    types = {o["type"] for o in r_ops}
    assert {"gather", "fused_attention", "__vjp__", "adam"} <= types
    head = [o for o in r_ops if o["type"] == "fused_lm_head_ce"]
    assert bool(head) == (fused is True or vocab == 16384)
    assert ("matmul" in types) == (not head)
    if head:
        assert head[0]["attrs"].get("auto_selected", False) == (fused is None)
    attn = [o for o in r_ops if o["type"] == "fused_attention"]
    assert attn and all(o["attrs"]["causal"] for o in attn)


def test_pipeline_stages_raise():
    """pipeline_stages 2 builds the reference's staged program (embeddings
    on stage 0, the final LN and the tied head on stage 1); more stages
    than layers raises."""
    cfgs = {pkg: _cfg(pkg) for pkg in ("ref", "port")}
    for cfg in cfgs.values():
        cfg.pipeline_stages = 2
    rm, _, _, _ = build("ref", cfgs["ref"], opt=False)
    pm, _, _, _ = build("port", cfgs["port"], opt=False)
    assert pm.to_desc() == rm.to_desc()
    stage = {op.outputs.get("Out", [""])[0]: op.attrs["pipeline_stage"]
             for op in pm.global_block().ops}
    assert min(stage.values()) == 0 and max(stage.values()) == 1
    ops = pm.global_block().ops
    assert ops[0].attrs["pipeline_stage"] == 0
    assert ops[-1].type == "mean" and ops[-1].attrs["pipeline_stage"] == 1
    cfg = _cfg("port")
    cfg.pipeline_stages = cfg.num_layers + 1
    with pytest.raises(ValueError, match="pipeline_stages"):
        build("port", cfg, opt=False)


def _matmul_inputs(shape_x, shape_y, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal(shape_x).astype(np.float32),
            rng.standard_normal(shape_y).astype(np.float32))


MATMUL_CASES = [
    # (X shape, Y shape, attrs)
    ((3, 4), (4, 5), {}),
    ((4, 3), (4, 5), {"transpose_X": True}),
    ((3, 4), (5, 4), {"transpose_Y": True}),
    ((4, 3), (5, 4), {"transpose_X": True, "transpose_Y": True}),
    ((2, 3, 4), (4, 5), {"alpha": 0.5}),
    ((2, 3, 4), (2, 5, 4), {"transpose_Y": True, "alpha": 0.5}),
    ((2, 1, 4, 3), (3, 4, 5), {"transpose_X": True}),
    ((2, 3, 5, 4), (2, 3, 5, 6), {"transpose_X": True, "alpha": 0.5}),
]


def _lowering_pair(op_type, ins_np, attrs, diff_slots):
    """(ref outputs + grads, port outputs + grads) of one lowering and its
    VJP against an all-ones-times-index cotangent."""
    rop, pop = ref_registry.get(op_type), port_registry.get(op_type)
    const = {s: v for s, v in ins_np.items() if s not in diff_slots}

    def rf(*xs):
        ins = {s: [jnp.asarray(v)] for s, v in const.items()}
        ins.update({s: [x] for s, x in zip(diff_slots, xs)})
        return rop.lower(ref_registry.LowerCtx(rng_key=jax.random.key(0)),
                         ins, attrs)["Out"][0]

    def pf(*xs):
        ins = {s: [torch.from_numpy(v)] for s, v in const.items()}
        ins.update({s: [x] for s, x in zip(diff_slots, xs)})
        return pop.lower(port_registry.LowerCtx(device="cpu"), ins,
                         attrs)["Out"][0]

    r_out, r_pull = jax.vjp(rf, *[jnp.asarray(ins_np[s])
                                  for s in diff_slots])
    ct = np.arange(np.prod(r_out.shape), dtype=np.float32).reshape(
        r_out.shape) / 7.0
    r_grads = r_pull(jnp.asarray(ct))
    p_out, p_pull = torch.func.vjp(pf, *[torch.from_numpy(ins_np[s])
                                         for s in diff_slots])
    p_grads = p_pull(torch.from_numpy(ct))
    return ([np.asarray(r_out)] + [np.asarray(g) for g in r_grads],
            [p_out.numpy()] + [g.numpy() for g in p_grads])


@pytest.mark.parametrize("case", range(len(MATMUL_CASES)))
def test_matmul_lowering_and_vjp_match_reference(case):
    sx, sy, attrs = MATMUL_CASES[case]
    x, y = _matmul_inputs(sx, sy, seed=case)
    ref, port = _lowering_pair("matmul", {"X": x, "Y": y}, attrs,
                               ("X", "Y"))
    for r, p in zip(ref, port):
        assert r.shape == p.shape
        np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("trans", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_matmul_v2_lowering_and_vjp_match_reference(trans):
    tx, ty = trans
    x, y = _matmul_inputs((2, 4, 3) if tx else (2, 3, 4),
                          (5, 4) if ty else (4, 5))
    ref, port = _lowering_pair("matmul_v2", {"X": x, "Y": y},
                               {"trans_x": tx, "trans_y": ty}, ("X", "Y"))
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("axis,index_shape", [(0, (7,)), (0, (3, 4)),
                                              (1, (5,)), (1, (2, 3))],
                         ids=["axis0_1d", "axis0_2d", "axis1_1d",
                              "axis1_2d"])
def test_gather_lowering_and_vjp_match_reference(axis, index_shape):
    rng = np.random.RandomState(3)
    x = rng.standard_normal((6, 8, 3)).astype(np.float32)
    idx = rng.randint(0, x.shape[axis], index_shape).astype(np.int32)
    ref, port = _lowering_pair("gather", {"X": x, "Index": idx},
                               {"axis": axis}, ("X",))
    assert port[0].shape == ref[0].shape
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-6)


def _persistables(main):
    return sorted(v.name for v in main.global_block().vars.values()
                  if v.persistable)


@pytest.mark.parametrize("fused,amp", [(None, False), (True, False),
                                       (None, True)],
                         ids=["f32_dense_head", "f32_fused_head",
                              "amp_bf16"])
def test_three_adam_steps_match_reference(fused, amp):
    toks = token_batches(_cfg("ref"))
    rm, rs, _, rloss = build("ref", _cfg("ref"), fused, amp)
    rscope, init = reference_start(rs)
    rexe = fluid.Executor()
    ref_losses = [float(rexe.run(rm, feed={"tokens": t}, fetch_list=[rloss],
                                 scope=rscope)[0]) for t in toks]
    names = _persistables(rm)
    ref_final = {n: np.asarray(rscope.find(n), np.float32) for n in names}

    pm, _, _, ploss = build("port", _cfg("port"), fused, amp)
    assert _persistables(pm) == names and set(init) == set(names)
    pexe, pscope = Executor("cpu"), load_numpy(Scope(), init, "cpu")
    port_losses = [float(pexe.run(pm, feed={"tokens": t},
                                  fetch_list=[ploss], scope=pscope)[0])
                   for t in toks]
    # module docstring: f32 rtol/atol 1e-5; AMP rtol 1e-4 / atol 5e-4
    loss_rtol, atol = (1e-4, 5e-4) if amp else (1e-5, 1e-5)
    np.testing.assert_allclose(port_losses, ref_losses, rtol=loss_rtol)
    for n in names:
        np.testing.assert_allclose(pscope.numpy(n), ref_final[n], rtol=0,
                                   atol=atol, err_msg=n)
    moved = [n for n in names if n.endswith("_w") or n in ("wte", "wpe")]
    assert all(not np.array_equal(pscope.numpy(n), init[n]) for n in moved)


def _logits_program(pkg):
    if pkg == "ref":
        prog, names, gpt, L = (ref_program, ref_unique_name, ref_gpt,
                               fluid.layers)
    else:
        from paddle_tpu_torch import layers as L
        prog, names, gpt = port_program, port_unique_name, port_gpt
    cfg = _cfg(pkg)
    main, start = prog.Program(), prog.Program()
    with prog.program_guard(main, start), names.guard():
        tokens = L.data(name="tokens", shape=[cfg.seq_len], dtype="int64")
        seq, wte = gpt.gpt_decoder(tokens, cfg)
        logits = L.matmul(seq, wte, transpose_y=True)
    return main, start, logits


def test_gpt_is_causal_and_matches_reference_logits():
    """Changing only the last token leaves every earlier position's logits
    unchanged and changes the last position's; the logits equal the
    reference's on the same weights (rtol 1e-5 / atol 1e-5)."""
    rm, rs, rlogits = _logits_program("ref")
    rscope, init = reference_start(rs)
    pm, _, plogits = _logits_program("port")
    cfg = _cfg("port")
    rng = np.random.RandomState(1)
    t1 = rng.randint(0, cfg.vocab_size, (2, cfg.seq_len)).astype(np.int64)
    t2 = t1.copy()
    t2[:, -1] = (t2[:, -1] + 7) % cfg.vocab_size
    exe, scope = Executor("cpu"), load_numpy(Scope(), init, "cpu")
    a, = exe.run(pm, feed={"tokens": t1}, fetch_list=[plogits], scope=scope)
    b, = exe.run(pm, feed={"tokens": t2}, fetch_list=[plogits], scope=scope)
    np.testing.assert_allclose(a[:, :-1], b[:, :-1], rtol=1e-5, atol=1e-6)
    assert np.abs(a[:, -1] - b[:, -1]).max() > 1e-4
    want, = fluid.Executor().run(rm, feed={"tokens": t1},
                                 fetch_list=[rlogits], scope=rscope)
    np.testing.assert_allclose(a, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_tied_wte_receives_both_gradients():
    """The gradient Adam applies to wte is a sum op over the head's and
    the gather's gradients (both non-zero) and equals the reference's
    (atol 1e-6, f32 sums in another order)."""
    toks = token_batches(_cfg("ref"), steps=1)[0]
    rm, rs, _, rloss = build("ref", _cfg("ref"))
    rscope, init = reference_start(rs)
    pm, _, _, _ = build("port", _cfg("port"))
    adam = [op for op in pm.global_block().ops
            if op.type == "adam" and op.inputs["Param"] == ["wte"]]
    merged = adam[0].inputs["Grad"][0]
    sums = [op for op in pm.global_block().ops
            if op.type == "sum" and op.outputs["Out"] == [merged]]
    assert len(adam) == 1 and len(sums) == 1
    parts = sums[0].inputs["X"]
    assert len(parts) == 2
    want, = fluid.Executor().run(rm, feed={"tokens": toks},
                                 fetch_list=[merged], scope=rscope)
    got = Executor("cpu").run(pm, feed={"tokens": toks},
                              fetch_list=[merged] + parts,
                              scope=load_numpy(Scope(), init, "cpu"))
    assert all(np.abs(p).max() > 0 for p in got[1:])
    np.testing.assert_array_equal(got[0], got[1] + got[2])
    np.testing.assert_allclose(got[0], np.asarray(want), rtol=0, atol=1e-6)
    names = [p.name for p in pm.all_parameters()]
    assert "wte" in names and not any("head" in n for n in names)


def test_trained_gpt_serves_from_scope():
    """Train GPT-tiny 2 steps in the port, pull the weights with
    params_from_scope, serve greedy requests through DecodeEngine: the
    tokens equal the dense generate's on the same weights."""
    cfg = _cfg("port")
    pm, ps, _, ploss = build("port", cfg)
    exe, scope = Executor("cpu"), Scope()
    exe.run(ps, scope=scope)
    for t in token_batches(cfg, steps=2):
        exe.run(pm, feed={"tokens": t}, fetch_list=[ploss], scope=scope)
    params = port_decode.params_from_scope(cfg, scope, device="cpu")
    assert set(params) == set(port_decode.param_names(cfg))
    np.testing.assert_array_equal(params["wte"].numpy(), scope.numpy("wte"))
    bf = port_decode.params_from_scope(cfg, scope, dtype="bfloat16",
                                       device="cpu")
    assert bf["wte"].dtype == torch.bfloat16
    assert bf["dec0_ln1_scale"].dtype == torch.float32
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in (5, 9)]
    eng = port_serving.DecodeEngine(params, cfg, device="cpu", max_slots=2,
                                    max_len=32, num_blocks=16)
    try:
        comps = eng.generate([port_serving.Request(p, max_new_tokens=6)
                              for p in prompts], timeout=120)
    finally:
        eng.stop()
    for p, c in zip(prompts, comps):
        assert c.ok, c.error
        want = port_decode.generate(params, cfg, np.asarray([p]), 6,
                                    device="cpu")[0, len(p):].tolist()
        assert list(c.tokens) == want
