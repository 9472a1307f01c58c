"""PyTorch port, program building and op lowerings: paddle_tpu_torch's
framework / layers / models.bert / optimizer held against the JAX
reference on the CPU.

* The BERT pretrain program (tiny geometry, padding mask, Adam minimize)
  built in both packages from fresh programs has EQUAL descs: op types and
  order, var names, shapes, dtypes and attrs, `__rng_seed__` included;
  likewise its startup program. `Program.from_desc` round-trips the
  reference's desc.
* One parity test per ported lowering against the reference's lowering on
  the same numpy inputs, at f32 and bf16. Tolerances: f32 rtol 1e-5 /
  atol 1e-6 (the frameworks sum in different orders); bf16 compared in f32
  with rtol and atol 1e-2 (one bf16 ulp is 2**-8 relative). Random
  lowerings (dropout, truncated_gaussian_random) draw from different
  generators in the two packages: their shapes, dtypes and statistics are
  compared instead, and the port's draws are checked to be deterministic.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.models import bert as ref_bert
from paddle_tpu.ops import registry as ref_registry

from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.framework import Executor, errors
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.framework.dtype import dtype_name
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.ops import registry as port_registry


def _ref_programs(fused=None):
    main, start = ref_program.Program(), ref_program.Program()
    with ref_program.program_guard(main, start), ref_unique_name.guard():
        cfg = ref_bert.BertConfig.tiny()
        cfg.fused_mlm_head = fused
        _, _, loss = ref_bert.build_pretrain_program(cfg, use_input_mask=True)
        paddle.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    return main, start


def _port_programs(fused=None):
    main, start = port_program.Program(), port_program.Program()
    with port_program.program_guard(main, start), port_unique_name.guard():
        cfg = port_bert.BertConfig.tiny()
        cfg.fused_mlm_head = fused
        _, _, loss = port_bert.build_pretrain_program(cfg,
                                                      use_input_mask=True)
        port_optimizer.Adam(learning_rate=1e-4).minimize(loss)
    return main, start


@pytest.mark.parametrize("fused", [None, True], ids=["dense_head",
                                                     "fused_head"])
def test_bert_pretrain_desc_equal(fused):
    ref_main, ref_start = _ref_programs(fused)
    port_main, port_start = _port_programs(fused)
    rd, pd = ref_main.to_desc(), port_main.to_desc()
    r_ops, p_ops = rd["blocks"][0]["ops"], pd["blocks"][0]["ops"]
    assert [o["type"] for o in p_ops] == [o["type"] for o in r_ops]
    for r, p in zip(r_ops, p_ops):
        assert p == r, (r["type"], r, p)
    assert pd["blocks"][0]["vars"] == rd["blocks"][0]["vars"]
    assert pd == rd
    assert port_start.to_desc() == ref_start.to_desc()
    types = {o["type"] for o in r_ops}
    assert {"fused_attention", "__vjp__", "adam", "dropout"} <= types
    assert ("fused_lm_head_ce" in types) == bool(fused)


def test_from_desc_round_trips_reference_desc():
    ref_main, _ = _ref_programs()
    desc = ref_main.to_desc()
    prog = port_program.Program.from_desc(desc)
    assert prog.to_desc() == desc
    params = {p.name for p in prog.all_parameters()}
    assert {"word_embedding", "enc1_ffn_out_w", "mlm_head_w"} <= params


def test_every_op_of_the_program_is_registered():
    ref_main, ref_start = _ref_programs(True)
    for prog in (ref_main, ref_start):
        for op in prog.global_block().ops:
            assert port_registry.has(op.type), op.type


# ---------------------------------------------------------------------------
# Lowering parity
# ---------------------------------------------------------------------------

def _cast_np(a, dtype):
    if np.issubdtype(a.dtype, np.floating):
        return a.astype(np.float32)
    return a


def _run_ref(op, ins, attrs, dtype):
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jins = {s: [jnp.asarray(a).astype(jd) if np.issubdtype(a.dtype, np.floating)
                else jnp.asarray(a) for a in vs] for s, vs in ins.items()}
    ctx = ref_registry.LowerCtx(rng_key=jax.random.key(0))
    return ref_registry.get(op).lower(ctx, jins, dict(attrs))


def _run_port(op, ins, attrs, dtype):
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    tins = {s: [torch.from_numpy(np.array(a)).to(td)
                if np.issubdtype(a.dtype, np.floating)
                else torch.from_numpy(np.array(a)) for a in vs]
            for s, vs in ins.items()}
    ctx = port_registry.LowerCtx(run_seed=0, device="cpu")
    return port_registry.get(op).lower(ctx, tins, dict(attrs))


def _assert_outs_close(ref, port, dtype, slots=None):
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "f32" \
        else dict(rtol=1e-2, atol=1e-2)
    for slot in slots or ref:
        assert len(port[slot]) == len(ref[slot]), slot
        for r, p in zip(ref[slot], port[slot]):
            assert tuple(p.shape) == tuple(r.shape), (slot, p.shape, r.shape)
            assert dtype_name(p.dtype) == np.dtype(r.dtype).name, slot
            rv = np.asarray(jnp.asarray(r).astype(jnp.float32)) \
                if jnp.issubdtype(r.dtype, jnp.floating) else np.asarray(r)
            pv = p.detach().float().numpy() if p.is_floating_point() \
                else p.numpy()
            np.testing.assert_allclose(pv, rv, err_msg=slot, **tol)


def _lowering_cases():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    ids = rng.randint(0, 50, (2, 6, 1)).astype(np.int32)
    labels = rng.randint(0, 50, (2, 6, 1)).astype(np.int32)
    labels[0, 1, 0] = -100                       # an ignored token
    return {
        "fill_constant": ({}, {"shape": [3, 4], "dtype": "float32",
                               "value": 1.5}),
        "reshape2": ({"X": [f(2, 6, 8)]}, {"shape": [0, 0, 2, 4]}),
        "transpose2": ({"X": [f(2, 6, 2, 4)]}, {"axis": [0, 2, 1, 3]}),
        "unsqueeze2": ({"X": [f(2, 6)]}, {"axes": [1, 2]}),
        "split": ({"X": [f(2, 6, 12)]}, {"num": 3, "sections": [],
                                         "axis": 2}),
        "slice": ({"Input": [f(10, 4)]}, {"axes": [0], "starts": [0],
                                          "ends": [6]}),
        "elementwise_add": ({"X": [f(2, 6, 8)], "Y": [f(8)]}, {"axis": 2}),
        "gelu": ({"X": [f(2, 6, 8)]}, {}),
        "scale": ({"X": [f(2, 6)]}, {"scale": 1e9, "bias": -1e9,
                                     "bias_after_scale": True}),
        "sum": ({"X": [f(3, 4), f(3, 4), f(3, 4)]}, {}),
        "mean": ({"X": [f(2, 6, 8)]}, {}),
        "mul": ({"X": [f(2, 6, 8)], "Y": [f(8, 5)]},
                {"x_num_col_dims": 2, "y_num_col_dims": 1}),
        "softmax_with_cross_entropy": (
            {"Logits": [f(2, 6, 50)], "Label": [labels]},
            {"soft_label": False, "axis": -1, "ignore_index": -100}),
        "layer_norm": ({"X": [f(2, 6, 8)], "Scale": [f(8)], "Bias": [f(8)]},
                       {"epsilon": 1e-5, "begin_norm_axis": 2}),
        "dropout": ({"X": [f(2, 6, 8)]},
                    {"dropout_prob": 0.1, "is_test": True,
                     "dropout_implementation": "upscale_in_train"}),
        "lookup_table": ({"W": [f(50, 8)], "Ids": [ids]},
                         {"padding_idx": -1, "is_sparse": False}),
        "fused_attention": (
            {"Q": [f(2, 2, 6, 8)], "K": [f(2, 2, 6, 8)], "V": [f(2, 2, 6, 8)],
             "Mask": [np.where(rng.rand(2, 1, 1, 6) < 0.3, -1e9,
                               0.0).astype(np.float32)]},
            {"dropout": 0.0, "causal": False, "is_test": False,
             "sequence_parallel": False, "scale": 0.35}),
    }


CASES = _lowering_cases()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("op", sorted(CASES))
def test_lowering_matches_reference(op, dtype):
    ins, attrs = CASES[op]
    ref = _run_ref(op, ins, attrs, dtype)
    port = _run_port(op, ins, attrs, dtype)
    slots = ["Loss"] if op == "softmax_with_cross_entropy" and \
        dtype == "bf16" else None
    if op == "fill_constant":
        ref = {"Out": ref["Out"]}
    _assert_outs_close(ref, port, dtype, slots)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("op", ["mul", "layer_norm", "gelu", "fused_attention",
                                "softmax_with_cross_entropy", "lookup_table"])
def test_vjp_lowering_matches_reference(op, dtype):
    """The generic __vjp__ op: torch.func.vjp over the port's lowering vs
    jax.vjp over the reference's, with the same cotangents."""
    ins, attrs = CASES[op]
    outs = _run_ref(op, ins, attrs, "f32")
    out_slots = [s for s in outs if s not in ("XShape",)]
    nondiff = ref_registry.get(op).nondiff_slots
    diff = [(s, i) for s, vs in ins.items() if s not in nondiff
            for i, a in enumerate(vs) if np.issubdtype(a.dtype, np.floating)]
    rng = np.random.RandomState(1)
    vjp_ins = dict(ins)
    for s in out_slots:
        vjp_ins[f"OG:{s}"] = [rng.randn(*o.shape).astype(np.float32)
                              for o in outs[s]]
    fake_op = type("Op", (), {"type": op, "attrs": dict(attrs),
                              "inputs": {s: [f"{s}{i}" for i in range(len(v))]
                                         for s, v in ins.items()},
                              "outputs": {s: [f"o{s}{i}" for i in
                                              range(len(outs[s]))]
                                          for s in out_slots}})
    vattrs = ref_registry.make_vjp_attrs(fake_op, diff, out_slots)
    ref = _run_ref("__vjp__", vjp_ins, vattrs, dtype)
    port = _run_port("__vjp__", vjp_ins, vattrs, dtype)
    _assert_outs_close(ref, port, dtype)


@pytest.mark.parametrize("layout", ["hv", "vh"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_lm_head_ce_matches_reference(layout, dtype):
    """Loss and grads (x, w, bias) at a vocabulary of 1000 with chunk 256
    (not a multiple), with an ignored token; the bias stays f32 as AMP's
    keep_f32_slots keeps it."""
    rng = np.random.RandomState(2)
    v, h = 1000, 16
    x = rng.randn(2, 5, h).astype(np.float32)
    w = (rng.randn(h, v) if layout == "hv" else rng.randn(v, h)) \
        .astype(np.float32) * 0.3
    b = rng.randn(v).astype(np.float32) * 0.1
    labels = rng.randint(0, v, (2, 5, 1)).astype(np.int32)
    labels[1, 2, 0] = -100
    g = rng.rand(2, 5, 1).astype(np.float32)
    attrs = {"chunk": 256, "w_layout": layout, "ignore_index": -100}
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    op = ref_registry.get("fused_lm_head_ce")

    def ref_f(x, w, b):
        ins = {"X": [x], "W": [w], "Label": [jnp.asarray(labels)],
               "Bias": [b]}
        return op.lower(ref_registry.LowerCtx(rng_key=jax.random.key(0)),
                        ins, attrs)["Loss"][0]

    out, pull = jax.vjp(ref_f, jnp.asarray(x, jd), jnp.asarray(w, jd),
                        jnp.asarray(b))
    ref = [out] + list(pull(jnp.asarray(g)))
    pop = port_registry.get("fused_lm_head_ce")

    def port_f(x, w, b):
        ins = {"X": [x], "W": [w], "Label": [torch.from_numpy(labels)],
               "Bias": [b]}
        return pop.lower(port_registry.LowerCtx(device="cpu"), ins,
                         attrs)["Loss"][0]

    out, pull = torch.func.vjp(port_f, torch.from_numpy(x).to(td),
                               torch.from_numpy(w).to(td),
                               torch.from_numpy(b))
    port = [out] + list(pull(torch.from_numpy(g)))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "f32" \
        else dict(rtol=2e-2, atol=2e-2)
    for r, p, name in zip(ref, port, ("loss", "dx", "dw", "db")):
        assert dtype_name(p.dtype) == np.dtype(r.dtype).name, name
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   err_msg=name, **tol)
    assert out[0, 0, 0] == out[0, 0, 0]
    assert float(port[0][1, 2, 0]) == 0.0          # ignored: zero loss


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adam_matches_reference_in_place(dtype):
    """The dense adam rule: same ParamOut / moments; the port updates the
    scope's tensors in place (the outputs ARE the inputs)."""
    rng = np.random.RandomState(3)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    ins = {"Param": [f(4, 5)], "Grad": [f(4, 5)],
           "LearningRate": [np.array([1e-3], np.float32)],
           "Moment1": [f(4, 5) * 0.1], "Moment2": [np.abs(f(4, 5)) * 0.01],
           "Beta1Pow": [np.array([0.9 ** 3], np.float32)],
           "Beta2Pow": [np.array([0.999 ** 3], np.float32)]}
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    ref = _run_ref("adam", {k: v for k, v in ins.items()}, attrs, "f32")
    tins = {s: [torch.from_numpy(a.copy()) for a in vs]
            for s, vs in ins.items()}
    if dtype == "bf16":
        tins["Grad"] = [tins["Grad"][0].bfloat16()]
        ref = _run_ref("adam", dict(ins, Grad=[np.asarray(jnp.asarray(
            ins["Grad"][0]).astype(jnp.bfloat16).astype(jnp.float32))]),
            attrs, "f32")
    out = port_registry.get("adam").lower(
        port_registry.LowerCtx(device="cpu"), tins, attrs)
    for slot, src in (("ParamOut", "Param"), ("Moment1Out", "Moment1"),
                      ("Moment2Out", "Moment2")):
        assert out[slot][0] is tins[src][0]
        np.testing.assert_allclose(out[slot][0].numpy(),
                                   np.asarray(ref[slot][0]), rtol=1e-5,
                                   atol=1e-7, err_msg=slot)


def test_random_lowerings_are_deterministic_and_distributed():
    """dropout and truncated_gaussian_random: same key -> same draw, other
    run seed -> other draw; keep rate ~ 1 - p; kept values upscaled; the
    normal is cut at two standard deviations."""
    x = torch.ones(64, 256)
    attrs = {"dropout_prob": 0.1, "is_test": False,
             "dropout_implementation": "upscale_in_train",
             "__rng_seed__": 3}
    low = port_registry.get("dropout").lower
    a = low(port_registry.LowerCtx(run_seed=5), {"X": [x]}, attrs)
    b = low(port_registry.LowerCtx(run_seed=5), {"X": [x]}, attrs)
    c = low(port_registry.LowerCtx(run_seed=6), {"X": [x]}, attrs)
    assert torch.equal(a["Out"][0], b["Out"][0])
    assert not torch.equal(a["Out"][0], c["Out"][0])
    keep = a["Mask"][0].bool()
    assert a["Mask"][0].dtype == torch.uint8
    assert abs(keep.float().mean().item() - 0.9) < 0.01
    assert torch.allclose(a["Out"][0][keep], torch.tensor(1 / 0.9))
    assert (a["Out"][0][~keep] == 0).all()
    tg = port_registry.get("truncated_gaussian_random").lower(
        port_registry.LowerCtx(run_seed=0),
        {}, {"shape": [256, 128], "dtype": "float32", "mean": 0.0,
             "std": 0.02, "__rng_seed__": 1})["Out"][0]
    assert tg.shape == (256, 128) and tg.dtype == torch.float32
    assert tg.abs().max().item() <= 0.04 + 1e-7
    assert abs(tg.std().item() - 0.02 * 0.88) < 0.002   # truncated std


def test_fleet_honours_amp_and_rejects_the_rest():
    s = port_fleet.DistributedStrategy()
    s.amp = True
    # tensor and sequence parallelism are honoured (tests/test_torch_tp.py
    # runs them); expert parallelism waits for switch_moe (item 12)
    s.tensor_parallel_degree = 2
    s.sequence_parallel_degree = 2
    s.tensor_parallel_degree = s.sequence_parallel_degree = 1
    with pytest.raises(NotImplementedError, match="item 12"):
        s.expert_parallel_degree = 2
    with pytest.raises(AttributeError, match="unknown"):
        s.shardingg = True
    main, start = port_program.Program(), port_program.Program()
    with port_program.program_guard(main, start), port_unique_name.guard():
        _, _, loss = port_bert.build_pretrain_program(
            port_bert.BertConfig.tiny())
        port_fleet.init(is_collective=True)
        port_fleet.distributed_optimizer(port_optimizer.Adam(1e-3),
                                         s).minimize(loss)
    assert main._amp and main._amp_dtype == "bfloat16"


def test_unported_options_raise():
    from paddle_tpu_torch.distributed import fleet as port_fleet
    with pytest.raises(NotImplementedError, match="localsgd"):
        port_fleet.DistributedStrategy().localsgd = True
    cfg = port_bert.BertConfig.tiny()
    cfg.moe_experts = 2
    with pytest.raises(NotImplementedError, match="item 12"):
        port_bert.build_pretrain_program(cfg)
    with pytest.raises(errors.UnimplementedError):
        port_registry.get("no_such_op")


def test_executor_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Executor()
