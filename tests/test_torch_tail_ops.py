"""PyTorch port, the tail ops and DGC: paddle_tpu_torch/ops/tail_ops.py,
`layers.chunk_eval` and `optimizer.DGCMomentumOptimizer` held against the
JAX reference on the CPU.

* One parity case per type of the reference's ops/tail_ops.py (67, and
  more arms of some), from tests/torch_tail_op_cases.py: f32 at rtol 1e-5
  / atol 1e-6, bf16 arms (compared in f32, rtol and atol 1e-2) for the
  types AMP can reach (interpolation, deformable_conv, multihead_matmul,
  fused_embedding_eltwise_layernorm, inplace_abn); integer and bool
  outputs equal. The random types draw from other generators in the two
  packages: their outputs' slots, shapes and dtypes are held, and their
  properties (a permutation is one, draws in range, the NCE cost and the
  sampled logits given the port's samples against the reference's
  formula on the same samples, accidental hits removed).
* A vjp case (torch.func.vjp over the port's lowering against jax.vjp
  over the reference's, the same cotangents) for the differentiable
  types.
* `test_every_tail_op_type_has_a_case` re-reads the reference file: 67
  types and the alias `multiclass_nms2` (its case is a detection case),
  all registered in the port with the reference's flags.
* `hash` on ids near 2**32 and `dgc` on the same U, V and G equal to the
  reference exactly; dgc's conservation EncodeGrad + VOut == V + m U + G
  bit for bit.
* The host ops (`print`, `py_func`, `chunk_eval`) and a shape read from a
  fed tensor make a program host-synced, so `run_steps` runs it eagerly;
  a `fill_constant` shape does not, and is read without a host read.
* `layers.chunk_eval` through a program in both packages, and the
  reference's six chunk_eval tests.
* DGCMomentumOptimizer: descs equal; 10 steps of a small MLP across the
  momentum -> DGC switch and all five sparsity segments against the
  reference (losses rtol 1e-5, every persistable atol 1e-5), with and
  without the local clip; `run_steps(10)` equal to ten `run` steps bit
  for bit.
"""
import pathlib
import re
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu import layers as ref_layers
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu.ops import registry as ref_registry
from paddle_tpu.ops import tail_ops as ref_tail

from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.framework import Executor, Scope, load_numpy
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.framework.dtype import dtype_name
from paddle_tpu_torch.framework.executor import _host_synced
from paddle_tpu_torch.ops import registry as port_registry
from paddle_tpu_torch.ops import tail_ops as port_tail

import jax
import jax.numpy as jnp

import torch_extra_op_cases
import torch_tail_op_cases as cases
from test_torch_program import _arms

CASES = cases.tail_cases()
for _fid, _fn in cases.PY_FUNCS.items():
    ref_tail.register_py_func(_fid, _fn)
    port_tail.register_py_func(_fid, _fn)


def _jax(v, jd):
    if v is None:
        return None
    if isinstance(v, tuple):
        return tuple(_jax(a, jd) for a in v)
    a = np.asarray(v)
    return jnp.asarray(a).astype(jd) if np.issubdtype(a.dtype, np.floating) \
        else jnp.asarray(a)


def _torch(v, td):
    if v is None:
        return None
    if isinstance(v, tuple):
        return tuple(_torch(a, td) for a in v)
    t = torch.from_numpy(np.array(v))
    return t.to(td) if t.is_floating_point() else t


def _run_ref(case, op, ins, attrs, dtype):
    """The reference's lowering on the CPU, under one jax.jit a case (one
    XLA compile, where op-by-op dispatch compiles every op), but for the
    cases it reads on the host."""
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jins = {s: [_jax(a, jd) for a in vs] for s, vs in ins.items()}
    ctx = ref_registry.LowerCtx(rng_key=jax.random.key(0))
    lower = ref_registry.get(op).lower
    if case in cases.REF_EAGER:
        return lower(ctx, jins, dict(attrs))
    return jax.jit(lambda v: lower(ctx, v, dict(attrs)))(jins)


def _run_port(op, ins, attrs, dtype="f32", seed=0):
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    tins = {s: [_torch(a, td) for a in vs] for s, vs in ins.items()}
    ctx = port_registry.LowerCtx(run_seed=seed, device="cpu")
    return port_registry.get(op).lower(ctx, tins, dict(attrs))


def _flat(outs):
    """{slot: [arrays]} with a LoDTensorArray's (buffer, length) as two
    entries."""
    out = {}
    for s, vs in outs.items():
        out[s] = [a for v in vs
                  for a in (v if isinstance(v, tuple) else (v,))]
    return out


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy() if v.is_floating_point() \
            else v.numpy()
    return np.asarray(jnp.asarray(v).astype(jnp.float32)) \
        if jnp.issubdtype(v.dtype, jnp.floating) else np.asarray(v)


def _dtype(v):
    return dtype_name(v.dtype) if isinstance(v, torch.Tensor) \
        else np.dtype(v.dtype).name


def _assert_close(ref, port, dtype, values=True):
    ref, port = _flat(ref), _flat(port)
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "f32" \
        else dict(rtol=1e-2, atol=1e-2)
    for slot in ref:
        assert len(port[slot]) == len(ref[slot]), slot
        for r, p in zip(ref[slot], port[slot]):
            assert tuple(p.shape) == tuple(r.shape), (slot, p.shape, r.shape)
            assert _dtype(p) == _dtype(r), (slot, _dtype(p), _dtype(r))
            if values:
                np.testing.assert_allclose(_np(p), _np(r), err_msg=slot,
                                           **tol)


PARITY = sorted(c for c in CASES if cases.op_of(c) not in cases.RANDOM)


@pytest.mark.parametrize("case,dtype", _arms(PARITY, cases.BF16_CASES))
def test_tail_lowering_matches_reference(case, dtype):
    ins, attrs = CASES[case]
    op = cases.op_of(case)
    _assert_close(_run_ref(case, op, ins, attrs, dtype),
                  _run_port(op, ins, attrs, dtype), dtype)


@pytest.mark.parametrize("case,dtype", _arms(cases.VJP_CASES,
                                             cases.VJP_BF16))
def test_tail_vjp_matches_reference(case, dtype):
    ins, attrs = CASES[case]
    op = cases.op_of(case)
    # the slots in the lowering's order (jax.jit returns them sorted)
    outs = _run_ref(case, op, ins, attrs, "f32")
    outs = {s: outs[s] for s in _run_port(op, ins, attrs)}
    vjp_ins, vattrs = torch_extra_op_cases.vjp_case(
        op, ins, attrs, outs, ref_registry.make_vjp_attrs)
    _assert_close(_run_ref(case, "__vjp__", vjp_ins, vattrs, dtype),
                  _run_port("__vjp__", vjp_ins, vattrs, dtype), dtype)


def _reference_types():
    """(the 67 types, the deferred alias) of the reference's file: its
    `register("...")`, interp table, and `_alias("...")` names."""
    src = (pathlib.Path(ref_registry.__file__).parent
           / "tail_ops.py").read_text()
    names = re.findall(r'register\("(\w+)"', src)
    names += re.findall(r'\("(\w+_interp(?:_v2)?)", "\w+", \d\)', src)
    names += re.findall(r'^_alias\("(\w+)"', src, re.M)
    deferred = [n for n in names if n == "multiclass_nms2"]
    return [n for n in names if n not in deferred], deferred


def test_every_tail_op_type_has_a_case():
    """The reference file registers 68 types; 67 each have a case here,
    and multiclass_nms2 (the alias of a detection op) has its case in
    tests/test_torch_detection_ops.py; all 68 are registered in the port
    with the reference's flags."""
    types_, deferred = _reference_types()
    assert len(types_) == len(set(types_)) == 67
    assert deferred == ["multiclass_nms2"]
    assert set(types_) == {cases.op_of(c) for c in CASES}
    assert port_registry.has("multiclass_nms2")
    for t in types_ + deferred:
        ref, port = ref_registry.get(t), port_registry.get(t)
        assert (port.nondiff_slots, port.stateful_outputs, port.is_random) \
            == (ref.nondiff_slots, ref.stateful_outputs, ref.is_random), t
    assert cases.RANDOM == {t for t in types_
                            if ref_registry.get(t).is_random}


def test_shared_cases_import_numpy_only():
    import ast
    tree = ast.parse(pathlib.Path(cases.__file__).read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert mods == {"numpy"}


# ---------------------------------------------------------------------------
# the random types: what the two packages share
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if cases.op_of(c) in cases.RANDOM))
def test_random_type_draws_in_range(case):
    """The reference's output slots, shapes and dtypes; the draws in their
    range, other under another seed, the same under the same seed."""
    ins, attrs = CASES[case]
    op = cases.op_of(case)
    ref = _run_ref(case, op, ins, attrs, "f32")
    port = _run_port(op, ins, attrs)
    _assert_close(ref, port, "f32", values=False)
    again = _run_port(op, ins, attrs)
    other = _run_port(op, ins, attrs, seed=1)
    for s in port:
        for a, b in zip(port[s], again[s]):
            assert torch.equal(a, b), s
    main = {"random_crop": "Out", "nce": "SampleLabels",
            "sample_logits": "Samples", "sampling_id": "Out",
            "shuffle_batch": "ShuffleIdx", "bernoulli": "Out",
            "randperm": "Out", "uniform_random_batch_size_like": "Out",
            "gaussian_random_batch_size_like": "Out"}[op]
    assert not torch.equal(port[main][0], other[main][0])
    out = port[main][0]
    if op in ("randperm", "shuffle_batch"):
        n = attrs.get("n") or ins["X"][0].shape[0]
        assert sorted(out.tolist()) == list(range(n))
        if op == "shuffle_batch":
            x = torch.from_numpy(ins["X"][0])
            assert torch.equal(port["Out"][0], x[out.long()])
    elif op == "random_crop":
        x = ins["X"][0]
        hits = [(i, j) for i in range(x.shape[2] - 3)
                for j in range(x.shape[3] - 4)
                if np.array_equal(x[:, :, i:i + 4, j:j + 5], out.numpy())]
        assert len(hits) == 1
    elif op in ("nce", "sample_logits"):
        classes = attrs.get("num_total_classes") or ins["Logits"][0].shape[1]
        assert out.min() >= 0 and out.max() < classes
        nt = 1
        lab = ins["Label" if op == "nce" else "Labels"][0]
        assert np.array_equal(out[:, :nt].numpy(), lab)
    elif op == "sampling_id":
        assert out.min() >= 0 and out.max() < ins["X"][0].shape[1]
    elif op == "bernoulli":
        assert set(out.unique().tolist()) <= {0.0, 1.0}
        assert torch.equal(out, (out > 0).float())
    elif op == "uniform_random_batch_size_like":
        assert out.min() >= -2.0 and out.max() < 3.0
    else:
        assert torch.isfinite(out).all() and out.std() > 0.5


def test_nce_cost_given_the_samples():
    """The port's cost and logits, given its own samples, equal the
    reference's formula (nce_op.cc) on those samples."""
    ins, attrs = CASES["nce"]
    port = _run_port("nce", ins, attrs)
    ids = port["SampleLabels"][0].numpy()
    x, w, b = ins["Input"][0], ins["Weight"][0], ins["Bias"][0]
    k, classes = attrs["num_neg_samples"], attrs["num_total_classes"]
    logits = jnp.einsum("bd,btd->bt", x, w[ids]) + b[ids]
    z = logits - jnp.log(k * (1.0 / classes))
    lbl = np.concatenate([np.ones((4, 1)), np.zeros((4, k))], 1)
    cost = (jax.nn.softplus(z) - lbl * z).sum(1, keepdims=True)
    np.testing.assert_allclose(port["SampleLogits"][0].numpy(), logits,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port["Cost"][0].numpy(), cost, rtol=1e-5,
                               atol=1e-6)


def test_sample_logits_removes_accidental_hits():
    """A sample equal to its row's label is pushed to -1e20; the rest are
    the logits corrected by the uniform sampling probability, as the
    reference's formula on the port's samples."""
    logits = np.random.RandomState(5).randn(16, 3).astype(np.float32)
    labels = np.zeros((16, 1), np.int32)
    attrs = {"num_samples": 4}
    port = _run_port("sample_logits", {"Logits": [logits],
                                       "Labels": [labels]}, attrs)
    ids = port["Samples"][0].numpy()
    got = port["SampledLogits"][0].numpy()
    picked = np.take_along_axis(logits, ids, 1)
    prob = np.float32(1 / 3)
    want = picked - np.log(prob * 3 * 4 / 3, dtype=np.float32)
    hit = ids[:, 1:] == labels
    assert hit.any() and (~hit).any()
    np.testing.assert_allclose(got[:, 1:][~hit], want[:, 1:][~hit],
                               rtol=1e-6)
    assert (got[:, 1:][hit] < -1e19).all()
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-6)
    assert np.array_equal(port["SampledLabels"][0].numpy(),
                          np.zeros((16, 1), np.int32))


# ---------------------------------------------------------------------------
# the cases the port writes out by hand, named
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["hash", "hash:mod_past_int32"])
def test_hash_on_ids_near_2_32_equals_reference_exactly(case):
    ins, attrs = CASES[case]
    ref = _run_ref(case, "hash", ins, attrs, "f32")["Out"][0]
    port = _run_port("hash", ins, attrs)["Out"][0]
    assert np.array_equal(port.numpy(), np.asarray(ref))
    if attrs["mod_by"] > 2 ** 31:
        assert (port < 0).any()         # the uint32 -> int32 wrap


DGC_CASES = sorted(c for c in CASES if cases.op_of(c) == "dgc")


@pytest.mark.parametrize("case", DGC_CASES)
def test_dgc_on_the_same_inputs_equals_reference_exactly(case):
    """The same U, V and G: the threshold, and so every kept element, is
    the reference's; every output bit for bit."""
    ins, attrs = CASES[case]
    ref = _run_ref(case, "dgc", ins, attrs, "f32")
    port = _run_port("dgc", ins, attrs)
    for s in ("UOut", "VOut", "EncodeGrad"):
        assert np.array_equal(port[s][0].numpy(), np.asarray(ref[s][0])), s
    step = float(ins["current_step"][0][0])
    kept = float((port["EncodeGrad"][0] != 0).float().mean())
    if step < attrs["rampup_begin_step"]:
        assert np.array_equal(port["EncodeGrad"][0].numpy(), ins["Grad"][0])
        assert not port["VOut"][0].any()
    else:
        s = port_tail.dgc_sparsity(torch.tensor(step), attrs)
        assert 0 < kept <= 1 - float(s) + 0.01, (kept, float(s))
        u, v, g = (torch.from_numpy(ins[k][0]) for k in ("U", "V", "Grad"))
        # conservation: what is sent plus what stays is V + m U + G
        assert torch.equal(port["EncodeGrad"][0] + port["VOut"][0],
                           v + port_tail.fma(attrs["m"], u, g))


class _NoHostReads(TorchDispatchMode):
    """Refuses the ops that read a device value on the host."""
    BANNED = ("aten::_local_scalar_dense", "aten::nonzero",
              "aten::_unique2", "aten::unique_dim")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        assert func._schema.name not in self.BANNED, func._schema.name
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["dgc", "dgc_momentum", "dgc_clip_by_norm",
                                  "randperm", "random_crop", "nce",
                                  "sample_logits", "sampling_id",
                                  "shuffle_batch", "hash", "mean_iou",
                                  "select_input", "fill",
                                  "fake_quantize_range_abs_max"])
def test_lowering_reads_nothing_on_the_host(case):
    ins, attrs = CASES[case]
    with _NoHostReads():
        _run_port(cases.op_of(case), ins, attrs)


def test_shape_from_a_fill_constant_reads_nothing_on_the_host():
    """A fill_constant's output carries its value: the interp op takes its
    size from it, on the device, and equals the attr-sized op."""
    x = torch.from_numpy(CASES["bilinear_interp_v2:scale"][0]["X"][0])
    ctx = port_registry.LowerCtx(device="cpu")
    size = port_registry.get("fill_constant").lower(
        ctx, {}, {"shape": [2], "dtype": "int32", "value": 4.0})["Out"][0]
    with _NoHostReads():
        out = port_registry.get("bilinear_interp_v2").lower(
            ctx, {"X": [x], "OutSize": [size]}, {})["Out"][0]
    want = port_registry.get("bilinear_interp_v2").lower(
        ctx, {"X": [x]}, {"out_h": 4, "out_w": 4})["Out"][0]
    assert torch.equal(out, want)


def test_host_ops_raise_inside_a_capture():
    ctx = port_registry.LowerCtx(device="cpu", capturing=True)
    for case in ("print", "py_func", "chunk_eval", "bilinear_interp_v2"):
        ins, attrs = CASES[case]
        tins = {s: [_torch(a, torch.float32) for a in vs]
                for s, vs in ins.items()}
        with pytest.raises(RuntimeError, match="captured step"):
            port_registry.get(cases.op_of(case)).lower(ctx, tins, attrs)


# ---------------------------------------------------------------------------
# the host ops under run_steps
# ---------------------------------------------------------------------------

def _host_program(kind):
    """(main, startup, fetch var) of a small program holding one host op
    (or an interp op sized by a fill_constant or by a feed)."""
    L = port_layers
    main, start = port_program.Program(), port_program.Program()
    with port_program.program_guard(main, start), port_unique_name.guard():
        x = L.data(name="x", shape=[2, 3], dtype="float32",
                   append_batch_size=False)
        block = main.global_block()
        out = block.create_var(name="out", shape=[2, 3], dtype="float32")
        if kind == "print":
            block.append_op("print", inputs={"In": [x]},
                            outputs={"Out": [out]},
                            attrs={"message": "step: "})
        elif kind == "py_func":
            block.append_op("py_func", inputs={"X": [x]},
                            outputs={"Out": [out]},
                            attrs={"forward_callable_id": 2301,
                                   "out_shapes": [[2, 3]],
                                   "out_dtypes": ["float32"]})
        elif kind == "chunk_eval":
            tags = L.data(name="tags", shape=[2, 6], dtype="int32",
                          append_batch_size=False)
            out = L.chunk_eval(tags, tags, "IOB", 2)[0]
        else:
            img = L.reshape(x, [1, 1, 2, 3])
            if kind == "interp_const":
                size = L.fill_constant([2], "int32", 4)
            else:
                size = L.data(name="size", shape=[2], dtype="int32",
                              append_batch_size=False)
            out = block.create_var(name="out", shape=[1, 1, 4, 4],
                                   dtype="float32")
            block.append_op("bilinear_interp_v2",
                            inputs={"X": [img], "OutSize": [size]},
                            outputs={"Out": [out]}, attrs={})
    return main, start, out


@pytest.mark.parametrize("kind", ["print", "py_func", "chunk_eval",
                                  "interp_fed", "interp_const"])
def test_host_ops_make_the_program_host_synced(kind, capsys):
    """A program with a host op, or a shape read from a fed tensor, runs
    eagerly under run_steps; one sized by a fill_constant may be
    captured. run_steps(3) equals three run() steps."""
    main, start, out = _host_program(kind)
    assert _host_synced(main) == (kind != "interp_const")
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.randn(2, 3).astype(np.float32)} for _ in range(3)]
    for f in feeds:
        if kind == "chunk_eval":
            f["tags"] = rng.randint(0, 5, (2, 6)).astype(np.int32)
        if kind == "interp_fed":
            f["size"] = np.array([4, 4], np.int32)
    exe, scope = Executor("cpu"), Scope()
    exe.run(start, scope=scope)
    want = [exe.run(main, feed=f, fetch_list=[out], scope=scope)[0]
            for f in feeds]
    stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
    exe2 = Executor("cpu")
    got = exe2.run_steps(3, main, feed=stacked, fetch_list=[out],
                         scope=scope)[0]
    assert exe2.stats["eager_steps"] == 3 and exe2.stats["captures"] == 0
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    if kind == "print":
        assert capsys.readouterr().out.count("step: ") == 6
    if kind == "chunk_eval":
        assert float(want[0][0]) == 1.0     # every chunk found in itself


# ---------------------------------------------------------------------------
# chunk_eval through the builder, and the reference's six tests
# ---------------------------------------------------------------------------

def _chunk_program(ns, scheme, excluded=None, with_len=True):
    main, start = ns.prog.Program(), ns.prog.Program()
    with ns.prog.program_guard(main, start), ns.names.guard():
        inf = ns.L.data(name="inf", shape=[-1, 6], dtype="int64",
                        append_batch_size=False)
        lab = ns.L.data(name="lab", shape=[-1, 6], dtype="int64",
                        append_batch_size=False)
        sl = ns.L.data(name="sl", shape=[-1], dtype="int64",
                       append_batch_size=False) if with_len else None
        outs = ns.L.chunk_eval(inf, lab, scheme, 2,
                               excluded_chunk_types=excluded, seq_length=sl)
    return main, start, outs


REF = types.SimpleNamespace(prog=ref_program, names=ref_unique_name,
                            L=ref_layers)
PORT = types.SimpleNamespace(prog=port_program, names=port_unique_name,
                             L=port_layers)


@pytest.mark.parametrize("scheme,excluded,with_len",
                         [("IOB", None, True), ("IOE", [1], False),
                          ("IOBES", None, True), ("plain", [0], True)])
def test_chunk_eval_builder_matches_reference(scheme, excluded, with_len):
    rm, rs, routs = _chunk_program(REF, scheme, excluded, with_len)
    pm, ps, pouts = _chunk_program(PORT, scheme, excluded, with_len)
    assert pm.to_desc() == rm.to_desc()
    n_tags = {"IOB": 5, "IOE": 5, "IOBES": 9, "plain": 3}[scheme]
    rng = np.random.RandomState(1)
    feed = {"inf": rng.randint(0, n_tags, (4, 6)).astype(np.int64),
            "lab": rng.randint(0, n_tags, (4, 6)).astype(np.int64)}
    feed["inf"][0] = feed["lab"][0]
    if with_len:
        feed["sl"] = np.array([6, 4, 5, 1], np.int64)
    want = fluid.Executor().run(rm, feed=feed, fetch_list=list(routs),
                                scope=RefScope())
    got = Executor("cpu").run(pm, feed=feed, fetch_list=list(pouts),
                              scope=Scope())
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64).reshape(-1),
                                   np.asarray(w, np.float64).reshape(-1),
                                   rtol=1e-6)
    assert int(np.asarray(got[4]).reshape(-1)[0]) > 0


def _chunk(inf, lab, scheme, **attrs):
    out = _run_port("chunk_eval", {"Inference": [np.array(inf, np.int32)],
                                   "Label": [np.array(lab, np.int32)]},
                    dict(num_chunk_types=2, chunk_scheme=scheme, **attrs))
    return {k: float(v[0].reshape(-1)[0]) for k, v in out.items()}


def test_chunk_eval_reference_tests():
    """tests/test_tail_ops.py's six chunk_eval tests, on the port."""
    o = _chunk([[0, 1, 4, 2, 3]], [[0, 1, 4, 2, 4]], "IOB")
    assert (o["NumInferChunks"], o["NumLabelChunks"],
            o["NumCorrectChunks"], o["Precision"]) == (2, 2, 1, 0.5)
    o = _chunk([[0, 1, 2, 3]], [[0, 1, 4, 3]], "IOE")
    assert (o["NumInferChunks"], o["NumLabelChunks"],
            o["NumCorrectChunks"], o["Precision"]) == (2, 2, 1, 0.5)
    o = _chunk([[3, 8, 4, 5, 6]], [[3, 8, 4, 5, 8]], "IOBES")
    assert (o["NumInferChunks"], o["NumCorrectChunks"], o["Recall"]) \
        == (2, 1, 0.5)
    o = _chunk([[0, 0, 1, 2]], [[0, 0, 1, 2]], "plain")
    assert (o["NumInferChunks"], o["NumCorrectChunks"], o["F1-Score"]) \
        == (2, 2, 1.0)
    o = _chunk([[0, 1, 4, 2, 3]], [[0, 1, 4, 2, 4]], "IOB",
               excluded_chunk_types=[0])
    assert (o["NumInferChunks"], o["NumLabelChunks"],
            o["NumCorrectChunks"], o["Precision"]) == (1, 1, 0, 0.0)
    with pytest.raises(ValueError, match="chunk scheme"):
        _chunk([[0]], [[0]], "BIO2")


# ---------------------------------------------------------------------------
# DGCMomentumOptimizer: training across the ramp
# ---------------------------------------------------------------------------

DGC_STEPS, DGC_BATCH, DGC_LR = 10, 8, 0.1
REF.opt, PORT.opt = paddle.optimizer, port_optimizer


def build_dgc(ns, clip=None):
    """(main, startup, loss) of a small MLP (16 -> 64 relu -> 10,
    softmax cross entropy) minimised by DGCMomentumOptimizer with the DGC
    paper's ImageNet ramp cut to begin at step 2 over 8 steps."""
    main, start = ns.prog.Program(), ns.prog.Program()
    with ns.prog.program_guard(main, start), ns.names.guard():
        x = ns.L.data(name="x", shape=[16], dtype="float32")
        y = ns.L.data(name="y", shape=[1], dtype="int64")
        h = ns.L.fc(x, 64, act="relu")
        logits = ns.L.fc(h, 10)
        loss = ns.L.mean(ns.L.softmax_with_cross_entropy(logits, y))
        ns.opt.DGCMomentumOptimizer(
            learning_rate=DGC_LR, momentum=0.9,
            sparsity=cases.DGC_SPARSITY, local_grad_clip_norm=clip,
            **{k: int(v) for k, v in cases.DGC_RAMP.items()}).minimize(loss)
    return main, start, loss


def dgc_feeds(n=DGC_STEPS, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(DGC_BATCH, 16).astype(np.float32),
             "y": rng.randint(0, 10, (DGC_BATCH, 1)).astype(np.int64)}
            for _ in range(n)]


def _persistables(main):
    return sorted(v.name for v in main.global_block().vars.values()
                  if v.persistable)


@pytest.fixture(scope="module", params=[None, 1.0], ids=["noclip", "clip"])
def dgc_reference(request):
    """The reference's startup arrays, losses and final persistables over
    DGC_STEPS steps."""
    main, start, loss = build_dgc(REF, request.param)
    scope, exe = RefScope(), fluid.Executor()
    exe.run(start, scope=scope)
    init = {n: np.asarray(scope.find(n)) for n in scope.local_names()
            if not n.startswith("__")}
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope)[0]))
              for f in dgc_feeds()]
    final = {n: np.asarray(scope.find(n), np.float32)
             for n in _persistables(main)}
    return request.param, init, losses, final


def test_dgc_desc_equals_reference(dgc_reference):
    clip = dgc_reference[0]
    rm, rs, _ = build_dgc(REF, clip)
    pm, ps, _ = build_dgc(PORT, clip)
    assert pm.to_desc() == rm.to_desc()
    assert ps.to_desc() == rs.to_desc()
    types_ = [op.type for op in pm.global_block().ops]
    assert types_.count("dgc") == types_.count("dgc_momentum") == 4
    assert types_.count("dgc_clip_by_norm") == (4 if clip else 0)
    assert types_[-1] == "increment"


def test_dgc_training_matches_reference(dgc_reference):
    """Ten steps across the momentum -> DGC switch (step 2) and the five
    sparsity segments (steps 2-9): losses within 1e-5 relative, every
    persistable (parameters, U, V, velocity, the counter) within 1e-5."""
    clip, init, want, ref_final = dgc_reference
    main, start, loss = build_dgc(PORT, clip)
    scope, exe = load_numpy(Scope(), init, "cpu"), Executor("cpu")
    got = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0])
           for f in dgc_feeds()]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert _persistables(main) == sorted(ref_final)
    for n, w in ref_final.items():
        np.testing.assert_allclose(scope.numpy(n), w, rtol=0, atol=1e-5,
                                   err_msg=n)
    counter = next(n for n in ref_final if "dgc_counter" in n)
    assert scope.numpy(counter).tolist() == [float(DGC_STEPS)]
    v = next(n for n in ref_final if n.endswith("_dgc_v_0")
             or "dgc_v" in n)
    assert np.abs(scope.numpy(v)).sum() > 0      # residuals accumulate


def test_dgc_run_steps_equals_run_bitwise(dgc_reference):
    clip, init = dgc_reference[:2]
    main, start, loss = build_dgc(PORT, clip)
    feeds = dgc_feeds()
    a, ea = load_numpy(Scope(), init, "cpu"), Executor("cpu")
    want = [float(ea.run(main, feed=f, fetch_list=[loss], scope=a)[0])
            for f in feeds]
    b, eb = load_numpy(Scope(), init, "cpu"), Executor("cpu")
    stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
    got = [float(v) for v in eb.run_steps(DGC_STEPS, main, feed=stacked,
                                          fetch_list=[loss], scope=b)[0]]
    assert got == want
    for n in _persistables(main):
        assert np.array_equal(a.numpy(n), b.numpy(n)), n


def test_dgc_exported_under_the_reference_names():
    import paddle_tpu.optimizer as ref_opt
    assert "DGCMomentumOptimizer" in port_optimizer.__all__
    assert ("DGCMomentumOptimizer" in ref_opt.__all__)
    assert "DGC" not in port_optimizer.__doc__.split("Not ported")[1]
