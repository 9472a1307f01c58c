"""PyTorch port, the extra ops and the recommender system:
paddle_tpu_torch/ops/extra_ops.py, `layers.cos_sim` and the book's
recommender system held against the JAX reference on the CPU.

* One parity case per type of the reference's ops/extra_ops.py (87), and
  more arms of some (`<op>:<arm>`), from tests/torch_extra_op_cases.py:
  f32 at rtol 1e-5 / atol 1e-6 (the frameworks sum in different orders),
  bf16 arms (compared in f32, rtol and atol 1e-2) for the ops AMP can
  hand bf16; integer and bool outputs equal, NaN where the reference has
  NaN (a matrix that is not positive definite).
* A vjp case (the generic `__vjp__`: torch.func.vjp over the port's
  lowering vs jax.vjp over the reference's, the same cotangents) for the
  losses, the recommender's scorer and the types whose gradient is
  written out or not the obvious one: warpctc, segment_pool,
  grid_sampler, cholesky, spectral_norm, lrn.
* The cases the port writes out by hand, named: the patch order of
  `unfold` / `im2sequence` against F.unfold's (C, kh, kw); warpctc's
  finite loss for an infeasible alignment where F.ctc_loss gives inf;
  unique_with_counts and the segment sums reading nothing on the host;
  `relu_` leaving its input alone; `size` in the device int dtype.
* `test_every_extra_op_type_has_a_case` re-reads the reference file: 87
  types, each registered in the port with the reference's flags.
* The book's recommender system (tests/torch_extra_op_cases.py `recsys`)
  at small widths, `is_sparse` on and off: descs equal; three SGD(0.2)
  steps against the reference (losses rtol 1e-5, every parameter atol
  1e-5); `run_steps` equal to `run` bit for bit; fleet's ZeRO stage 1
  (the dense parameters in one bucket, B6's plain version on the CPU)
  equal to stage 0 bit for bit, the tables out of the bucket.
"""
import ast
import pathlib
import re
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu import layers as ref_layers
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu.ops import registry as ref_registry

from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.framework import Executor, Scope, load_numpy
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.ops import registry as port_registry

import jax
import jax.numpy as jnp

import torch_extra_op_cases as cases
from test_torch_program import _arms, _assert_outs_close, _run_port

CASES = cases.extra_cases()


def _run_ref(op, ins, attrs, dtype):
    """The reference's lowering on the CPU, traced under one jax.jit (one
    XLA compile a case, where op-by-op dispatch compiles every op of it)."""
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jins = {s: [jnp.asarray(a).astype(jd)
                if np.issubdtype(a.dtype, np.floating) else jnp.asarray(a)
                for a in vs] for s, vs in ins.items()}
    ctx = ref_registry.LowerCtx(rng_key=jax.random.key(0))
    lower = ref_registry.get(op).lower
    return jax.jit(lambda v: lower(ctx, v, dict(attrs)))(jins)


def _outs(outs):
    """The outputs the harness compares: a slot of None (warpctc's
    WarpCTCGrad) holds nothing in either package."""
    return {s: vs for s, vs in outs.items()
            if all(v is not None for v in vs)}


@pytest.mark.parametrize("case,dtype", _arms(sorted(CASES), cases.BF16_CASES))
def test_extra_lowering_matches_reference(case, dtype):
    ins, attrs = CASES[case]
    op = cases.op_of(case)
    ref = _outs(_run_ref(op, ins, attrs, dtype))
    port = _outs(_run_port(op, ins, attrs, dtype))
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    _assert_outs_close(ref, port, dtype)


@pytest.mark.parametrize("case,dtype", _arms(cases.VJP_CASES,
                                             cases.VJP_BF16))
def test_extra_vjp_matches_reference(case, dtype):
    ins, attrs = CASES[case]
    op = cases.op_of(case)
    # the slots in the lowering's order (jax.jit returns them sorted)
    outs = _run_ref(op, ins, attrs, "f32")
    outs = {s: outs[s] for s in _run_port(op, ins, attrs, "f32")}
    vjp_ins, vattrs = cases.vjp_case(op, ins, attrs, outs,
                                     ref_registry.make_vjp_attrs)
    ref = _run_ref("__vjp__", vjp_ins, vattrs, dtype)
    port = _run_port("__vjp__", vjp_ins, vattrs, dtype)
    _assert_outs_close(ref, port, dtype)


def test_every_extra_op_type_has_a_case():
    """The reference file registers 87 types; each has a case here and is
    registered in the port with the reference's flags."""
    src = (pathlib.Path(ref_registry.__file__).parent
           / "extra_ops.py").read_text()
    types_ = re.findall(r'register\("(\w+)"', src)
    assert len(types_) == len(set(types_)) == 87
    assert set(types_) == {cases.op_of(c) for c in CASES}
    import paddle_tpu.ops.extra_ops  # noqa: F401  (registers on import)
    for t in types_:
        ref, port = ref_registry.get(t), port_registry.get(t)
        assert (port.nondiff_slots, port.stateful_outputs, port.is_random) \
            == (ref.nondiff_slots, ref.stateful_outputs, ref.is_random), t
    assert "CentersOut" not in port_registry.get(
        "center_loss").stateful_outputs


def test_shared_cases_import_numpy_only():
    """chip_smoke.py imports tests/torch_extra_op_cases.py on the card,
    where neither JAX nor the reference may be imported: numpy only."""
    tree = ast.parse(pathlib.Path(cases.__file__).read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert mods == {"numpy"}


# ---------------------------------------------------------------------------
# the cases written out by hand, named
# ---------------------------------------------------------------------------

def _port(op, ins, attrs):
    return _run_port(op, ins, attrs, "f32")


@pytest.mark.parametrize("op,kernel_attr", [("unfold", "kernel_sizes"),
                                             ("im2sequence", "kernels")])
def test_patches_in_f_unfold_order(op, kernel_attr):
    """Both patch ops order a patch's features (C, kh, kw), as F.unfold
    does (and conv_general_dilated_patches in the reference)."""
    x = np.random.RandomState(3).randn(2, 3, 5, 6).astype(np.float32)
    attrs = {kernel_attr: [2, 3], "strides": [1, 2],
             "paddings": [1, 1, 1, 1]}
    got = _port(op, {"X": [x]}, attrs)["Y" if op == "unfold" else "Out"][0]
    want = F.unfold(torch.from_numpy(x), (2, 3), padding=(1, 1),
                    stride=(1, 2))
    if op == "im2sequence":
        want = want.transpose(1, 2).reshape(-1, want.shape[1])
    assert torch.equal(got, want)


def test_warpctc_infeasible_alignment_is_finite_where_ctc_loss_is_inf():
    """Label length 4 in 2 frames: optax's recursion (log 0 as -1e5) gives
    a large finite loss, F.ctc_loss inf; the feasible rows agree with
    F.ctc_loss. The pullback is finite on every row."""
    ins, attrs = CASES["warpctc"]
    loss = _port("warpctc", ins, attrs)["Loss"][0][:, 0]
    vjp_ins, vattrs = cases.vjp_case(
        "warpctc", ins, attrs, {"Loss": [loss[:, None]]},
        port_registry.make_vjp_attrs)
    grad = _port("__vjp__", vjp_ins, vattrs)["IG:Logits"][0]
    assert torch.isfinite(grad).all()
    logp = torch.log_softmax(torch.from_numpy(ins["Logits"][0]), -1)
    want = F.ctc_loss(logp.transpose(0, 1), torch.from_numpy(
        ins["Label"][0]).long(), torch.from_numpy(ins["LogitsLength"][0]),
        torch.from_numpy(ins["LabelLength"][0]), blank=0, reduction="none")
    assert torch.isinf(want[2]) and torch.isfinite(loss[2])
    assert loss[2] > 1e4
    torch.testing.assert_close(loss[:2], want[:2], rtol=1e-5, atol=1e-5)


class _NoHostReads(TorchDispatchMode):
    """Refuses the ops that read a device value on the host."""
    BANNED = ("aten::_local_scalar_dense", "aten::nonzero",
              "aten::_unique2", "aten::unique_dim", "aten::unique_consecutive")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        assert func._schema.name not in self.BANNED, func._schema.name
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["unique_with_counts", "segment_pool:max",
                                  "scatter_nd_add", "cholesky:not_pd",
                                  "warpctc", "max_pool2d_with_index"])
def test_lowering_reads_nothing_on_the_host(case):
    ins, attrs = CASES[case]
    with _NoHostReads():
        _port(cases.op_of(case), ins, attrs)


def test_relu_inplace_alias_leaves_its_input_and_size_is_device_int():
    x = torch.tensor([-1.0, 0.0, 2.0])
    before = x.clone()
    out = port_registry.get("relu_").lower(
        port_registry.LowerCtx(device="cpu"), {"X": [x]}, {})["Out"][0]
    assert torch.equal(x, before) and out.data_ptr() != x.data_ptr()
    size = _port("size", {"Input": [np.zeros((3, 4, 5), np.float32)]},
                 {})["Out"][0]
    assert size.dtype == torch.int32 and size.shape == () and size == 60


# ---------------------------------------------------------------------------
# the book's recommender system
# ---------------------------------------------------------------------------

REF = types.SimpleNamespace(prog=ref_program, names=ref_unique_name,
                            L=ref_layers, opt=paddle.optimizer,
                            fleet=ref_fleet)
PORT = types.SimpleNamespace(prog=port_program, names=port_unique_name,
                             L=port_layers, opt=port_optimizer,
                             fleet=port_fleet)
SMALL = {"user": 50, "gender": 2, "age": 7, "job": 21, "movie": 40,
         "category": 18, "title": 60}
WIDTHS = {"emb": 8, "small": 4, "hidden": 16, "title_filters": 8}
STEPS, BATCH = 3, 16


def build_recsys(ns, is_sparse, stage=None):
    main, start = ns.prog.Program(), ns.prog.Program()
    with ns.prog.program_guard(main, start), ns.names.guard():
        loss, _ = cases.recsys(ns.L, SMALL, is_sparse=is_sparse, **WIDTHS)
        opt = ns.opt.SGD(learning_rate=cases.RECSYS_LR)
        if stage is not None:
            ns.fleet.init(is_collective=True)
            s = ns.fleet.DistributedStrategy()
            s.sharding_stage = stage
            opt = ns.fleet.distributed_optimizer(opt, s)
        opt.minimize(loss)
    return main, start, loss


def params(main):
    return sorted(p.name for p in main.global_block().all_parameters())


@pytest.fixture(scope="module")
def recsys_reference():
    """Per `is_sparse`: the reference's startup arrays, its losses over
    STEPS batches and its final parameters."""
    feeds = cases.recsys_feed(STEPS, BATCH, SMALL)
    out = {}
    for is_sparse in (True, False):
        main, start, loss = build_recsys(REF, is_sparse)
        scope = RefScope()
        exe = fluid.Executor()
        exe.run(start, scope=scope)
        init = {n: np.asarray(scope.find(n)) for n in scope.local_names()
                if not n.startswith("__")}
        losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                           scope=scope)[0]))
                  for f in feeds]
        out[is_sparse] = (init, losses, {n: np.asarray(scope.find(n))
                                         for n in params(main)})
    return feeds, out


def port_run(main, start, loss, init, feeds, window=False):
    scope, exe = Scope(), Executor("cpu")
    exe.run(start, scope=scope)
    load_numpy(scope, init, "cpu")
    if window:
        stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
        got = exe.run_steps(len(feeds), main, feed=stacked,
                            fetch_list=[loss], scope=scope)[0]
        return [float(g) for g in got], scope
    return [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scope)[0])) for f in feeds], scope


@pytest.mark.parametrize("is_sparse", [True, False])
def test_recsys_desc_equals_reference(is_sparse):
    rm, rs, _ = build_recsys(REF, is_sparse)
    pm, ps, _ = build_recsys(PORT, is_sparse)
    assert pm.to_desc() == rm.to_desc()
    assert ps.to_desc() == rs.to_desc()
    assert sum(op.type == "cos_sim" for op in pm.global_block().ops) == 1
    lookups = [op for op in pm.global_block().ops if op.type == "lookup_table"]
    assert len(lookups) == 7
    assert all(op.attrs["is_sparse"] == is_sparse for op in lookups)


@pytest.mark.parametrize("is_sparse", [True, False])
def test_recsys_sgd_steps_match_reference(is_sparse, recsys_reference):
    feeds, ref = recsys_reference
    init, want, ref_params = ref[is_sparse]
    main, start, loss = build_recsys(PORT, is_sparse)
    got, scope = port_run(main, start, loss, init, feeds)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] != got[0]
    for n in params(main):
        np.testing.assert_allclose(scope.numpy(n), ref_params[n], rtol=0,
                                   atol=1e-5, err_msg=n)


@pytest.mark.parametrize("arm", ["run_steps", "stage1"])
@pytest.mark.parametrize("is_sparse", [True, False])
def test_recsys_arms_equal_run_bit_for_bit(arm, is_sparse, recsys_reference):
    """run_steps(3) and fleet's ZeRO stage 1 against three Executor.run
    steps of the plain program, bit for bit: losses and parameters. At
    stage 1 the dense parameters are one bucket (one `__zero_update__`,
    B6's plain version on the CPU) and the sparse tables stay out of it
    on their own `sgd`."""
    feeds, ref = recsys_reference
    init = ref[is_sparse][0]
    plain = build_recsys(PORT, is_sparse)
    want, want_scope = port_run(*plain, init, feeds)
    if arm == "run_steps":
        got, scope = port_run(*plain, init, feeds, window=True)
    else:
        main, start, loss = build_recsys(PORT, is_sparse, stage=1)
        buckets = main._grad_buckets["zero_buckets"]
        assert len(buckets) == 1
        tables = {op.inputs["W"][0] for op in main.global_block().ops
                  if op.type == "lookup_table"}
        sgd_params = {op.inputs["Param"][0] for op in main.global_block().ops
                      if op.type == "sgd"}
        assert sum(op.type == "__zero_update__"
                   for op in main.global_block().ops) == 1
        if is_sparse:
            assert not tables & set(buckets[0]["params"])
            assert sgd_params == tables
        else:
            assert tables <= set(buckets[0]["params"]) and not sgd_params
        got, scope = port_run(main, start, loss, init, feeds)
    assert got == want
    for n in params(plain[0]):
        assert np.array_equal(scope.numpy(n), want_scope.numpy(n)), n
