"""PyTorch port, row-sparse gradients: paddle_tpu_torch's ops/sparse_grad.py
(`SelectedRows`, `merge_rows`, `densify`, the `lookup_table_sparse_grad`
lowering), the `is_sparse` branch of append_backward, `sum` over sparse
gradients, the five sparse update rules, clip and regularization passing
sparse gradients by, the ZeRO bucket pass leaving them out, and
models/wide_deep.py, held against the JAX reference on the CPU.

* The reference's tests/test_sparse_grad.py on both packages from one
  numpy init: an `is_sparse` embedding + fc trained 5 steps with SGD,
  Adam, Momentum, Adagrad and AdamW. Descs equal; losses rtol 1e-5 and
  both parameters atol 1e-5 against the reference; inside the port, the
  sparse run against the dense one as the reference test holds them
  (losses rtol 1e-4 / atol 1e-5, touched rows likewise; AdamW decays the
  touched rows only, so its rows are held against the reference alone)
  and the untouched rows bit-equal to their initial values.
* The value semantics (duplicate ids summed, densify after merge equal),
  the two SelectedRows helpers of ops/dense_tail_ops.py, and two lookups
  of one table summed by the `sum` op's sparse branch (both sparse, or
  one dense), each against the reference.
* `merge_rows` on duplicate ids, padding ids and every id equal: the
  distinct ids and their summed rows equal the reference's (rows atol
  1e-6), the padding slots are zero rows repeating the last id, and
  `densify` of the merge equals the reference's. It reads nothing on the
  host: no `.item()`, `nonzero` or `unique` under a dispatch mode that
  refuses them, in the captured form of a training step too
  (`LowerCtx.capturing`), which equals the eager step bit for bit.
* `build_ctr` at vocab 1,000, batch 16, 3 steps of Adam: descs equal,
  losses and AUC within 1e-5, the table and the fc weights within 1e-5,
  through `Executor.run`, `run_steps` and fleet's ZeRO stage 1 (whose
  buckets hold the dense parameters only and equal the plain run bit for
  bit).
* The raises that stay: a sparse table at dp > 1 and on a tp / sp mesh,
  and a rule without a sparse branch fed a sparse gradient.
"""
import importlib
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu import layers as ref_layers
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu.models import wide_deep as ref_wide_deep
from paddle_tpu.ops import sparse_grad as ref_sparse

from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.framework import Executor, Scope, errors, load_numpy
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.layer_helper import ParamAttr as PortParamAttr
from paddle_tpu_torch.models import wide_deep as port_wide_deep
from paddle_tpu_torch.ops import registry as port_registry
from paddle_tpu_torch.ops import sparse_grad as port_sparse

ref_clip = importlib.import_module("paddle_tpu.clip")
ref_reg = importlib.import_module("paddle_tpu.regularizer")
port_clip = importlib.import_module("paddle_tpu_torch.clip")
port_reg = importlib.import_module("paddle_tpu_torch.regularizer")

REF = types.SimpleNamespace(prog=ref_program, names=ref_unique_name,
                            L=ref_layers, opt=paddle.optimizer,
                            attr=paddle.ParamAttr, fleet=ref_fleet,
                            wd=ref_wide_deep, clip=ref_clip, reg=ref_reg)
PORT = types.SimpleNamespace(prog=port_program, names=port_unique_name,
                             L=port_layers, opt=port_optimizer,
                             attr=PortParamAttr, fleet=port_fleet,
                             wd=port_wide_deep, clip=port_clip, reg=port_reg)
RULES = {
    "sgd": lambda ns: ns.opt.SGD(learning_rate=0.1),
    "adam": lambda ns: ns.opt.Adam(learning_rate=0.05),
    "momentum": lambda ns: ns.opt.Momentum(learning_rate=0.1, momentum=0.9),
    "adagrad": lambda ns: ns.opt.Adagrad(learning_rate=0.1),
    "adamw": lambda ns: ns.opt.AdamW(learning_rate=0.05, weight_decay=0.01),
}
SPARSE_RULES = list(RULES)
RULES["adamax"] = lambda ns: ns.opt.Adamax(learning_rate=0.05)


def build(ns, fn):
    main, start = ns.prog.Program(), ns.prog.Program()
    with ns.prog.program_guard(main, start), ns.names.guard():
        fetch = fn(ns)
    return main, start, fetch


def assert_descs_equal(ref, port):
    rd, pd = ref.to_desc(), port.to_desc()
    for r, p in zip(rd["blocks"][0]["ops"], pd["blocks"][0]["ops"]):
        assert p == r, (r["type"], r, p)
    assert pd == rd


def ref_startup(start):
    scope = RefScope()
    fluid.Executor().run(start, scope=scope)
    return scope, {n: np.asarray(scope.find(n)) for n in scope.local_names()
                   if not n.startswith("__")}


def ref_steps(main, scope, feeds, fetch):
    exe = fluid.Executor()
    return [[np.asarray(v) for v in exe.run(main, feed=f, fetch_list=fetch,
                                            scope=scope)] for f in feeds]


def port_steps(main, start, init, feeds, fetch, window=False):
    """Steps of the port after its startup program, with the reference's
    startup arrays `init` in place of its own: one run() a feed, or
    (`window`) one run_steps over them all. Returns (per-step fetches,
    scope)."""
    scope, exe = Scope(), Executor("cpu")
    exe.run(start, scope=scope)
    load_numpy(scope, init, "cpu")
    if window:
        stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
        got = exe.run_steps(len(feeds), main, feed=stacked,
                            fetch_list=fetch, scope=scope)
        return [[g[b] for g in got] for b in range(len(feeds))], scope
    return [[np.asarray(v) for v in exe.run(main, feed=f, fetch_list=fetch,
                                            scope=scope)]
            for f in feeds], scope


# ---------------------------------------------------------------------------
# the reference's tests/test_sparse_grad.py on both packages
# ---------------------------------------------------------------------------

def minimize(ns, opt, loss, stage=None):
    """`opt.minimize(loss)`, through fleet at ZeRO `stage` when given."""
    if stage is not None:
        ns.fleet.init(is_collective=True)
        s = ns.fleet.DistributedStrategy()
        s.sharding_stage = stage
        opt = ns.fleet.distributed_optimizer(opt, s)
    opt.minimize(loss)


def emb_fc(is_sparse, rule, stage=None):
    def fn(ns):
        L = ns.L
        ids = L.data(name="ids", shape=[4], dtype="int64")
        y = L.data(name="y", shape=[1], dtype="float32")
        emb = L.embedding(ids, size=[100, 8], is_sparse=is_sparse,
                          param_attr=ns.attr(name="emb_w"))
        pred = L.fc(L.reshape(emb, [-1, 32]), 1,
                    param_attr=ns.attr(name="fc_w"))
        loss = L.mean(L.square_error_cost(pred, y))
        minimize(ns, RULES[rule](ns), loss, stage)
        return [loss]
    return fn


def emb_feeds(steps=5):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 20, (16, 4)).astype(np.int64)
    y = rng.randn(16, 1).astype(np.float32)
    return [{"ids": ids, "y": y}] * steps


@pytest.fixture(scope="module")
def emb_init():
    """One numpy init of emb_w and fc_w for every rule and both modes."""
    _, start, _ = build(REF, emb_fc(True, "sgd"))
    return ref_startup(start)[1]


@pytest.mark.parametrize("rule", SPARSE_RULES)
def test_sparse_training_matches_reference_and_dense(rule, emb_init):
    rm, rs, rf = build(REF, emb_fc(True, rule))
    pm, ps, pf = build(PORT, emb_fc(True, rule))
    assert_descs_equal(rm, pm)
    assert [op.type for op in pm.global_block().ops].count(
        "lookup_table_sparse_grad") == 1
    grad = next(op.inputs["Grad"][0] for op in pm.global_block().ops
                if op.inputs.get("Param") == ["emb_w"])
    assert pm.global_block().var(grad)._is_selected_rows
    scope = RefScope()
    fluid.Executor().run(rs, scope=scope)
    for n, v in emb_init.items():
        scope.set(n, v)
    feeds = emb_feeds()
    want = ref_steps(rm, scope, feeds, rf)
    got, pscope = port_steps(pm, ps, emb_init, feeds, pf)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-5)
    for n in ("emb_w", "fc_w"):
        np.testing.assert_allclose(pscope.numpy(n),
                                   np.asarray(scope.find(n)), rtol=0,
                                   atol=1e-5, err_msg=n)
    # inside the port: sparse against dense, as the reference test holds
    dm, dstart, df = build(PORT, emb_fc(False, rule))
    dense, ds = port_steps(dm, dstart, emb_init, feeds, df)
    touched = np.unique(feeds[0]["ids"])
    untouched = np.setdiff1d(np.arange(100), touched)
    w_sparse, w_dense = pscope.numpy("emb_w"), ds.numpy("emb_w")
    np.testing.assert_array_equal(w_sparse[untouched],
                                  emb_init["emb_w"][untouched])
    if rule != "adamw":
        np.testing.assert_allclose([g[0] for g in got],
                                   [d[0] for d in dense], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(w_sparse[touched], w_dense[touched],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(w_dense[untouched],
                                      emb_init["emb_w"][untouched])


def test_selected_rows_value_semantics():
    rows, ids = [[1., 1.], [2., 2.], [3., 3.]], [5, 1, 5]
    ref = ref_sparse.SelectedRows(rows=np.asarray(rows, np.float32),
                                  ids=np.asarray(ids, np.int32))
    sr = port_sparse.SelectedRows(rows=torch.tensor(rows),
                                  ids=torch.tensor(ids))
    d = port_sparse.densify(sr, 10)
    np.testing.assert_allclose(d[5].numpy(), [4., 4.])
    np.testing.assert_allclose(d[1].numpy(), [2., 2.])
    np.testing.assert_array_equal(d.numpy(),
                                  np.asarray(ref_sparse.densify(ref, 10)))
    m = port_sparse.merge_rows(sr, 10)
    np.testing.assert_array_equal(port_sparse.densify(m, 10).numpy(),
                                  d.numpy())


HELPER_IDS = {"duplicates": [4, 1, 4, 0, 1, 4], "distinct": [5, 2, 0, 3, 1, 4],
              "all_equal": [3, 3, 3, 3, 3, 3]}


@pytest.mark.parametrize("op_type,ids", [
    ("get_tensor_from_selected_rows", "duplicates"),
    *[("merge_selected_rows", k) for k in HELPER_IDS]])
def test_selected_rows_helpers_match_reference(op_type, ids):
    from paddle_tpu.ops import registry as ref_registry
    import paddle_tpu.ops.dense_tail_ops  # noqa: F401 (registers the ops)
    rows = np.random.RandomState(2).randn(6, 3).astype(np.float32)
    ids = np.array(HELPER_IDS[ids], np.int64)
    want = ref_registry.get(op_type).lower(
        None, {"X": [ref_sparse.SelectedRows(rows=rows, ids=ids)]},
        {})["Out"][0]
    got = port_registry.get(op_type).lower(
        None, {"X": [port_sparse.SelectedRows(rows=torch.from_numpy(rows),
                                              ids=torch.from_numpy(ids))]},
        {})["Out"][0]
    if op_type == "merge_selected_rows":
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        got, want = got.rows, want.rows
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    dense = torch.ones(2, 3)
    assert port_registry.get(op_type).lower(
        None, {"X": [dense]}, {})["Out"][0] is dense


def two_consumers(second_sparse):
    def fn(ns):
        L = ns.L
        a = L.data(name="a", shape=[2], dtype="int64")
        b = L.data(name="b", shape=[2], dtype="int64")
        w_attr = ns.attr(name="shared_emb")
        e1 = L.embedding(a, size=[50, 4], is_sparse=True, param_attr=w_attr)
        e2 = L.embedding(b, size=[50, 4], is_sparse=second_sparse,
                         param_attr=w_attr)
        loss = L.mean(L.elementwise_add(e1, e2))
        ns.opt.SGD(learning_rate=1.0).minimize(loss)
        return [loss]
    return fn


@pytest.mark.parametrize("second_sparse", [True, False])
def test_two_consumer_sparse_accumulation(second_sparse):
    """Two lookups of one table, summed by the `sum` op's SelectedRows
    branch: both sparse, the sum stays sparse (rows and ids
    concatenated); one dense, the sparse rows are added into the dense
    gradient. Id 2, in both lookups, moves twice as far."""
    rm, rs, rf = build(REF, two_consumers(second_sparse))
    pm, ps, pf = build(PORT, two_consumers(second_sparse))
    assert_descs_equal(rm, pm)
    sums = [op for op in pm.global_block().ops if op.type == "sum"]
    assert len(sums) == 1
    assert getattr(pm.global_block().var(sums[0].outputs["Out"][0]),
                   "_is_selected_rows", False) == second_sparse
    scope, init = ref_startup(rs)
    feed = [{"a": np.array([[1, 2]], np.int64),
             "b": np.array([[2, 3]], np.int64)}]
    ref_steps(rm, scope, feed, rf)
    _, pscope = port_steps(pm, ps, init, feed, pf)
    w0, w1 = init["shared_emb"], pscope.numpy("shared_emb")
    np.testing.assert_allclose(w1, np.asarray(scope.find("shared_emb")),
                               rtol=0, atol=1e-6)
    moved = np.where(np.abs(w1 - w0).max(axis=1) > 1e-9)[0]
    np.testing.assert_array_equal(moved, [1, 2, 3])
    np.testing.assert_allclose((w0 - w1)[2].max(), 2 * (w0 - w1)[1].max(),
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# merge_rows: static size, no host reads
# ---------------------------------------------------------------------------

class NoHostReads(TorchDispatchMode):
    """Refuses every op that reads a device value on the host or returns
    a data-dependent size: what a CUDA graph cannot capture."""
    REFUSED = ("_local_scalar_dense", "nonzero", "unique", "item",
               "masked_select")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__
        if any(r in name for r in self.REFUSED):
            raise AssertionError(f"host read: {name}")
        return func(*args, **(kwargs or {}))


MERGE_CASES = {
    "duplicates": ([7, 3, 7, 9, 3, 7, 0, 2], -1),
    "padding_ids": ([4, 0, 4, 4, 6, 0, 1, 4], 4),
    "every_id_equal": ([5] * 8, -1),
}


@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merge_rows_matches_reference_without_host_reads(case):
    ids, padding_idx = MERGE_CASES[case]
    vocab = 10
    og = np.random.RandomState(1).randn(len(ids), 3).astype(np.float32)
    ids_np = np.asarray(ids, np.int64)[:, None]
    w = np.zeros((vocab, 3), np.float32)
    ref_lower = ref_sparse._lookup_table_sparse_grad
    rsr = ref_lower(None, {"W": [w], "Ids": [ids_np], "OG:Out": [og]},
                    {"padding_idx": padding_idx})["IG:W"][0]
    rmerged = ref_sparse.merge_rows(rsr, vocab)
    lower = port_registry.get("lookup_table_sparse_grad").lower
    with NoHostReads():
        psr = lower(None, {"W": [torch.from_numpy(w)],
                           "Ids": [torch.from_numpy(ids_np)],
                           "OG:Out": [torch.from_numpy(og)]},
                    {"padding_idx": padding_idx})["IG:W"][0]
        merged = port_sparse.merge_rows(psr, vocab)
        writers = port_sparse.writer_slots(merged.ids)
    np.testing.assert_array_equal(psr.rows.numpy(), np.asarray(rsr.rows))
    n = len(set(ids))
    r_ids, r_rows = np.asarray(rmerged.ids), np.asarray(rmerged.rows)
    np.testing.assert_array_equal(merged.ids[:n].numpy(), r_ids[:n])
    np.testing.assert_allclose(merged.rows[:n].numpy(), r_rows[:n], rtol=0,
                               atol=1e-6)
    # the reference's padding: id `vocab`, dropped by its scatters; the
    # port's: zero rows repeating the last id, written by their real slot
    assert (r_ids[n:] == vocab).all()
    assert (merged.ids[n:] == merged.ids[n - 1]).all()
    assert not merged.rows[n:].any()
    np.testing.assert_array_equal(
        writers.numpy(), np.minimum(np.arange(len(ids)), n - 1))
    np.testing.assert_allclose(
        port_sparse.densify(merged, vocab).numpy(),
        np.asarray(ref_sparse.densify(rmerged, vocab)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("rule", SPARSE_RULES)
def test_captured_sparse_step_reads_nothing_on_the_host(rule):
    """The step body in its captured form (every lowering told it is being
    captured) under `NoHostReads`, and equal to the eager step bit for
    bit, its repeated ids included."""
    from paddle_tpu_torch.framework import executor as port_executor
    pm, ps, pf = build(PORT, emb_fc(True, rule))
    init = {}
    start = Scope()
    Executor("cpu").run(ps, scope=start)
    for n in start.local_names():
        if isinstance(start.find(n), torch.Tensor):
            init[n] = start.numpy(n)
    feed = emb_feeds(1)[0]
    out = {}
    for capturing in (False, True):
        scope, exe = load_numpy(Scope(), init, "cpu"), Executor("cpu")
        env = {n: port_executor._coerce_feed_value(pm.global_block(), n, v,
                                                   exe.device)
               for n, v in feed.items()}
        ctx = port_registry.LowerCtx(run_seed=0, device="cpu",
                                     capturing=capturing)
        with NoHostReads():
            loss = exe._step(pm, env, scope, ctx, [pf[0].name])
        out[capturing] = (loss[0].numpy(), scope.numpy("emb_w"))
    for a, b in zip(out[False], out[True]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Wide&Deep
# ---------------------------------------------------------------------------

CTR_VOCAB, CTR_BATCH, CTR_STEPS, CTR_LR = 1000, 16, 3, 1e-3
CTR_PARAMS = ("SparseFeatFactors", "deep_fc1_w", "deep_fc2_w", "deep_fc3_w",
              "wide_w")


def ctr(stage=None):
    def fn(ns):
        _, _, loss, auc = ns.wd.build_ctr(vocab_size=CTR_VOCAB)
        minimize(ns, ns.opt.Adam(learning_rate=CTR_LR), loss, stage)
        return [loss, auc]
    return fn


def ctr_feeds(steps=CTR_STEPS, batch=CTR_BATCH, vocab=CTR_VOCAB, seed=0):
    """Criteo's layout: 13 dense features, 26 categorical ids, a click."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        f = {"dense_input": rng.rand(batch, 13).astype(np.float32),
             "label": rng.randint(0, 2, (batch, 1)).astype(np.int64)}
        for i in range(26):
            f[f"C{i}"] = rng.randint(0, vocab, (batch, 1)).astype(np.int64)
        out.append(f)
    return out


@pytest.fixture(scope="module")
def ctr_reference():
    """The reference's run: (startup arrays, fetches, final params). At
    one process its stage-1 program trains the same steps."""
    rm, rs, rf = build(REF, ctr())
    scope, init = ref_startup(rs)
    got = ref_steps(rm, scope, ctr_feeds(), rf)
    return init, got, {n: np.asarray(scope.find(n)) for n in CTR_PARAMS}


@pytest.mark.parametrize("arm", ["run", "run_steps", "stage1"])
def test_build_ctr_matches_reference(arm, ctr_reference):
    init, want, ref_params = ctr_reference
    stage = 1 if arm == "stage1" else None
    pm, ps, pf = build(PORT, ctr(stage))
    assert_descs_equal(build(REF, ctr(stage))[0], pm)
    got, scope = port_steps(pm, ps, init, ctr_feeds(), pf,
                            window=arm == "run_steps")
    np.testing.assert_allclose(np.ravel([g for g, _ in got]),
                               np.ravel([w for w, _ in want]), rtol=1e-5)
    np.testing.assert_allclose(np.ravel([a for _, a in got]),
                               np.ravel([a for _, a in want]), rtol=0,
                               atol=1e-5)
    for n in CTR_PARAMS:
        np.testing.assert_allclose(scope.numpy(n), ref_params[n], rtol=0,
                                   atol=1e-5, err_msg=n)
    table = scope.numpy("SparseFeatFactors")
    touched = np.unique(np.concatenate(
        [f[f"C{i}"].ravel() for f in ctr_feeds() for i in range(26)]))
    untouched = np.setdiff1d(np.arange(CTR_VOCAB), touched)
    np.testing.assert_array_equal(table[untouched],
                                  init["SparseFeatFactors"][untouched])
    if arm == "stage1":
        # the table's update stays a per-parameter adam; the dense ones
        # are one bucket, equal to the plain run bit for bit
        buckets = pm._grad_buckets["zero_buckets"]
        assert len(buckets) == 1
        assert "SparseFeatFactors" not in buckets[0]["params"]
        assert [op.inputs["Param"] for op in pm.global_block().ops
                if op.type == "adam"] == [["SparseFeatFactors"]]
        plain, pstart, plain_f = build(PORT, ctr())
        pg, pscope = port_steps(plain, pstart, init, ctr_feeds(), plain_f)
        assert [g[0] for g in pg] == [g[0] for g in got]
        for n in CTR_PARAMS:
            np.testing.assert_array_equal(scope.numpy(n), pscope.numpy(n))


def test_clip_and_regularization_pass_sparse_gradients_by():
    """AdamW + L2Decay + GlobalNorm clip: the table's SelectedRows gradient
    is neither clipped nor regularised, so its update reads the gradient
    of the lookup itself; descs and 5 steps equal the reference's."""
    RULES["adamw_l2_clip"] = lambda ns: ns.opt.AdamW(
        learning_rate=0.05, weight_decay=0.01,
        regularization=ns.reg.L2Decay(1e-2),
        grad_clip=ns.clip.GradientClipByGlobalNorm(0.1))
    rm, rs, rf = build(REF, emb_fc(True, "adamw_l2_clip"))
    pm, ps, pf = build(PORT, emb_fc(True, "adamw_l2_clip"))
    assert_descs_equal(rm, pm)
    upd = next(op for op in pm.global_block().ops
               if op.type == "adamw" and op.inputs["Param"] == ["emb_w"])
    assert upd.inputs["Grad"] == ["emb_w@GRAD"]
    assert pm.global_block().var("emb_w@GRAD")._is_selected_rows
    assert "fc_w@GRAD" not in next(
        op for op in pm.global_block().ops
        if op.type == "adamw" and op.inputs["Param"] == ["fc_w"]
    ).inputs["Grad"]
    scope, init = ref_startup(rs)
    want = ref_steps(rm, scope, emb_feeds(), rf)
    got, pscope = port_steps(pm, ps, init, emb_feeds(), pf)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-5)
    for n in ("emb_w", "fc_w"):
        np.testing.assert_allclose(pscope.numpy(n), np.asarray(scope.find(n)),
                                   rtol=0, atol=1e-5, err_msg=n)


# ---------------------------------------------------------------------------
# the raises that stay
# ---------------------------------------------------------------------------

def test_sparse_table_at_dp2_raises_naming_its_item(monkeypatch):
    """A program fleet minimized at stage 1 whose table is sparse, run in
    a world of 2: the executor's dp plan refuses it, names the item and
    counts it. (The world of 2 stands in for a gang: the plan is decided
    before any collective. Wide&Deep itself is refused earlier, for its
    `auc`, a cross-batch op.)"""
    from paddle_tpu_torch.distributed import parallel
    from paddle_tpu_torch.observability import metrics
    pm, ps, pf = build(PORT, emb_fc(True, "adam", stage=1))
    pm._dp = 2
    monkeypatch.setattr(parallel, "get_world_size", lambda: 2)
    metrics.reset("executor.zero_manual_fallbacks.selected_rows")
    scope, exe = Scope(), Executor("cpu")
    with pytest.raises(errors.UnimplementedError, match="item 26"):
        exe.run(pm, feed=emb_feeds(1)[0], fetch_list=pf, scope=scope)
    assert metrics.get("executor.zero_manual_fallbacks.selected_rows") == 1


def test_sparse_table_on_a_mesh_raises_naming_its_item():
    """A program whose attached DistConfig has tp or sp above 1 runs on
    DTensors (parallel/gspmd.py): a sparse table there raises before the
    step touches the mesh."""
    from paddle_tpu_torch.framework import executor as port_executor
    pm, ps, pf = build(PORT, emb_fc(True, "adam"))
    pm._dist_config = types.SimpleNamespace(mixed=True)
    exe = Executor("cpu")
    env = {n: port_executor._coerce_feed_value(pm.global_block(), n, v,
                                               exe.device)
           for n, v in emb_feeds(1)[0].items()}
    with pytest.raises(errors.UnimplementedError, match="item 26"):
        exe._step(pm, env, Scope(), port_registry.LowerCtx(device="cpu"),
                  [pf[0].name])


def test_rule_without_a_sparse_branch_raises():
    """Adamax has no sparse branch in the reference either: the port
    refuses the gradient rather than densifying it."""
    pm, ps, pf = build(PORT, emb_fc(True, "adamax"))
    scope, exe = Scope(), Executor("cpu")
    exe.run(ps, scope=scope)
    with pytest.raises(NotImplementedError, match="adamax"):
        exe.run(pm, feed=emb_feeds(1)[0], fetch_list=pf, scope=scope)
