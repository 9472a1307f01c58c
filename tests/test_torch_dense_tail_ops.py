"""PyTorch port, the dense tail and the CRF: paddle_tpu_torch/ops/
dense_tail_ops.py, dense_tail_ops2.py and decode_ops.py (linear_chain_crf,
crf_decoding), the six `layers/nn.py` builders over them, `contrib.layers`
and the book's semantic role labeller, held against the JAX reference on
the CPU.

* One parity case per type of the reference's ops/dense_tail_ops.py and
  dense_tail_ops2.py (24 types) and the CRF pair, and more arms of some,
  from tests/torch_dense_tail_op_cases.py: f32 at rtol 1e-5 / atol 1e-6,
  integer and bool outputs equal. The random cases draw from other
  generators in the two packages: their slots, shapes and dtypes are held,
  and their properties (draws in range and from the allowed values, the
  same draw from the same seed, another from another).
* A vjp case (torch.func.vjp over the port's lowering against jax.vjp
  over the reference's, the same cotangents) for the differentiable
  types.
* `test_every_dense_tail_op_type_has_a_case` re-reads the two reference
  files: their 24 types (and the two SelectedRows helpers) and the
  CRF pair registered in the port with the reference's flags.
* The six `layers/nn.py` builders and the eight `contrib.layers` builders
  give the reference's descs.
* The book's SRL at a small size: descs equal, three SGD steps on the
  book's exponential decay against the reference from its startup
  arrays, the frozen table unchanged, Viterbi paths and chunk_eval's
  counts equal; `run_steps(3)` == three `run` steps and ZeRO stage 1 ==
  stage 0 bit for bit; the decode program eager under `run_steps`.
"""
import pathlib
import re
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu import contrib as ref_contrib
from paddle_tpu import layers as ref_layers
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu.layer_helper import ParamAttr as RefParamAttr
from paddle_tpu.ops import registry as ref_registry

from paddle_tpu_torch import contrib as port_contrib
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.framework import Executor, Scope, load_numpy
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.layer_helper import ParamAttr as PortParamAttr
from paddle_tpu_torch.ops import registry as port_registry

import jax
import jax.numpy as jnp

import torch_dense_tail_op_cases as cases
import torch_extra_op_cases
from test_torch_tail_ops import _NoHostReads, _dtype, _flat, _jax, _np, \
    _run_port

CASES = cases.dense_tail_cases()


def _run_ref(op, ins, attrs):
    """The reference's lowering on the CPU under one jax.jit a case."""
    jins = {s: [_jax(a, jnp.float32) for a in vs] for s, vs in ins.items()}
    ctx = ref_registry.LowerCtx(rng_key=jax.random.key(0))
    lower = ref_registry.get(op).lower
    return jax.jit(lambda v: lower(ctx, v, dict(attrs)))(jins)


def _assert_close(ref, port, values=True):
    """The same slots, shapes and dtypes; floats within rtol 1e-5 / atol
    1e-6, integers and bools equal."""
    ref, port = _flat(ref), _flat(port)
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    for slot in ref:
        assert len(port[slot]) == len(ref[slot]), slot
        for r, p in zip(ref[slot], port[slot]):
            if r is None:
                assert p is None, slot
                continue
            assert tuple(p.shape) == tuple(r.shape), (slot, p.shape, r.shape)
            assert _dtype(p) == _dtype(r), (slot, _dtype(p), _dtype(r))
            if not values:
                continue
            if p.is_floating_point():
                np.testing.assert_allclose(_np(p), _np(r), rtol=1e-5,
                                           atol=1e-6, err_msg=slot)
            else:
                assert np.array_equal(_np(p), _np(r)), slot


PARITY = sorted(c for c in CASES if c not in cases.RANDOM)


@pytest.mark.parametrize("case", PARITY)
def test_dense_tail_lowering_matches_reference(case):
    ins, attrs = CASES[case]
    op = cases.op_of(case)
    _assert_close(_run_ref(op, ins, attrs), _run_port(op, ins, attrs))


@pytest.mark.parametrize("case", sorted(cases.VJP_CASES))
def test_dense_tail_vjp_matches_reference(case):
    ins, attrs = CASES[case]
    op = cases.op_of(case)
    # the slots in the lowering's order (jax.jit returns them sorted)
    outs = _run_ref(op, ins, attrs)
    outs = {s: outs[s] for s in _run_port(op, ins, attrs)}
    vjp_ins, vattrs = torch_extra_op_cases.vjp_case(
        op, ins, attrs, outs, ref_registry.make_vjp_attrs)
    _assert_close(_run_ref("__vjp__", vjp_ins, vattrs),
                  _run_port("__vjp__", vjp_ins, vattrs))


def _reference_types():
    """The types the two reference files register, in order."""
    root = pathlib.Path(ref_registry.__file__).parent
    return [n for f in ("dense_tail_ops.py", "dense_tail_ops2.py")
            for n in re.findall(r'register\("(\w+)"',
                                (root / f).read_text())]


SELECTED_ROWS_HELPERS = ("get_tensor_from_selected_rows",
                         "merge_selected_rows")


def test_every_dense_tail_op_type_has_a_case():
    """The two reference files register 26 types: the two SelectedRows
    helpers (held in tests/test_torch_sparse_grad.py) and 24 more, which
    with the CRF pair each have a case here; all 28 are
    registered in the port with the reference's flags."""
    types_ = _reference_types()
    assert len(types_) == len(set(types_)) == 26
    row3 = [t for t in types_ if t not in SELECTED_ROWS_HELPERS]
    assert len(row3) == 24
    assert {cases.op_of(c) for c in CASES} == set(row3) | set(cases.CRF_TYPES)
    for t in types_ + list(cases.CRF_TYPES):
        ref, port = ref_registry.get(t), port_registry.get(t)
        assert (port.nondiff_slots, port.stateful_outputs, port.is_random) \
            == (ref.nondiff_slots, ref.stateful_outputs, ref.is_random), t
    random_types = {t for t in row3 if ref_registry.get(t).is_random}
    assert random_types == {"multinomial", "seed", "tdm_sampler",
                            "pyramid_hash"}
    assert {cases.op_of(c) for c in cases.RANDOM} == random_types
    assert cases.VJP_CASES <= set(CASES)


def test_shared_cases_import_numpy_only():
    import ast
    tree = ast.parse(pathlib.Path(cases.__file__).read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert mods == {"numpy", "math"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lowering_reads_nothing_on_the_host(case):
    ins, attrs = CASES[case]
    with _NoHostReads():
        _run_port(cases.op_of(case), ins, attrs)


# ---------------------------------------------------------------------------
# the random types: what the two packages share
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(cases.RANDOM))
def test_random_case_draws_in_range(case):
    """The reference's output slots, shapes and dtypes; the draws in their
    range, the same under the same seed, another under another seed."""
    ins, attrs = CASES[case]
    op = cases.op_of(case)
    port = _run_port(op, ins, attrs)
    _assert_close(_run_ref(op, ins, attrs), port, values=False)
    again = _run_port(op, ins, attrs)
    other = _run_port(op, ins, attrs, seed=1)
    for s in port:
        for a, b in zip(port[s], again[s]):
            assert torch.equal(a, b), s
    main = {"multinomial": "Out", "seed": "Out", "tdm_sampler": "Out",
            "pyramid_hash": "Out"}[op]
    assert not torch.equal(port[main][0], other[main][0])
    out = port[main][0]
    if op == "multinomial":
        x = ins["X"][0]
        assert out.min() >= 0 and out.max() < x.shape[1]
        # a zero probability is never drawn
        assert not (out[1] == 2).any()
        if not attrs["replacement"]:
            for row in out.tolist():
                assert len(set(row)) == len(row)
    elif op == "seed":
        assert 1 <= int(out) < 2 ** 31 - 1
    elif op == "tdm_sampler":
        _check_tdm_sampler(ins, attrs, port)
    else:
        # dropped windows only take rows out: each sequence's sum lies
        # between none and all of its windows' rows
        full = dict(attrs, is_training=0)
        want = _run_port(op, ins, full)["Out"][0]
        assert not torch.equal(out, want)
        no_drop = _run_port(op, ins, dict(attrs, drop_out_percent=0.0))
        assert torch.equal(no_drop["Out"][0], want)


def _check_tdm_sampler(ins, attrs, port):
    """Each layer's positive is the item's travel node (1 / 0 labels);
    each negative is a node of that layer other than the positive; a
    padded path (node 0) gives zeros and a zero mask."""
    x, travel = ins["X"][0].reshape(-1), ins["Travel"][0]
    layer, offs = ins["Layer"][0], attrs["layer_offset_lod"]
    out = port["Out"][0][..., 0].numpy()
    lab = port["Labels"][0][..., 0].numpy()
    mask = port["Mask"][0][..., 0].numpy()
    col = 0
    for li, neg in enumerate(attrs["neg_samples_num_list"]):
        nodes = set(layer[offs[li]:offs[li + 1]].tolist())
        width = neg + attrs["output_positive"]
        for r, item in enumerate(x):
            pos = travel[item, li]
            o = out[r, col:col + width]
            if pos == 0:
                assert not o.any() and not mask[r, col:col + width].any()
                continue
            assert mask[r, col:col + width].all()
            negs = o[1:] if attrs["output_positive"] else o
            if attrs["output_positive"]:
                assert o[0] == pos and lab[r, col] == 1
            assert not lab[r, col + width - neg:col + width].any()
            assert all(v in nodes and v != pos for v in negs)
        col += width


# ---------------------------------------------------------------------------
# the cases the port writes out by hand, named
# ---------------------------------------------------------------------------

def test_pyramid_hash_rows_on_tokens_near_2_31_equal_reference_exactly():
    """FNV-1a in wrapping uint32 over n-grams of tokens near 2**31 and
    negative, then % space_len: the rows the reference's hash picks."""
    from paddle_tpu.ops.dense_tail_ops2 import _fnv1a as ref_fnv1a
    from paddle_tpu_torch.ops.dense_tail_ops2 import _fnv1a
    ins, attrs = CASES["pyramid_hash"]
    x, space = ins["X"][0], attrs["space_len"]
    for ln in (2, 3, 4):
        win = np.stack([x[:, i:x.shape[1] - ln + 1 + i] for i in range(ln)],
                       axis=-1)
        ref = np.asarray(ref_fnv1a(jnp.asarray(win)) % jnp.uint32(space))
        port = (_fnv1a(torch.from_numpy(win).long()) % space).numpy()
        assert np.array_equal(port, ref.astype(np.int64)), ln


@pytest.mark.parametrize("case", ["crf_decoding", "crf_decoding:label",
                                  "crf_decoding:ties"])
def test_viterbi_paths_equal_reference_exactly(case):
    ins, attrs = CASES[case]
    ref = np.asarray(_run_ref("crf_decoding", ins, attrs)["ViterbiPath"][0])
    port = _run_port("crf_decoding", ins, attrs)["ViterbiPath"][0].numpy()
    assert np.array_equal(port, ref)
    if case.endswith("ties"):
        assert not port.any()          # the first maximum, every step


def test_hsigmoid_simple_code_depth_is_exact():
    """The default tree's depth is floor(log2(label + num_classes)) by
    integer compares, exact at the powers of two."""
    from paddle_tpu_torch.ops.dense_tail_ops import _simple_code
    labels = torch.tensor([0, 1, 2, 5, 8191 - 5000, 8192 - 5000])
    node, bit, valid = _simple_code(labels, 5000, 13)
    assert valid.sum(1).tolist() == [12, 12, 12, 12, 12, 13]
    codes = labels + 5000
    for r, code in enumerate(codes.tolist()):
        n = int(valid[r].sum())
        assert node[r, 0] == 0        # every path starts at the root
        assert int(bit[r, n - 1]) == code & 1


# ---------------------------------------------------------------------------
# the builders: layers/nn.py and contrib.layers
# ---------------------------------------------------------------------------

REF = types.SimpleNamespace(prog=ref_program, names=ref_unique_name,
                            L=ref_layers, contrib=ref_contrib.layers,
                            ParamAttr=RefParamAttr, opt=paddle.optimizer,
                            fleet=ref_fleet)
PORT = types.SimpleNamespace(prog=port_program, names=port_unique_name,
                             L=port_layers, contrib=port_contrib.layers,
                             ParamAttr=PortParamAttr, opt=port_optimizer,
                             fleet=port_fleet)


def _builders_nn(ns):
    L = ns.L
    x = L.data(name="x", shape=[6], dtype="float32")
    lab = L.data(name="lab", shape=[1], dtype="int64")
    L.hsigmoid(x, lab, num_classes=6)
    L.hsigmoid(x, lab, num_classes=6, bias_attr=False,
               param_attr=ns.ParamAttr(name="hs_w"))
    table = L.data(name="ptable", shape=[3], dtype="int64")
    code = L.data(name="pcode", shape=[3], dtype="int64")
    L.hsigmoid(x, lab, num_classes=6, path_table=table, path_code=code,
               is_custom=True)
    hyp = L.data(name="hyp", shape=[7], dtype="int64")
    ref = L.data(name="ref", shape=[5], dtype="int64")
    hl = L.data(name="hl", shape=[1], dtype="int64")
    rl = L.data(name="rl", shape=[1], dtype="int64")
    L.edit_distance(hyp, ref, normalized=False, input_length=hl,
                    label_length=rl)
    y = L.data(name="y", shape=[4], dtype="float32")
    L.bilinear_tensor_product(x, y, 3, act="tanh")
    L.bilinear_tensor_product(x, y, 2, bias_attr=False)
    seq = L.data(name="seq", shape=[5, 6], dtype="float32")
    L.add_position_encoding(seq, 0.5, 1.5)
    em = L.data(name="em", shape=[5, 4], dtype="float32")
    tags = L.data(name="tags", shape=[5], dtype="int64")
    lens = L.data(name="lens", shape=[1], dtype="int64")
    L.linear_chain_crf(em, tags, param_attr=ns.ParamAttr(name="crfw"),
                       length=lens)
    L.crf_decoding(em, param_attr=ns.ParamAttr(name="crfw"), length=lens)
    L.crf_decoding(em, param_attr=ns.ParamAttr(name="crfw"), label=tags)
    L.linear_chain_crf(em, tags)


def _builders_contrib(ns):
    L, C = ns.L, ns.contrib
    ids = L.data(name="ids", shape=[2], dtype="int64")
    info = L.data(name="info", shape=[5], dtype="int64",
                  append_batch_size=False)
    C.tdm_child(ids, node_nums=8, child_nums=2, tree_info=info)
    item = L.data(name="item", shape=[1], dtype="int64")
    travel = L.data(name="travel", shape=[2], dtype="int64")
    layer = L.data(name="layer", shape=[1], dtype="int64")
    C.tdm_sampler(item, [1, 2], [2, 4], 4, travel=travel, layer=layer,
                  output_positive=False, seed=3)
    toks = L.data(name="toks", shape=[6], dtype="int64")
    C.search_pyramid_hash(toks, num_emb=4, space_len=40, pyramid_layer=3,
                          rand_len=4, drop_out_percent=0.1,
                          is_training=True, use_filter=False,
                          white_list_len=0, black_list_len=0, seed=1)
    img = L.data(name="img", shape=[2, 6, 7], dtype="float32")
    row = L.data(name="row", shape=[1], dtype="int64")
    col = L.data(name="col", shape=[1], dtype="int64")
    C.var_conv_2d(img, row, col, 2, 3, [3, 3], stride=[1, 2], act="relu")
    feat = L.data(name="feat", shape=[3], dtype="float32")
    off = L.data(name="off", shape=[7], dtype="int64")
    C.rank_attention(feat, off, [27, 4], ns.ParamAttr(name="rank_w"))
    C.correlation(img, img, 1, 3, 2, 1, 1)
    grid = L.data(name="grid", shape=[6, 4, 3, 3], dtype="float32")
    guide = L.data(name="guide", shape=[6, 7], dtype="float32")
    C.bilateral_slice(img, guide, grid, has_offset=True)
    C.similarity_focus(img, 1, [0, 1])


@pytest.mark.parametrize("which", ["nn", "contrib"])
def test_builders_give_the_reference_descs(which):
    build = _builders_nn if which == "nn" else _builders_contrib
    descs = []
    for ns in (REF, PORT):
        main, start = ns.prog.Program(), ns.prog.Program()
        with ns.prog.program_guard(main, start), ns.names.guard():
            build(ns)
        descs.append((main.to_desc(), start.to_desc()))
    assert descs[1] == descs[0]


# ---------------------------------------------------------------------------
# the book's semantic role labeller at a small size
# ---------------------------------------------------------------------------

SMALL = cases.srl_sizes(words=50, predicates=20, labels=9)
SRL_T, SRL_BATCH, STEPS = 10, 4, 3
SRL_WIDTHS = {"word_dim": 8, "mark_dim": 3, "hidden_dim": 32, "depth": 3}


def build_srl(ns, stage=None):
    """(main, startup, test program, loss, Viterbi path, chunk counts) of
    the SRL at SMALL in namespace `ns`: SGD on the book's decay, through
    fleet at ZeRO `stage` when given; the test program cloned before the
    optimizer, with crf_decoding on `crfw` and chunk_eval."""
    L = ns.L
    main, start = ns.prog.Program(), ns.prog.Program()
    with ns.prog.program_guard(main, start), ns.names.guard():
        loss, feature, target, length = cases.srl(
            L, ns.ParamAttr, SRL_T, SMALL, **SRL_WIDTHS)
        test = main.clone(for_test=True)
        lr, steps, rate = cases.SRL_LR
        opt = ns.opt.SGD(learning_rate=L.exponential_decay(
            lr, steps, rate, staircase=True))
        if stage is not None:
            ns.fleet.init(is_collective=True)
            s = ns.fleet.DistributedStrategy()
            s.sharding_stage = stage
            opt = ns.fleet.distributed_optimizer(opt, s)
        opt.minimize(loss)
        with ns.prog.program_guard(test):
            block = test.global_block()
            path = L.crf_decoding(block.var(feature.name),
                                  param_attr=ns.ParamAttr(name="crfw"),
                                  length=block.var(length.name))
            counts = L.chunk_eval(
                path, block.var(target.name), "IOB",
                cases.srl_chunk_types(SMALL["label"]),
                seq_length=block.var(length.name))[3:]
    return main, start, test, loss, path, counts


def srl_params(main):
    return sorted(p.name for p in main.global_block().all_parameters())


@pytest.fixture(scope="module")
def srl_reference():
    """The reference's startup arrays, its losses over STEPS batches, its
    parameters after them, and its test program's paths and chunk counts
    on a fourth batch after them."""
    feeds = cases.srl_feed(STEPS + 1, SRL_BATCH, SRL_T, SMALL)
    main, start, test, loss, path, counts = build_srl(REF)
    scope, exe = RefScope(), fluid.Executor()
    exe.run(start, scope=scope)
    init = {n: np.asarray(scope.find(n)) for n in scope.local_names()
            if not n.startswith("__")}
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope)[0]))
              for f in feeds[:STEPS]]
    final = {n: np.asarray(scope.find(n)) for n in srl_params(main)}
    decoded = [np.asarray(v) for v in exe.run(
        test, feed=feeds[STEPS], fetch_list=[path, *counts], scope=scope)]
    return feeds, init, losses, final, decoded


def srl_port_run(built, init, feeds, window=False):
    main, start, test, loss, path, counts = built
    scope, exe = Scope(), Executor("cpu")
    exe.run(start, scope=scope)
    load_numpy(scope, init, "cpu")
    if window:
        stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
        got = exe.run_steps(len(feeds), main, feed=stacked,
                            fetch_list=[loss], scope=scope)[0]
        return [float(g) for g in got], scope, exe
    return [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scope)[0])) for f in feeds], \
        scope, exe


def test_srl_desc_equals_reference():
    ref, port = build_srl(REF), build_srl(PORT)
    for r, p in zip(ref[:3], port[:3]):
        assert p.to_desc() == r.to_desc()
    ops = [op.type for op in port[0].global_block().ops]
    assert ops.count("lstm") == SRL_WIDTHS["depth"]
    assert ops.count("linear_chain_crf") == 1
    assert ops.count("lookup_table") == 8
    tables = [op for op in port[0].global_block().ops
              if op.type == "lookup_table"]
    assert all(op.attrs["is_sparse"] for op in tables)
    test_ops = [op.type for op in port[2].global_block().ops]
    assert "crf_decoding" in test_ops and "chunk_eval" in test_ops
    assert "sgd" not in test_ops
    # the frozen table takes no update; crfw's rate is scaled
    params = {p.name: p for p in port[0].global_block().all_parameters()}
    assert not params["emb"].trainable
    sgd_params = {op.inputs["Param"][0] for op in port[0].global_block().ops
                  if op.type == "sgd"}
    assert "emb" not in sgd_params and "crfw" in sgd_params


def test_srl_sgd_steps_match_reference(srl_reference):
    feeds, init, want, ref_params, ref_decoded = srl_reference
    built = build_srl(PORT)
    got, scope, exe = srl_port_run(built, init, feeds[:STEPS])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] != got[0]
    for n in srl_params(built[0]):
        np.testing.assert_allclose(scope.numpy(n), ref_params[n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    assert np.array_equal(scope.numpy("emb"), init["emb"])
    assert not np.array_equal(scope.numpy("crfw"), init["crfw"])
    main, start, test, loss, path, counts = built
    decoded = exe.run(test, feed=feeds[STEPS], fetch_list=[path, *counts],
                      scope=scope)
    assert np.array_equal(decoded[0], ref_decoded[0])
    for g, w in zip(decoded[1:], ref_decoded[1:]):
        assert int(np.asarray(g).reshape(-1)[0]) == \
            int(np.asarray(w).reshape(-1)[0])
    assert int(np.asarray(decoded[1]).reshape(-1)[0]) > 0


@pytest.mark.parametrize("arm", ["run_steps", "stage1"])
def test_srl_arms_equal_run_bit_for_bit(arm, srl_reference):
    """run_steps(3) and fleet's ZeRO stage 1 against three Executor.run
    steps of the plain program, bit for bit: losses and parameters. At
    stage 1 the dense parameters are one bucket, `crfw` among them: its
    ParamAttr's learning_rate is stored on the parameter and read by
    neither package's optimizer, so it updates at the decayed rate as the
    rest. The sparse tables stay out on their own `sgd`, and the frozen
    `emb` is in neither."""
    feeds, init = srl_reference[:2]
    plain = build_srl(PORT)
    want, want_scope, _ = srl_port_run(plain, init, feeds[:STEPS])
    if arm == "run_steps":
        got, scope, _ = srl_port_run(plain, init, feeds[:STEPS],
                                     window=True)
    else:
        built = build_srl(PORT, stage=1)
        main = built[0]
        buckets = main._grad_buckets["zero_buckets"]
        bucketed = [set(b["params"]) for b in buckets]
        assert len(bucketed) == 1 and "crfw" in bucketed[0]
        assert not bucketed[0] & {"emb", "vemb"}
        sgd_params = {op.inputs["Param"][0]
                      for op in main.global_block().ops if op.type == "sgd"}
        tables = {op.inputs["W"][0] for op in main.global_block().ops
                  if op.type == "lookup_table"}
        assert sgd_params == tables - {"emb"}
        assert sum(op.type == "__zero_update__"
                   for op in main.global_block().ops) == 1
        got, scope, _ = srl_port_run(built, init, feeds[:STEPS])
    assert got == want
    for n in srl_params(plain[0]):
        assert np.array_equal(scope.numpy(n), want_scope.numpy(n)), n


def test_srl_decode_program_runs_eagerly_under_run_steps(srl_reference):
    """The test program holds chunk_eval (a host read), so run_steps runs
    it eagerly, each step equal to a `run`."""
    feeds, init = srl_reference[:2]
    main, start, test, loss, path, counts = build_srl(PORT)
    scope, exe = Scope(), Executor("cpu")
    exe.run(start, scope=scope)
    load_numpy(scope, init, "cpu")
    want = [exe.run(test, feed=f, fetch_list=[path, counts[2]],
                    scope=scope) for f in feeds[:2]]
    stacked = {n: np.stack([f[n] for f in feeds[:2]]) for n in feeds[0]}
    exe2 = Executor("cpu")
    got = exe2.run_steps(2, test, feed=stacked,
                         fetch_list=[path, counts[2]], scope=scope)
    assert exe2.stats["eager_steps"] == 2 and exe2.stats["captures"] == 0
    for i in range(2):
        assert np.array_equal(got[0][i], want[i][0])
        assert np.array_equal(np.asarray(got[1][i]).reshape(-1),
                              np.asarray(want[i][1]).reshape(-1))
