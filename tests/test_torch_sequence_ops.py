"""PyTorch port, the LoD and sequence lowerings: paddle_tpu_torch's
ops/lod_ops.py (10 op types) and ops/sequence_ops.py (19) held against
the JAX reference's lowerings on the CPU, on the same numpy inputs.

* One case or more per op type (ragged lengths, a zero length where the
  op defines one, `is_reverse`, H0 / C0, the GRU's two bias conventions,
  every pooling type; arrays as (buffer, length) pairs): integer and
  bool outputs exactly, f32 within rtol 1e-5 / atol 1e-6.
* The gradients of the differentiable ones: torch.func.vjp over the
  port's lowering (the generic `__vjp__` op) against jax.vjp over the
  reference's, with the same cotangents, rtol 1e-5 / atol 1e-6.
* The set of op types is pinned: every type the reference registers in
  its lod_ops.py, sequence_ops.py and layers/control_flow.py is
  registered in the port, and every lod / sequence type has a case here.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import registry as ref_registry

from paddle_tpu_torch.framework.dtype import dtype_name
from paddle_tpu_torch.ops import registry as port_registry

TOL = dict(rtol=1e-5, atol=1e-6)
B, T = 4, 6
LENS = np.array([[3], [6], [1], [4]], np.int64)


def _f(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _table(lens):
    idx = np.array(sorted(range(len(lens)), key=lambda i: -int(lens[i])),
                   np.int32)
    return np.stack([idx, np.asarray(lens).reshape(-1)[idx]],
                    1).astype(np.int32)


class Arr:
    """A LoDTensorArray input: (buffer, length)."""

    def __init__(self, buf, length):
        self.buf, self.length = buf, length


def _to_ref(a):
    if isinstance(a, Arr):
        return (jnp.asarray(a.buf), jnp.asarray(a.length, jnp.int32))
    return jnp.asarray(a)


def _to_port(a):
    """A numpy input as the executor hands it over: int64 as int32 (the
    device policy, framework/dtype.py)."""
    if isinstance(a, Arr):
        return (torch.from_numpy(a.buf.copy()),
                torch.tensor(a.length, dtype=torch.int32))
    a = np.array(a)
    return torch.from_numpy(a.astype(np.int32) if a.dtype == np.int64
                            else a)


def run_ref(op, ins, attrs):
    ctx = ref_registry.LowerCtx(rng_key=jax.random.key(0))
    return ref_registry.get(op).lower(
        ctx, {s: [_to_ref(a) for a in vs] for s, vs in ins.items()},
        dict(attrs))


def run_port(op, ins, attrs):
    ctx = port_registry.LowerCtx(run_seed=0, device="cpu")
    return port_registry.get(op).lower(
        ctx, {s: [_to_port(a) for a in vs] for s, vs in ins.items()},
        dict(attrs))


def assert_same(r, p, what):
    if isinstance(r, tuple):
        assert isinstance(p, tuple), what
        for k, (a, b) in enumerate(zip(r, p)):
            assert_same(a, b, f"{what}[{k}]")
        return
    if r is None:
        assert p is None, what
        return
    rv = np.asarray(r)
    pv = p.detach().numpy()
    assert pv.shape == rv.shape, (what, pv.shape, rv.shape)
    assert dtype_name(p.dtype) == np.dtype(rv.dtype).name, what
    if np.issubdtype(rv.dtype, np.floating):
        np.testing.assert_allclose(pv, rv, err_msg=what, **TOL)
    else:
        np.testing.assert_array_equal(pv, rv, err_msg=what)


def _lstm_ins(reverse=False, init=False):
    ins = {"Input": [_f(B, T, 16)], "Weight": [_f(4, 16, seed=1) * 0.5],
           "Bias": [_f(16, seed=2)], "SeqLen": [LENS]}
    if init:
        ins["H0"], ins["C0"] = [_f(B, 4, seed=3)], [_f(B, 4, seed=4)]
    return ins, {"is_reverse": reverse}


def _gru_ins(bias_hh=False, origin=False):
    ins = {"Input": [_f(B, T, 12)], "Weight": [_f(4, 12, seed=1) * 0.5],
           "Bias": [_f(12, seed=2)], "SeqLen": [LENS],
           "H0": [_f(B, 4, seed=3)]}
    if bias_hh:
        ins["BiasHH"] = [_f(12, seed=5)]
    return ins, {"origin_mode": origin}


def _cases():
    table = _table(LENS)
    ties = np.array([[3], [6], [3], [4]], np.int64)
    pool_lens = np.array([[3], [6], [0], [4]], np.int64)
    rank_buf = _f(T, B, 3, seed=6)
    mask = np.array([[True], [False], [True], [True], [False]])
    ids = np.random.RandomState(7).randint(0, 9, (B, T)).astype(np.int64)
    c = {
        # lod_ops
        "lod_rank_table": ({"X": [_f(B, T, 3)], "Length": [ties]}, {}),
        "max_sequence_len": ({"RankTable": [table]}, {}),
        "lod_tensor_to_array": ({"X": [_f(B, T, 3)], "RankTable": [table]},
                                {}),
        "array_to_lod_tensor": ({"X": [Arr(rank_buf, T)],
                                 "RankTable": [table]}, {"max_len": T}),
        "array_to_lod_tensor:trim": ({"X": [Arr(_f(T + 3, B, 2), T)],
                                      "RankTable": [table]}, {"max_len": T}),
        "shrink_rnn_memory": ({"X": [_f(B, 5)], "RankTable": [table],
                               "I": [np.array([2], np.int64)]}, {}),
        "split_lod_tensor": ({"X": [_f(5, 3)], "Mask": [mask]}, {}),
        "merge_lod_tensor": ({"InTrue": [_f(5, 3)],
                              "InFalse": [_f(5, 3, seed=1)],
                              "X": [_f(5, 3, seed=2)], "Mask": [mask]}, {}),
        "reorder_lod_tensor_by_rank": ({"X": [_f(B, 3)],
                                        "RankTable": [table]}, {}),
        "lod_array_length": ({"X": [Arr(rank_buf, 5)]}, {}),
        "tensor_array_to_tensor:stack": ({"X": [Arr(rank_buf, T)]},
                                         {"axis": 1, "use_stack": True}),
        "tensor_array_to_tensor:concat": ({"X": [Arr(rank_buf, T)]},
                                          {"axis": 0, "use_stack": False}),
        "tensor_array_to_tensor:neg": ({"X": [Arr(rank_buf, T)]},
                                       {"axis": -1, "use_stack": False}),
        # sequence_ops
        "sequence_mask": ({"X": [LENS]}, {"maxlen": T}),
        "sequence_mask:f32": ({"X": [LENS]}, {"maxlen": 8,
                                              "out_dtype": "float32"}),
        "sequence_softmax": ({"X": [_f(B, T)], "SeqLen": [LENS]}, {}),
        "sequence_softmax:3d": ({"X": [_f(B, T, 1)], "SeqLen": [LENS]}, {}),
        "sequence_reverse": ({"X": [_f(B, T, 3)], "SeqLen": [LENS]}, {}),
        "sequence_expand_as": ({"X": [_f(B, 3)], "Y": [_f(B, T, 2)],
                                "SeqLen": [LENS]}, {}),
        "sequence_pad": ({"X": [_f(B, T, 2)], "SeqLen": [LENS],
                          "PadValue": [np.array([-9.0], np.float32)]}, {}),
        "sequence_pad:zero": ({"X": [_f(B, T, 2)], "SeqLen": [LENS]}, {}),
        "sequence_unpad": ({"X": [_f(B, T, 2)], "Length": [LENS]}, {}),
        "sequence_concat": ({"X": [_f(B, T, 2), _f(B, 4, 2, seed=1)],
                             "SeqLens": [LENS, np.array([2, 4, 0, 1])]},
                            {}),
        "sequence_conv": ({"X": [_f(B, T, 3)], "Filter": [_f(9, 5, seed=1)],
                           "SeqLen": [LENS]}, {"context_length": 3}),
        "sequence_conv:start": ({"X": [_f(B, T, 3)],
                                 "Filter": [_f(12, 5, seed=1)],
                                 "SeqLen": [LENS]},
                                {"context_length": 4, "context_start": -3}),
        "lstm": _lstm_ins(),
        "lstm:reverse": _lstm_ins(reverse=True),
        "lstm:init": _lstm_ins(init=True),
        "gru": _gru_ins(),
        "gru:origin": _gru_ins(origin=True),
        "gru:bias_hh": _gru_ins(bias_hh=True),
        "simple_rnn": ({"Input": [_f(B, T, 5)],
                        "Weight": [_f(5, 5, seed=1) * 0.5],
                        "Bias": [_f(5, seed=2)], "SeqLen": [LENS]}, {}),
        "sequence_slice": ({"X": [_f(B, T, 2)],
                            "Offset": [np.array([[0], [2], [1], [5]])],
                            "Length": [np.array([[3], [4], [0], [1]])]}, {}),
        "sequence_erase": ({"X": [ids], "SeqLen": [LENS]},
                           {"tokens": [2, 5]}),
        "sequence_scatter": ({"X": [_f(B, 7)],
                              "Ids": [ids % 7],
                              "Updates": [_f(B, T, seed=1)],
                              "SeqLen": [LENS]}, {}),
        "sequence_enumerate": ({"X": [ids], "SeqLen": [LENS]},
                               {"win_size": 3, "pad_value": 0}),
        "sequence_reshape": ({"X": [_f(B, T, 4)], "SeqLen": [LENS]},
                             {"new_dim": 2}),
        "sequence_reshape:wide": ({"X": [_f(B, T, 4)], "SeqLen": [LENS]},
                                  {"new_dim": 8}),
        "sequence_expand": ({"X": [_f(B, 3)], "Y": [_f(B, T, 1)],
                             "YSeqLen": [LENS]}, {}),
        "sequence_expand:3d": ({"X": [_f(B, 3, 2)], "Y": [_f(B, T, 1)],
                                "SeqLen": [np.array([2, 3, 1, 0])],
                                "YSeqLen": [LENS]}, {}),
        "sequence_topk_avg_pooling": ({"X": [_f(2, 2, 3, 5)],
                                       "COLUMN": [np.array([4, 2])]},
                                      {"topks": [1, 3]}),
    }
    for ptype in ("sum", "average", "sqrt", "max", "first", "last"):
        c[f"sequence_pool:{ptype}"] = (
            {"X": [_f(B, T, 3)], "SeqLen": [pool_lens]},
            {"pool_type": ptype, "pad_value": -7.0})
    c["sequence_pool:full"] = ({"X": [_f(B, T, 3)]},
                               {"pool_type": "average"})
    return c


CASES = _cases()


def _op(case):
    return case.split(":")[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_lowering_matches_reference(case):
    ins, attrs = CASES[case]
    ref = run_ref(_op(case), ins, attrs)
    port = run_port(_op(case), ins, attrs)
    assert set(port) == set(ref)
    for slot in ref:
        assert len(port[slot]) == len(ref[slot]), slot
        for k, (r, p) in enumerate(zip(ref[slot], port[slot])):
            assert_same(r, p, f"{slot}[{k}]")


VJP_CASES = sorted(c for c in CASES if _op(c) in {
    "sequence_pool", "sequence_softmax", "sequence_reverse",
    "sequence_expand_as", "sequence_pad", "sequence_unpad",
    "sequence_concat", "sequence_conv", "lstm", "gru", "simple_rnn",
    "sequence_slice", "sequence_scatter", "sequence_reshape",
    "sequence_expand", "sequence_topk_avg_pooling", "shrink_rnn_memory",
    "split_lod_tensor", "merge_lod_tensor", "reorder_lod_tensor_by_rank"})


@pytest.mark.parametrize("case", VJP_CASES)
def test_vjp_matches_reference(case):
    """The generic `__vjp__` op over every floating input outside the
    op's nondiff slots, with seeded cotangents on every floating output."""
    ins, attrs = CASES[case]
    op = _op(case)
    outs = run_ref(op, ins, attrs)
    out_slots = [s for s, vs in outs.items()
                 if any(v is not None and jnp.issubdtype(v.dtype,
                                                         jnp.floating)
                        for v in vs)]
    nondiff = ref_registry.get(op).nondiff_slots
    diff = [(s, i) for s, vs in ins.items() if s not in nondiff
            for i, a in enumerate(vs)
            if np.issubdtype(np.asarray(a).dtype, np.floating)]
    rng = np.random.RandomState(1)
    vjp_ins = dict(ins)
    for s in out_slots:
        vjp_ins[f"OG:{s}"] = [rng.randn(*o.shape).astype(np.float32)
                              for o in outs[s]]
    fake_op = type("Op", (), {
        "type": op, "attrs": dict(attrs),
        "inputs": {s: [f"{s}{i}" for i in range(len(v))]
                   for s, v in ins.items()},
        "outputs": {s: [f"o{s}{i}" for i in range(len(outs[s]))]
                    for s in out_slots}})
    vattrs = ref_registry.make_vjp_attrs(fake_op, diff, out_slots)
    ref = run_ref("__vjp__", vjp_ins, vattrs)
    port = run_port("__vjp__", vjp_ins, vattrs)
    assert set(port) == set(ref)
    for slot in ref:
        for k, (r, p) in enumerate(zip(ref[slot], port[slot])):
            assert_same(r, p, f"{slot}[{k}]")


def test_sequence_mask_needs_a_static_maxlen():
    for run in (run_ref, run_port):
        with pytest.raises(ValueError, match="static maxlen"):
            run("sequence_mask", {"X": [LENS]}, {"maxlen": -1})


def test_every_lod_and_sequence_op_type_has_a_case():
    """The reference's lod_ops.py (10 types) and sequence_ops.py (19) are
    all covered here, and with control_flow.py's 8 all registered in the
    port."""
    root = pathlib.Path(ref_registry.__file__).parent.parent

    def types(path):
        return set(re.findall(r'register\("(\w+)"', (root / path)
                              .read_text()))
    lod, seq = types("ops/lod_ops.py"), types("ops/sequence_ops.py")
    flow = types("layers/control_flow.py")
    assert (len(lod), len(seq), len(flow)) == (10, 19, 8)
    assert {_op(c) for c in CASES} == lod | seq
    assert all(port_registry.has(t) for t in lod | seq | flow)
