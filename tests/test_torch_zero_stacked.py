"""PyTorch port, ZeRO stage 3 over a rolled program: the stacked `@LAYERS`
buckets of parallel/zero.py (`_plan_stacked_stage3`,
`_build_zero3_stacked_bucket`, `_zero_update_stacked`) and the layer
scan's per-layer gather and reduce-scatter (parallel/transforms.py), held
against the JAX reference and against rolled stage 0 on the CPU.

* GPT-tiny rolled by fleet's `layer_scan` at stage 3: the program equals
  the reference's desc for desc (main and startup; the reference's desc,
  `zero3_flat` included, round-trips through the port's
  `Program.from_desc`), and every bucket's
  metadata (layout "stacked", `[L, padded]`, `num_layers`, names) equals
  the reference's `_zero_buckets`.
* One process, dropout 0.1: 3 Adam steps of rolled stage 3 equal rolled
  stage 0 bit for bit (losses and the unsharded state); at dropout 0 both
  match the reference's rolled stage 3 from its startup arrays (losses at
  rtol 1e-5 / atol 1e-7, the state at atol 1e-6: tests/
  test_torch_layer_scan.py `PARAM_TOL` says why).
* dp 2 in a gloo gang (`testing.gloo_gang`), each rank 2 rows of a global
  batch of 4: rolled stage 3 equals rolled stage 0 at dp 2 bit for bit,
  with and without `remat`; every step's collectives equal the plan (an
  all-gather per stacked bucket and layer, again in the remat backward,
  and a reduce-scatter per stacked bucket and layer; one of each per flat
  bucket; the loss's mean); a rank's optimizer-state and parameter bytes
  are about half of stage 0's.
* dp 3 does not divide a padding of 64: each rank keeps the full `[L,
  padded]` storage of such a bucket and all-reduces its gradient before
  the update (counted), within rtol 1e-6 of stage 0.
* The stage-3 checkpoint written at dp 2 (gathered first) is the
  unsharded format: it loads into rolled stage 0 in one process and into
  the reference's rolled program, equal to the gang's state, and the next
  step's losses agree.
* The stacked update at dp 2 is one B8 launch over the rank's whole
  `[L, padded/dp]` shard (a 2-D contiguous tensor, pointer and element
  count checked with the numpy stand-in library of
  tests/test_torch_zero_update.py), bit for bit the plain rule's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
from paddle_tpu import io as ref_io
from paddle_tpu.framework.scope import Scope as RefScope

import torch_dist_ranks as ranks
from test_torch_layer_scan import (PARAM_TOL, TOL, _PKGS, feeds,
                                   persistables, ref_run)
from test_torch_zero_update import _StandInLibrary, _torch_ins

from paddle_tpu_torch import io as port_io
from paddle_tpu_torch.framework import Executor, Scope, load_numpy
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.io import _portable_arrays
from paddle_tpu_torch.ops import registry as port_registry
from paddle_tpu_torch.ops.kernels import zero_update as zk
from paddle_tpu_torch.parallel import zero as port_zero
from paddle_tpu_torch.testing import gloo_gang


def build(pkg, stage, dropout=0.0, remat=False, bucket_mb=0.05):
    """GPT-tiny rolled through fleet at ZeRO `stage`, Adam 1e-4."""
    m = _PKGS[pkg]
    main, start = m["prog"].Program(), m["prog"].Program()
    with m["prog"].program_guard(main, start), m["names"].guard():
        cfg = m["gpt"].GPTConfig.tiny()
        cfg.hidden_dropout = cfg.attention_dropout = dropout
        _, loss = m["gpt"].build_lm_program(cfg)
        m["fleet"].init(is_collective=True)
        s = m["fleet"].DistributedStrategy()
        s.layer_scan = True
        s.recompute = remat
        s.sharding_stage = stage
        s.fuse_grad_size_in_mb = bucket_mb
        m["fleet"].distributed_optimizer(
            m["opt"].Adam(learning_rate=1e-4), s).minimize(loss)
    return main, start, loss


def port_steps(main, start, loss, fs, init=None):
    exe, scope = Executor("cpu"), Scope()
    exe.run(start, scope=scope)
    if init is not None:
        port_io.restore_arrays(scope, init, program=main, device="cpu")
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in fs]
    return losses, _portable_arrays(main, scope)


def test_stacked_buckets_and_descs_equal_reference():
    rm, rs, _ = build("ref", 3)
    pm, ps, _ = build("port", 3)
    assert pm.to_desc() == rm.to_desc()
    assert ps.to_desc() == rs.to_desc()
    # `zero3_flat` and the rest of the scan's attrs cross into the port
    assert port_program.Program.from_desc(rm.to_desc()).to_desc() \
        == rm.to_desc()
    got = port_zero.zero_buckets(pm)
    assert got == rm._zero_buckets
    stacked = [b for b in got if b["layout"] == "stacked"]
    L = _PKGS["port"]["gpt"].GPTConfig.tiny().num_layers
    assert len(stacked) == len(pm._layer_stacks)
    assert all(b["num_layers"] == L and b["padded"] % 64 == 0
               for b in stacked)
    scan, = [op for op in pm.global_block().ops
             if op.type == "__layer_scan__"]
    z3 = scan.attrs["zero3_flat"]
    assert sum(z is not None for z in z3) == len(stacked)


def test_rolled_stage3_equals_stage0_and_matches_reference():
    fs = feeds("gpt")
    out = {}
    for stage in (0, 3):
        out[stage] = port_steps(*build("port", stage, dropout=0.1), fs)
    assert out[3][0] == out[0][0]
    assert sorted(out[3][1]) == sorted(out[0][1])
    for n, v in out[0][1].items():
        assert np.array_equal(out[3][1][n], v), n

    rm, rs, rloss = build("ref", 3)
    init, ref_losses, ref_final = ref_run(rm, rs, rloss, fs)
    pm, _, ploss = build("port", 3)
    exe, scope = Executor("cpu"), load_numpy(Scope(), init, "cpu")
    losses = [float(exe.run(pm, feed=f, fetch_list=[ploss],
                            scope=scope)[0]) for f in fs]
    np.testing.assert_allclose(losses, ref_losses, **TOL)
    assert persistables(pm) == sorted(ref_final)
    for n, want in ref_final.items():
        np.testing.assert_allclose(scope.numpy(n), want, err_msg=n,
                                   **PARAM_TOL)


def _plan_calls(arm, L):
    """Collective calls a step at dp 2 from the arm's bucket plan."""
    stacked = [b for b in arm["layouts"] if b[0] == "stacked"]
    flat = [b for b in arm["layouts"] if b[0] == "flat"]
    gathers = len(stacked) * L * (2 if any(arm["scan_remat"]) else 1)
    return {"all_gather.calls": gathers + len(flat),
            "reduce_scatter.calls": len(stacked) * L + sum(
                not b[3] for b in flat),
            "all_reduce.calls": 1 + arm["sync_buckets"]}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero_stacked")
    rm, rs, _ = build("ref", 0)
    scope = RefScope()
    fluid.Executor().run(rs, scope=scope)
    init = {n: np.asarray(scope.find(n)) for n in scope.local_names()
            if not n.startswith("__")}
    rng = np.random.RandomState(5)
    cfg = _PKGS["port"]["gpt"].GPTConfig.tiny()
    tokens = rng.randint(0, cfg.vocab_size, (3, 4, cfg.seq_len)) \
        .astype(np.int64)
    ckpt = str(tmp / "ckpt")
    return init, tokens, ckpt, gloo_gang(ranks.rolled_gpt_suite, 2,
                                         args=(init, tokens, ckpt),
                                         timeout_s=240)


def test_rolled_stage3_dp2_equals_stage0_bitwise(gang):
    _, _, _, res = gang
    for r in res:
        base = r["stage0"]
        for arm in ("stage3", "stage3_remat"):
            got = r[arm]
            assert got["losses"] == base["losses"], arm
            assert sorted(got["state"]) == sorted(base["state"])
            for n, v in base["state"].items():
                assert np.array_equal(got["state"][n], v), (arm, n)
    assert res[0]["stage3"]["losses"] == res[1]["stage3"]["losses"]
    assert res[0]["stage3"]["scan_remat"] == [False]
    assert res[0]["stage3_remat"]["scan_remat"] == [True]


def test_rolled_stage3_dp2_collectives_and_bytes(gang):
    _, _, _, res = gang
    L = _PKGS["port"]["gpt"].GPTConfig.tiny().num_layers
    for r in res:
        for arm in ("stage3", "stage3_remat"):
            want = _plan_calls(r[arm], L)
            for step in r[arm]["calls"]:
                assert {k: step.get(k, 0) for k in want} == want, arm
        s0, s3 = r["stage0"], r["stage3"]
        assert any(b[0] == "stacked" for b in s3["layouts"])
        # half of stage 0's, give or take the 64-element padding
        assert 0.45 < s3["state_bytes"] / s0["state_bytes"] < 0.6
        assert 0.45 < s3["param_bytes"] / s0["param_bytes"] < 0.6


def test_stage3_dp2_checkpoint_loads_into_stage0_and_reference(gang):
    init, tokens, ckpt, res = gang
    state = res[0]["stage3"]["state"]
    nxt = {"tokens": tokens[-1]}

    pm, ps, ploss = build("port", 0, dropout=0.1)
    exe, scope = Executor("cpu"), Scope()
    exe.run(ps, scope=scope)
    port_io.load_persistables(exe, ckpt, pm, scope=scope)
    loaded = _portable_arrays(pm, scope)
    assert sorted(loaded) == sorted(state)
    for n, v in state.items():
        assert np.array_equal(loaded[n], v), n
    port_loss = float(exe.run(pm, feed=nxt, fetch_list=[ploss],
                              scope=scope)[0])

    rm, rs, rloss = build("ref", 0, dropout=0.0)
    rscope = RefScope()
    rexe = fluid.Executor()
    rexe.run(rs, scope=rscope)
    from paddle_tpu.framework import scope as ref_scope_mod
    prev = ref_scope_mod._global_scope
    ref_scope_mod._global_scope = rscope
    try:
        ref_io.load_persistables(rexe, ckpt, rm)
    finally:
        ref_scope_mod._global_scope = prev
    for n in persistables(rm):
        np.testing.assert_array_equal(np.asarray(rscope.find(n)), state[n],
                                      err_msg=n)
    # the port's program at dropout 0 from the same file, one step each
    pm0, ps0, ploss0 = build("port", 0, dropout=0.0)
    exe0, scope0 = Executor("cpu"), Scope()
    exe0.run(ps0, scope=scope0)
    port_io.load_persistables(exe0, ckpt, pm0, scope=scope0)
    want = float(rexe.run(rm, feed=nxt, fetch_list=[rloss],
                          scope=rscope)[0])
    got = float(exe0.run(pm0, feed=nxt, fetch_list=[ploss0],
                         scope=scope0)[0])
    np.testing.assert_allclose(got, want, **TOL)
    assert np.isfinite(port_loss)


def test_indivisible_dp_keeps_full_width_stacked_storage(gang):
    """dp 3 does not divide a padding of 64: every rank keeps the whole
    `[L, padded]` bucket, all-reduces its local gradient before the
    update (counted as `indivisible_padding`), and trains as stage 0
    does (three-way sums may round in another order: rtol 1e-6)."""
    init, tokens = gang[0], gang[1]
    global_batch = np.concatenate([tokens, tokens[:, :2]], axis=1)
    res = gloo_gang(ranks.rolled_indivisible, 3, args=(init, global_batch),
                    timeout_s=240)
    for r in res:
        # a bucket whose padding 3 divides is sharded all the same
        assert r["storage"] == {
            n: [L, p // 3 if p % 3 == 0 else p]
            for n, (L, p) in r["padded"].items()}
        assert any(p % 3 for _, p in r["padded"].values())
        assert r["indivisible"] >= 1
        np.testing.assert_allclose(r["stage3"]["losses"],
                                   r["stage0"]["losses"], rtol=1e-6)
        for n, v in r["stage0"]["state"].items():
            np.testing.assert_allclose(r["stage3"]["state"][n], v, rtol=0,
                                       atol=1e-6, err_msg=n)
    assert res[0]["stage3"]["losses"] == res[2]["stage3"]["losses"]


def test_stacked_update_is_one_b8_launch_over_the_shard(monkeypatch):
    L, padded, dp = 3, 256, 2
    rng = np.random.RandomState(9)

    def shard():
        return rng.randn(L, padded // dp).astype(np.float32)
    ins = {"FlatParam": [shard()], "Grad": [shard()],
           "FlatState": [shard(), np.abs(shard())],
           "LearningRate": [np.asarray([1e-3], np.float32)],
           "Beta1Pow": [np.asarray([0.9 ** 2], np.float32)],
           "Beta2Pow": [np.asarray([0.999 ** 2], np.float32)]}
    attrs = {"update_op": "adam", "update_attrs": {}, "padded": padded,
             "sizes": [200], "shapes": [[10, 20]], "num_layers": L,
             "dtype": "float32", "state_kinds": ["moment1", "moment2"],
             "stage": 3, "layout": "stacked"}
    lib = _StandInLibrary()
    monkeypatch.setattr(zk, "fused_flat_update",
                        lambda op, i, a: zk.launch(lib, op, i, a, 0))
    tins = _torch_ins(ins)
    zk.reset_launches()
    lower = port_registry.get("__zero_update__").lower
    with port_zero._manual_ctx(dp):
        out = lower(None, tins, attrs)
    (name, args), = lib.calls
    assert name == "zero_adam" and zk.launches["zero_adam"] == 1
    p = tins["FlatParam"][0]
    assert args[3] == p.data_ptr() and args[7] == L * padded // dp
    assert out["FlatParamOut"][0] is p and p.shape == (L, padded // dp)
    plain = _torch_ins(ins)
    want = zk.fused_flat_update_plain(
        "adam", {"Param": plain["FlatParam"],
                 "Grad": [plain["Grad"][0] * (1.0 / dp)],
                 "Moment1": [plain["FlatState"][0]],
                 "Moment2": [plain["FlatState"][1]],
                 "LearningRate": plain["LearningRate"],
                 "Beta1Pow": plain["Beta1Pow"],
                 "Beta2Pow": plain["Beta2Pow"]}, {})
    assert torch.equal(p, want["ParamOut"][0])
    assert torch.equal(out["FlatStateOut"][0], want["Moment1Out"][0])
    assert torch.equal(out["FlatGradOut"][0], plain["Grad"][0] * 0.5)
