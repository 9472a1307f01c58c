"""ZeRO stages 1-2 with tensor and sequence parallelism in the port
(parallel/zero.py `_lower_zero_update`, parallel/spmd.py `state_specs`,
fleet's bucket pass and attach on a dp x tp x sp mesh).

The port runs in one gloo gang of 4 CPU ranks (tests/torch_mesh_ranks.py
`zero_suite`): tiny GPT at dp 2 x tp 2 and at dp 2 x sp 2 (Ulysses),
tiny BERT at dp 2 x tp 2, each rank feeding the global batch. The
reference runs the same arms in a `cpu_mesh_env(4)` subprocess
(tests/torch_mesh_reference.py), where fleet's mesh is dp 2 x tp 2 (or
dp 2 x sp 2) and GSPMD shards the flat state over dp. Tolerances, as
tests/test_torch_tp.py's:

* 3 Adam steps against the reference: losses within 1e-4 relative, every
  parameter within 1e-4 of the largest element of the reference's;
* stage k against stage 0 on the port's own mesh: bit for bit (f32);
* the fleet descs at dp 2 x tp 2, stages 0-2, equal the reference's, op
  for op (the bucket ops included);
* the flat state a rank holds is its dp half; rank 3 of dp 2 x tp 2 (dp
  coordinate 1) updates the second half of the bucket, not a shard picked
  by its global rank;
* a gradient-merge program at stage 1 takes `zero1_fallback_rules` (its
  accumulators sharded over dp, counted once, as the reference counts it)
  and equals stage 0 bit for bit;
* a stage-1 checkpoint written at dp 2 x tp 2 holds the reference's
  unsharded entries, equal to the reference's arrays after the same steps
  within the parameter tolerance; it loads at one process and at dp 2 x
  tp 2 to the arrays it holds.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import cpu_mesh_env

import torch_mesh_ranks as ranks
from paddle_tpu_torch.testing import gloo_gang

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_mesh_reference.py")
RTOL = 1e-4
REF_ARMS = {
    "gpt_tp_s1": ("gpt", {"tensor_parallel_degree": 2, "sharding_stage": 1},
                  True),
    "gpt_tp_s2": ("gpt", {"tensor_parallel_degree": 2, "sharding_stage": 2},
                  False),
    "gpt_sp_s1": ("gpt", {"sequence_parallel_degree": 2, "sp_mode": "ulysses",
                          "sharding_stage": 1}, False),
    "gpt_sp_s2": ("gpt", {"sequence_parallel_degree": 2, "sp_mode": "ulysses",
                          "sharding_stage": 2}, False),
    "bert_tp_s1": ("bert", {"tensor_parallel_degree": 2, "sharding_stage": 1},
                   False),
}


def start_reference(tmp, arms, arrays, n_devices):
    """The reference subprocess over `arms` {name: (kind, strategy,
    checkpoint)}; returns (Popen, output path)."""
    src, dst = str(tmp / "ref_in.npz"), str(tmp / "ref_out.npz")
    spec = {name: {"kind": kind, "strategy": st, "checkpoint": ck,
                   "feeds": kind}
            for name, (kind, st, ck) in arms.items()}
    np.savez(src, __json__=json.dumps({"arms": spec}), **arrays)
    proc = subprocess.Popen([sys.executable, REF, src, dst],
                            env=cpu_mesh_env(n_devices),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, dst


def finish_reference(proc, dst):
    """(losses by arm, arrays) of a finished reference run."""
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-4000:]
    with np.load(dst) as f:
        arrays = {n: f[n] for n in f.files}
    return json.loads(str(arrays.pop("__json__"))), arrays


def reference_inputs(gpt, bert=None):
    """The reference's input arrays: weights and stacked feeds."""
    arrays = {}
    for kind, pair in (("gpt", gpt), ("bert", bert)):
        if pair is None:
            continue
        init, feeds = pair
        arrays.update({f"{kind}/{n}": v for n, v in init.items()})
        for k in feeds[0]:
            arrays[f"{kind}:{k}"] = np.stack([f[k] for f in feeds])
    return arrays


def assert_params_close(got, want, names=None):
    """Every parameter within RTOL of the largest element of `want`'s."""
    for n in names or want:
        scale = max(float(np.abs(want[n]).max()), 1e-30)
        np.testing.assert_allclose(got[n], want[n], rtol=0,
                                   atol=RTOL * scale, err_msg=n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from test_torch_tp import _model_init
    tmp = tmp_path_factory.mktemp("zero_tp")
    gpt = _model_init("gpt", 3)
    bert = _model_init("bert", 4)
    proc, dst = start_reference(tmp, REF_ARMS, reference_inputs(gpt, bert),
                                4)
    try:
        ckpt = str(tmp / "ckpt")
        port = gloo_gang(ranks.zero_suite, 4,
                         args=(gpt[0], gpt[1], bert[0], bert[1], ckpt),
                         timeout_s=600)
        ref, ref_arrays = finish_reference(proc, dst)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"port": port, "ref": ref, "ref_arrays": ref_arrays,
            "ckpt": ckpt, "gpt": gpt}


def _ref_params(runs, arm):
    prefix = f"{arm}/"
    return {n[len(prefix):]: v for n, v in runs["ref_arrays"].items()
            if n.startswith(prefix) and "/ckpt/" not in n}


@pytest.mark.parametrize("arm", sorted(REF_ARMS))
def test_three_steps_match_reference(runs, arm):
    want = runs["ref"][arm]
    ref_params = _ref_params(runs, arm)
    for r in runs["port"]:
        got = r[arm]
        np.testing.assert_allclose(got["losses"], want, rtol=RTOL, atol=0)
        assert_params_close(got["params"], ref_params)


@pytest.mark.parametrize("arm", ["gpt_tp_s1", "gpt_tp_s2", "gpt_sp_s1",
                                 "gpt_sp_s2", "bert_tp_s1", "gpt_merge_s1"])
def test_stage_k_equals_stage0_bitwise(runs, arm):
    base = arm[:-1] + "0"
    for r in runs["port"]:
        assert r[arm]["losses"] == r[base]["losses"]
        for n, v in r[base]["params"].items():
            assert np.array_equal(r[arm]["params"][n], v), n


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_descs_equal_reference(runs, stage):
    """The fleet-built program at dp 2 x tp 2 (the reference's in this
    process: conftest's 8 CPU devices, fleet's dp takes 4)."""
    import jax
    import paddle_tpu.fluid as fluid
    from paddle_tpu.distributed import fleet
    from paddle_tpu.models import gpt
    from paddle_tpu.testing import reset_programs
    import paddle_tpu as paddle
    assert jax.device_count() >= 4
    reset_programs(0)
    _, loss = gpt.build_lm_program(gpt.GPTConfig.tiny())
    fleet.init(is_collective=True)
    s = fleet.DistributedStrategy()
    s.tensor_parallel_degree = 2
    s.tensor_parallel_rules = gpt.tp_sharding_rules()
    s.sharding_stage = stage
    fleet.distributed_optimizer(paddle.optimizer.Adam(learning_rate=1e-3),
                                s).minimize(loss)
    ref_desc = fluid.default_main_program().to_desc()
    port_desc = runs["port"][0][f"gpt_tp_s{stage}"]["desc"]
    r_ops, p_ops = ref_desc["blocks"][0]["ops"], port_desc["blocks"][0]["ops"]
    assert [o["type"] for o in p_ops] == [o["type"] for o in r_ops]
    for r, p in zip(r_ops, p_ops):
        assert p == r, (r["type"], r, p)
    assert port_desc == ref_desc
    types = [o["type"] for o in p_ops]
    assert ("__zero_update__" in types) == (stage > 0)
    assert "__bucket_sync__" in types


@pytest.mark.parametrize("mesh", ["tp", "sp"])
def test_flat_state_is_a_dp_half_and_shards_by_dp_coordinate(runs, mesh):
    """Stage 1: the specs name every flat var over dp; a rank holds half
    of the flat state (and so less than stage 0's); its B8 update runs on
    the [padded/2] slice at its dp coordinate."""
    for rank, r in enumerate(runs["port"]):
        s0, s1 = r[f"gpt_{mesh}_s0"], r[f"gpt_{mesh}_s1"]
        assert s1["state_specs"] and set(s1["state_specs"].values()) \
            == {("dp",)}
        padded, = s1["padded"]
        half = padded // 2
        assert s1["state_bytes"] < s0["state_bytes"]
        assert s1["state_bytes"] == 2 * half * 4 + 0
        dp_coord = rank // 2
        assert s1["update_shards"] == [(dp_coord * half, half)] * 3


def test_gradient_merge_takes_the_fallback_rules(runs):
    """gm k 2 at stage 1 declines the bucket pass: counted once under
    grad_merge (as the reference's minimize counts it), and the
    per-parameter accumulators are sharded over dp by the fallback rows."""
    from paddle_tpu.distributed import fleet
    from paddle_tpu.models import gpt
    from paddle_tpu.monitor import stat_get
    from paddle_tpu.testing import reset_programs
    import paddle_tpu as paddle
    reset_programs(0)
    before = stat_get("executor.zero_manual_fallbacks.grad_merge") or 0
    _, loss = gpt.build_lm_program(gpt.GPTConfig.tiny())
    fleet.init(is_collective=True)
    s = fleet.DistributedStrategy()
    s.tensor_parallel_degree = 2
    s.tensor_parallel_rules = gpt.tp_sharding_rules()
    s.sharding_stage = 1
    s.gradient_merge = True
    s.gradient_merge_configs = {"k_steps": 2, "avg": True}
    fleet.distributed_optimizer(paddle.optimizer.Adam(learning_rate=1e-3),
                                s).minimize(loss)
    ref_count = (stat_get("executor.zero_manual_fallbacks.grad_merge")
                 or 0) - before
    for r in runs["port"]:
        gm0, gm1 = r["gpt_merge_s0"], r["gpt_merge_s1"]
        assert gm1["fallbacks"] == ref_count == 1
        assert gm0["fallbacks"] == 0
        assert gm1["moment_placements"] == ["Shard(dim=0)", "Replicate()"]
        assert gm0["moment_placements"] == ["Replicate()", "Shard(dim=1)"]


def test_stage1_checkpoint_round_trip(runs):
    """The stage-1 checkpoint of dp 2 x tp 2: the reference's unsharded
    entries (no flat bucket var), equal to the reference's checkpoint
    arrays after the same 3 steps; loaded into a one-process stage-1
    program and at dp 2 x tp 2, the arrays it holds."""
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.framework.scope import to_numpy
    from paddle_tpu_torch.resilience import CheckpointManager
    mgr = CheckpointManager(runs["ckpt"], max_keep=1)
    saved = mgr.load_arrays(mgr.latest_valid()[0])
    prefix = "gpt_tp_s1/ckpt/"
    want = {n[len(prefix):]: v for n, v in runs["ref_arrays"].items()
            if n.startswith(prefix)}
    port_keys = {n for n in saved if not n.startswith("__")}
    assert port_keys == {n for n in want if not n.startswith("__")}
    assert_params_close(saved, want, sorted(port_keys))
    # one process, stage 1: the flat state packed from the entries
    main, start, _ = ranks.build(stage=1)
    scope, exe = Scope(), Executor("cpu")
    exe.run(start, scope=scope)
    mgr.restore_latest(program=main, scope=scope, executor=exe)
    exe._prepare(main, scope)
    for p in main.all_parameters():
        assert np.array_equal(to_numpy(scope.find(p.name)), saved[p.name])
    from paddle_tpu_torch.io import checkpoint_arrays
    back = checkpoint_arrays(main, scope)
    for n in port_keys:
        assert np.array_equal(back[n], saved[n]), n
    for r in runs["port"]:
        for n, v in r["reloaded"].items():
            assert np.array_equal(v, saved[n]), n
        padded, = r["gpt_tp_s1"]["padded"]
        assert r["reloaded_flat_local"] == padded // 2
