"""PyTorch port, data parallelism across processes: fleet over gloo CPU
ranks (one process per rank, paddle_tpu_torch.testing.gloo_gang) held
against the reference's manual-dp path on a CPU mesh of as many devices
(tests/torch_dist_reference.py in a `cpu_mesh_env(dp)` subprocess), the
same numpy inputs on both sides. Rank r feeds the r-th contiguous block
of the reference's global batch, which is what `P("dp")` gives shard r.

* The fc regression model of tests/test_distributed.py:47 (x[8] -> fc 16
  relu -> fc 1, square error, mean) at dp 2 and dp 4, ZeRO stages 0-3,
  with Adam, SGD and Momentum, buckets of 0.0003 MB (two buckets), 3
  steps from one numpy init: losses rtol 1e-5 and the final parameters
  atol 1e-5 against the reference (f32; the frameworks sum in other
  orders), every rank's losses equal, and the reference on its manual
  path.
* Stage k == stage 0 bit for bit at dp 2, losses and parameters: a sum
  of two values commutes, whatever collective and bucket layout carry it.
  At dp 4 stages 1, 2 and 3 equal each other bit for bit (one padded
  bucket layout, and gloo's reduce-scatter adds each element's four values
  in the order its all-reduce does), but not stage 0: gloo's all-reduce
  orders an element's four-way sum by where the element falls in its
  buffer, and stage 0's sync buckets are unpadded (33 and 128 elements)
  where the ZeRO buckets are padded (64 and 128), so a gradient sum can
  differ by one rounding. Measured after 3 steps: losses equal, the
  parameters within 1.5e-8 (8 ulp of a bias near zero); held to atol
  1e-7.
* Collectives per step per rank against the plan (the reference's own
  bucket plan, tests/test_collective_budget.py:97): stage 0 one
  all-reduce per bucket plus the loss's mean; stages 1-3 one
  reduce-scatter and one all-gather per bucket plus the loss's mean.
* Optimizer state bytes per rank: the port's `optimizer_state_bytes(dp)`
  equals the reference's and the bytes each rank holds; stage 1 holds
  stage 0's / dp, give or take the 64-element padding.
* dp 3 does not divide the padding: stage 1 runs the update full-width,
  is counted (`indivisible_padding`) and equals stage 0.
* A cross-batch op (batch_norm) in a dp 2 program raises naming its cause.
* run_steps(3) == three run() calls at dp 2, stage 1, bit for bit (the
  reference's tests/test_collective_budget.py:605), every step eager under
  gloo and counted.
* GPT-tiny (dropout 0, Adam 1e-4) at dp 2, stage 1: losses rtol 1e-5 and
  every parameter atol 1e-5 against the reference; B8's width on a shard.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import cpu_mesh_env

import torch_dist_ranks as ranks
from paddle_tpu_torch.testing import gloo_gang

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_dist_reference.py")
STAGES, RULES = range(4), ("adam", "sgd", "momentum")


def fc_init():
    rng = np.random.RandomState(0)
    return {"w1": rng.randn(8, 16).astype(np.float32) * 0.3,
            "b1": rng.randn(16).astype(np.float32) * 0.1,
            "w2": rng.randn(16, 1).astype(np.float32) * 0.3,
            "b2": np.zeros(1, np.float32)}


def fc_batches(rows=8, steps=3, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        xv = rng.randn(rows, 8).astype(np.float32)
        out.append((xv, (xv.sum(1, keepdims=True) * 0.3).astype(np.float32)))
    return out


def gpt_inputs():
    """GPT-tiny weights (every parameter of the port's program, seeded
    numpy) and 3 global batches of 4 x 32 tokens."""
    from paddle_tpu_torch.framework import program as pm, unique_name
    from paddle_tpu_torch.models import gpt
    main, start = pm.Program(), pm.Program()
    with pm.program_guard(main, start), unique_name.guard():
        cfg = gpt.GPTConfig.tiny()
        gpt.build_lm_program(cfg)
    rng = np.random.RandomState(3)
    init = {}
    for p in main.all_parameters():
        shape = tuple(p.shape)
        if p.name.endswith("_scale"):
            init[p.name] = np.ones(shape, np.float32)
        elif len(shape) == 1:
            init[p.name] = (rng.randn(*shape) * 0.02).astype(np.float32)
        else:
            init[p.name] = (rng.randn(*shape) * 0.02).astype(np.float32)
    tokens = rng.randint(0, cfg.vocab_size, (3, 4, cfg.seq_len)) \
        .astype(np.int64)
    return init, tokens


def start_reference(task, dp, tmp, cfg, arrays):
    src, dst = str(tmp / f"{task}{dp}_in.npz"), str(tmp / f"{task}{dp}_out.npz")
    np.savez(src, __json__=json.dumps(cfg), **arrays)
    proc = subprocess.Popen([sys.executable, REF, task, src, dst],
                            env=cpu_mesh_env(dp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, dst


def finish_reference(proc, dst, timeout=300):
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    with np.load(dst) as f:
        data = {n: f[n] for n in f.files}
    return json.loads(str(data.pop("__json__"))), data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    init, batches = fc_init(), fc_batches()
    gpt_init, tokens = gpt_inputs()
    arrays = {f"init/{n}": v for n, v in init.items()}
    arrays["xs"] = np.stack([b[0] for b in batches])
    arrays["ys"] = np.stack([b[1] for b in batches])
    cfg = {"stages": list(STAGES), "rules": list(RULES),
           "bucket_mb": ranks.FC_BUCKET_MB}
    refs = {2: start_reference("fc", 2, tmp, dict(cfg, gpt=True), dict(
                arrays, tokens=tokens,
                **{f"gpt/{n}": v for n, v in gpt_init.items()})),
            4: start_reference("fc", 4, tmp, cfg, arrays)}
    try:
        port = {2: gloo_gang(ranks.dp_suite, 2,
                             args=(init, batches, gpt_init, tokens)),
                4: gloo_gang(ranks.fc_suite, 4, args=(init, batches)),
                3: gloo_gang(ranks.fc_suite, 3,
                             args=(init, fc_batches(rows=12), (0, 1),
                                   ("adam",)))}
        ref = {dp: finish_reference(*p) for dp, p in refs.items()}
    finally:
        for proc, _ in refs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return port, ref


ARMS = [(dp, s, r) for dp in (2, 4) for s in STAGES for r in RULES]


@pytest.mark.parametrize("dp,stage,rule", ARMS,
                         ids=[f"dp{d}-stage{s}-{r}" for d, s, r in ARMS])
def test_fc_matches_reference(runs, dp, stage, rule):
    port, ref = runs
    rj, ra = ref[dp]
    key = f"{stage}_{rule}"
    assert rj["devices"] == dp and rj[key]["manual"]
    got = [r["fc"][key] if "fc" in r else r[key] for r in port[dp]]
    for other in got[1:]:
        assert other["losses"] == got[0]["losses"]
    np.testing.assert_allclose(got[0]["losses"], rj[key]["losses"],
                               rtol=1e-5)
    for n in ranks.FC_PARAMS:
        np.testing.assert_allclose(got[0]["params"][n], ra[f"{key}/{n}"],
                                   rtol=0, atol=1e-5, err_msg=n)


def _arms(port, dp):
    r0 = port[dp][0]
    return r0["fc"] if "fc" in r0 else r0


@pytest.mark.parametrize("rule", RULES)
def test_stage_k_equals_stage0_bitwise(runs, rule):
    arms = _arms(runs[0], 2)
    base = arms[f"0_{rule}"]
    for stage in (1, 2, 3):
        got = arms[f"{stage}_{rule}"]
        assert got["losses"] == base["losses"], stage
        for n in ranks.FC_PARAMS:
            np.testing.assert_array_equal(got["params"][n],
                                          base["params"][n], err_msg=n)


@pytest.mark.parametrize("rule", RULES)
def test_stages_at_dp4(runs, rule):
    arms = _arms(runs[0], 4)
    base, one = arms[f"0_{rule}"], arms[f"1_{rule}"]
    for stage in (2, 3):
        got = arms[f"{stage}_{rule}"]
        assert got["losses"] == one["losses"], stage
        for n in ranks.FC_PARAMS:
            np.testing.assert_array_equal(got["params"][n],
                                          one["params"][n], err_msg=n)
    np.testing.assert_allclose(one["losses"], base["losses"], rtol=1e-6)
    for n in ranks.FC_PARAMS:
        np.testing.assert_allclose(one["params"][n], base["params"][n],
                                   rtol=0, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("stage", STAGES)
def test_collectives_per_step_follow_the_plan(runs, dp, stage):
    port, ref = runs
    rj, _ = ref[dp]
    for rank_out in port[dp]:
        arm = (rank_out["fc"] if "fc" in rank_out else rank_out)[
            f"{stage}_adam"]
        plan = arm["plan"]
        assert plan["sync"] == rj[f"{stage}_adam"]["plan"]["sync"]
        assert plan["zero"] == rj[f"{stage}_adam"]["plan"]["zero"]
        calls = arm["counters"]
        if stage == 0:
            assert plan["zero"] == 0 and plan["sync"] == 2
            want = {"all_reduce.calls": plan["sync"] + 1}
        else:
            assert plan["sync"] == 0 and not any(plan["pre_synced"])
            want = {"reduce_scatter.calls": plan["zero"],
                    "all_gather.calls": plan["zero"],
                    "all_reduce.calls": 1}
        assert calls == want, calls


@pytest.mark.parametrize("dp", [2, 4])
def test_state_bytes_per_rank(runs, dp):
    port, ref = runs
    rj, _ = ref[dp]
    arms = _arms(port, dp)
    for stage in STAGES:
        arm = arms[f"{stage}_adam"]
        assert arm["bytes_plan"] == rj[f"{stage}_adam"]["bytes"], stage
        assert arm["state_bytes"] == \
            arm["bytes_plan"]["state_bytes_per_device"], stage
    full, shard = arms["0_adam"]["state_bytes"], arms["1_adam"]["state_bytes"]
    padding = sum(arms["1_adam"]["plan"]["padded"]) * 4 * 2 - full
    assert shard * dp == full + padding
    assert 0 <= padding < 64 * 4 * 2 * len(arms["1_adam"]["plan"]["padded"])


def test_indivisible_padding_runs_full_width_and_is_counted(runs):
    port, _ = runs
    for rank_out in port[3]:
        assert rank_out["1_adam"]["plan"]["padded"] == [64, 128]
        assert rank_out["fallbacks"][
            "executor.zero_manual_fallbacks.indivisible_padding"] >= 1
        base, got = rank_out["0_adam"], rank_out["1_adam"]
        np.testing.assert_allclose(got["losses"], base["losses"], rtol=1e-6)
        for n in ranks.FC_PARAMS:
            np.testing.assert_allclose(got["params"][n], base["params"][n],
                                       rtol=0, atol=1e-6)
        # the full-width state: nothing sharded
        assert got["state_bytes"] == (64 + 128) * 4 * 2


def test_cross_batch_program_raises_with_its_cause(runs):
    for rank_out in runs[0][2]:
        got = rank_out["cross_batch"]
        assert got["raised"] and "batch_norm" in got["raised"]
        assert got["counted"] == 1


def test_run_steps_equals_runs_at_dp2(runs):
    for rank_out in runs[0][2]:
        runs_, steps = rank_out["run_steps"]["runs"], \
            rank_out["run_steps"]["run_steps"]
        assert runs_["losses"] == steps["losses"]
        assert set(runs_["state"]) == set(steps["state"])
        for n in runs_["state"]:
            np.testing.assert_array_equal(runs_["state"][n],
                                          steps["state"][n], err_msg=n)
        assert steps["eager_steps"] == 3 and steps["uncaptured"] == 3
        assert runs_["uncaptured"] == 0


def test_gpt_tiny_dp2_stage1_matches_reference(runs):
    port, ref = runs
    rj, ra = ref[2]
    assert rj["gpt"]["manual"]
    got = [r["gpt"] for r in port[2]]
    assert got[0]["losses"] == got[1]["losses"]
    np.testing.assert_allclose(got[0]["losses"], rj["gpt"]["losses"],
                               rtol=1e-5)
    for n, v in got[0]["params"].items():
        np.testing.assert_allclose(v, ra[f"gpt/{n}"], rtol=0, atol=1e-5,
                                   err_msg=n)
    assert all(w > 0 for w in got[0]["b8_width"])
