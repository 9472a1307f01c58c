"""PyTorch port, LocalSGD (distributed/fleet/base.py `localsgd`,
framework/executor.py `_LocalSGDStep`) held against the reference's
`_LocalSGDBlock` (paddle_tpu/framework/executor.py:219) on a dp 2 CPU
mesh, as tests/test_strategies.py:37 runs it
(tests/torch_localsgd_reference.py in a `cpu_mesh_env(2)` subprocess),
and the port on two gloo CPU ranks (`testing.gloo_gang`,
tests/torch_localsgd_ranks.py), the same numpy inputs on both sides.

* The fc model and GPT-tiny (dropout 0) at dp 2, k 2 and 4, SGD and
  Adam, 5 steps from one numpy init, every rank feeding the global batch:
  losses rtol 1e-5, the synced view after every step and each rank's
  copy at the end atol 1e-5 (the tolerance tests/test_torch_dp.py holds
  dp 2 to), and both ranks' losses and views equal.
* Between syncs the scope keeps the last synced view: it changes only on
  every k-th step, and there both ranks' copies equal it.
* The dataset path: `train_from_dataset` (steps_per_loop 3) ends where
  `exe.run` step by step ends, bit for bit.
* At dp 2 the program has no explicit collective op and stamps one
  `__step_sync__` marker a dispatch; a sharding request on a LocalSGD
  program takes no bucket and counts
  `executor.zero_manual_fallbacks.localsgd`, as the reference's does.
* tp, sp, pp and a pipeline refuse LocalSGD, with the reference's text;
  an indivisible feed raises with the reference's text.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import cpu_mesh_env

import torch_localsgd_ranks as ranks
from paddle_tpu_torch.testing import gloo_gang

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_localsgd_reference.py")
ARMS = [(m, r, k) for m in ("fc", "gpt") for r in ("sgd", "adam")
        for k in (2, 4)]
STEPS = 5


def fc_inputs():
    rng = np.random.RandomState(0)
    init = {"w1": rng.randn(8, 16).astype(np.float32) * 0.3,
            "b1": rng.randn(16).astype(np.float32) * 0.1,
            "w2": rng.randn(16, 1).astype(np.float32) * 0.3,
            "b2": np.zeros(1, np.float32)}
    xs = rng.randn(STEPS, 8, 8).astype(np.float32)
    ys = (xs.sum(2, keepdims=True) * 0.3).astype(np.float32)
    return init, [(x, y) for x, y in zip(xs, ys)]


def gpt_inputs():
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
        init[p.name] = (np.ones(shape, np.float32)
                        if p.name.endswith("_scale")
                        else (rng.randn(*shape) * 0.02).astype(np.float32))
    tokens = rng.randint(0, cfg.vocab_size, (STEPS, 4, cfg.seq_len)) \
        .astype(np.int64)
    return init, tokens


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("localsgd")
    fc_init, fc_batches = fc_inputs()
    gpt_init, tokens = gpt_inputs()
    src, dst = str(tmp / "in.npz"), str(tmp / "out.npz")
    arrays = {f"fc/{n}": v for n, v in fc_init.items()}
    arrays.update({f"gpt/{n}": v for n, v in gpt_init.items()})
    np.savez(src, __json__=json.dumps({"arms": ARMS}),
             xs=np.stack([b[0] for b in fc_batches]),
             ys=np.stack([b[1] for b in fc_batches]), tokens=tokens,
             **arrays)
    proc = subprocess.Popen([sys.executable, REF, src, dst],
                            env=cpu_mesh_env(2), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        port = gloo_gang(ranks.suite, 2, timeout_s=300,
                         args=(ARMS, fc_init, fc_batches, gpt_init,
                               list(tokens)))
        out, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    with np.load(dst) as f:
        data = {n: f[n] for n in f.files}
    return port, json.loads(str(data.pop("__json__"))), data


def _key(arm):
    return "{}_{}_k{}".format(*arm)


@pytest.mark.parametrize("arm", ARMS, ids=[_key(a) for a in ARMS])
def test_matches_reference(runs, arm):
    port, ref, ref_copies = runs
    key = _key(arm)
    r0, r1 = (p[key] for p in port)
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], ref[key]["losses"], rtol=1e-5)
    for step in range(STEPS):
        for n, want in ref[key]["views"][step].items():
            for r in (r0, r1):
                np.testing.assert_array_equal(r["views"][step][n],
                                              r0["views"][step][n])
            np.testing.assert_allclose(r0["views"][step][n], want, rtol=0,
                                       atol=1e-5, err_msg=f"{n} @ {step}")
    for rank, r in enumerate((r0, r1)):
        for n, got in r["copies"].items():
            np.testing.assert_allclose(got, ref_copies[f"{key}/{n}"][rank],
                                       rtol=0, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("arm", ARMS, ids=[_key(a) for a in ARMS])
def test_scope_keeps_the_synced_view_between_syncs(runs, arm):
    port, ref, _ = runs
    model, rule, k = arm
    init = fc_inputs()[0] if model == "fc" else None
    for r in port:
        got = r[_key(arm)]
        assert got["step"] == STEPS
        views = got["views"]
        for step in range(STEPS):
            prev = (init if step == 0 else views[step - 1])
            changed = any(not np.array_equal(views[step][n], prev[n])
                          for n in views[step]) if prev is not None \
                else None
            if prev is not None:
                assert changed == ((step + 1) % k == 0), (step, k)
        # the last step (5) is local at k 2 and 4: the copies moved on
        assert any(not np.array_equal(got["copies"][n], got["view"][n])
                   for n in got["view"])
    # after the last sync every view equals the reference's there
    last_sync = (STEPS // k) * k - 1
    for n, want in ref[_key(arm)]["views"][last_sync].items():
        np.testing.assert_allclose(port[0][_key(arm)]["views"][last_sync][n],
                                   want, rtol=0, atol=1e-5)


def test_train_from_dataset_equals_runs_step_by_step(runs):
    port, _, _ = runs
    for r in port:
        got, want = r["dataset"], r["fc_adam_k2"]
        assert got["losses"][-1] == want["losses"][-1]
        assert got["step"] == want["step"] == STEPS
        for n in want["view"]:
            np.testing.assert_array_equal(got["view"][n], want["view"][n])
            np.testing.assert_array_equal(got["copies"][n],
                                          want["copies"][n])


def test_step_sync_marker_and_sharding_fallback(runs):
    port, _, _ = runs
    for r in port:
        assert [tuple(p) for p in r["fc_adam_k2"]["plan"]] == \
            [("__step_sync__", 0)]
        assert r["fc_adam_k2"]["buckets"] == 0
        assert r["sharded"] == {"fallbacks": 1, "buckets": 0,
                                "grad_buckets": False}
    assert [r["rank"] for r in port] == [0, 1]


def test_sharding_request_falls_back_as_the_reference_does():
    """One process: the reference's fleet counts the same fallback and
    leaves the LocalSGD program without ZeRO buckets."""
    import paddle_tpu as paddle
    import paddle_tpu.fluid as fluid
    from paddle_tpu.distributed import fleet as ref_fleet
    from paddle_tpu.monitor import stat_get
    from paddle_tpu.testing import reset_programs
    from paddle_tpu_torch.observability import metrics
    reset_programs(0)
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    loss = fluid.layers.mean(fluid.layers.fc(x, 1))
    ref_fleet.init(is_collective=True)
    s = ref_fleet.DistributedStrategy()
    s.localsgd, s.localsgd_configs, s.sharding_stage = True, \
        {"k_steps": 2}, 1
    before = stat_get("executor.zero_manual_fallbacks.localsgd") or 0
    ref_fleet.distributed_optimizer(paddle.optimizer.Adam(1e-2),
                                    s).minimize(loss)
    prog = fluid.default_main_program()
    assert prog._localsgd_k == 2
    assert not getattr(prog, "_zero_buckets", None)
    assert stat_get("executor.zero_manual_fallbacks.localsgd") == \
        before + 1
    metrics.reset("executor.zero_manual_fallbacks.localsgd")
    _, port_prog, _ = ranks.build("fc", "adam", 2, stage=1)
    assert port_prog._localsgd_k == 2
    assert metrics.get("executor.zero_manual_fallbacks.localsgd") == 1


REFUSED = [("tensor_parallel_degree", 2), ("sequence_parallel_degree", 2),
           ("pipeline_parallel_degree", 2), ("pipeline", True)]


@pytest.mark.parametrize("field,value", REFUSED,
                         ids=[f for f, _ in REFUSED])
def test_localsgd_refuses_tp_sp_pp(field, value):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.base import DistributedOptimizer
    from paddle_tpu_torch import optimizer
    s = fleet.DistributedStrategy()
    s.localsgd = True
    s.localsgd_configs = {"k_steps": 2}
    setattr(s, field, value)
    exe, _, loss = ranks.build("fc", "sgd", 1)     # k 1: no LocalSGD
    with pytest.raises(ValueError, match="cannot combine with tp/sp/pp/ep"):
        DistributedOptimizer(optimizer.SGD(0.1), s).minimize(loss)


def test_indivisible_feed_raises_with_the_reference_text():
    from paddle_tpu_torch.framework import errors
    from paddle_tpu_torch.framework.executor import _LocalSGDStep

    class _Prog:
        _localsgd_k = 2

        def global_block(self):
            class _B:
                ops = []
            return _B()

    step = _LocalSGDStep(_Prog())
    step.dp, step.rank = 2, 1
    import torch
    with pytest.raises(errors.InvalidArgumentError,
                       match="localsgd: feed 'x' batch 3 is not divisible "
                             "by dp=2"):
        step._rows({"x": torch.zeros(3, 2)})
    rows = step._rows({"x": torch.arange(8.).reshape(4, 2),
                       "lr": torch.tensor(0.5)})
    assert rows["x"].tolist() == [[4.0, 5.0], [6.0, 7.0]]
    assert float(rows["lr"]) == 0.5
