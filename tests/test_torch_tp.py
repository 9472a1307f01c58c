"""Tensor parallelism in the port (parallel/mesh.py, parallel/spmd.py,
parallel/gspmd.py, fleet's `tensor_parallel_degree`) against the
reference and against the port at tp 1.

The reference runs in a `cpu_mesh_env(4)` subprocess
(tests/torch_tp_reference.py): the Megatron fc case at dp 2 x tp 2 (its
tests/test_distributed.py case, 5 SGD steps) and tiny GPT / tiny BERT at
tp 2 under GSPMD. The port runs in gloo gangs (tests/torch_tp_ranks.py):
the fc case in 4 ranks, GPT / BERT in 2, each rank feeding the global
batch. Tolerances:

* fc: the reference's own (rtol 2e-4, atol 1e-5) against the reference
  at dp 2 x tp 2 and against its unsharded run;
* GPT / BERT (f32, 3 Adam steps from the same numpy weights): losses
  within 1e-4 relative of the reference and of the port at tp 1, every
  parameter within 1e-4 of the largest element of its tp-1 value (the
  row-parallel sums are reduced in another order);
* dropout 0.1 at tp 2 against tp 1 (the flash kernels' and dropout's
  counter hashes keyed on global heads and elements): losses within 1e-5
  relative; run_steps(3) equal to three run() calls bit for bit;
* a checkpoint written at tp 2 holds whole arrays: loaded at tp 1 array
  for array, and back at tp 2 into a fresh scope the same arrays.
"""
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

from conftest import cpu_mesh_env

import torch_tp_ranks as ranks
from paddle_tpu_torch.testing import gloo_gang

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_tp_reference.py")
RTOL = 1e-4


def _model_init(kind, seed):
    """Seeded numpy weights for every parameter of the port's tiny model,
    and 3 feeds of batch 4."""
    from paddle_tpu_torch.framework import program as pm, unique_name
    from paddle_tpu_torch.models import bert, gpt
    main, start = pm.Program(), pm.Program()
    with pm.program_guard(main, start), unique_name.guard():
        if kind == "gpt":
            cfg = gpt.GPTConfig.tiny()
            gpt.build_lm_program(cfg)
        else:
            cfg = bert.BertConfig.tiny()
            bert.build_pretrain_program(cfg, use_input_mask=True)
    rng = np.random.RandomState(seed)
    init = {}
    for p in main.all_parameters():
        shape = tuple(p.shape)
        init[p.name] = np.ones(shape, np.float32) \
            if p.name.endswith("_scale") \
            else (rng.randn(*shape) * 0.02).astype(np.float32)
    s = cfg.seq_len
    if kind == "gpt":
        feeds = [{"tokens": rng.randint(0, cfg.vocab_size, (4, s))
                  .astype(np.int64)} for _ in range(3)]
    else:
        feeds = []
        for _ in range(3):
            lens = rng.randint(s // 2, s + 1, size=(4, 1))
            feeds.append({
                "input_ids": rng.randint(0, cfg.vocab_size, (4, s))
                .astype(np.int64),
                "mlm_labels": rng.randint(0, cfg.vocab_size, (4, s, 1))
                .astype(np.int64),
                "input_mask": (np.arange(s)[None] < lens)
                .astype(np.float32)})
    return init, feeds


def _fc_init():
    rng = np.random.RandomState(5)
    return ({"w1": (rng.randn(16, 32) * 0.3).astype(np.float32),
             "b1": (rng.randn(32) * 0.1).astype(np.float32),
             "w2": (rng.randn(32, 4) * 0.3).astype(np.float32),
             "b2": np.zeros(4, np.float32)},
            np.random.RandomState(1).rand(8, 16).astype(np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    gpt_init, gpt_feeds = _model_init("gpt", 3)
    bert_init, bert_feeds = _model_init("bert", 4)
    fc_init, xv = _fc_init()
    arrays = {f"fc/{n}": v for n, v in fc_init.items()}
    arrays.update({f"gpt/{n}": v for n, v in gpt_init.items()})
    arrays.update({f"bert/{n}": v for n, v in bert_init.items()})
    arrays["xv"] = xv
    arrays["gpt_tokens"] = np.stack([f["tokens"] for f in gpt_feeds])
    for key, name in (("bert_ids", "input_ids"), ("bert_labels",
                                                  "mlm_labels"),
                      ("bert_mask", "input_mask")):
        arrays[key] = np.stack([f[name] for f in bert_feeds])
    src, dst = str(tmp / "tp_in.npz"), str(tmp / "tp_out.npz")
    np.savez(src, __json__=json.dumps({}), **arrays)
    proc = subprocess.Popen([sys.executable, REF, "tp", src, dst],
                            env=cpu_mesh_env(4), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        ckpt = str(tmp / "ckpt")
        port = gloo_gang(ranks.tp_suite, 2, args=(
            gpt_init, gpt_feeds, bert_init, bert_feeds, ckpt))
        fc = gloo_gang(ranks.fc_megatron, 4, args=(fc_init, xv))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            one = {kind: ranks.model_run(kind, init, feeds)[:2]
                   for kind, init, feeds in (
                       ("gpt", gpt_init, gpt_feeds),
                       ("bert", bert_init, bert_feeds))}
            one["dropout"] = ranks.model_run("gpt", gpt_init, gpt_feeds,
                                             dropout=0.1)[:2]
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    with np.load(dst) as f:
        ref_arrays = {n: f[n] for n in f.files}
    ref = json.loads(str(ref_arrays.pop("__json__")))
    return {"ref": ref, "ref_arrays": ref_arrays, "port": port, "fc": fc,
            "one": one, "ckpt": ckpt}


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def test_megatron_fc_dp2_tp2_matches_reference(runs):
    ref = runs["ref"]
    assert ref["devices"] == 4
    for r in runs["fc"]:
        np.testing.assert_allclose(r["losses"], ref["fc_tp"], rtol=2e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r["losses"], ref["fc_plain"], rtol=2e-4,
                                   atol=1e-5)
    # w1 column-parallel over tp, whole over dp: [16, 16] on each rank
    coords = sorted(tuple(r["coords"]) for r in runs["fc"])
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["w1_local"] == [16, 32 // 2] for r in runs["fc"])
    assert all(r["w1_placements"] == ["Replicate()", "Shard(dim=1)"]
               for r in runs["fc"])
    assert all(r["mesh"] == "Mesh(dp=2, tp=2)" for r in runs["fc"])
    # w1 and w2 halved; the biases match no rule and stay whole
    assert all(r["param_elements"] == 16 * 16 + 32 + 16 * 4 + 4
               for r in runs["fc"])


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_tp2_matches_reference_and_tp1(runs, kind):
    """3 Adam steps at tp 2 against the reference at tp 2 and the port at
    tp 1: losses within 1e-4 relative, every parameter within 1e-4 of its
    largest element."""
    ref, port = runs["ref"], runs["port"]
    one_losses, one_params = runs["one"][kind]
    for r in port:
        _close(r[kind]["losses"], ref[kind])
        _close(r[kind]["losses"], one_losses)
        for n, want in one_params.items():
            got = r[kind]["params"][n]
            scale = np.abs(want).max()
            assert np.abs(got - want).max() <= RTOL * scale, n
            ref_p = runs["ref_arrays"][f"{kind}/{n}"]
            assert np.abs(got - ref_p).max() <= RTOL * scale, n


def test_gpt_tp2_layout(runs):
    """The tiny GPT's vocab (512) divides by 2: `wte` is vocab-sharded
    (the Megatron vocab-parallel lookup); per rank, half of every
    tp-sharded parameter and the whole of the rest."""
    from paddle_tpu_torch.models import gpt
    cfg = gpt.GPTConfig.tiny()
    h, f, L, v = (cfg.hidden_size, cfg.intermediate_size, cfg.num_layers,
                  cfg.vocab_size)
    sharded = L * (h * 3 * h + 3 * h + h * f + f + h * h + f * h) + v * h
    whole = cfg.max_position * h + L * (4 * h + 2 * h) + 2 * h
    for r in runs["port"]:
        assert r["gpt"]["wte_placements"] == ["Shard(dim=0)"]
        assert r["gpt"]["param_elements"] == sharded // 2 + whole


def test_bert_tp2_keeps_the_dense_head(runs):
    for r in runs["port"]:
        assert r["bert"]["fused_head"] is False


def test_tp2_dropout_equals_tp1_and_run_steps_equals_runs(runs):
    """Dropout 0.1: tp 2 draws tp 1's masks (global keying), and
    run_steps(3) at tp 2 equals three run() calls bit for bit."""
    one_losses, one_params = runs["one"]["dropout"]
    for r in runs["port"]:
        d = r["dropout"]
        _close(d["losses"], one_losses, rtol=1e-5)
        assert d["run_steps_losses"] == d["losses"]
        assert d["params_bitwise"]
        for n, want in one_params.items():
            assert np.abs(r["saved"][n] - want).max() \
                <= RTOL * np.abs(want).max(), n


def test_tp2_checkpoint_loads_at_tp1_and_tp2(runs):
    """The checkpoint written at tp 2 is the tp-1 format: loaded at tp 1
    every parameter is the tp-2 run's whole array, and loaded back at tp
    2 (a fresh scope, redistributed) the same."""
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.framework.scope import to_numpy
    from paddle_tpu_torch.resilience import CheckpointManager
    main, start, _ = ranks.build_model("gpt", dropout=0.1)
    scope, exe = Scope(), Executor("cpu")
    exe.run(start, scope=scope)
    step = CheckpointManager(runs["ckpt"], max_keep=1).restore_latest(
        program=main, scope=scope, executor=exe)
    assert step == 2
    saved = runs["port"][0]["saved"]
    for p in main.all_parameters():
        assert np.array_equal(to_numpy(scope.find(p.name)), saved[p.name])
    for r in runs["port"]:
        assert r["reloaded_is_dtensor"]
        for n, want in saved.items():
            assert np.array_equal(r["reloaded_tp2"][n], want), n


def test_tp2_collectives_follow_the_plan(runs):
    """GPT at tp 2 with a whole vocab table, f32: every step's DTensor
    collectives, by (op, collective, bytes), are chip_smoke's plan (the
    one phase 13 holds GPT-2 small to on the card) at 4-byte activations."""
    import chip_smoke
    from paddle_tpu_torch.models import gpt
    cfg = gpt.GPTConfig.tiny()
    want = {f"{k[0]} {k[1]} {k[2]}": 3 * v for k, v in
            chip_smoke.mp_plan_tp(cfg, 4, amp_bytes=4).items()}
    for r in runs["port"]:
        assert r["plan"] == want


def test_synchronous_functional_collectives(runs):
    """With DTensor's functional collectives served by the synchronous
    c10d calls (the gloo-on-CUDA path), the tp 2 run is the same, bit for
    bit, and the calls are counted."""
    for r in runs["port"]:
        assert r["sync_functionals"]["losses"] == r["dropout"]["losses"]
        assert r["sync_functionals"]["all_gathers"] > 0
