"""PyTorch port, collectives across processes (distributed/collective.py and
the process group of distributed/parallel.py), on gloo CPU ranks
(paddle_tpu_torch.testing.gloo_gang), against the reference's collectives
on a dp-sharded array in a `cpu_mesh_env(dp)` subprocess
(tests/torch_dist_reference.py), the same numpy array on both sides.

* At dp 2 and dp 4, rank r holding block r of the array: `all_reduce`
  (sum, max, min, prod) equals the reference's reduction over the shards,
  `all_gather` its list of shards, `split_batch` its shard r; broadcast,
  reduce, scatter, and the flat reduce-scatter / all-gather that ZeRO uses
  equal their per-rank definitions (numpy). Bit for bit, except a sum or
  product of four values, which gloo and XLA (and numpy) associate in
  their own orders: rtol 1e-6 there (one rounding of a four-term sum of
  values in [0.5, 1.5)). Every call is counted once, with its bytes.
* The group: NCCL asked for with two ranks on one device raises the typed
  PreconditionNotMetError (the check every rank runs before NCCL is
  touched); a rank whose peers never come raises within its timeout; a
  rank whose peer died raises in its next collective within the group's
  timeout; `nccl` on the CPU and a missing rendezvous raise.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from conftest import cpu_mesh_env

import torch_dist_ranks as ranks
from paddle_tpu_torch.distributed import parallel
from paddle_tpu_torch.framework import errors
from paddle_tpu_torch.testing import gloo_gang

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_dist_reference.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _array(dp):
    rng = np.random.RandomState(dp)
    return (rng.rand(dp * 2, 3) + 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("coll")
    procs = {}
    for dp in (2, 4):
        src, dst = str(tmp / f"in{dp}.npz"), str(tmp / f"out{dp}.npz")
        np.savez(src, __json__=json.dumps({}), x=_array(dp))
        procs[dp] = (subprocess.Popen(
            [sys.executable, REF, "collective", src, dst],
            env=cpu_mesh_env(dp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), dst)
    try:
        port = {dp: gloo_gang(ranks.collectives, dp, args=(_array(dp),))
                for dp in (2, 4)}
        ref = {}
        for dp, (proc, dst) in procs.items():
            out, _ = proc.communicate(timeout=300)
            assert proc.returncode == 0, out
            with np.load(dst) as f:
                ref[dp] = {n: f[n] for n in f.files}
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return port, ref


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
def test_all_reduce_matches_reference(runs, dp, op):
    port, ref = runs
    for r in range(dp):
        got, want = port[dp][r][f"all_reduce_{op}"], \
            ref[dp][f"all_reduce_{op}"]
        if dp == 2 or op in ("max", "min"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("dp", [2, 4])
def test_all_gather_and_split_batch_match_reference(runs, dp):
    port, ref = runs
    shards = np.split(ref[dp]["split_batch"], dp)
    for r in range(dp):
        np.testing.assert_array_equal(port[dp][r]["all_gather"],
                                      ref[dp]["all_gather"])
        np.testing.assert_array_equal(port[dp][r]["all_gather"][r],
                                      shards[r])


@pytest.mark.parametrize("dp", [2, 4])
def test_per_rank_collectives(runs, dp):
    port, _ = runs
    x = _array(dp)
    blocks = np.split(x, dp)
    flat = x.reshape(-1)
    k = flat.size // dp
    scale = sum(r + 1 for r in range(dp))
    for r in range(dp):
        got = port[dp][r]
        np.testing.assert_array_equal(got["broadcast"], blocks[-1])
        np.testing.assert_array_equal(got["scatter"],
                                      np.full((2, 3), 10 * r + 1.0))
        np.testing.assert_allclose(got["reduce_scatter_flat"],
                                   flat[r * k:(r + 1) * k] * scale,
                                   rtol=1e-6)
        np.testing.assert_array_equal(got["all_gather_flat"], flat)
    np.testing.assert_allclose(port[dp][0]["reduce"], x.reshape(
        dp, 2, 3).sum(0), rtol=1e-6)


@pytest.mark.parametrize("dp", [2, 4])
def test_every_call_is_counted_with_its_bytes(runs, dp):
    port, _ = runs
    got = port[dp][0]["counters"]
    assert got["all_reduce.calls"] == 4 and got["all_reduce.bytes"] == 4 * 24
    assert got["all_gather.calls"] == 2
    assert got["all_gather.bytes"] == 2 * 24 * dp
    assert got["broadcast.calls"] == 1 and got["reduce.calls"] == 1
    assert got["scatter.calls"] == 1 and got["barrier.calls"] == 1
    assert got["reduce_scatter.calls"] == 1
    assert got["reduce_scatter.bytes"] == _array(dp).nbytes


def test_nccl_with_two_ranks_on_one_device_raises_typed():
    card = "host|cuda|GPU-0"
    with pytest.raises(errors.PreconditionNotMetError,
                       match="two ranks on one GPU"):
        parallel.check_devices_distinct([card, card], "nccl")
    parallel.check_devices_distinct([card, card], "gloo")
    parallel.check_devices_distinct([card, "host|cuda|GPU-1"], "nccl")


def test_group_arguments_are_checked(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    for key in ("PADDLE_DIST_INIT_METHOD", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(errors.InvalidArgumentError, match="nccl"):
        parallel.init_parallel_env(backend="nccl", device="cpu")
    with pytest.raises(errors.InvalidArgumentError, match="rendezvous"):
        parallel.init_parallel_env(backend="gloo", device="cpu")
    assert not parallel.is_initialized()


def test_a_rank_without_its_peers_raises_within_its_timeout(tmp_path):
    code = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {REPO!r})
        from paddle_tpu_torch.distributed import parallel
        t0 = time.monotonic()
        try:
            parallel.init_parallel_env(timeout_s=2.0)
        except Exception as e:
            print(type(e).__name__, round(time.monotonic() - t0, 1))
            sys.exit(0)
        sys.exit(3)
        """)
    env = dict(os.environ, PADDLE_TRAINER_ID="0", PADDLE_TRAINERS_NUM="2",
               PADDLE_DIST_DEVICE="cpu", PADDLE_DIST_BACKEND="gloo",
               PADDLE_DIST_INIT_METHOD=f"file://{tmp_path}/store")
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert time.monotonic() - t0 < 60
    assert float(r.stdout.split()[-1]) < 20, r.stdout


def test_a_dead_peer_fails_the_collective_not_hangs():
    got = gloo_gang(ranks.dead_peer, 2, timeout_s=60, group_timeout_s=3.0)
    assert got[1] is None
    assert got[0]["raised"] is not None
    assert got[0]["elapsed_s"] < 30, got[0]
