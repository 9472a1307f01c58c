"""PyTorch port, the elastic resize: train at dp 4, resume at dp 2
(paddle_tpu_torch.testing `zero_resize_case`, the reference's
paddle_tpu/testing.py:118 drill), on gloo CPU ranks.

* A dp-4 gang trains the flat resize model (8 -> 32 tanh -> 1, Adam,
  buckets of 0.001 MB) 3 steps at ZeRO stage k (1, 2, 3), each rank
  holding its shard of the flat state, and saves a checkpoint: the shards
  all-gathered, rank 0 writing the reference's unsharded format, every
  rank at a barrier.
* A dp-2 gang restores it twice, at stage k (the per-parameter entries
  packed into the flat buckets and this rank's half taken) and at stage 0
  (the oracle), and trains 3 more steps: bit for bit equal, losses and
  every portable array (a sum of two values commutes, so the stages agree
  at dp 2).
* The checkpoint loads into the reference: the reference's own resize
  model (paddle_tpu.testing.zero_resize_flat_build, one device, stage k)
  restores it through its CheckpointManager with every array equal to the
  file's, and its next step's loss (the global batch of 8) equals the
  port's resumed loss at dp 2 (rtol 1e-5: the frameworks sum in other
  orders).
"""
import os

import numpy as np
import pytest

import torch_dist_ranks as ranks
from paddle_tpu_torch.testing import gloo_gang

STAGES = (1, 2, 3)


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("resize"))
    trained = gloo_gang(ranks.resize, 4, args=("train", work))
    resumed = gloo_gang(ranks.resize, 2, args=("resume", work))
    return work, trained, resumed


@pytest.mark.parametrize("stage", STAGES)
def test_resumed_stage_k_equals_resumed_stage0(drill, stage):
    _, trained, resumed = drill
    assert len({tuple(r[stage]["losses"]) for r in trained}) == 1
    for r in resumed:
        got = r[stage]
        assert got["losses_equal"], (got["l_zero"], got["l_repl"])
        assert got["mismatched"] == []
    assert resumed[0][stage]["l_zero"] == resumed[1][stage]["l_zero"]


@pytest.mark.parametrize("stage", STAGES)
def test_checkpoint_loads_into_the_reference(drill, stage):
    import paddle_tpu as paddle
    from paddle_tpu.resilience import CheckpointManager
    from paddle_tpu.testing import zero_resize_flat_build

    work, _, resumed = drill
    root = os.path.join(work, f"stage{stage}")
    step = CheckpointManager(root).steps()[-1]
    with np.load(os.path.join(root, f"ckpt_{step}", "params.npz")) as f:
        saved = {n: f[n] for n in f.files}
    assert not any(n.startswith(f"zero{stage}_b") for n in saved)
    exe, prog, loss, feed = zero_resize_flat_build(1, stage)
    restored = CheckpointManager(root).restore_latest(
        program=prog, scope=paddle.global_scope())
    assert restored == step == 2
    scope = paddle.global_scope()
    for n in ("fc_w_0", "fc_b_0", "fc_w_1", "fc_b_1"):
        np.testing.assert_array_equal(np.asarray(scope.find(n)), saved[n])
    out, = exe.run(feed=feed(3), fetch_list=[loss])
    np.testing.assert_allclose(float(np.asarray(out).ravel()[0]),
                               float(resumed[0][stage]["l_zero"][0]),
                               rtol=1e-5)
