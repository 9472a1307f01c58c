"""PyTorch port, the cross-replica divergence sentinel
(resilience/integrity.py `fingerprint`, `DivergenceSentinel`,
`ReplicaDivergenceError`) over the host Gloo group
(distributed/gloo.py), and `InMemoryDataset.global_shuffle(fleet)` under
launched ranks, on a gloo CPU gang of 2 (fleet at ZeRO stage 1).

* The trap: at stage 1 each rank holds a different half of every flat
  bucket, so a fingerprint of the rank's own storage would differ. The
  port's fingerprint hashes the gathered buckets, as the reference hashes
  its global arrays: both ranks agree after startup and after every step,
  and the sentinel reports no divergence.
* Rank 1's parameter perturbed: the sentinel raises
  ReplicaDivergenceError on both ranks naming rank 1 (two ranks tie; the
  quorum is the group holding the lowest rank, so every rank reaches the
  same verdict); with the SnapshotManager it heals instead: the quorum's
  newest snapshot (the gathered state) is broadcast and every rank
  restores it, back to the pre-perturbation fingerprint.
* `global_shuffle(fleet)`: each rank's order equals the reference's on
  the same files with the reference's rank taken as that rank: its
  round-robin share of the files, shuffled with seed `1 * 9973 + rank`.
"""
import pytest

import torch_dist_ranks as ranks
from paddle_tpu_torch.testing import gloo_gang
from test_torch_dataset import _assert_same, _write_multislot
from test_torch_dp import fc_batches, fc_init


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("div")
    paths = _write_multislot(tmp, n_files=4)
    got = gloo_gang(ranks.sentinel, 2,
                    args=(fc_init(), fc_batches(), str(tmp / "snap"), paths))
    return got, paths


def test_fingerprints_agree_at_stage1(gang):
    got, _ = gang
    assert got[0]["startup"] == got[1]["startup"]
    assert got[0]["shard_width"] == 32           # half of a 64-wide bucket
    for r in got:
        for step in r["digests"]:
            assert set(step) == {0, 1} and step[0] == step[1]
    assert got[0]["digests"] == got[1]["digests"]


def test_perturbed_rank_is_named_as_the_minority(gang):
    got, _ = gang
    for r in got:
        assert r["raised"] == {"minority": [1], "step": 3}


def test_quorum_restore_heals_every_rank(gang):
    got, _ = gang
    for r in got:
        assert r["healed_to"] == 2
        assert r["healed_agree"]
    assert got[0]["after_heal"] == got[1]["after_heal"] == got[0]["before"]


@pytest.mark.parametrize("rank", [0, 1])
def test_global_shuffle_follows_the_reference_rule(gang, monkeypatch, rank):
    import paddle_tpu.dataset as ref_dataset
    from paddle_tpu.parallel import mesh as ref_mesh
    from test_torch_dataset import _dataset, _ref_vars
    got, paths = gang
    monkeypatch.setattr(ref_mesh, "get_rank", lambda: rank)
    monkeypatch.setattr(ref_mesh, "get_world_size", lambda: 2)
    ds = _dataset(ref_dataset, "InMemoryDataset", _ref_vars(), paths,
                  shuffles=0)
    ds.global_shuffle()
    want = [b["x"] for b in ds]
    _assert_same([{"x": x} for x in got[rank]["shuffled"]],
                 [{"x": x} for x in want])
    assert len(want) == 5          # two 10-row files at batch 4
