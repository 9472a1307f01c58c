"""PyTorch port, peer snapshot replication and the recovery ladder
(paddle_tpu_torch/resilience/snapshot.py) against the reference's
(paddle_tpu/resilience/snapshot.py; its tests/test_snapshot.py:156,179).

* The ladder: for every combination of a peer payload flushed by the ring
  buddy, an older local flush and a disk checkpoint, both packages pick
  the same rung and step and restore the same arrays; the peer rung wins
  over local and disk; `peer=False` skips it.
* The layout: the same flushes publish the same directory tree in both
  packages (`rank<r>/`, `peer_of_rank<r>/`, the recovery stamp).
* `replicate`: at world 2, 3 and 4 every rank keeps its ring buddy's
  (rank - 1) payload, as the reference's does, over a stand-in transport;
  over the port's real host group (distributed/gloo.py) at world 2 with a
  payload of 24 MB a rank, each rank holds the other's arrays bit for bit.
* The SIGTERM flush writes the own snapshot and the held peer payload.
* At dp 2 (two gloo CPU ranks) a rank flushes its own snapshot and its
  peer payload alone: the checkpoint's dp write (rank 0 writes, every
  rank waits at a barrier) would leave rank 1's rung unwritten, and a
  lost peer would never reach the barrier.
"""
import os
import signal
import threading

import numpy as np
import pytest

from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu.resilience import CheckpointManager as RefCheckpointManager
from paddle_tpu.resilience import snapshot as ref_snap
from paddle_tpu_torch.distributed.gloo import Gloo
from paddle_tpu_torch.framework import Scope
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.resilience import CheckpointManager
from paddle_tpu_torch.resilience import snapshot as port_snap

PEER = {"w": np.full(3, 7.0, np.float32), "b": np.arange(2, dtype=np.int64)}
LOCAL = {"w": np.zeros(3, np.float32), "b": np.arange(2, dtype=np.int64)}
DISK = {"w": np.full(3, -1.0, np.float32), "b": np.arange(2, dtype=np.int64)}


def _stage(mod, ckpt_cls, root, rungs):
    """Flush the rungs `rungs` for rank 0 with package `mod`: the peer
    payload its buddy (rank 1) held, an older local flush, a disk
    checkpoint. Returns the disk CheckpointManager (or None)."""
    if "peer" in rungs:
        holder = mod.SnapshotManager(root=root, rank=1, world=2)
        holder._peer = mod.Snapshot(9, PEER, rank=0)
        holder.flush("buddy_sigterm")
        holder.close()
    if "local" in rungs:
        own = mod.SnapshotManager(root=root, rank=0, world=2)
        own._buffers[0] = mod.Snapshot(5, LOCAL, rank=0)
        own._newest = 0
        own.flush("local")
        own.close()
    if "disk" not in rungs:
        return None
    ckpt = ckpt_cls(os.path.join(root, "ckpt"), max_keep=2)
    ckpt.save(2, arrays=DISK)
    return ckpt


def _tree(root):
    out = []
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".json") and f.startswith("recovery_rank"):
                out.append(os.path.relpath(os.path.join(d, f), root))
            elif "ckpt" not in os.path.relpath(d, root):
                out.append(os.path.relpath(d, root).split(os.sep)[0])
    return sorted(set(out))


LADDERS = [("peer", "local", "disk"), ("peer",), ("local", "disk"),
           ("disk",), ()]


@pytest.mark.parametrize("rungs", LADDERS,
                         ids=["+".join(r) or "none" for r in LADDERS])
def test_ladder_equal_to_reference(tmp_path, rungs):
    roots = {k: str(tmp_path / k) for k in ("port", "ref")}
    ckpt = _stage(port_snap, CheckpointManager, roots["port"], rungs)
    ref_ckpt = _stage(ref_snap, RefCheckpointManager, roots["ref"], rungs)
    scope, ref_scope = Scope(), RefScope()
    got = port_snap.recover(scope, root=roots["port"], rank=0,
                            ckpt_manager=ckpt, device="cpu")
    want = ref_snap.recover(ref_scope, root=roots["ref"], rank=0,
                            ckpt_manager=ref_ckpt)
    assert got == want
    assert got[0] == (rungs[0] if rungs else None)
    if rungs:
        for n in ("w", "b"):
            np.testing.assert_array_equal(scope.numpy(n),
                                          np.asarray(ref_scope.find(n)))
    assert _tree(roots["port"]) == _tree(roots["ref"])
    stamps = port_snap.read_recovery_stamps(roots["port"])
    assert [(r["rank"], r["rung"], r["step"]) for r in stamps] == [
        (0, got[0] or "none", got[1])]


def test_peer_false_skips_the_peer_rung(tmp_path):
    _stage(port_snap, CheckpointManager, str(tmp_path), ("peer", "local"))
    scope = Scope()
    assert port_snap.recover(scope, root=str(tmp_path), rank=0, peer=False,
                             stamp=False, device="cpu") == ("local", 5)
    np.testing.assert_array_equal(scope.numpy("w"), LOCAL["w"])
    assert os.path.isdir(tmp_path / "peer_of_rank0")


class _StubRound:
    """A host group whose all-gather returns fixed payloads."""

    def __init__(self, payloads):
        self.payloads = payloads

    def all_gather(self, value):
        return list(self.payloads)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_replicate_keeps_the_ring_buddys_payload(tmp_path, world):
    payloads = [(4 + r, {"w": np.float32([r, r + 1])}) for r in range(world)]
    for rank in range(world):
        got = []
        for mod in (port_snap, ref_snap):
            mgr = mod.SnapshotManager(root=str(tmp_path / mod.__name__),
                                      rank=rank, world=world)
            try:
                step = mgr.replicate(_StubRound(payloads))
                peer = mgr.peer_payload()
                got.append((step, peer.rank, peer.step,
                            peer.arrays["w"].tolist()))
            finally:
                mgr.close()
        assert got[0] == got[1]
        buddy = (rank - 1) % world
        assert got[0] == (4 + buddy, buddy, 4 + buddy, [buddy, buddy + 1])


def test_replicate_over_the_host_group(tmp_path):
    """Two ranks (threads here) replicate 24 MB snapshots through the
    port's TCP store: each keeps the other's arrays bit for bit."""
    rng = np.random.RandomState(0)
    arrays = [{"w": rng.randn(6 << 20).astype(np.float32),
               "step": np.int64(r)} for r in range(2)]
    store = Gloo(0, 2)
    out, errs = {}, []

    def rank_main(rank, g):
        mgr = port_snap.SnapshotManager(root=str(tmp_path), rank=rank,
                                        world=2)
        try:
            mgr._buffers[0] = port_snap.Snapshot(3, arrays[rank], rank=rank)
            mgr._newest = 0
            out[rank] = (mgr.replicate(g), mgr.peer_payload())
        except BaseException as e:     # noqa: BLE001 - reported below
            errs.append(e)
        finally:
            mgr.close()

    before = metrics.snapshot().get("resilience.replicate_bytes", {})
    peer_g = Gloo(1, 2, store_addr=f"127.0.0.1:{store.store_port}")
    t = threading.Thread(target=rank_main, args=(1, peer_g))
    t.start()
    rank_main(0, store)
    t.join(timeout=60)
    peer_g.close()
    store.close()
    assert not errs, errs
    for rank in range(2):
        step, peer = out[rank]
        assert (step, peer.rank, peer.step) == (3, 1 - rank, 3)
        np.testing.assert_array_equal(peer.arrays["w"], arrays[1 - rank]["w"])
    sent = metrics.snapshot()["resilience.replicate_bytes"]["value"] - \
        (before.get("value", 0) if before else 0)
    assert sent == 2 * (arrays[0]["w"].nbytes + 8)


def test_sigterm_flush_writes_own_and_peer(tmp_path):
    mgr = port_snap.SnapshotManager(root=str(tmp_path), rank=0, world=2)
    mgr._buffers[0] = port_snap.Snapshot(3, LOCAL, rank=0)
    mgr._newest = 0
    mgr._peer = port_snap.Snapshot(3, PEER, rank=1)
    mgr.install_sigterm_flush()
    try:
        with pytest.raises(SystemExit) as exc:
            os.kill(os.getpid(), signal.SIGTERM)
        assert exc.value.code == 128 + signal.SIGTERM
    finally:
        mgr.close()
    assert sorted(os.listdir(tmp_path)) == ["peer_of_rank1", "rank0"]
    scope = Scope()
    assert port_snap.recover(scope, root=str(tmp_path), rank=1,
                             stamp=False, device="cpu") == ("peer", 3)
    np.testing.assert_array_equal(scope.numpy("w"), PEER["w"])


def test_a_rank_flushes_alone_at_dp2(tmp_path):
    import torch_localsgd_ranks as ranks
    from paddle_tpu_torch.testing import gloo_gang
    got = gloo_gang(ranks.flush_alone, 2, args=(str(tmp_path),),
                    timeout_s=120, group_timeout_s=20)
    assert got == [None, ["peer_of_rank0", "rank1"]]
    scope = Scope()
    assert port_snap.recover(scope, root=str(tmp_path), rank=1, stamp=False,
                             device="cpu") == ("local", 4)
    np.testing.assert_array_equal(scope.numpy("w"), np.full(3, 1.0))
