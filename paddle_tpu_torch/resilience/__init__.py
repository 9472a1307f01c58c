"""Fault tolerance (counterpart of paddle_tpu/resilience/):

  faults      deterministic seedable fault injection (FaultPlan +
              fault_point sites), so every recovery path is testable on
              the CPU
  retry       one RetryPolicy (backoff + jitter + deadline + max
              attempts); exhaustion raises the typed DeadlineExceededError
  checkpoint  crash-safe CheckpointManager: temp dir + checksummed
              manifest + atomic rename + keep-N + fallback to the last
              complete checkpoint
  snapshot    double-buffered in-memory snapshots (device -> pinned host
              off the main thread), replication to a ring buddy over the
              host group, SIGTERM flush, the peer -> local -> disk
              recovery ladder
  integrity   state fingerprints, the cross-replica DivergenceSentinel
              with its quorum restore, and the NaN/loss-spike
              TrainingGuard with bounded rollback to the last good
              snapshot

Not ported: sparse tables in checkpoints (ROADMAP item 19.2).
"""
from .faults import (FaultPlan, FaultRule, FaultInjected, fault_point,
                     install_plan, clear_plan, current_plan)
from .retry import RetryPolicy, DEFAULT_RETRYABLE
from .checkpoint import (CheckpointManager, validate_manifest,
                         write_manifest, sha256_file)
from .snapshot import (Snapshot, SnapshotManager, recover,
                       read_recovery_stamps, snapshot_dir)
from .integrity import (DivergenceSentinel, ReplicaDivergenceError,
                        RollbackExhausted, TrainingGuard, fingerprint)

__all__ = [
    "FaultPlan", "FaultRule", "FaultInjected", "fault_point",
    "install_plan", "clear_plan", "current_plan",
    "RetryPolicy", "DEFAULT_RETRYABLE",
    "CheckpointManager", "validate_manifest", "write_manifest",
    "sha256_file",
    "Snapshot", "SnapshotManager", "recover", "read_recovery_stamps",
    "snapshot_dir",
    "RollbackExhausted", "TrainingGuard", "fingerprint",
    "DivergenceSentinel", "ReplicaDivergenceError",
]
