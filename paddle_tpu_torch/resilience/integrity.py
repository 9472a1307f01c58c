"""Training-state fingerprints, the cross-replica divergence sentinel and
poison-batch rollback (counterpart of paddle_tpu/resilience/integrity.py).

Every step is a pure function of the state, the batch and the run seed
(the port's run seed is a counter restored with the state, io.py), so
replicas that start equal stay equal bit for bit, and a rollback is
exact: restore the last good snapshot, replay the clean batches after it
and skip the poisoned one, and the run is bit for bit the run that never
saw that batch.

* `fingerprint` — sha256 over every persistable's bytes, dtype and shape
  (and the run-seed counter) in name order; ZeRO flat buckets hash as the
  whole flat storage. At dp > 1 a rank holds only its shard of each flat
  bucket, and the shards differ from rank to rank, so the fingerprint
  all-gathers them first (a collective: every rank calls it) and hashes
  the gathered arrays, as the reference hashes its global arrays. Two
  ranks agree iff their replicated state and the gathered buckets are
  bit-identical.
* `DivergenceSentinel` — every `FLAGS_fingerprint_steps` steps each rank
  fingerprints its state and all-gathers the digests over the host Gloo
  group (distributed/gloo.py). A mismatch counts
  `integrity.fingerprint_mismatch`, writes a flight dump, and raises the
  typed `ReplicaDivergenceError` naming the minority rank(s), or, given
  a SnapshotManager, heals: the lowest rank of the quorum broadcasts its
  newest snapshot and EVERY rank restores it (`integrity.quorum_restores`),
  returning the step to replay from. Snapshots at dp > 1 hold the
  gathered state (resilience/snapshot.py), so any rank's restores any
  rank.
* `TrainingGuard` — a NaN/Inf and loss-spike sentinel around the training
  loop. A poisoned step restores the last good snapshot and rewinds the
  `steps` schedule past it, skipping the batch; bounded by
  `FLAGS_rollback_budget` (`integrity.rollbacks`), after which it raises
  RollbackExhausted. The spike rule: a loss above
  `FLAGS_loss_spike_factor` times the trailing-window median.
"""
from __future__ import annotations

import hashlib
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..framework.errors import EnforceNotMet, ErrorCode
from ..framework.scope import to_numpy
from ..observability import metrics as _metrics
from ..observability import trace as _trace
from .snapshot import Snapshot, SnapshotManager, _gathered_shards


def fingerprint(program, scope) -> str:
    """sha256 of the training state: every persistable's name, dtype,
    shape and bytes in name order (ZeRO shards gathered at dp > 1), then
    the run-seed counter."""
    from ..io import RNG_SCOPE_KEY, _persistable_names
    full = _gathered_shards(program, scope)
    h = hashlib.sha256()
    for n in sorted(_persistable_names(program, scope)):
        a = to_numpy(full.get(n, scope.find(n)))
        h.update(n.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    ctr = scope.find(RNG_SCOPE_KEY)
    if ctr is not None:
        h.update(f"{RNG_SCOPE_KEY}={int(ctr)}".encode())
    return h.hexdigest()


class ReplicaDivergenceError(EnforceNotMet):
    """A rank's replicated state diverged from the quorum's (silent data
    corruption, a lost update, a desync). Carries the minority rank(s),
    the step, the per-rank digests and the flight dump written at
    detection."""

    code = ErrorCode.PRECONDITION_NOT_MET

    def __init__(self, minority_ranks: List[int], step: int,
                 digests: Dict[int, str], dump_path: Optional[str] = None):
        self.minority_ranks = list(minority_ranks)
        self.step = int(step)
        self.digests = dict(digests)
        self.dump_path = dump_path
        super().__init__(
            "replica state diverged at step %d: minority rank(s) %s "
            "disagree with the quorum fingerprint (per-rank digests %s)%s"
            % (step, self.minority_ranks,
               {r: d[:12] for r, d in sorted(self.digests.items())},
               f"; flight dump: {dump_path}" if dump_path else ""))


def _split_quorum(digests: Dict[int, str]) -> Tuple[str, List[int]]:
    """(quorum digest, minority ranks). The quorum is the largest group
    of equal digests; a tie goes to the group holding the lowest rank, so
    every rank reaches the same verdict."""
    groups: Dict[str, List[int]] = {}
    for rank in sorted(digests):
        groups.setdefault(digests[rank], []).append(rank)
    quorum = max(groups.values(), key=lambda rs: (len(rs), -min(rs)))
    minority = sorted(r for rs in groups.values() if rs is not quorum
                      for r in rs)
    return digests[quorum[0]], minority


class DivergenceSentinel:
    """Periodic cross-replica fingerprint comparison over a host Gloo
    group:

        sentinel = DivergenceSentinel(gloo, interval=16)
        for step in ...:
            exe.run(...)
            healed = sentinel.check(program, scope, step, snapshots=mgr)
            if healed is not None:
                step = healed        # replay from the snapshot's step

    `check` is a collective on the cadence: every rank calls it with the
    same steps. Without a SnapshotManager (or with heal=False) a mismatch
    raises ReplicaDivergenceError on every rank."""

    def __init__(self, gloo, interval: Optional[int] = None,
                 heal: bool = True):
        from ..flags import flag
        self.gloo = gloo
        self.interval = (int(flag("FLAGS_fingerprint_steps"))
                         if interval is None else int(interval))
        self.heal = heal
        self.last_minority: List[int] = []
        self.last_digests: Dict[int, str] = {}

    def check(self, program, scope, step: int,
              snapshots: Optional[SnapshotManager] = None) -> Optional[int]:
        """On the cadence: fingerprint, all-gather, compare. Returns None
        when the replicas agree (or off the cadence), the snapshot step to
        replay from after a quorum heal, or raises
        ReplicaDivergenceError."""
        if self.interval <= 0 or step % self.interval != 0:
            return None
        digest = fingerprint(program, scope)
        rank = self.gloo.rank
        digests = {int(r): d for r, d in
                   self.gloo.all_gather((rank, digest))}
        self.last_digests = digests
        quorum_digest, minority = _split_quorum(digests)
        if not minority:
            return None
        _metrics.inc("integrity.fingerprint_mismatch")
        self.last_minority = minority
        from ..observability import flight as _flight
        dump = _flight.dump("replica_divergence",
                            extra={"step": int(step), "rank": rank,
                                   "minority_ranks": minority,
                                   "digests": {str(r): d for r, d
                                               in digests.items()}})
        _trace.instant("replica_divergence",
                       args={"step": int(step),
                             "minority": ",".join(map(str, minority))},
                       cat="resilience")
        err = ReplicaDivergenceError(minority, step, digests,
                                     dump_path=dump)
        if not self.heal or snapshots is None:
            raise err
        return self._quorum_restore(program, scope, snapshots, digests,
                                    quorum_digest, err)

    def _quorum_restore(self, program, scope, snapshots: SnapshotManager,
                        digests: Dict[int, str], quorum_digest: str,
                        err: ReplicaDivergenceError) -> int:
        """The lowest quorum rank broadcasts its newest snapshot and EVERY
        rank restores it, so the group replays from one state. Raises the
        original error when the quorum holds no snapshot."""
        root = min(r for r, d in digests.items() if d == quorum_digest)
        snapshots.wait()
        snap = snapshots.latest()
        mine = (None if snap is None
                else (snap.step, {n: np.asarray(a)
                                  for n, a in snap.arrays.items()}))
        payload = self.gloo.broadcast(mine, root=root)
        if payload is None:
            raise err
        step, arrays = int(payload[0]), payload[1]
        Snapshot(step, arrays, rank=root).restore(scope, program=program)
        _metrics.inc("integrity.quorum_restores")
        _trace.instant("quorum_restore",
                       args={"from_rank": root, "step": step,
                             "rank": self.gloo.rank}, cat="resilience")
        return step


class RollbackExhausted(EnforceNotMet):
    """The poison-batch rollback budget ran out: the instability is not a
    transient bad batch."""

    code = ErrorCode.PRECONDITION_NOT_MET


class TrainingGuard:
    """NaN/Inf and loss-spike sentinel with bounded snapshot rollback.

        guard = TrainingGuard(mgr, program=prog, scope=scope)
        for step in guard.steps(total):
            out, = exe.run(prog, feed=feed(step), fetch_list=[loss],
                           scope=scope)
            if not guard.observe(step, float(out)):
                mgr.maybe_capture(prog, scope, step)

    When `observe` flags step k, the guard restores the newest snapshot
    (step s0 <= k) and `steps` rewinds to s0 + 1, replaying s0+1..k-1 and
    skipping k."""

    def __init__(self, snapshots: SnapshotManager, program=None, scope=None,
                 spike_factor: Optional[float] = None, window: int = 8,
                 budget: Optional[int] = None):
        from ..flags import flag
        from ..framework.program import default_main_program
        from ..framework.scope import global_scope
        self.snapshots = snapshots
        self.program = program or default_main_program()
        self.scope = scope or global_scope()
        self.spike_factor = (float(flag("FLAGS_loss_spike_factor"))
                             if spike_factor is None else float(spike_factor))
        self.budget = (int(flag("FLAGS_rollback_budget"))
                       if budget is None else int(budget))
        self.window: deque = deque(maxlen=max(2, int(window)))
        self.skip: set = set()
        self.rollbacks = 0
        self._rewind_to: Optional[int] = None
        self._history: list = []

    def _poisoned(self, loss: float) -> Optional[str]:
        if not np.isfinite(loss):
            return "non-finite"
        if self.spike_factor > 0 and len(self.window) >= 2:
            med = float(np.median(self.window))
            if med > 0 and loss > self.spike_factor * med:
                return (f"spike {loss:.6g} > {self.spike_factor:g} x "
                        f"median {med:.6g}")
        return None

    def observe(self, step: int, loss: float) -> bool:
        """Feed the step's loss. Returns True when the step was poisoned
        (the state is rolled back and `steps` will rewind); clean losses
        enter the spike window."""
        why = self._poisoned(float(loss))
        if why is None:
            self.window.append(float(loss))
            return False
        self._history.append((int(step), float(loss), why))
        if self.rollbacks >= self.budget:
            raise RollbackExhausted(
                "poisoned step %d (%s) but the rollback budget (%d) is "
                "exhausted; poison history: %s"
                % (step, why, self.budget, self._history))
        self.snapshots.wait()
        snap = self.snapshots.latest()
        if snap is None or snap.step > step:
            raise RollbackExhausted(
                "poisoned step %d (%s) with no snapshot at or before it "
                "(newest: %s): raise the FLAGS_snapshot_steps cadence"
                % (step, why, None if snap is None else snap.step))
        snap.restore(self.scope, program=self.program)
        self.skip.add(int(step))
        self.rollbacks += 1
        self._rewind_to = snap.step
        _metrics.inc("integrity.rollbacks")
        _trace.instant("rollback", args={"poison_step": int(step),
                                         "to_step": snap.step,
                                         "why": why}, cat="resilience")
        return True

    def steps(self, total: int, start: int = 0):
        """The rollback-aware schedule: step indices [start, total),
        rewinding after a rollback and skipping poisoned steps."""
        step = start
        while step < total:
            if step in self.skip:
                step += 1
                continue
            yield step
            if self._rewind_to is not None:
                step = self._rewind_to + 1
                self._rewind_to = None
                continue
            step += 1
