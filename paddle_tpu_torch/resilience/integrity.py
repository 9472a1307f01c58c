"""Training-state fingerprints and poison-batch rollback (counterpart of
paddle_tpu/resilience/integrity.py, one process).

Every step is a pure function of the state, the batch and the run seed
(the port's run seed is a counter restored with the state, io.py), so a
rollback is exact: restore the last good snapshot, replay the clean
batches after it and skip the poisoned one, and the run is bit for bit
the run that never saw that batch.

* `fingerprint` — sha256 over every persistable's bytes, dtype and shape
  (and the run-seed counter) in name order; ZeRO flat buckets hash as the
  flat storage.
* `TrainingGuard` — a NaN/Inf and loss-spike sentinel around the training
  loop. A poisoned step restores the last good snapshot and rewinds the
  `steps` schedule past it, skipping the batch; bounded by
  `FLAGS_rollback_budget` (`integrity.rollbacks`), after which it raises
  RollbackExhausted. The spike rule: a loss above
  `FLAGS_loss_spike_factor` times the trailing-window median.

Not ported (ROADMAP item 19, needs gloo across processes): the
cross-replica `DivergenceSentinel` and `ReplicaDivergenceError`.
"""
from __future__ import annotations

import hashlib
from collections import deque
from typing import Optional

import numpy as np

from ..framework.errors import EnforceNotMet, ErrorCode
from ..framework.scope import to_numpy
from ..observability import metrics as _metrics
from ..observability import trace as _trace
from .snapshot import SnapshotManager


def fingerprint(program, scope) -> str:
    """sha256 of the training state: every persistable's name, dtype,
    shape and bytes in name order, then the run-seed counter."""
    from ..io import RNG_SCOPE_KEY, _persistable_names
    h = hashlib.sha256()
    for n in sorted(_persistable_names(program, scope)):
        a = to_numpy(scope.find(n))
        h.update(n.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    ctr = scope.find(RNG_SCOPE_KEY)
    if ctr is not None:
        h.update(f"{RNG_SCOPE_KEY}={int(ctr)}".encode())
    return h.hexdigest()


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
