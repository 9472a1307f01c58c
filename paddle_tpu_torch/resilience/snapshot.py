"""In-memory snapshots of the training state (counterpart of
paddle_tpu/resilience/snapshot.py, one process).

A disk checkpoint bounds what a restart loses to one checkpoint interval
plus a cold restore. A snapshot bounds it to one snapshot interval
(`FLAGS_snapshot_steps`): a double-buffered host copy of the portable
training state, flushed to disk only when the process is about to die
(SIGTERM inside `PADDLE_LAUNCH_GRACE_S`) or on request.

* **The copy is off the main thread's critical path.** `maybe_capture`
  runs after a step, or after a `run_steps` window, never inside a
  captured graph. On CUDA it queues the copies from the device into
  pinned host buffers on a side stream, after the work already queued,
  records an event, makes the main stream wait for that event (on the
  device: the next step's in-place updates must not overwrite state
  being copied) and returns; the worker thread waits on the event and
  builds the snapshot from the pinned buffers. The main thread never waits
  for the device. On the CPU the copy is a clone on the calling thread.
  A capture while the previous one is still in flight is skipped and
  counted (`resilience.snapshot_skips`).
* **Double buffering.** Two sets of pinned buffers; the worker fills the
  standby set and swaps the newest pointer only after the copy finished,
  so `latest()` is always a complete snapshot.
* **Payload** (`io.checkpoint_arrays`): the persistables in the portable
  unsharded form (ZeRO flat buckets split into per-parameter views) and
  the port's run-seed counter, so a restore replays the dropout masks of
  the run it rewinds. At dp > 1 the ZeRO shards are all-gathered on the
  calling thread first (every rank on the same cadence), so every rank's
  snapshot is the whole state and any rank's restores any rank
  (`integrity.DivergenceSentinel`'s quorum restore).
* **Flush** writes the newest snapshot through CheckpointManager
  (checksummed manifest, atomic publish; a torn flush keeps the previous
  one). **Recovery** (`recover`): the local snapshot rung, then a disk
  CheckpointManager.

Executor wiring: with `FLAGS_snapshot_steps` > 0 every Executor calls
`maybe_capture` after a step or a `run_steps` window of a program
(`Executor._maybe_snapshot`), tagged with that program's step count: a
`run_steps(k)` window snapshots at its end when it crossed a multiple of
the interval (the reference counts a window as one step);
`snapshot_dir()` resolves FLAGS_snapshot_dir, then PADDLE_SNAPSHOT_DIR,
then a per-process temp directory.

Stats: `resilience.snapshots` / `snapshot_ms` (from the copy's queueing
to the swap, on the worker) / `snapshot_host_ms` (the calling thread's
share) / `snapshot_copy_ms` (CUDA: the copy's device time) /
`snapshot_skips` / `snapshot_flushes`.

Not ported (ROADMAP item 19.1's rest): peer
replication (`replicate`, `peer_payload`) and the peer rung of
`recover`, which raise.
"""
from __future__ import annotations

import json
import os
import signal
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..framework import errors
from ..observability import metrics as _metrics
from ..observability import trace as _trace
from .checkpoint import CheckpointManager


def _item19(what):
    return errors.Unimplemented(
        "%s: peer replication of snapshots is not ported yet (ROADMAP "
        "item 19.1)", what)


def snapshot_dir() -> str:
    """FLAGS_snapshot_dir -> PADDLE_SNAPSHOT_DIR -> a per-process temp
    directory."""
    from ..flags import flag
    d = str(flag("FLAGS_snapshot_dir") or "")
    d = d or os.environ.get("PADDLE_SNAPSHOT_DIR", "")
    return d or os.path.join(tempfile.gettempdir(),
                             f"paddle_tpu_torch_snap_{os.getpid()}")


def _rank_world() -> Tuple[int, int]:
    return (int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0),
            int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1))


def _gathered_shards(program, scope) -> Dict[str, torch.Tensor]:
    """{flat var: the full array gathered from every rank} for the ZeRO
    shards a rank holds at dp > 1 (parallel/zero.py `shard_names`)."""
    from ..parallel.zero import gathered_shards
    return gathered_shards(program, scope)


def _grace_s() -> float:
    try:
        return float(os.environ.get("PADDLE_LAUNCH_GRACE_S", "10"))
    except ValueError:
        return 10.0


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy without a copy (bf16 widened, as to_numpy
    does)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class Snapshot:
    """One complete in-memory snapshot: step tag + host arrays."""

    __slots__ = ("step", "arrays", "rank")

    def __init__(self, step: int, arrays: Dict[str, np.ndarray],
                 rank: int = 0):
        self.step = int(step)
        self.arrays = arrays
        self.rank = int(rank)

    def restore(self, scope, program=None, device=None) -> int:
        """Write the snapshot into `scope` (io.py `restore_arrays`: in
        place where the scope holds the tensors, the RNG counter restored;
        given `program`, ZeRO buckets packed on the host)."""
        from ..io import restore_arrays
        restore_arrays(scope, self.arrays, program=program, device=device)
        return self.step


class _Job:
    __slots__ = ("step", "slot", "host", "rng", "program", "done",
                 "start", "t0")

    def __init__(self, step, slot, host, rng, program, done, start, t0):
        self.step, self.slot, self.host, self.rng = step, slot, host, rng
        self.program, self.done, self.start, self.t0 = (program, done,
                                                         start, t0)


class SnapshotManager:
    """Double-buffered snapshots for one trainer process.

        mgr = SnapshotManager(interval=4)
        mgr.maybe_capture(program, scope, step)    # per step, cheap
        mgr.flush("sigterm")                       # newest -> disk

    The executor drives `maybe_capture` when FLAGS_snapshot_steps > 0;
    `install_sigterm_flush` arms the flush on SIGTERM/SIGUSR1."""

    def __init__(self, interval: int = 0, root: Optional[str] = None,
                 rank: Optional[int] = None, world: Optional[int] = None):
        env_rank, env_world = _rank_world()
        self.interval = int(interval)
        self.root = root or snapshot_dir()
        self.rank = env_rank if rank is None else int(rank)
        self.world = env_world if world is None else int(world)
        self._buffers: list = [None, None]   # Snapshot double buffer
        self._newest = -1                    # index into _buffers
        self._pinned = [{}, {}]              # per slot: name -> host tensor
        self._streams: dict = {}             # device -> copy stream
        self._lock = threading.Lock()
        self._job: Optional[_Job] = None
        self._job_ready = threading.Condition(self._lock)
        self._idle = threading.Event()
        self._idle.set()
        self._stop = False
        self._worker: Optional[threading.Thread] = None
        self._prev_handlers: dict = {}

    # -- capture -----------------------------------------------------------
    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._capture_loop,
                                            daemon=True,
                                            name="snapshot-capture")
            self._worker.start()

    def _buffer(self, slot, name, t):
        buf = self._pinned[slot].get(name)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[slot][name] = buf
        return buf

    def maybe_capture(self, program, scope, step: int,
                      sync: bool = False,
                      prev_step: Optional[int] = None) -> bool:
        """On the cadence, start a copy of the portable state and hand it
        to the worker: when `step % interval == 0`, or when a window of
        steps (prev_step, step] crossed a multiple of the interval.
        Returns True when a capture was started (with sync=True:
        completed). The calling thread never waits for the device unless
        sync=True; its own time is `resilience.snapshot_host_ms`."""
        if self.interval <= 0:
            return False
        if step % self.interval != 0 and (
                prev_step is None
                or step // self.interval == prev_step // self.interval):
            return False
        # at dp > 1 every rank gathers its ZeRO shards on the cadence
        # (a collective), before the skip below, which each rank decides
        # on its own
        full = _gathered_shards(program, scope)
        if not self._idle.is_set():
            _metrics.inc("resilience.snapshot_skips")
            return False
        from ..io import RNG_SCOPE_KEY, _persistable_names
        t0 = time.perf_counter()
        with self._lock:
            slot = 1 - self._newest if self._newest >= 0 else 0
            self._buffers[slot] = None     # its buffers are rewritten now
        host, cuda = {}, {}
        for n in _persistable_names(program, scope):
            v = full.get(n, scope.find(n))
            if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                cuda[n] = v
            elif isinstance(v, torch.Tensor):
                host[n] = v.detach().clone()
            else:
                host[n] = torch.as_tensor(np.array(v, copy=True))
        done = start = None
        if cuda:
            dev = next(iter(cuda.values())).device
            main = torch.cuda.current_stream(dev)
            side = self._streams.get(dev)
            if side is None:
                side = self._streams[dev] = torch.cuda.Stream(dev)
            side.wait_stream(main)
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(side):
                start.record(side)
                for n, t in cuda.items():
                    host[n] = self._buffer(slot, n, t)
                    host[n].copy_(t, non_blocking=True)
                done.record(side)
            # the next step updates this state in place: it waits for the
            # copy on the device, the host does not
            main.wait_event(done)
        job = _Job(int(step), slot, host, scope.find(RNG_SCOPE_KEY),
                   program, done, start, t0)
        with self._lock:
            self._job = job
            self._idle.clear()
            self._job_ready.notify()
        self._ensure_worker()
        _metrics.observe("resilience.snapshot_host_ms",
                         (time.perf_counter() - t0) * 1000.0)
        if sync:
            self.wait()
        return True

    def _capture_loop(self):
        while True:
            with self._lock:
                while self._job is None and not self._stop:
                    self._job_ready.wait(timeout=0.5)
                if self._stop:
                    self._idle.set()
                    return
                job, self._job = self._job, None
            try:
                self._capture(job)
            finally:
                self._idle.set()

    def _capture(self, job: _Job):
        from ..io import RNG_FILE_KEY
        from ..parallel.zero import unbucket_state_for_save
        if job.done is not None:
            job.done.synchronize()       # the worker waits, not the caller
            _metrics.observe("resilience.snapshot_copy_ms",
                             job.start.elapsed_time(job.done))
        arrays = {n: _host_array(t) for n, t in job.host.items()}
        arrays = unbucket_state_for_save(job.program, arrays)
        if job.rng is not None:
            arrays[RNG_FILE_KEY] = np.int64(job.rng)
        snap = Snapshot(job.step, arrays, rank=self.rank)
        with self._lock:
            self._buffers[job.slot] = snap
            self._newest = job.slot       # swap after the copy completed
        dt_ms = (time.perf_counter() - job.t0) * 1000.0
        _metrics.inc("resilience.snapshots")
        _metrics.observe("resilience.snapshot_ms", dt_ms)
        _trace.instant("snapshot", args={"step": job.step,
                                         "ms": round(dt_ms, 3)},
                       cat="resilience")

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until no capture is in flight."""
        return self._idle.wait(timeout)

    def latest(self) -> Optional[Snapshot]:
        with self._lock:
            return self._buffers[self._newest] if self._newest >= 0 else None

    def peer_payload(self):
        raise _item19("SnapshotManager.peer_payload")

    def replicate(self, gloo):
        raise _item19("SnapshotManager.replicate")

    # -- flush + SIGTERM ---------------------------------------------------
    def _own_dir(self, rank: Optional[int] = None) -> str:
        return os.path.join(self.root,
                            f"rank{self.rank if rank is None else rank}")

    def flush(self, reason: str = "manual") -> Optional[str]:
        """Write the newest complete snapshot to disk through
        CheckpointManager (atomic publish, checksummed manifest; a torn
        write keeps the previous flush). Waits for a capture in flight at
        most half the launcher's grace budget."""
        self.wait(timeout=max(1.0, _grace_s() * 0.5))
        snap = self.latest()
        if snap is None:
            return None
        mgr = CheckpointManager(self._own_dir(), max_keep=2)
        path = mgr.save(snap.step, arrays=snap.arrays,
                        meta={"kind": "snapshot", "reason": reason,
                              "rank": self.rank})
        _metrics.inc("resilience.snapshot_flushes")
        return path

    def install_sigterm_flush(self, exit_after: bool = True) -> None:
        """SIGTERM/SIGUSR1 flush the newest snapshot, chain the previous
        handler and (by default) exit 128 + signal. Main thread only;
        idempotent."""
        if threading.current_thread() is not threading.main_thread():
            return

        def _on_signal(signum, frame):
            try:
                self.flush(reason=f"signal_{signum}")
            except Exception:
                # a failed flush (disk full, injected fault) must not eat
                # the signal: the previous flush is still published
                pass
            prev = self._prev_handlers.get(signum)
            if callable(prev):
                prev(signum, frame)
            if exit_after:
                raise SystemExit(128 + int(signum))

        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                prev = signal.signal(sig, _on_signal)
            except (ValueError, OSError):
                continue
            if sig not in self._prev_handlers:
                self._prev_handlers[sig] = prev

    def uninstall(self) -> None:
        for sig, prev in list(self._prev_handlers.items()):
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
            self._prev_handlers.pop(sig, None)

    def close(self):
        """Stop the worker (after a capture in flight), restore the signal
        handlers and release the pinned buffers."""
        self.wait()
        with self._lock:
            self._stop = True
            self._job_ready.notify()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        self.uninstall()
        self._pinned = [{}, {}]


# -- recovery ladder --------------------------------------------------------

def _load_rung(root_dir: str):
    """(step, arrays) of the newest valid flushed snapshot under
    `root_dir`, or None; torn flushes fall back as checkpoints do."""
    if not os.path.isdir(root_dir):
        return None
    mgr = CheckpointManager(root_dir, max_keep=2)
    step, payload = mgr.latest_valid()
    if step is None:
        return None
    return int(payload.get("step", step)), mgr.load_arrays(step)


def recover(scope, root: Optional[str] = None, rank: Optional[int] = None,
            ckpt_manager: Optional[CheckpointManager] = None,
            stamp: bool = True, program=None, device=None, peer=False):
    """The recovery ladder over the local snapshot rung, then the disk
    CheckpointManager: restores the first rung holding a complete state
    into `scope` and returns ("local" | "disk", step), or (None, None) on
    a fresh start. `stamp` records the outcome in
    `<root>/recovery_rank<r>.json`. `peer=True` (the reference's first
    rung) raises: it is ROADMAP item 19.1."""
    if peer:
        raise _item19("recover(peer=True)")
    env_rank, _ = _rank_world()
    rank = env_rank if rank is None else int(rank)
    root = root or snapshot_dir()
    chosen, step = None, None
    got = _load_rung(os.path.join(root, f"rank{rank}"))
    if got is not None:
        step, arrays = got
        Snapshot(step, arrays, rank=rank).restore(scope, program=program,
                                                  device=device)
        chosen = "local"
    elif ckpt_manager is not None:
        restored = ckpt_manager.restore_latest(program=program, scope=scope,
                                               device=device)
        if restored is not None:
            chosen, step = "disk", int(restored)
    if chosen is not None:
        _metrics.inc(f"resilience.recover_{chosen}")
    if stamp:
        _stamp_recovery(root, rank, chosen, step)
    return chosen, step


def _stamp_recovery(root: str, rank: int, rung: Optional[str],
                    step: Optional[int]) -> None:
    """Atomic rung record for a supervisor's log. Never raises."""
    try:
        os.makedirs(root, exist_ok=True)
        path = os.path.join(root, f"recovery_rank{rank}.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"rank": rank, "rung": rung or "none",
                       "step": step, "pid": os.getpid(),
                       "wall_time": time.time()}, f)
        os.replace(tmp, path)
    except OSError:
        pass


def read_recovery_stamps(root: str, since: float = 0.0) -> list:
    """The rung records written after `since`, sorted by rank."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        if not (name.startswith("recovery_rank")
                and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(root, name)) as f:
                rec = json.load(f)
            if float(rec.get("wall_time") or 0.0) >= since:
                out.append(rec)
        except (OSError, ValueError):
            continue
    return sorted(out, key=lambda r: int(r.get("rank", 0)))
