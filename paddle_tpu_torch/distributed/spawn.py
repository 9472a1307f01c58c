"""paddle.distributed.spawn: one process per rank for a training function
(counterpart of paddle_tpu/distributed/spawn.py: `free_ports` :20,
`spawn` :85).

Each worker gets the trainer env contract (PADDLE_TRAINER_ID,
PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS, PADDLE_CURRENT_ENDPOINT,
TRAINING_ROLE) plus `options["env"]`, runs `func(*args)` and reports its
result or traceback. `SpawnContext.join(timeout)` is bounded: past the
timeout, or when one worker fails, every worker still alive is killed
(SIGTERM, then SIGKILL) and the join raises, so a rank that dies never
leaves its siblings waiting in a collective and no worker outlives the
join.

`start_method` defaults to "spawn"; the port's test harness
(paddle_tpu_torch/testing.py) uses "forkserver" with torch preloaded.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue as _queue
import socket
import time
import traceback
from typing import Optional

__all__ = ["free_ports", "spawn", "SpawnContext"]


def free_ports(n: int = 1):
    """n distinct free localhost ports, each socket held open until all
    are bound."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _worker(func, rank, nprocs, endpoints, env_extra, q, args):
    os.environ.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
        "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
        "TRAINING_ROLE": "TRAINER",
        "LOCAL_RANK": str(rank),
        **(env_extra or {}),
    })
    try:
        out = func(*args)
        q.put((rank, "ok", pickle.dumps(out)))
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))
        raise


class SpawnContext:
    def __init__(self, procs, queue):
        self.processes = procs
        self._queue = queue
        self.results = {}

    def kill(self, grace_s: float = 2.0) -> None:
        """SIGTERM every worker still alive, SIGKILL past `grace_s`, and
        reap them all."""
        alive = [p for p in self.processes if p.is_alive()]
        for p in alive:
            p.terminate()
        deadline = time.monotonic() + grace_s
        for p in alive:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in alive:
            if p.is_alive():
                p.kill()
                p.join(5)

    def join(self, timeout: Optional[float] = 600.0) -> bool:
        """Collect every worker's result, bounded by `timeout` seconds in
        all. A worker's error, a worker dying without a result, or the
        timeout kills the rest and raises RuntimeError."""
        deadline = time.monotonic() + (timeout or 600.0)
        pending = {i for i in range(len(self.processes))}
        try:
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(
                        f"spawned trainers {sorted(pending)} did not finish "
                        f"within {timeout} s; the gang was killed")
                try:
                    rank, status, payload = self._queue.get(
                        timeout=min(left, 0.5))
                except _queue.Empty:
                    dead = [r for r in pending
                            if self.processes[r].exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"spawned trainer {dead[0]} exited "
                            f"{self.processes[dead[0]].exitcode} without a "
                            f"result; the gang was killed")
                    continue
                pending.discard(rank)
                if status == "error":
                    raise RuntimeError(
                        f"spawned trainer {rank} failed:\n{payload}")
                self.results[rank] = pickle.loads(payload)
            for p in self.processes:
                p.join(max(1.0, deadline - time.monotonic()))
            for p in self.processes:
                if p.exitcode not in (0, None):
                    raise RuntimeError(
                        f"spawned trainer pid={p.pid} exited {p.exitcode}")
        finally:
            self.kill()
        return True


def spawn(func, args=(), nprocs=1, join=True, daemon=False,
          timeout: Optional[float] = 600.0, **options):
    """Run `func(*args)` in `nprocs` processes with the trainer env
    contract; returns a SpawnContext (its `results` by rank after
    `join`)."""
    ctx = mp.get_context(options.get("start_method", "spawn"))
    endpoints = [f"127.0.0.1:{p}" for p in free_ports(nprocs)]
    q = ctx.Queue()
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_worker,
                        args=(func, rank, nprocs, endpoints,
                              options.get("env"), q, args),
                        daemon=daemon)
        p.start()
        procs.append(p)
    sctx = SpawnContext(procs, q)
    if join:
        sctx.join(timeout)
    return sctx
