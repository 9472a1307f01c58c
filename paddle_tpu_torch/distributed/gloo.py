"""Host collectives over Python values (counterpart of
paddle_tpu/distributed/gloo.py: `_Store` :54, `Gloo` :120).

Rank 0 hosts a small TCP store (length-prefixed pickles over loopback or
the network) that gathers one value per rank per round and serves the set
back: barrier, all_gather, all_reduce and broadcast of host values, as
the reference's GlooWrapper offers them. Device tensors go through the
process group (distributed/collective.py); this path carries host values
only, the fingerprints of resilience/integrity.py's DivergenceSentinel
among them, and the snapshots that resilience/snapshot.py replicates to
a ring buddy (hundreds of MB a rank: each message is received in place
into one buffer). Rendezvous dials and every round are bounded by
FLAGS_gloo_timeout_ms (each wait for a peer's value, and each receive
call of a message in flight): a dead peer or store raises the typed
DeadlineExceededError instead of parking the rank. Fault sites:
"gloo.rendezvous" (per dial), "gloo.exchange" (per round).

`from_env()` builds the group of a launched job: rank 0 hosts the store
on its `PADDLE_CURRENT_ENDPOINT` port, the others dial
`PADDLE_TRAINER_ENDPOINTS[0]`.
"""
from __future__ import annotations

import pickle
import socket
import struct
import threading
from typing import List, Optional

import numpy as np

from ..framework.errors import DeadlineExceeded
from ..resilience.faults import FaultInjected, fault_point
from ..resilience.retry import RetryPolicy


def _gloo_timeout_s() -> float:
    from ..flags import flag
    return flag("FLAGS_gloo_timeout_ms") / 1000.0


def _send_msg(sock, obj):
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("<Q", len(data)))
    sock.sendall(data)


def _recv_exact(sock, n: int) -> bytearray:
    """Exactly n bytes, received in place into one buffer (a value of
    hundreds of MB, such as a snapshot, costs one copy, not one per
    chunk)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(16 << 20, n - got))
        if not k:
            raise ConnectionError("gloo store peer closed")
        got += k
    return buf


def _recv_msg(sock):
    n = struct.unpack("<Q", bytes(_recv_exact(sock, 8)))[0]
    return pickle.loads(_recv_exact(sock, n))


class _Store:
    """Rank-0 TCP store: gathers one value per rank per round, then serves
    the full set back (one round-trip collective primitive)."""

    def __init__(self, world_size: int, port: int = 0,
                 round_timeout_s: Optional[float] = None):
        self.world = world_size
        self.round_timeout_s = (round_timeout_s if round_timeout_s is not None
                                else _gloo_timeout_s())
        self.srv = socket.socket()
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind(("0.0.0.0", port))
        self.port = self.srv.getsockname()[1]
        self.srv.listen(world_size + 4)
        self._lock = threading.Condition()
        self._rounds: dict = {}
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while self._running:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                break
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        try:
            while True:
                tag, rank, value = _recv_msg(conn)
                with self._lock:
                    rnd = self._rounds.setdefault(tag, {})
                    rnd["values"] = rnd.get("values", {})
                    rnd["values"][rank] = value
                    self._lock.notify_all()
                    while len(self._rounds[tag]["values"]) < self.world:
                        if not self._lock.wait(timeout=self.round_timeout_s):
                            self._rounds.pop(tag, None)  # poison removed
                            raise TimeoutError(
                                f"gloo round {tag} timed out waiting for "
                                f"{self.world - len(rnd['values'])} rank(s)")
                    vals = self._rounds[tag]["values"]
                    full = [vals[r] for r in range(self.world)]
                    rnd["served"] = rnd.get("served", 0) + 1
                    if rnd["served"] >= self.world:   # GC completed rounds
                        self._rounds.pop(tag, None)
                _send_msg(conn, full)
        except TimeoutError as e:
            import sys
            print(f"[gloo] {e}", file=sys.stderr)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def stop(self):
        self._running = False
        try:
            self.srv.close()
        except OSError:
            pass


class Gloo:
    """The GlooWrapper surface: barrier / all_reduce / all_gather /
    broadcast of host values (module docstring). Rendezvous dials under a
    RetryPolicy bounded by `rendezvous_timeout_s`; every round is bounded
    by `op_timeout_s`."""

    def __init__(self, rank: int, world_size: int,
                 store_addr: Optional[str] = None, port: int = 0,
                 rendezvous_timeout_s: Optional[float] = None,
                 op_timeout_s: Optional[float] = None):
        self.rank = rank
        self.world = world_size
        self._store = None
        self._round = 0
        if rendezvous_timeout_s is None:
            rendezvous_timeout_s = _gloo_timeout_s()
        self.op_timeout_s = (op_timeout_s if op_timeout_s is not None
                             else _gloo_timeout_s())
        # injected faults fire before any byte moves, so retrying them is
        # always stream-safe; a real mid-round socket error is NOT retried
        # (the length-prefixed stream would desync) — it propagates
        self._op_retry = RetryPolicy(max_attempts=None,
                                     deadline_s=self.op_timeout_s,
                                     retry_on=(FaultInjected,))
        if rank == 0 and store_addr is None:
            self._store = _Store(world_size, port,
                                 round_timeout_s=self.op_timeout_s)
            host, sport = "127.0.0.1", self._store.port
        else:
            assert store_addr, "non-root ranks need store_addr host:port"
            host, sport = store_addr.rsplit(":", 1)

        def dial():
            fault_point("gloo.rendezvous")
            return socket.create_connection((host, int(sport)),
                                            timeout=rendezvous_timeout_s)

        dial_retry = RetryPolicy(max_attempts=None, base_delay_s=0.05,
                                 max_delay_s=1.0,
                                 deadline_s=rendezvous_timeout_s)
        self.sock = dial_retry.call(dial, site="gloo.rendezvous")

    @property
    def store_port(self):
        return self._store.port if self._store else None

    def _exchange(self, value):
        tag = self._round
        self._round += 1

        def op():
            fault_point("gloo.exchange")
            self.sock.settimeout(self.op_timeout_s)
            try:
                _send_msg(self.sock, (tag, self.rank, value))
                return _recv_msg(self.sock)
            except socket.timeout as e:
                # poison the socket (kvstore.cc PingDeadline does the
                # same): the round's late reply is still owed on this
                # stream, so a caller that catches the error and issues
                # round N+1 here would read round N's values as its own
                try:
                    self.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                raise DeadlineExceeded(
                    "gloo round %d timed out after %.1fs (rank %d/%d) — "
                    "peer or store dead?", tag, self.op_timeout_s,
                    self.rank, self.world) from e

        return self._op_retry.call(op, site="gloo.exchange")

    def barrier(self):
        self._exchange(None)

    def all_gather(self, value) -> List:
        return self._exchange(value)

    def all_reduce(self, value, op: str = "sum"):
        vals = [np.asarray(v) for v in self._exchange(np.asarray(value))]
        if op == "sum":
            return sum(vals[1:], vals[0].copy())
        if op == "max":
            return np.maximum.reduce(vals)
        if op == "min":
            return np.minimum.reduce(vals)
        raise ValueError(f"unsupported reduce op {op!r}")

    def broadcast(self, value, root: int = 0):
        return self._exchange(value)[root]

    def close(self):
        try:
            self.sock.close()
        finally:
            if self._store:
                self._store.stop()


def from_env(rendezvous_timeout_s: Optional[float] = None,
             op_timeout_s: Optional[float] = None) -> Gloo:
    """The host group of a launched job, from the trainer env contract
    (module docstring)."""
    import os
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1)
    eps = [e for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                                     "").split(",") if e]
    if world > 1 and len(eps) < world:
        raise ValueError(
            f"gloo.from_env: PADDLE_TRAINER_ENDPOINTS lists {len(eps)} "
            f"endpoint(s) for {world} ranks")
    if rank == 0:
        port = int(eps[0].rsplit(":", 1)[1]) if eps else 0
        return Gloo(0, world, port=port,
                    rendezvous_timeout_s=rendezvous_timeout_s,
                    op_timeout_s=op_timeout_s)
    return Gloo(rank, world, store_addr=eps[0],
                rendezvous_timeout_s=rendezvous_timeout_s,
                op_timeout_s=op_timeout_s)
