"""Deterministic, seedable fault injection (counterpart of
paddle_tpu/resilience/faults.py).

Every resilience site calls `fault_point("<site>")`, and a FaultPlan
decides, deterministically from a seed and per-site call counters,
whether that call delays, raises or kills the process. With no plan
installed a site is a near-free no-op.

Spec grammar (`FLAGS_fault_plan`, or `install_plan`):

    plan   := clause (";" clause)*
    clause := site ":" action (":" key "=" value)*
    action := "error" | "kill" | "delay=<seconds>"
    keys   := every=N   fire when the site's call count is a multiple of N
              at=N      fire exactly on the N-th call (1-based)
              p=F       fire with probability F (deterministic in the seed)
              times=N   fire at most N times total

Example: "serving.window:error:at=2"

Sites of the port (grep fault_point for ground truth), all on the host and
before any device work, never inside a CUDA graph capture:
    serving.admit        at submit; an error sheds the request
                         (reason admit_fault)
    serving.prefill      per admission, inside the per-request isolation
                         boundary
    serving.window       before each decode window and verify pass; an
                         error kills the engine (the failover drill's
                         replica-kill site)
    serving.spec.draft   before each draft proposal; an error degrades
                         the engine to plain decode
    ckpt.write           after a checkpoint's data is written and before
                         it is published (io.py `_atomic_savez`,
                         CheckpointManager.save); an error leaves the
                         previous checkpoint the newest complete one
    dataloader.worker    per batch, inside a DataLoader worker process
                         (dataloader/dataloader.py `_worker_loop`; the
                         plan reaches the worker as its (spec, seed)): an
                         error fails the epoch naming the worker, a kill
                         exits it with KILL_EXIT_CODE (a respawn under
                         FLAGS_dataloader_max_respawns, else the epoch
                         fails naming the exit code)
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from ..framework.errors import UnavailableError
from ..monitor import stat_add


class FaultInjected(UnavailableError):
    """Raised by an `error` fault rule. Subclasses UnavailableError (a
    transient, retryable condition) so RetryPolicy recovers from it exactly
    as it would from a real dropped RPC."""


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def _str_hash(s: str) -> int:
    # FNV-1a, NOT builtin hash(): PYTHONHASHSEED randomizes the latter per
    # interpreter, which would give every run (and every forkserver worker)
    # a different p= fault schedule and retry-jitter sequence
    h = 0xCBF29CE484222325
    for b in s.encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _hash01(seed: int, site: str, count: int) -> float:
    h = _splitmix64(seed ^ _splitmix64(_str_hash(site))
                    ^ _splitmix64(count))
    return (h >> 11) / float(1 << 53)


class FaultRule:
    __slots__ = ("site", "action", "delay_s", "every", "at", "p", "times",
                 "fired")

    def __init__(self, site: str, action: str, delay_s: float = 0.0,
                 every: Optional[int] = None, at: Optional[int] = None,
                 p: Optional[float] = None, times: Optional[int] = None):
        assert action in ("error", "kill", "delay"), action
        self.site = site
        self.action = action
        self.delay_s = float(delay_s)
        self.every = every
        self.at = at
        self.p = p
        self.times = times
        self.fired = 0

    def should_fire(self, seed: int, count: int) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        if self.at is not None and count != self.at:
            return False
        if self.every is not None and count % self.every != 0:
            return False
        if self.p is not None and _hash01(seed, self.site, count) >= self.p:
            return False
        return True


class FaultPlan:
    """A parsed plan: per-site call counters + the rules that consult them.
    Counters are per-process and per-plan, so the same spec replays the same
    faults — the property the bit-for-bit chaos parity check relies on."""

    KILL_EXIT_CODE = 43   # distinctive, so tests/ops can tell kill-injection
                          # deaths from organic crashes

    def __init__(self, spec: str = "", seed: int = 0):
        self.spec = spec or ""
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self.rules: List[FaultRule] = []
        for clause in filter(None, (c.strip()
                                    for c in self.spec.split(";"))):
            self.rules.append(self._parse_clause(clause))

    @staticmethod
    def _parse_clause(clause: str) -> FaultRule:
        parts = clause.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"fault clause {clause!r}: want site:action[:k=v...]")
        site, action = parts[0], parts[1]
        delay_s = 0.0
        if action.startswith("delay="):
            delay_s = float(action.split("=", 1)[1])
            action = "delay"
        kw: dict = {}
        for opt in parts[2:]:
            k, _, v = opt.partition("=")
            if k == "every":
                kw["every"] = int(v)
            elif k == "at":
                kw["at"] = int(v)
            elif k == "p":
                kw["p"] = float(v)
            elif k == "times":
                kw["times"] = int(v)
            else:
                raise ValueError(f"fault clause {clause!r}: unknown "
                                 f"option {k!r}")
        return FaultRule(site, action, delay_s, **kw)

    def fire(self, site: str):
        """Advance `site`'s counter and apply any triggered rules. Called
        from the fault_point() sites; raising FaultInjected / sleeping /
        os._exit happens HERE, before the wrapped operation runs, so a
        retried operation replays identical arithmetic."""
        with self._lock:
            count = self._counts.get(site, 0) + 1
            self._counts[site] = count
            triggered = [r for r in self.rules
                         if r.site == site and r.should_fire(self.seed, count)]
            for r in triggered:
                r.fired += 1
        for r in triggered:
            stat_add("resilience.faults_injected")
            if r.action == "delay":
                time.sleep(r.delay_s)
            elif r.action == "error":
                raise FaultInjected(
                    f"injected fault at site {site!r} (call #{count})")
            elif r.action == "kill":
                os._exit(self.KILL_EXIT_CODE)

    def count(self, site: str) -> int:
        with self._lock:
            return self._counts.get(site, 0)


_plan: Optional[FaultPlan] = None
_plan_lock = threading.Lock()


def install_plan(plan_or_spec, seed: int = 0) -> FaultPlan:
    """Install the process-global plan (tests / chaos harnesses)."""
    global _plan
    plan = (plan_or_spec if isinstance(plan_or_spec, FaultPlan)
            else FaultPlan(str(plan_or_spec), seed))
    with _plan_lock:
        _plan = plan
    return plan


def clear_plan():
    global _plan
    with _plan_lock:
        _plan = None


def current_plan() -> Optional[FaultPlan]:
    """The installed plan, else one lazily built from FLAGS_fault_plan
    (seeded from the FLAGS_fault_plan env var at import — the reference's
    gflags-at-interpreter-start semantics)."""
    global _plan
    if _plan is not None:
        return _plan
    from ..flags import flag
    spec = flag("FLAGS_fault_plan")
    if not spec:
        return None
    with _plan_lock:
        if _plan is None:
            _plan = FaultPlan(spec, int(flag("FLAGS_fault_seed")))
    return _plan


def fault_point(site: str):
    """The injection hook. A no-op (one None check + one flag read) unless a
    plan is installed or FLAGS_fault_plan is set."""
    plan = _plan if _plan is not None else current_plan()
    if plan is not None:
        plan.fire(site)
