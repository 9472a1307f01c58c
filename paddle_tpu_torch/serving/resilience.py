"""Fault-tolerant serving: replica failover, the health loop, canary-gated
resurrection and graceful drain (counterpart of
paddle_tpu/serving/resilience.py).

It rests on one property: decode is a pure function of (prompt, seed,
token index), in the port as in the reference (sampling is a counter hash
of (seed, generated index), models/gpt_decode.sample_rows; B4's bits
depend on a slot's position only). A request re-dispatched to another
replica therefore REPLAYS its tokens bit for bit, and failover is
lossless.

* **Replica failover**: a dying engine (`DecodeEngine._fail_all`) hands
  every queued and in-flight request (prompt, seed, the tokens streamed
  so far) to the frontend's failover sink, which re-dispatches each to
  the least-loaded live replica; the handle swallows the replay of the
  tokens the caller already has (`RequestHandle._arm_resume`). A
  per-request budget (`FLAGS_serving_failover_budget`) turns a repeat
  victim into a typed RequestFailedError.
* **Health states and resurrection**: live -> suspect (the engine died
  and handed its work over) -> dead (the frontend confirms) ->
  resurrecting -> live. The health loop resets a dead engine in place
  (`DecodeEngine.resurrect`: pools and static buffers zeroed, the
  captured graphs kept, no capture while other replicas serve) and
  re-admits it only after a CANARY decode equals a live replica's tokens.
  Attempts ride a RetryPolicy (`FLAGS_serving_resurrect_budget`);
  exhaustion parks the engine dead. A speculative draft walks the same
  ladder one level down.
* **Least-loaded routing**: `submit` routes to the live replica with the
  fewest pending decode tokens, preferring one with queue room; no live
  replica raises the typed NoHealthyReplicaError.
* **Graceful drain**: `drain()` stops admission (new submits shed with
  reason `draining`), lets in-flight slots decode to completion, and hands
  back the unstarted requests.

Recovery is timed into the metrics registry: `serving.resurrect_ms` (the
reset), `serving.canary_ms` (the canary decode) and `serving.recover_ms`
(from the engine's death to LIVE again). Everything is drivable
deterministically through the fault sites of resilience/faults.py.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..flags import flag
from ..framework import errors as _errors
from ..observability import metrics as _metrics
from ..observability import trace as _trace
from ..resilience.retry import RetryPolicy
from .request import (Request, RequestHandle, RequestState,
                      ServingError)


class Health:
    """Engine health as the frontend sees it. SUSPECT is self-reported
    (the engine died and handed over its work); DEAD is the frontend's
    confirmation (a standalone engine goes straight there); RESURRECTING
    covers the reset and the canary gate."""
    LIVE = "live"
    SUSPECT = "suspect"
    DEAD = "dead"
    RESURRECTING = "resurrecting"


class NoHealthyReplicaError(ServingError):
    """Every replica behind the frontend is dead. Typed, so a caller can
    tell "service down" from a per-request rejection."""


def shed_handle(handle: RequestHandle, reason: str,
                detail: str) -> RequestHandle:
    """Finish a handle as SHED with the typed taxonomy reason: counts
    `serving.shed_total` and `serving.shed.<reason>`, drops a trace
    instant, and finishes the handle `shed:<reason>` (its result() raises
    ShedError)."""
    _metrics.inc("serving.shed_total")
    _metrics.inc(f"serving.shed.{reason}")
    _trace.instant("serving.shed",
                   args={"uid": handle.request.uid, "reason": reason})
    handle._finish(RequestState.REJECTED, f"shed:{reason}", error=detail)
    return handle


# the fixed canary request: tiny, greedy, deterministic; its tokens are a
# pure function of the weights, so a resurrected replica that reproduces a
# live replica's canary serves the same model
_CANARY_PROMPT_LEN = 4
_CANARY_NEW_TOKENS = 3


class ServingFrontend:
    """N replicas with least-loaded routing, failover, a health loop and
    graceful drain. `RoundRobinFrontend` (serving/frontend.py) stays as
    the minimal baseline."""

    def __init__(self, engines: List, resurrect: bool = True):
        if not engines:
            raise ValueError("no engines")
        self.engines = list(engines)
        self._resurrect_enabled = bool(resurrect)
        self._lock = threading.Lock()
        self._stopped = False
        self._draining = False
        self._gave_up: set = set()          # engine ids past the budget
        self._unexpected_errors: Dict[int, int] = {}
        self._canary_tokens: Optional[List[int]] = None
        self.failover_total = 0             # monotonic (the stats value)
        self.failover_log: List[str] = []   # last 1024 re-dispatched uids
        for eng in self.engines:
            eng._failover = self._failover_sink
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True,
            name="serving-frontend-health")
        self._health_thread.start()

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------
    def _live(self, exclude=None) -> List:
        return [e for e in self.engines
                if e is not exclude and e.health == Health.LIVE
                and e._dead is None]

    def submit(self, request: Request,
               bounded: bool = True) -> RequestHandle:
        if self._draining or self._stopped:
            return shed_handle(RequestHandle(request), "draining",
                               "frontend draining")
        # least-loaded over the live set, preferring replicas with queue
        # room; the _probe submit returns None (no shed counted) if the
        # pick dies under us, so a routing retry elsewhere counts nothing
        for _ in range(len(self.engines)):
            live = self._live()
            if not live:
                break
            with_room = [e for e in live if not e.queue_full()]
            eng = min(with_room or live, key=lambda e: e.load())
            handle = eng.submit(request, _probe=True, bounded=bounded)
            if handle is not None:
                _metrics.inc("serving.frontend_dispatch")
                return handle
        dead = sum(1 for e in self.engines if e.health == Health.DEAD)
        raise NoHealthyReplicaError(
            f"no healthy replica ({len(self.engines)} total, "
            f"{dead} dead)")

    def generate(self, requests: List[Request], timeout: float = 300.0):
        """Batch-style (`bounded=False`, as DecodeEngine.generate): a
        finite known workload queues FCFS past the online admission
        bounds."""
        handles = [self.submit(r, bounded=False) for r in requests]
        return [h.result(timeout=timeout, raise_on_error=False)
                for h in handles]

    # ------------------------------------------------------------------
    # failover
    # ------------------------------------------------------------------
    def _failover_sink(self, src, victims, why: str,
                       charge_unserved: bool = False):
        """Called by a dying engine with its in-flight work,
        [(Request, RequestHandle)], queued entries and live slots alike.
        Re-dispatches each to a live replica (the deterministic re-decode
        replays the tokens already streamed), bounded by the per-request
        failover budget."""
        budget = int(flag("FLAGS_serving_failover_budget"))
        for req, handle in victims:
            # an engine death does not charge a never-served queue victim
            # (it is freely re-routable, as drain() has it); a prefill
            # failure (charge_unserved) always charges, or a request that
            # always fails would ping-pong between replicas forever
            if charge_unserved or handle.tokens_so_far():
                handle.failovers += 1
            if handle.failovers > budget:
                handle._finish(
                    RequestState.FAILED,
                    "failover budget exhausted",
                    error=f"{handle.failovers - 1} failover(s) already "
                          f"spent (budget {budget}); engine death: {why}")
                continue
            replay = handle._arm_resume()
            placed = False
            for eng in sorted(self._live(exclude=src),
                              key=lambda e: e.load()):
                if eng.submit(req, _handle=handle,
                              _failover=True) is not None:
                    placed = True
                    break
            if placed:
                _metrics.inc("serving.failovers")
                _trace.instant("serving.failover",
                               args={"uid": req.uid, "replay": replay,
                                     "attempt": handle.failovers})
                with self._lock:
                    self.failover_total += 1
                    self.failover_log.append(req.uid)
                    del self.failover_log[:-1024]   # bounded memory
            else:
                handle._finish(
                    RequestState.FAILED,
                    "no healthy replica for failover",
                    error=f"engine death: {why}")

    # ------------------------------------------------------------------
    # health loop + resurrection
    # ------------------------------------------------------------------
    def _health_loop(self):
        while not self._stopped:
            time.sleep(
                float(flag("FLAGS_serving_health_interval_ms")) / 1000.0)
            if self._stopped or self._draining:
                continue
            for eng in self.engines:
                if self._stopped or self._draining:
                    break
                try:
                    self._health_tick(eng)
                except Exception as e:  # noqa: BLE001 — the loop IS the
                    # resilience tier: an unexpected error (a canary
                    # timing out, a reset raising) must not kill the
                    # thread and with it every later recovery
                    _metrics.inc("serving.health_loop_errors")
                    _trace.instant("serving.health_loop_error",
                                   args={"engine": eng._id,
                                         "error": repr(e)})
                    if eng.health == Health.RESURRECTING:
                        eng._dead = f"resurrection error: {e!r}"
                        eng._set_health(Health.DEAD)
                    n = self._unexpected_errors.get(id(eng), 0) + 1
                    self._unexpected_errors[id(eng)] = n
                    if n >= int(flag("FLAGS_serving_resurrect_budget")):
                        self._gave_up.add(id(eng))
                        _metrics.inc("serving.resurrect_gave_up")

    def _health_tick(self, eng):
        h = eng.health
        if h == Health.LIVE and eng._dead is not None:
            # died without reporting (a stop()-time _fail_all)
            eng._set_health(Health.SUSPECT)
        elif h == Health.SUSPECT:
            eng._set_health(Health.DEAD)    # frontend-confirmed
        elif (h == Health.DEAD and self._resurrect_enabled
                and id(eng) not in self._gave_up):
            self._try_resurrect(eng)
            return
        # the DRAFT arm walks the same ladder one level down: a dead draft
        # only costs speculation (the target serves plain decode), so it
        # is resurrected behind a LIVE target and re-armed only after the
        # canary passes WITH speculation armed
        spec = getattr(eng, "spec", None)
        if spec is None or eng.health != Health.LIVE \
                or eng._dead is not None:
            return
        if spec.health == Health.SUSPECT:
            spec._set_health(Health.DEAD)   # frontend-confirmed
        elif (spec.health == Health.DEAD and self._resurrect_enabled
                and ("draft", id(eng)) not in self._gave_up):
            self._try_resurrect_draft(eng)

    def _policy(self) -> RetryPolicy:
        return RetryPolicy(
            max_attempts=int(flag("FLAGS_serving_resurrect_budget")),
            base_delay_s=0.05, max_delay_s=1.0, deadline_s=None,
            retry_on=(_errors.UnavailableError,))

    def _aborted(self) -> bool:
        return self._stopped or self._draining

    def _try_resurrect(self, eng):
        try:
            self._policy().call(self._resurrect_once, eng,
                                site="serving.resurrect",
                                abort=self._aborted)
        except _errors.DeadlineExceededError as e:
            eng._set_health(Health.DEAD)
            if self._aborted():
                return    # aborted by stop/drain, not out of budget
            self._gave_up.add(id(eng))
            eng._dead = f"resurrection budget exhausted: {e}"
            _metrics.inc("serving.resurrect_gave_up")

    def _resurrect_once(self, eng):
        if self._aborted():
            raise _errors.Unavailable("frontend stopping: resurrection "
                                      "of engine %d aborted", eng._id)
        t0 = time.perf_counter()
        eng.resurrect()
        t1 = time.perf_counter()
        expected = self._canary_expected()
        t2 = time.perf_counter()
        comp = self._run_canary(eng)
        t3 = time.perf_counter()
        if self._stopped:
            # stop() raced the canary: a stopped frontend must not leak a
            # revived engine with a live service thread
            eng.stop()
            raise _errors.Unavailable("frontend stopped during the canary "
                                      "of engine %d", eng._id)
        if eng._dead is not None:
            # the engine died DURING its canary: the failover sink may
            # have re-dispatched the canary to a healthy replica, whose
            # tokens must not vouch for this engine
            eng._set_health(Health.DEAD)
            raise _errors.Unavailable(
                "engine %d died during its canary decode (%s)",
                eng._id, eng._dead)
        if not comp.ok or (expected is not None
                           and comp.tokens != expected):
            eng._dead = (f"canary failed: got {comp.tokens} "
                         f"want {expected} ({comp.finish_reason})")
            eng._set_health(Health.DEAD)
            raise _errors.Unavailable("serving canary mismatch on engine "
                                      "%d", eng._id)
        if expected is None:
            # admitted on completes-cleanly: no live replica existed to
            # give the expectation; said once per such resurrection
            _metrics.inc("serving.canary_ungated")
            _trace.instant("serving.canary_ungated",
                           args={"engine": eng._id})
        eng._set_health(Health.LIVE)
        _metrics.observe("serving.resurrect_ms", (t1 - t0) * 1000.0)
        _metrics.observe("serving.canary_ms", (t3 - t2) * 1000.0)
        if eng._died_at is not None:
            _metrics.observe("serving.recover_ms",
                             (time.perf_counter() - eng._died_at) * 1000.0)
        # a clean recovery forgives earlier transient health-loop errors
        self._unexpected_errors.pop(id(eng), None)
        _trace.instant("serving.resurrected", args={"engine": eng._id})

    def _try_resurrect_draft(self, eng):
        try:
            self._policy().call(self._resurrect_draft_once, eng,
                                site="serving.spec.resurrect",
                                abort=self._aborted)
        except _errors.DeadlineExceededError:
            eng.spec._set_health(Health.DEAD)
            if self._aborted():
                return
            self._gave_up.add(("draft", id(eng)))
            _metrics.inc("serving.resurrect_gave_up")

    def _resurrect_draft_once(self, eng):
        if self._aborted():
            raise _errors.Unavailable(
                "frontend stopping: draft resurrection of engine %d "
                "aborted", eng._id)
        spec = eng.spec
        spec.resurrect_draft()
        # provisional re-arm: the canary must decode THROUGH speculation
        # to vouch for the draft path; its expectation is the same either
        # way (spec-on tokens == spec-off tokens)
        spec.rearm()
        expected = self._canary_expected()
        comp = self._run_canary(eng)
        if eng._dead is not None:
            # the TARGET died during the spec-armed canary: its own ladder
            # owns the recovery now
            spec._set_health(Health.DEAD)
            raise _errors.Unavailable(
                "engine %d died during the spec-armed canary (%s)",
                eng._id, eng._dead)
        if not comp.ok or (expected is not None
                           and comp.tokens != expected):
            spec._set_health(Health.DEAD)
            raise _errors.Unavailable(
                "spec-armed canary mismatch on engine %d", eng._id)
        _metrics.inc("serving.spec.rearmed")
        _trace.instant("serving.spec.rearmed", args={"engine": eng._id})

    def _canary_expected(self) -> Optional[List[int]]:
        """The canary's expected tokens, taken once from a LIVE replica.
        With none live the gate degrades to completes-cleanly (counted)."""
        if self._canary_tokens is None:
            live = self._live()
            if live:
                comp = self._run_canary(live[0])
                if comp.ok:
                    self._canary_tokens = comp.tokens
        return self._canary_tokens

    def _run_canary(self, eng):
        vocab = eng.model_config.vocab_size
        req = Request(
            prompt=np.arange(1, 1 + _CANARY_PROMPT_LEN) % vocab,
            max_new_tokens=_CANARY_NEW_TOKENS,
            uid=f"canary-e{eng._id}")
        return eng.submit(req).result(timeout=60.0, raise_on_error=False)

    # ------------------------------------------------------------------
    # drain + stop
    # ------------------------------------------------------------------
    def drain(self, timeout_s: Optional[float] = None) -> List[Request]:
        """Stop admission, finish in-flight windows, hand back the
        unstarted requests. New submits (and the handles of handed-back
        requests) shed with reason `draining`; the returned Requests can
        be re-submitted elsewhere by the caller."""
        if timeout_s is None:
            timeout_s = float(flag("FLAGS_serving_drain_timeout_ms")) \
                / 1000.0
        self._draining = True
        _metrics.inc("serving.drains")
        deadline = time.monotonic() + timeout_s
        handed_back: List[Request] = []
        for eng in self.engines:
            if eng._dead is not None:
                continue
            # a small floor lets an engine past the deadline still clear
            # and hand back its queue
            remaining = max(deadline - time.monotonic(), 0.1)
            handed_back.extend(
                req for req, _ in eng.drain(timeout_s=remaining))
        _metrics.inc("serving.drained_unstarted", len(handed_back))
        return handed_back

    def stop(self):
        self._stopped = True
        self._health_thread.join(timeout=5)
        for eng in self.engines:
            eng._failover = None     # stop()-time deaths must not bounce
        for eng in self.engines:
            eng.stop()

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        per = [e.stats() for e in self.engines]
        return {
            "replicas": len(per),
            "live": sum(1 for e in self.engines
                        if e.health == Health.LIVE and e._dead is None),
            "health": {e._id: e.health for e in self.engines},
            "completed": sum(s["completed"] for s in per),
            "windows": sum(s["windows"] for s in per),
            "failovers": self.failover_total,
            "draining": self._draining,
            "per_replica": per,
        }
