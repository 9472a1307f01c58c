r"""Request / response types and the per-request lifecycle (a copy of
paddle_tpu/serving/request.py; the port imports nothing of the reference).

A request is a first-class object with a LIFECYCLE, because the engine
interleaves many requests through one slot array:

    QUEUED -> PREFILL -> DECODE -> DONE
         \-> REJECTED        \-> FAILED

Timing fields follow the serving-literature conventions: TTFT (time to
first token — submit to first sampled token materialized on host) and
TPOT (time per output token over the decode phase). Both feed the typed
metrics registry (`serving.ttft_ms` / `serving.tpot_ms` histograms).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np


class ServingError(RuntimeError):
    """A request failed or was rejected; .completion has the details."""

    def __init__(self, msg, completion=None):
        super().__init__(msg)
        self.completion = completion


class ShedError(ServingError):
    """The request was SHED by admission control: the engine judged it
    could not serve it within its capacity/deadline contract and rejected
    it typed-and-early rather than queueing it to time out. `.reason` is
    the taxonomy key (queue_full | deadline_unmeetable | unfundable |
    draining | engine_dead | admit_fault); the same key lands in the
    `serving.shed.<reason>` counter."""

    def __init__(self, msg, completion=None, reason: str = ""):
        super().__init__(msg, completion=completion)
        self.reason = reason


class RequestFailedError(ServingError):
    """The request FAILED terminally — its engine died and it either
    exhausted the per-request failover budget
    (FLAGS_serving_failover_budget re-dispatches) or no healthy replica
    remained to take it (a standalone engine fails it at once). Distinct
    from ShedError: shed requests were never served; failed requests may
    have streamed tokens first."""


class RequestState:
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    FAILED = "failed"
    REJECTED = "rejected"


@dataclasses.dataclass
class Request:
    """One generation request. `prompt` is a 1-D int token array;
    temperature 0.0 means greedy; `seed` drives the per-request sampling
    noise (a generator seeded with (seed, generated_index) — the same
    scheme models/gpt_decode.generate uses, so a fixed seed reproduces the
    same tokens no matter which slot or window carries the request)."""
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    eos_token: Optional[int] = None
    uid: Optional[str] = None
    # admission-control deadline: if the engine estimates the QUEUE WAIT
    # alone already exceeds this, the request is shed at submit
    # (reason deadline_unmeetable) instead of queueing to time out.
    # None = no deadline (never deadline-shed).
    deadline_ms: Optional[float] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        # mask into the PRNG's u32 seed space (deterministic for any int —
        # a negative/huge seed must not blow up on the service thread)
        self.seed = int(self.seed) & 0xFFFFFFFF
        if self.uid is None:
            self.uid = f"req-{id(self):x}"


@dataclasses.dataclass
class Completion:
    uid: str
    state: str
    prompt_len: int
    tokens: List[int]                  # generated tokens (eos included)
    finish_reason: str                 # "eos" | "length" | error/reject text
    ttft_ms: Optional[float] = None
    tpot_ms: Optional[float] = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.state == RequestState.DONE


class RequestHandle:
    """The caller's view of an in-flight request. `result()` blocks until
    retirement; `tokens_so_far()` streams without blocking. The handle is
    written only by the engine's service thread; readers see a consistent
    snapshot under the handle lock."""

    def __init__(self, request: Request, flow_id: Optional[int] = None):
        self.request = request
        self.flow_id = flow_id
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._state = RequestState.QUEUED
        self._tokens: List[int] = []
        self._finish_reason = ""
        self._error: Optional[str] = None
        self.t_submit = time.perf_counter()
        self.t_first_token: Optional[float] = None
        self.t_retire: Optional[float] = None
        # failover bookkeeping (serving/resilience.py): how many times the
        # request was re-dispatched after an engine death, and how many
        # replayed tokens to swallow before appending resumes. Decode is
        # deterministic ((seed, token_idx) noise), so the re-decode from
        # the prompt REPLAYS exactly the tokens the caller already saw.
        self.failovers = 0
        self._skip = 0
        self._ttft_observed = False

    # ---- engine side -----------------------------------------------------
    def _set_state(self, state: str):
        with self._lock:
            self._state = state

    def _arm_resume(self) -> int:
        """Prepare the handle for re-dispatch to another replica: tokens
        appended next are a deterministic REPLAY of what was already
        streamed, so swallow exactly that many before appending resumes.
        Returns the replay length (for telemetry)."""
        with self._lock:
            self._skip = len(self._tokens)
            self._state = RequestState.QUEUED
            return self._skip

    def _append_tokens(self, toks):
        now = time.perf_counter()
        with self._lock:
            if self._skip:
                take = min(self._skip, len(toks))
                self._skip -= take
                toks = list(toks)[take:]
            if not self._tokens and toks:
                self.t_first_token = now
            self._tokens.extend(int(t) for t in toks)

    def _finish(self, state: str, reason: str, error: Optional[str] = None):
        with self._lock:
            self._state = state
            self._finish_reason = reason
            self._error = error
            self.t_retire = time.perf_counter()
        self._done.set()

    # ---- caller side -----------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def tokens_so_far(self) -> List[int]:
        with self._lock:
            return list(self._tokens)

    def done(self) -> bool:
        return self._done.is_set()

    def _ttft_ms_locked(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return (self.t_first_token - self.t_submit) * 1000.0

    def _tpot_ms_locked(self) -> Optional[float]:
        n = len(self._tokens)
        if self.t_retire is None or self.t_first_token is None or n < 2:
            return None
        return (self.t_retire - self.t_first_token) * 1000.0 / (n - 1)

    def ttft_ms(self) -> Optional[float]:
        with self._lock:
            return self._ttft_ms_locked()

    def tpot_ms(self) -> Optional[float]:
        with self._lock:
            return self._tpot_ms_locked()

    def completion(self) -> Completion:
        with self._lock:
            return Completion(
                uid=self.request.uid, state=self._state,
                prompt_len=int(self.request.prompt.shape[0]),
                tokens=list(self._tokens),
                finish_reason=self._finish_reason,
                ttft_ms=self._ttft_ms_locked(),
                tpot_ms=self._tpot_ms_locked(),
                error=self._error)

    def result(self, timeout: Optional[float] = None,
               raise_on_error: bool = True) -> Completion:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request.uid} not finished in {timeout}s "
                f"(state={self.state})")
        c = self.completion()
        if raise_on_error and not c.ok:
            msg = f"request {c.uid} {c.state}: {c.error or c.finish_reason}"
            if (c.state == RequestState.REJECTED
                    and c.finish_reason.startswith("shed:")):
                raise ShedError(msg, completion=c,
                                reason=c.finish_reason[len("shed:"):])
            if c.state == RequestState.FAILED:
                raise RequestFailedError(msg, completion=c)
            raise ServingError(msg, completion=c)
        return c
