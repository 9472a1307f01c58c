"""RetryPolicy: one exponential-backoff / jitter / deadline policy for
transient failures (counterpart of paddle_tpu/resilience/retry.py). The
serving frontend retries a dead engine's resurrection under it.
Exhausting the policy raises DeadlineExceededError instead of hanging.

Stats (monitor.py): `resilience.retries` per retried attempt,
`resilience.gave_up` per exhaustion. Each retried attempt also drops a
`retry` instant on the trace timeline (observability/trace.py) with the
site and attempt number.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

from ..framework.errors import (DeadlineExceededError, DeadlineExceeded,
                                UnavailableError)
from ..monitor import stat_add
from ..observability import trace as _trace
from .faults import _hash01

# Transient by default: socket/IO errors and the typed "service not
# reachable right now" (FaultInjected subclasses UnavailableError).
DEFAULT_RETRYABLE: Tuple[type, ...] = (OSError, ConnectionError,
                                       UnavailableError)


# The reference's defaults (its FLAGS_retry_* and FLAGS_rpc_deadline_ms):
# the port's one caller, ServingFrontend, passes its own.
DEFAULT_MAX_ATTEMPTS = 4
DEFAULT_BASE_DELAY_S = 0.02
DEFAULT_MAX_DELAY_S = 2.0
DEFAULT_DEADLINE_S = 10.0


class RetryPolicy:
    """Exponential backoff + deterministic jitter + deadline + max-attempts.

    delay(attempt) = min(max_delay, base * multiplier**attempt)
                     * (1 + jitter * (2u - 1)),  u = hash01(seed, attempt)

    Jitter is hashed, not drawn from global RNG state: a retried run
    schedules the same sleeps every time, keeping chaos runs reproducible.
    `max_attempts=None` means unbounded (the deadline is then the only
    bound); `deadline_s=None` means no wall-clock bound.
    """

    def __init__(self, max_attempts: Optional[int] = -1,
                 base_delay_s: float = None, max_delay_s: float = None,
                 multiplier: float = 2.0, jitter: float = 0.25,
                 deadline_s: float = -1.0,
                 retry_on: Tuple[type, ...] = None,
                 seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep):
        # -1 sentinels -> defaults (None stays None = unbounded)
        if max_attempts == -1:
            max_attempts = DEFAULT_MAX_ATTEMPTS
        if seed is None:   # the flag's help text promises it seeds jitter
            from ..flags import flag
            seed = int(flag("FLAGS_fault_seed"))
        if base_delay_s is None:
            base_delay_s = DEFAULT_BASE_DELAY_S
        if max_delay_s is None:
            max_delay_s = DEFAULT_MAX_DELAY_S
        if deadline_s == -1.0:
            deadline_s = DEFAULT_DEADLINE_S
        self.max_attempts = max_attempts
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.deadline_s = deadline_s
        self.retry_on = retry_on or DEFAULT_RETRYABLE
        self.seed = int(seed)
        self._sleep = sleep

    def backoff(self, attempt: int) -> float:
        """Delay before retry number `attempt` (0-based)."""
        d = min(self.max_delay_s,
                self.base_delay_s * (self.multiplier ** attempt))
        u = _hash01(self.seed, "backoff", attempt)
        return max(0.0, d * (1.0 + self.jitter * (2.0 * u - 1.0)))

    def call(self, fn: Callable, *args, site: str = "?",
             abort: Optional[Callable[[], bool]] = None, **kwargs):
        """Run fn(*args, **kwargs), retrying transient failures under the
        policy. Raises DeadlineExceededError (chaining the last real error)
        on exhaustion; non-retryable exceptions propagate untouched.

        `abort` (optional) is polled between attempts AND during backoff
        sleeps (chunked): when it returns True the policy stops retrying
        immediately and raises DeadlineExceededError noting the abort —
        so a long backoff ladder (e.g. serving-engine resurrection) can
        be cancelled by a shutting-down owner instead of outliving it."""
        start = time.monotonic()
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except DeadlineExceededError:
                raise              # a nested policy already gave up
            except self.retry_on as e:
                attempt += 1
                elapsed = time.monotonic() - start
                out_of_attempts = (self.max_attempts is not None
                                   and attempt >= self.max_attempts)
                out_of_time = (self.deadline_s is not None
                               and elapsed >= self.deadline_s)
                aborted = abort is not None and abort()
                if out_of_attempts or out_of_time or aborted:
                    stat_add("resilience.gave_up")
                    _trace.instant("retry_gave_up",
                                   args={"site": site, "attempts": attempt},
                                   cat="resilience")
                    raise DeadlineExceeded(
                        "%s: gave up after %d attempt(s) / %.2fs (%s); "
                        "last error: %r", site, attempt, elapsed,
                        "aborted" if aborted else
                        ("deadline" if out_of_time else "max_attempts"),
                        e) from e
                stat_add("resilience.retries")
                _trace.instant("retry", args={"site": site,
                                              "attempt": attempt},
                               cat="resilience")
                delay = self.backoff(attempt - 1)
                if self.deadline_s is not None:
                    delay = min(delay,
                                max(0.0, self.deadline_s - elapsed))
                if delay > 0:
                    if abort is None:
                        self._sleep(delay)
                    else:
                        end = time.monotonic() + delay
                        while True:
                            if abort():
                                # same telemetry as the attempt-boundary
                                # exhaustion path: a give-up is a give-up
                                # wherever in the sleep the abort landed
                                stat_add("resilience.gave_up")
                                _trace.instant(
                                    "retry_gave_up",
                                    args={"site": site,
                                          "attempts": attempt},
                                    cat="resilience")
                                raise DeadlineExceeded(
                                    "%s: aborted during backoff after %d "
                                    "attempt(s); last error: %r",
                                    site, attempt, e) from e
                            remaining = end - time.monotonic()
                            if remaining <= 0:
                                break
                            self._sleep(min(0.05, remaining))
