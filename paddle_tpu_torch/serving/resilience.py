"""Serving health states and the shed contract (the `Health` and
`shed_handle` parts of paddle_tpu/serving/resilience.py; replica
failover, drain and resurrection are not ported yet)."""
from __future__ import annotations

from ..observability import metrics as _metrics
from .request import RequestHandle, RequestState


class Health:
    """Engine health. A standalone engine is LIVE until it fails, then
    DEAD. A speculative draft arm (serving/spec.py) also passes through
    RESURRECTING when `resurrect_draft` rebuilds it (the frontend's
    SUSPECT state is not ported)."""
    LIVE = "live"
    DEAD = "dead"
    RESURRECTING = "resurrecting"


def shed_handle(handle: RequestHandle, reason: str,
                detail: str) -> RequestHandle:
    """Finish a handle as SHED with the typed taxonomy reason: counts
    `serving.shed_total` and `serving.shed.<reason>`, and finishes the
    handle `shed:<reason>` (its result() raises ShedError)."""
    _metrics.inc("serving.shed_total")
    _metrics.inc(f"serving.shed.{reason}")
    handle._finish(RequestState.REJECTED, f"shed:{reason}", error=detail)
    return handle
