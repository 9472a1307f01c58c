"""Replicated serving: N decode engines over one weight copy, and the
round-robin frontend (counterpart of paddle_tpu/serving/frontend.py;
`worker_main`, the launcher-supervised worker, is not ported yet).

Each replica owns its slot array, paged pools, CUDA graphs, graph memory
pool, static buffers and stream, and SHARES the prepared weight tensors
(the windows only read them). `replicated_engines` builds the replicas
from one prepared parameter set; `RoundRobinFrontend` spreads submissions
and skips dead replicas, so one dead engine costs capacity, not
availability. ServingFrontend (serving/resilience.py) adds least-loaded
routing, failover, resurrection and drain.
"""
from __future__ import annotations

import itertools
import threading
from typing import List, Optional

from ..observability import metrics as _metrics
from .engine import DecodeEngine, EngineConfig
from .request import Request, RequestHandle
from .resilience import NoHealthyReplicaError


def replicated_engines(n: int, params, model_config,
                       config: Optional[EngineConfig] = None,
                       device=None, **overrides) -> List[DecodeEngine]:
    """N engines over ONE weight set: prepare_params runs once, inside the
    first engine; the rest adopt its tensors, so replicas add pools, not
    weights."""
    first = DecodeEngine(params, model_config, config=config,
                         device=device, **overrides)
    return [first] + [_clone_engine(first) for _ in range(n - 1)]


def _clone_engine(src: DecodeEngine) -> DecodeEngine:
    """A replica sharing src's prepared params and scales (the same
    tensors, the same data_ptr) with its own cache, graphs and scheduler.
    A spec-enabled source hands its draft's prepared tensors over the same
    way: one draft weight copy across replicas."""
    return DecodeEngine(
        None, src.model_config, config=src.config, device=src.device,
        _prepared=(src.params, src.scales, src.compute_dtype),
        _draft_prepared=(src.spec.draft_prepared
                         if src.spec is not None else None))


class RoundRobinFrontend:
    """Spread requests over replicas; skip dead ones; aggregate stats."""

    def __init__(self, engines: List[DecodeEngine]):
        if not engines:
            raise ValueError("no engines")
        self.engines = list(engines)
        self._rr = itertools.count()
        self._lock = threading.Lock()

    def submit(self, request: Request,
               bounded: bool = True) -> RequestHandle:
        n = len(self.engines)
        with self._lock:
            start = next(self._rr)
        for probe in range(n):
            eng = self.engines[(start + probe) % n]
            if eng._dead is None:
                _metrics.inc("serving.frontend_dispatch")
                return eng.submit(request, bounded=bounded)
        # every replica dead: a typed signal the caller can act on
        raise NoHealthyReplicaError(f"all {n} replicas dead")

    def generate(self, requests: List[Request], timeout: float = 300.0):
        """Batch-style: a finite known workload queues FCFS past the
        online admission bounds."""
        handles = [self.submit(r, bounded=False) for r in requests]
        return [h.result(timeout=timeout, raise_on_error=False)
                for h in handles]

    def stop(self):
        for e in self.engines:
            e.stop()

    def stats(self) -> dict:
        per = [e.stats() for e in self.engines]
        return {
            "replicas": len(per),
            "live": sum(1 for s in per if not s["dead"]),
            "completed": sum(s["completed"] for s in per),
            "windows": sum(s["windows"] for s in per),
            "per_replica": per,
        }
