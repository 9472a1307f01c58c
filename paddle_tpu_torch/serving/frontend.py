"""Replicated serving: N decode engines over one weight copy, the
round-robin frontend, and `worker_main`, a decode worker the gang
launcher supervises (counterpart of paddle_tpu/serving/frontend.py).

Each replica owns its slot array, paged pools, CUDA graphs, graph memory
pool, static buffers and stream, and SHARES the prepared weight tensors
(the windows only read them). `replicated_engines` builds the replicas
from one prepared parameter set; `RoundRobinFrontend` spreads submissions
and skips dead replicas, so one dead engine costs capacity, not
availability. ServingFrontend (serving/resilience.py) adds least-loaded
routing, failover, resurrection and drain.

`worker_main` runs one rank of a serving gang under
`python -m paddle_tpu_torch.distributed.launch --nproc_per_node N
<script>`, where the script calls it: the launcher's rendezvous,
heartbeats, fail-fast sibling kill and straggler naming apply to decode
workers as to trainers.
"""
from __future__ import annotations

import itertools
import json
import os
import signal
import threading
from typing import List, Optional

from ..observability import metrics as _metrics
from .engine import DecodeEngine, EngineConfig
from .request import Request, RequestHandle
from .resilience import NoHealthyReplicaError, ServingFrontend


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


# ---------------------------------------------------------------------------
# the supervised worker (a rank of a gang under distributed/launch.py)
# ---------------------------------------------------------------------------

def worker_main(requests_path: str, out_dir: str, model: str = "tiny",
                dtype: str = "float32", max_slots: int = 4,
                max_len: int = 128, window: int = 0, replicas: int = 1,
                block_size: int = 0, num_blocks: int = 64,
                device=None) -> int:
    """One supervised decode worker (the reference's :113). Builds the GPT
    (`model` "tiny" or "small", GPT-2 small) from the startup program
    seeded 0 on `device` (cuda unless the caller asks for the CPU) and
    serves it with `params_from_scope`; takes the rank-th shard of the
    JSONL request file (rows {"uid", "prompt", "max_new", "temperature"?,
    "top_k"?, "seed"?}; row i belongs to rank i mod world, by
    PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM); serves it through a
    ServingFrontend over `replicas` engines; writes one row per request to
    `<out_dir>/rank<r>.jsonl` ({"uid", "state", "tokens",
    "finish_reason", "ttft_ms", "tpot_ms", "rank"}). Returns the exit
    code: 0, or 1 when a request failed.

    SIGTERM (the supervisor's preemption signal) starts a graceful drain
    bounded by half of PADDLE_LAUNCH_GRACE_S: in-flight requests finish,
    the unstarted ones are handed back and written with the state
    "handed_back", and the worker exits 0."""
    import numpy as np
    from ..framework import Executor, default_startup_program
    from ..models.gpt import GPTConfig, build_lm_program
    from ..models.gpt_decode import params_from_scope
    from ..testing import reset_programs

    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1)
    if model not in ("tiny", "small"):
        raise ValueError(f"worker_main: model {model!r} is not 'tiny' or "
                         "'small'")
    reset_programs(seed=0)
    cfg = GPTConfig.tiny() if model == "tiny" else GPTConfig.small()
    cfg.max_position = max(cfg.max_position, max_len)
    build_lm_program(cfg)
    exe = Executor(device)
    exe.run(default_startup_program())
    params = params_from_scope(cfg, device=exe.device)

    with open(requests_path) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    mine = [r for i, r in enumerate(rows) if i % world == rank]
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"rank{rank}.jsonl")
    kw = dict(max_slots=max_slots, max_len=max_len, window=window,
              dtype=dtype, block_size=block_size, num_blocks=num_blocks)
    engines = (replicated_engines(replicas, params, cfg, device=exe.device,
                                  **kw)
               if replicas > 1 else
               [DecodeEngine(params, cfg, device=exe.device, **kw)])
    fe = ServingFrontend(engines)
    handed_back: List[Request] = []

    def _on_term(signum, frame):
        grace = float(os.environ.get("PADDLE_LAUNCH_GRACE_S", "10") or 10)
        handed_back.extend(fe.drain(timeout_s=max(grace * 0.5, 1.0)))

    prev_term = None
    if threading.current_thread() is threading.main_thread():
        prev_term = signal.signal(signal.SIGTERM, _on_term)
    try:
        completions = fe.generate([
            Request(prompt=np.asarray(r["prompt"], np.int64),
                    max_new_tokens=int(r["max_new"]),
                    temperature=float(r.get("temperature", 0.0)),
                    top_k=int(r.get("top_k", 0)),
                    seed=int(r.get("seed", 0)),
                    uid=str(r.get("uid", f"r{rank}-{i}")))
            for i, r in enumerate(mine)], timeout=600)
        handed = {r.uid for r in handed_back}
        with open(out_path, "w") as f:
            for c in completions:
                f.write(json.dumps({
                    "uid": c.uid,
                    "state": ("handed_back" if c.uid in handed
                              else c.state),
                    "tokens": [int(t) for t in c.tokens],
                    "finish_reason": c.finish_reason,
                    "ttft_ms": c.ttft_ms, "tpot_ms": c.tpot_ms,
                    "rank": rank}) + "\n")
    finally:
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
        fe.stop()
    # handed-back and drain-shed requests are not failures: the caller
    # (or the surviving workers) owns them now
    bad = [c for c in completions
           if not c.ok and c.uid not in handed
           and c.finish_reason != "shed:draining"]
    return 1 if bad else 0
