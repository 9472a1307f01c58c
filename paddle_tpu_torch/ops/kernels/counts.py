"""Launch counts under CUDA graph capture, for the flash (B1-B3) and fused
update (B6-B8) wrappers and the collectives (distributed/collective.py).

A wrapper adds one to its kernel's count where it launches it
(`count(launches, name)`; a collective also adds its bytes, `n`). While a stream is being captured
(`capture(stream)`), a launch made on that stream is recorded instead of
counted, on whatever thread it is made: a captured training step's
backward kernels are launched by the autograd engine's device thread, on
the capturing stream. A capture records kernels without running them;
each replay of the graph then counts what the capture recorded
(`count_replay`). (The paged decode wrapper keeps its own per-thread
recorder, ops/kernels/paged_attention.py `capture_launches`.)
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Tuple

_lock = threading.Lock()
# CUDA stream handle -> the launches recorded by the capture under way on it
_active: Dict[int, List[Tuple[Dict[str, int], str, int]]] = {}


def count(launches: Dict[str, int], name: str, n: int = 1):
    if _active:
        import torch
        if torch.cuda.is_current_stream_capturing():
            rec = _active.get(torch.cuda.current_stream().cuda_stream)
            if rec is not None:
                with _lock:
                    rec.append((launches, name, n))
                return
    with _lock:
        launches[name] += n


@contextlib.contextmanager
def capture(stream):
    """Within the block, launches made on `stream` while it captures are
    recorded into the list it yields ([(launches dict, name, amount)])
    instead of counted."""
    rec: List[Tuple[Dict[str, int], str, int]] = []
    key = stream.cuda_stream
    with _lock:
        _active[key] = rec
    try:
        yield rec
    finally:
        with _lock:
            _active.pop(key, None)


def count_replay(rec):
    """Count the launches of one replay of a graph whose capture recorded
    `rec`."""
    with _lock:
        for launches, name, n in rec:
            launches[name] += n
