"""Default-device resolution for the port's entry points.

The port is written for the card: an entry point given no device runs on
`cuda`. The CPU is used only when the caller asks for it (the tests pass
`device="cpu"`). There is no silent fallback: asking for CUDA on a host
without it raises.

`collector_paused()` brackets every CUDA graph capture of the port.
"""
from __future__ import annotations

import contextlib
import gc
import threading
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> cuda; a CUDA device on a host without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the port on the CPU")
    return dev


_gc_lock = threading.Lock()
_gc_holds = 0
_gc_was_enabled = False


@contextlib.contextmanager
def collector_paused():
    """One full collection, then Python's cyclic collector off for the
    block (every CUDA graph capture runs inside one). A dead reference
    cycle that owns device state (an executor and its captured graph and
    memory pool, a replaced engine) is freed before the capture begins:
    freed inside it, its CUDA graph's destruction is an operation the
    capturing thread may not make, and the capture is invalidated. Holds
    nest, across threads; the collector's state before the first hold
    comes back after the last."""
    global _gc_holds, _gc_was_enabled
    gc.collect()
    with _gc_lock:
        if _gc_holds == 0:
            _gc_was_enabled = gc.isenabled()
            gc.disable()
        _gc_holds += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_holds -= 1
            if _gc_holds == 0 and _gc_was_enabled:
                gc.enable()
