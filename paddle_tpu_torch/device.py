"""Default-device resolution for the port's entry points.

The port is written for the card: an entry point given no device runs on
`cuda`. The CPU is used only when the caller asks for it (the tests pass
`device="cpu"`). There is no silent fallback: asking for CUDA on a host
without it raises.

`capture_lock` serialises the process's CUDA graph captures, and
`collector_paused()` brackets every capture of the port.
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


# One CUDA graph capture at a time in the process, from any thread: a
# capture's warm-up and `torch.cuda.graph` (which synchronises the device
# and empties the allocator's cache at entry) must not land inside another
# thread's capture. Reentrant: `collector_paused` takes it too.
capture_lock = threading.RLock()
_gc_holds = 0
_gc_was_enabled = False


@contextlib.contextmanager
def collector_paused():
    """Python's cyclic collector off for the block, after one full
    collection if no other hold is active (every CUDA graph capture runs
    inside one, under `capture_lock`). A dead reference cycle that owns
    device state (an executor and its captured graph and memory pool, a
    replaced engine) is freed before the capture begins: freed inside it,
    its CUDA graph's destruction is an operation the capturing thread may
    not make, and the capture is invalidated. So the collection runs only
    while no hold is active anywhere (a capture holds `capture_lock` for
    its whole length, so a hold that collects waits for it). Holds nest,
    across threads; the collector's state before the first hold comes back
    after the last."""
    global _gc_holds, _gc_was_enabled
    with capture_lock:
        if _gc_holds == 0:
            gc.collect()
            _gc_was_enabled = gc.isenabled()
            gc.disable()
        _gc_holds += 1
    try:
        yield
    finally:
        with capture_lock:
            _gc_holds -= 1
            if _gc_holds == 0 and _gc_was_enabled:
                gc.enable()
