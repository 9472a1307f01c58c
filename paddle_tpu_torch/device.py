"""Default-device resolution for the port's entry points.

The port is written for the card: an entry point given no device runs on
`cuda`. The CPU is used only when the caller asks for it (the tests pass
`device="cpu"`). There is no silent fallback: asking for CUDA on a host
without it raises.
"""
from __future__ import annotations

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
