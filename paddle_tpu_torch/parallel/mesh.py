"""The device mesh (counterpart of paddle_tpu/parallel/mesh.py): the dp
and pp axes.

The reference's mesh is a jax `Mesh` of devices with named axes
dp/tp/pp/sp/ep, held by one process. The port runs one process per dp
rank (distributed/parallel.py), so its `dp` axis spans the processes of
the default group: `build_mesh(dp=-1)` spans the group, and `dp` must
equal its size. Its `pp` axis lives inside the process, as the
reference's single-controller pipeline does: a list of P torch devices,
one per pipeline stage (parallel/pipeline.py). `devices=None` means
`cuda:0` ... `cuda:P-1`; `devices=` may name one device more than once
(two stages sharing a card) or `"cpu"` P times.

dp x pp: each dp rank (process) holds its own P stage devices. Without
`devices=`, rank r of a node (`LOCAL_RANK`) takes `cuda:r*P` ...
`cuda:r*P+P-1`; `devices=` names this rank's stage devices (two ranks
sharing one card name `cuda:0` P times each). The pipeline runner then
averages the summed microbatch gradients over the dp ranks before the
optimizer (parallel/pipeline.py).

Not ported (ROADMAP item 16): tensor, sequence and expert parallelism
(tp, sp or ep above 1 raises).
"""
from __future__ import annotations

import os
from typing import List, Optional

import torch

from ..distributed.parallel import (get_rank, get_world_size,
                                    init_parallel_env)
from ..framework import errors

__all__ = ["Mesh", "build_mesh", "set_mesh", "get_mesh", "get_rank",
           "get_world_size", "init_parallel_env"]

_current: Optional["Mesh"] = None


class Mesh:
    """dp processes of the default group x pp stage devices of this
    process. `devices` holds the pp axis: stage s runs on devices[s]."""

    axis_names = ("dp", "pp")

    def __init__(self, dp: int, devices: Optional[List[torch.device]] = None):
        self.devices = list(devices or [])
        self.shape = {"dp": int(dp), "pp": max(1, len(self.devices))}

    @property
    def size(self) -> int:
        return self.shape["dp"]

    def __repr__(self):
        if self.shape["pp"] > 1:
            return f"Mesh(dp={self.shape['dp']}, pp={self.devices})"
        return f"Mesh(dp={self.shape['dp']})"


def _stage_devices(pp: int, devices, dp: int = 1) -> List[torch.device]:
    if devices is None:
        base = pp * int(os.environ.get("LOCAL_RANK", "0") or 0) \
            if dp > 1 else 0
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < base + pp:
            raise errors.Unavailable(
                "build_mesh(pp=%d) without devices= places stage s of this "
                "rank on cuda:%d+s, and %d CUDA device(s) are visible: pass "
                "devices= (one device may hold several stages)", pp, base,
                have)
        return [torch.device("cuda", base + s) for s in range(pp)]
    devs = [torch.device(d) for d in devices]
    if len(devs) != pp:
        raise errors.InvalidArgument(
            "build_mesh(pp=%d) with %d devices: name one device a stage",
            pp, len(devs))
    return devs


def build_mesh(dp: int = -1, tp: int = 1, pp: int = 1, sp: int = 1,
               ep: int = 1, devices=None) -> Mesh:
    """A mesh of `dp` processes (dp=-1: the whole group) and, with
    pp > 1, `pp` stage devices in each of them (module docstring)."""
    for axis, n in (("tp", tp), ("sp", sp), ("ep", ep)):
        if int(n) > 1:
            raise NotImplementedError(
                f"a mesh with {axis}={n}: tensor, sequence and expert "
                f"parallelism are not ported yet (ROADMAP item 16)")
    world = get_world_size()
    dp = world if int(dp) == -1 else int(dp)
    pp = int(pp)
    if dp != world:
        raise ValueError(
            f"build_mesh(dp={dp}) over a group of {world} process(es): the "
            f"port runs one process per dp rank")
    if pp <= 1:
        return Mesh(dp)
    return Mesh(dp, _stage_devices(pp, devices, dp))


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _current
    _current = mesh


def get_mesh() -> Optional[Mesh]:
    return _current
