"""The data-parallel mesh (counterpart of paddle_tpu/parallel/mesh.py, dp
only).

The reference's mesh is a jax `Mesh` of devices with named axes
dp/tp/pp/sp/ep, held by one process. The port runs one process per rank
(distributed/parallel.py), so its mesh is one axis, `dp`, over the
processes of the default group: `build_mesh(dp=-1)` spans the group, and
`dp` must equal its size. Any other axis above 1 raises: tensor, pipeline,
sequence and expert parallelism are ROADMAP item 16.
"""
from __future__ import annotations

from typing import Optional

from ..distributed.parallel import (get_rank, get_world_size,
                                    init_parallel_env)

__all__ = ["Mesh", "build_mesh", "set_mesh", "get_mesh", "get_rank",
           "get_world_size", "init_parallel_env"]

_current: Optional["Mesh"] = None


class Mesh:
    """A 1-D `dp` mesh over the default group's processes."""

    axis_names = ("dp",)

    def __init__(self, dp: int):
        self.shape = {"dp": int(dp)}

    @property
    def size(self) -> int:
        return self.shape["dp"]

    def __repr__(self):
        return f"Mesh(dp={self.shape['dp']})"


def build_mesh(dp: int = -1, tp: int = 1, pp: int = 1, sp: int = 1,
               ep: int = 1, devices=None) -> Mesh:
    """A `dp` mesh over the group (dp=-1: the whole group)."""
    for axis, n in (("tp", tp), ("pp", pp), ("sp", sp), ("ep", ep)):
        if int(n) > 1:
            raise NotImplementedError(
                f"a mesh with {axis}={n}: tensor, pipeline, sequence and "
                f"expert parallelism are not ported yet (ROADMAP item 16); "
                f"the port's mesh is data parallel only")
    world = get_world_size()
    dp = world if int(dp) == -1 else int(dp)
    if dp != world:
        raise ValueError(
            f"build_mesh(dp={dp}) over a group of {world} process(es): the "
            f"port runs one process per dp rank")
    return Mesh(dp)


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _current
    _current = mesh


def get_mesh() -> Optional[Mesh]:
    return _current

