"""The device mesh and the sharding rules (counterpart of
paddle_tpu/parallel/mesh.py).

The reference's mesh is a jax `Mesh` of devices with named axes
dp/tp/pp/sp/ep, held by one process, and GSPMD shards parameters by
`ShardingRules`. The port runs one process per rank of the dp, tp and sp
axes (distributed/parallel.py) and keeps pp inside the process:

* dp, tp, sp span the processes of the default group, laid out row-major
  as the reference's `np.array(devices).reshape(dp, tp, pp, sp, ep)`:
  rank = (d * tp + t) * sp + s. `build_mesh(dp=-1)` takes what the other
  axes leave of the group. With tp or sp above 1 the mesh holds a
  `torch.distributed.device_mesh.DeviceMesh` over those of dp/tp/sp that
  are above 1 (`Mesh.device_mesh`, its dims in that order), and the
  executor runs the program on DTensors over it (framework/executor.py):
  the counterpart of GSPMD. dp alone stays on the manual-dp path
  (parallel/zero.py) and holds no DeviceMesh.
* pp lives inside the process, as the reference's single-controller
  pipeline does: a list of P torch devices, one per stage
  (parallel/pipeline.py). `devices=None` means `cuda:0` ... `cuda:P-1`;
  `devices=` may name one device more than once (two stages sharing a
  card) or `"cpu"` P times. pp composes with every process axis: each
  process (one (dp, tp, sp) coordinate) holds its own P stage devices, as
  each of the reference's stages owns a pp submesh that keeps every other
  axis (reference parallel/pipeline.py:247-256); without `devices=`, the
  process of a node with `LOCAL_RANK` r takes `cuda:r*P` ...
  `cuda:r*P+P-1`. With tp or sp, a stage's DTensors live on its device
  over the process axes' DeviceMesh (parallel/pipeline.py); under NCCL
  that group is bound to the rank's own device, so every stage must be
  that device (`_check_stages_on_group`, which refuses the default
  stages there).

`ShardingRules` maps a parameter name to a spec, a tuple with one mesh
axis name (or a tuple of names, or None) per tensor dim, as the
reference's `PartitionSpec`: the first regex that matches wins, an
`@LAYERS` stacked name takes its per-layer rule shifted one dim right, and
`sharding_for` drops an axis that does not divide its dim (the
reference's :130-144) and returns DTensor placements for the mesh.

Not ported: ep (ROADMAP item 12, `switch_moe` is not ported) raises.
"""
from __future__ import annotations

import math
import os
import re
from typing import List, Optional, Sequence, Tuple

import torch

from ..distributed.parallel import (get_rank, get_world_size,
                                    init_parallel_env)
from ..framework import errors

__all__ = ["Mesh", "P", "PartitionSpec", "ShardingRules", "REPLICATED",
           "build_mesh", "set_mesh", "get_mesh", "get_rank",
           "get_world_size", "init_parallel_env", "moe_sharding_rules",
           "transformer_tp_rules"]

_current: Optional["Mesh"] = None
# the process axes, in the reference's row-major order (pp is in-process)
PROCESS_AXES = ("dp", "tp", "sp")


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names, or
    None (the reference's jax PartitionSpec, without jax)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


class Mesh:
    """dp x tp x sp processes of the default group x pp stage devices of
    this process. `devices` holds the pp axis: stage s runs on devices[s].
    `device_mesh` is the DeviceMesh over the process axes above 1 when tp
    or sp is above 1, else None."""

    axis_names = ("dp", "tp", "pp", "sp", "ep")

    def __init__(self, dp: int, devices: Optional[List[torch.device]] = None,
                 tp: int = 1, sp: int = 1, device_mesh=None):
        self.devices = list(devices or [])
        self.shape = {"dp": int(dp), "tp": int(tp),
                      "pp": max(1, len(self.devices)), "sp": int(sp),
                      "ep": 1}
        self.device_mesh = device_mesh
        self.mesh_axes: Tuple[str, ...] = tuple(
            a for a in PROCESS_AXES if self.shape[a] > 1) \
            if device_mesh is not None else ()

    @property
    def size(self) -> int:
        """The dp width (the manual-dp path's replica count)."""
        return self.shape["dp"]

    @property
    def mixed(self) -> bool:
        """tp or sp above 1: the program runs on DTensors."""
        return self.device_mesh is not None

    def coordinate(self, axis: str) -> int:
        """This rank's index along a process axis (0 for an axis of 1)."""
        if axis not in PROCESS_AXES:
            raise ValueError(f"{axis!r} is not a process axis")
        rank = get_rank()
        strides = {"dp": self.shape["tp"] * self.shape["sp"],
                   "tp": self.shape["sp"], "sp": 1}
        return (rank // strides[axis]) % self.shape[axis]

    def group(self, axis: str):
        """The process group of this rank's line along `axis` (None for
        an axis of 1)."""
        if self.shape.get(axis, 1) <= 1 or self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def __repr__(self):
        parts = [f"dp={self.shape['dp']}"]
        parts += [f"{a}={self.shape[a]}" for a in ("tp", "sp")
                  if self.shape[a] > 1]
        if self.shape["pp"] > 1:
            parts.append(f"pp={self.devices}")
        return f"Mesh({', '.join(parts)})"


def _stage_devices(pp: int, devices, procs: int = 1) -> List[torch.device]:
    if devices is None:
        base = pp * int(os.environ.get("LOCAL_RANK", "0") or 0) \
            if procs > 1 else 0
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


def _check_stages_on_group(stages: List[torch.device]) -> None:
    """With tp or sp, every stage's DTensors take their collectives on the
    process axes' group. NCCL binds that group to this rank's device
    (`rank_device()`, cuda:LOCAL_RANK), so under NCCL every stage must
    sit there; the default `cuda:r*P+s` stages would not. Gloo moves each
    collective through host memory and takes any stage device."""
    from ..distributed.parallel import backend, rank_device
    if backend() != "nccl":
        return
    home = rank_device()
    off = [str(d) for d in stages if d != home]
    if off:
        raise errors.Unimplemented(
            "pp with tp or sp under NCCL: stage device(s) %s are not this "
            "rank's group device %s, and the DTensor collectives of a "
            "stage run on its group's device; pass devices= naming %s for "
            "every stage (a DTensor on a second card per rank has never "
            "run, ROADMAP item 16)", ", ".join(off), home, home)


def _device_mesh(dp: int, tp: int, sp: int):
    """The DeviceMesh over the process axes above 1, on the device type of
    this rank's group (distributed/parallel.py)."""
    from torch.distributed.device_mesh import DeviceMesh
    from ..distributed.parallel import rank_device
    names = tuple(a for a, n in zip(PROCESS_AXES, (dp, tp, sp)) if n > 1)
    dims = tuple(n for n in (dp, tp, sp) if n > 1)
    ranks = torch.arange(dp * tp * sp).reshape(dims)
    return DeviceMesh(rank_device().type, ranks, mesh_dim_names=names)


def build_mesh(dp: int = -1, tp: int = 1, pp: int = 1, sp: int = 1,
               ep: int = 1, devices=None) -> Mesh:
    """A mesh of dp x tp x sp processes (dp=-1: what tp and sp leave of
    the group) and, with pp > 1, `pp` stage devices in each of them
    (module docstring)."""
    tp, pp, sp, ep = int(tp), int(pp), int(sp), int(ep)
    if ep > 1:
        raise NotImplementedError(
            f"a mesh with ep={ep}: expert parallelism needs switch_moe, "
            f"which is not ported (ROADMAP item 12)")
    world = get_world_size()
    fixed = tp * sp
    if int(dp) == -1:
        if world % fixed:
            raise ValueError(
                f"build_mesh(tp={tp}, sp={sp}) over a group of {world} "
                f"process(es): tp * sp must divide it")
        dp = world // fixed
    dp = int(dp)
    if dp * fixed != world:
        raise ValueError(
            f"build_mesh(dp={dp}, tp={tp}, sp={sp}) over a group of {world} "
            f"process(es): the port runs one process per dp rank (and per "
            f"tp and sp rank)")
    stages = _stage_devices(pp, devices, world) if pp > 1 else None
    if fixed > 1:
        from ..distributed.parallel import backend, rank_device
        if stages:
            _check_stages_on_group(stages)
        if rank_device().type == "cuda" and backend() == "gloo":
            from ..distributed.collective import install_gloo_functionals
            install_gloo_functionals()
        return Mesh(dp, stages, tp=tp, sp=sp,
                    device_mesh=_device_mesh(dp, tp, sp))
    return Mesh(dp, stages)


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _current
    _current = mesh


def get_mesh() -> Optional[Mesh]:
    return _current


# ---------------------------------------------------------------------------
# Sharding rules (reference :103-144)
# ---------------------------------------------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class ShardingRules:
    """Name pattern -> spec table for parameters (the Megatron rules as
    data). Patterns are checked in order; the first regex match wins."""

    def __init__(self, rules: Sequence[Tuple[str, tuple]] = (),
                 default: tuple = P()):
        self._rules = [(re.compile(pat), P(*spec)) for pat, spec in rules]
        self._default = P(*default)

    def spec_for(self, name: str, shape=None) -> PartitionSpec:
        # [L]-stacked per-layer params (parallel/transforms.py
        # apply_layer_scan): the per-layer rule shifted one dim right, the
        # layer axis unsharded
        if name.endswith("@LAYERS"):
            base = self.spec_for(name[:-len("@LAYERS")],
                                 tuple(shape[1:]) if shape else None)
            return P(None, *base)
        for pat, spec in self._rules:
            if pat.search(name):
                return spec
        return self._default

    def fixed_spec(self, mesh_shape, name: str, shape=None) -> PartitionSpec:
        """`spec_for` with every axis that does not divide its dim dropped
        (the reference's `sharding_for` :130-144); `mesh_shape` maps axis
        names to sizes."""
        spec = self.spec_for(name, shape)
        if shape is None:
            return spec
        fixed = []
        for dim, ax in zip(shape,
                           list(spec) + [None] * (len(shape) - len(spec))):
            if ax is None:
                fixed.append(None)
                continue
            size = math.prod(int(mesh_shape[a]) for a in _axes(ax))
            fixed.append(ax if dim % size == 0 and dim > 0 else None)
        return P(*fixed)

    def sharding_for(self, mesh: Mesh, name: str, shape=None):
        """DTensor placements of `name` on the mesh's DeviceMesh: Shard(d)
        on each mesh dim the fixed spec names for tensor dim d, Replicate
        elsewhere."""
        return placements(mesh, self.fixed_spec(mesh.shape, name, shape))


def placements(mesh: Mesh, spec) -> list:
    """A spec as DTensor placements, one per dim of `mesh.device_mesh`;
    an axis of size 1 (not a mesh dim) is dropped."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.mesh_axes]
    for d, entry in enumerate(spec):
        for ax in _axes(entry):
            if ax in mesh.mesh_axes:
                out[mesh.mesh_axes.index(ax)] = Shard(d)
            elif mesh.shape.get(ax, 1) > 1:
                raise ValueError(f"spec {spec} names axis {ax!r}, which "
                                 f"this mesh runs outside its DeviceMesh")
    return out


REPLICATED = ShardingRules()


def moe_sharding_rules(extra=()) -> ShardingRules:
    """Expert-parallel rules (reference :150): the leading [E] dim of
    switch_moe's expert weights over ep. The port has no ep axis yet
    (ROADMAP item 12); the rows are kept so that a table built from them
    reads as the reference's."""
    rules = [(r"_expert_(w|b)[12]_?\d*$", P("ep"))]
    return ShardingRules(list(extra) + rules)


def transformer_tp_rules(extra=()) -> ShardingRules:
    """The Megatron table every transformer in models/ shares (reference
    :157): column-parallel QKV and FFN-in (their output dim over tp),
    row-parallel attention projection and FFN-out (their input dim).
    Models put their embedding and head rules first through `extra`."""
    rules = [
        (r"_attn_qkv_w$", P(None, "tp")),
        (r"_attn_qkv_b$", P("tp")),
        (r"_ffn_in_w$", P(None, "tp")),
        (r"_ffn_in_b$", P("tp")),
        (r"_attn_proj_w$", P("tp", None)),
        (r"_ffn_out_w$", P("tp", None)),
    ]
    return moe_sharding_rules(extra=list(extra) + rules)
