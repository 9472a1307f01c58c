"""A program on a tp/sp mesh: the DTensor plan (the port's counterpart of
the reference executor's GSPMD path, paddle_tpu/framework/executor.py
:99-191).

The reference jits the step with `in_shardings` / `out_shardings` from the
attached DistConfig and XLA inserts every collective. The port runs the
same lowerings eagerly on DTensors over the mesh's DeviceMesh
(parallel/mesh.py), and DTensor's propagation inserts the collectives:

* Parameters and their optimizer state live in the scope as DTensors:
  a parameter with the placements `DistConfig.state_sharding` gives it, an
  optimizer accumulator of its parameter's shape with its parameter's
  placements, anything else by the rules (replicated by default).
  `distribute_scope` converts the plain tensors a startup run or a load
  left in the scope; every rank holds the same whole value then, so each
  keeps its own shard and nothing is sent.
* Feeds: every rank feeds the GLOBAL batch (the reference's single
  controller view); `place_feed` keeps this rank's block by
  `DistConfig.feed_sharding` (dim 0 over dp when it divides).
* The step runs under `step_context`: `implicit_replication`, so a plain
  tensor a lowering builds from a (global) shape is a replicated value
  (dropout's counter-hash mask keys on global element indices that way),
  and `CollectiveCounter`, which counts DTensor's collectives by op and
  bytes into `distributed.collective.counters`.
* Gradients come from autograd (ops/registry.py `func_vjp` takes the
  autograd route for DTensor operands: DTensor's methods are not reachable
  through torch.func's wrappers). Before an update rule runs, its gradient
  is redistributed to its parameter's placements (`align_grad`): at dp x
  tp that is the dp gradient average, the reduction of DTensor's
  `Partial` placement.
* Lowerings that launch a kernel (flash attention) or need local tensors
  (the fused head's GEMM) run on local shards through `local_call`.
* At sp > 1 the attention's output stays sharded along the sequence (the
  reference's `out_specs`), and so does the rest of the layer: the
  products flatten a sequence-sharded activation on local shards
  (ops/math_ops.py `_mesh_mm`), dropout keys its mask on the global
  element indices of each rank's block (`block_offsets`), and the shifted
  label rows [0, S-1) are cut on local shards into DTensor's uneven
  blocks (ops/tensor_ops.py `_mesh_slice`). The token feeds stay sharded
  over dp alone, as the reference's `batch_axes`, so the embedding sum
  before the first attention is whole on every sp rank.
* ZeRO stages 1-2: the flat bucket state is a DTensor `Shard(0)` on the
  mesh's dp dim (parallel/spmd.py `state_specs`), updated on this rank's
  shard (parallel/zero.py `_lower_zero_update`).
* Fetches come back whole (`whole`, `full_tensor()`).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["mixed_config", "is_dtensor", "state_plan", "distribute_scope",
           "place_feed", "whole", "align_grad", "settled", "step_context",
           "local_call", "local_param_elements", "CollectiveCounter",
           "chunks", "block_offsets"]


def mixed_config(program):
    """The attached DistConfig when its mesh has tp or sp above 1."""
    dist = getattr(program, "_dist_config", None)
    return dist if dist is not None and dist.mixed else None


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def state_plan(program, dist) -> Dict[str, list]:
    """{persistable name: placements} for the program's parameters and
    optimizer state (module docstring). Cached per program version."""
    key = (program._version, id(dist))
    cached = getattr(program, "_gspmd_plan", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    mesh = dist.resolve_mesh()
    block = program.global_block()
    plan = {}
    for v in program.list_vars():
        if v.persistable and v.shape is not None:
            plan[v.name] = dist.state_sharding(mesh, v.name, tuple(v.shape))
    for op in block.ops:
        params = op.inputs.get("Param") or []
        if len(params) != 1 or params[0] not in plan:
            continue
        pvar = block.find_var_recursive(params[0])
        for slot, names in op.inputs.items():
            if slot in ("Param", "Grad", "LearningRate"):
                continue
            for n in names:
                var = block.find_var_recursive(n)
                # an accumulator the rules place themselves (ZeRO's
                # fallback rows shard it over dp) keeps its own layout
                if var is not None and var.persistable \
                        and tuple(var.shape) == tuple(pvar.shape) \
                        and not any(dist.param_rules.fixed_spec(
                            mesh.shape, n, tuple(var.shape))):
                    plan[n] = plan[params[0]]
    program._gspmd_plan = (key, plan)
    return plan


def distribute_scope(program, scope, dist, device) -> int:
    """Turn each plain tensor the plan names into a DTensor on the mesh
    (this rank's shard of the whole value every rank holds). Returns how
    many were converted."""
    from torch.distributed.tensor import distribute_tensor
    mesh = dist.resolve_mesh()
    n = 0
    for name, pl in state_plan(program, dist).items():
        val = scope.find(name)
        if not isinstance(val, torch.Tensor) or is_dtensor(val):
            continue
        with torch.no_grad():
            dt = distribute_tensor(val.detach().to(device), mesh.device_mesh,
                                   pl, src_data_rank=None)
        scope.set(name, dt)
        n += 1
    return n


def local_param_elements(program, scope) -> int:
    """Elements of the program's parameters this rank holds."""
    total = 0
    for p in program.global_block().all_parameters():
        val = scope.find(p.name)
        if isinstance(val, torch.Tensor):
            total += (val.to_local() if is_dtensor(val) else val).numel()
    return total


def place_feed(dist, name, t):
    """This rank's block of a global feed, as a DTensor."""
    from torch.distributed.tensor import distribute_tensor
    mesh = dist.resolve_mesh()
    pl = dist.feed_sharding(mesh, name, tuple(t.shape))
    return distribute_tensor(t, mesh.device_mesh, pl, src_data_rank=None)


def whole(v):
    """A fetched value as one plain tensor (a collective for a sharded
    DTensor: every rank fetches it)."""
    if is_dtensor(v):
        return v.full_tensor()
    return v


def align_grad(grad, param):
    """`grad` in `param`'s placements (the dp reduction of a Partial
    gradient, a slice of a replicated one, this rank's block of a plain
    whole value); as it is where `param` is a partial sum, which nothing
    can be redistributed to."""
    if not is_dtensor(param):
        return grad
    if isinstance(grad, torch.Tensor) and not is_dtensor(grad):
        # a plain value (the loss's seed cotangent) is a replicated one
        from torch.distributed.tensor import Replicate, distribute_tensor
        return distribute_tensor(
            grad, param.device_mesh,
            [Replicate() if p.is_partial() else p
             for p in param.placements], src_data_rank=None)
    if is_dtensor(grad) \
            and tuple(grad.placements) != tuple(param.placements) \
            and not any(p.is_partial() for p in param.placements):
        return grad.redistribute(param.device_mesh, param.placements)
    return grad


def settled(t):
    """`t` with every partial sum reduced (Partial -> Replicate): DTensor
    keeps a sum partial through linear ops until something needs it."""
    if is_dtensor(t) and any(p.is_partial() for p in t.placements):
        from torch.distributed.tensor import Replicate
        return t.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])
    return t


# the collectives DTensor issues, under the port's counter names
_COLLECTIVES = {
    "all_reduce": "all_reduce", "all_reduce_": "all_reduce",
    "all_gather_into_tensor": "all_gather",
    "all_gather_into_tensor_out": "all_gather",
    "reduce_scatter_tensor": "reduce_scatter",
    "all_to_all_single": "all_to_all",
    "all_reduce_coalesced": "all_reduce",
    "all_gather_into_tensor_coalesced": "all_gather",
    "reduce_scatter_tensor_coalesced": "reduce_scatter",
}


# the program op a step on DTensors is running (the executor sets it), and
# DTensor's collectives by (op, collective, bytes): the plan a run follows
current_op = [None]
by_op: Dict[tuple, int] = {}


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(t) for t in x)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """Counts the functional collectives DTensor issues beneath it, by op
    and bytes, into `distributed.collective.counters` (`<op>.calls`,
    `<op>.bytes`: the full buffer of an all-gather or a reduce-scatter, the
    input of an all-reduce or an all-to-all), as the port's own collectives
    count themselves, and their host time into `collective.host_ms` (the
    waits under "wait": gloo runs a collective on its own thread).
    A DTensor operation passes through to DTensor, whose collectives
    then reach this mode on plain tensors."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func.namespace != "_c10d_functional":
            return func(*args, **(kwargs or {}))
        from ..distributed.collective import count_call, host_ms
        t0 = time.perf_counter()
        out = func(*args, **(kwargs or {}))
        op = _COLLECTIVES.get(func._opname)
        host_ms[op or "wait"] += (time.perf_counter() - t0) * 1e3
        if op is not None:
            nbytes = _bytes(out) if op == "all_gather" else _bytes(args[0])
            count_call(op, nbytes)
            key = (current_op[0], op, nbytes)
            by_op[key] = by_op.get(key, 0) + 1
        return out


@contextlib.contextmanager
def step_context():
    """What a step on DTensors runs under (module docstring)."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication(), CollectiveCounter():
        yield


def chunks(n: int, p: int):
    """[(start, size)] of the p blocks DTensor's Shard cuts a dim of n
    into (torch.chunk's: ceil(n / p) each, the last ones shorter or
    empty)."""
    c = -(-n // p) if p else n
    return [(min(r * c, n), max(0, min(n, (r + 1) * c) - min(r * c, n)))
            for r in range(p)]


def block_offsets(t):
    """This rank's block of DTensor `t` as [(global start, size)] per
    tensor dim (mesh dims applied in order, as DTensor nests them)."""
    out = [(0, int(n)) for n in t.shape]
    coord = t.device_mesh.get_coordinate()
    for i, p in enumerate(t.placements):
        if p.is_shard():
            d = p.dim % t.dim()
            start, size = out[d]
            s, n = chunks(size, t.device_mesh.size(i))[coord[i]]
            out[d] = (start + s, n)
    return out


def contiguous_stride(shape):
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))


def local_call(fn, args, out_placements, grad_placements=None, shapes=None):
    """`fn` on the local shards of the DTensors in `args` (other values
    pass as they are), its tensor results wrapped back as DTensors with
    `out_placements` (one list per result). `grad_placements` (one per
    DTensor argument, None = its own placements) says how each argument's
    gradient is laid out: Partial on the mesh dims where the call reduces
    over a sharded batch. `shapes` (one global shape per result, None =
    the local shape times the shards) is needed where a result is
    sharded unevenly (a dim that its mesh size does not divide). The
    counterpart of DTensor's `local_map`, written out so that the gradient
    placements are explicit."""
    from torch.distributed.tensor import DTensor
    mesh = None
    local = []
    gi = 0
    for a in args:
        if is_dtensor(a):
            mesh = a.device_mesh
            gp = None if grad_placements is None else grad_placements[gi]
            gi += 1
            local.append(a.to_local(grad_placements=gp))
        else:
            local.append(a)
    out = fn(*local)
    single = not isinstance(out, (tuple, list))
    outs = [out] if single else list(out)
    shapes = shapes or [None] * len(outs)
    wrapped = [o if not isinstance(o, torch.Tensor) or pl is None
               else DTensor.from_local(o, mesh, pl, run_check=False)
               if shp is None else DTensor.from_local(
                   o, mesh, pl, run_check=False, shape=torch.Size(shp),
                   stride=contiguous_stride(shp))
               for o, pl, shp in zip(outs, out_placements, shapes)]
    return wrapped[0] if single else wrapped
