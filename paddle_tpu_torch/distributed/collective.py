"""Collective communication across processes (counterpart of
paddle_tpu/distributed/collective.py).

Divergence from the reference: there, one process holds global arrays and
a collective reduces over the shards of a mesh axis. Here each process is
one rank holding its own tensor, as in Paddle: `all_reduce` sums the
ranks' tensors, `all_gather` lists them in rank order, `scatter` hands
rank r the r-th piece, `split_batch` takes this rank's contiguous block
of a global batch. The reference's `all_reduce` of a dp-sharded array is
the port's `all_reduce` of each rank's shard. The group is the default
one that `init_parallel_env` (distributed/parallel.py) builds.

ZeRO's flat buffers (parallel/zero.py) take `reduce_scatter_flat` (each
rank receives the sum of its `[n/dp]` slice) and `all_gather_flat` (the
shards concatenated in rank order). Sequence parallelism
(parallel/ring_attention.py) takes `ppermute` (each rank's tensor to the
next rank of a group's ring) and `all_to_all_single`, over a mesh axis's
group.

Gloo (torch 2.11 on the H100, probed with two ranks on one card) takes
all_reduce, broadcast, all_gather, all_gather_into_tensor,
reduce_scatter_tensor and all_to_all_single on CUDA tensors, which is
what DTensor issues, but not send/recv: `ppermute` there stages through
host memory (counted `executor.collective_emulated.ppermute`). For the
collectives of the dp path the port keeps mapping onto all_reduce and
broadcast, as it has since it first ran on gloo: `reduce_scatter_flat` is an
all-reduce of the whole buffer and a slice, `all_gather` /
`all_gather_flat` are one broadcast from each rank, `reduce` an
all-reduce, `scatter` a broadcast of the stacked pieces. Each such call
counts `executor.collective_emulated.<op>`. The values are the same bits a
native call gives.

Counts: every call adds one to `counters["<op>.calls"]` and its bytes to
`counters["<op>.bytes"]` (the full buffer of a reduce-scatter or an
all-gather), through ops/kernels/counts.py, so a call inside a captured
CUDA graph counts once per replay. Outside a capture the call's host time
goes to `host_ms["<op>"]` and a `collective.<op>` trace span.
"""
from __future__ import annotations

import collections
import time
from typing import List, Optional

import numpy as np
import torch

from ..observability import metrics as _metrics
from ..observability import trace as _trace
from ..ops.kernels import counts as _counts
from .parallel import get_rank, get_world_size

__all__ = ["ReduceOp", "all_reduce", "all_gather", "broadcast", "reduce",
           "scatter", "barrier", "split_batch", "get_rank",
           "get_world_size", "reduce_scatter_flat", "all_gather_flat",
           "counters", "host_ms", "reset_counters", "ppermute",
           "all_to_all_single", "count_call", "install_gloo_functionals"]

counters = collections.defaultdict(int)
host_ms = collections.defaultdict(float)
# the collectives gloo takes on CUDA tensors
_GLOO_CUDA = frozenset({"all_reduce", "broadcast"})


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"


def reset_counters() -> None:
    counters.clear()
    host_ms.clear()


def _dist():
    import torch.distributed as dist
    return dist


def _red(op):
    d = _dist().ReduceOp
    return {"sum": d.SUM, "max": d.MAX, "min": d.MIN,
            "prod": d.PRODUCT}[op]


def _emulated(op: str, t: torch.Tensor, group=None) -> bool:
    """True where the backend does not take `op` on `t`'s device."""
    if t.device.type != "cuda" or op in _GLOO_CUDA:
        return False
    if _dist().get_backend(group) != "gloo":
        return False
    _metrics.inc(f"executor.collective_emulated.{op}")
    return True


class _Span:
    """Count one call and time it on the host (outside a capture)."""

    __slots__ = ("op", "nbytes", "t0", "ev")

    def __init__(self, op, nbytes):
        self.op, self.nbytes = op, int(nbytes)

    def __enter__(self):
        _counts.count(counters, f"{self.op}.calls")
        _counts.count(counters, f"{self.op}.bytes", self.nbytes)
        self.ev = None
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            self.t0 = None
            return self
        self.t0 = time.perf_counter()
        self.ev = _trace.RecordEvent(f"collective.{self.op}",
                                     cat="collective",
                                     args={"bytes": self.nbytes})
        self.ev.__enter__()
        return self

    def __exit__(self, *exc):
        if self.ev is not None:
            self.ev.__exit__(*exc)
            host_ms[self.op] += (time.perf_counter() - self.t0) * 1e3
        return False


def count_call(op: str, nbytes: int) -> None:
    """Count one collective issued outside this module (DTensor's, counted
    by parallel/gspmd.py `CollectiveCounter`)."""
    _counts.count(counters, f"{op}.calls")
    _counts.count(counters, f"{op}.bytes", int(nbytes))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(tensor: torch.Tensor, op=ReduceOp.SUM, group=None,
               sync_op=True) -> torch.Tensor:
    """Reduce every rank's `tensor` into each rank's `tensor`, in place."""
    with _Span("all_reduce", _nbytes(tensor)):
        _dist().all_reduce(tensor, op=_red(op), group=group)
    return tensor


def broadcast(tensor: torch.Tensor, src: int = 0, group=None
              ) -> torch.Tensor:
    """`src`'s tensor into every rank's `tensor`, in place."""
    with _Span("broadcast", _nbytes(tensor)):
        _dist().broadcast(tensor, src=src, group=group)
    return tensor


def all_gather(tensor_list: Optional[list], tensor: torch.Tensor,
               group=None) -> List[torch.Tensor]:
    """Every rank's `tensor`, in rank order (appended to `tensor_list`
    when one is given)."""
    world = get_world_size()
    t = tensor.contiguous()
    with _Span("all_gather", _nbytes(t) * world):
        if _emulated("all_gather", t, group):
            out = []
            for r in range(world):
                buf = t.clone() if r == get_rank() else torch.empty_like(t)
                _dist().broadcast(buf, src=r, group=group)
                out.append(buf)
        else:
            out = [torch.empty_like(t) for _ in range(world)]
            _dist().all_gather(out, t, group=group)
    if tensor_list is not None:
        tensor_list.extend(out)
    return out


def reduce(tensor: torch.Tensor, dst: int = 0, op=ReduceOp.SUM, group=None
           ) -> torch.Tensor:
    """The reduction of every rank's tensor into `dst`'s tensor (the other
    ranks' tensors are left undefined, as in Paddle)."""
    with _Span("reduce", _nbytes(tensor)):
        if _emulated("reduce", tensor, group):
            _dist().all_reduce(tensor, op=_red(op), group=group)
        else:
            _dist().reduce(tensor, dst=dst, op=_red(op), group=group)
    return tensor


def scatter(tensor: torch.Tensor, tensor_list=None, src: int = 0,
            group=None) -> torch.Tensor:
    """Rank r receives `src`'s `tensor_list[r]` into `tensor`."""
    world, rank = get_world_size(), get_rank()
    with _Span("scatter", _nbytes(tensor) * world):
        if _emulated("scatter", tensor, group):
            stacked = (torch.stack([t.contiguous() for t in tensor_list])
                       if rank == src else
                       torch.empty((world,) + tuple(tensor.shape),
                                   dtype=tensor.dtype, device=tensor.device))
            _dist().broadcast(stacked, src=src, group=group)
            tensor.copy_(stacked[rank])
        else:
            _dist().scatter(tensor, list(tensor_list) if rank == src
                            else None, src=src, group=group)
    return tensor


def barrier(group=None) -> None:
    with _Span("barrier", 0):
        _dist().barrier(group=group)


def ppermute(tensor: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Each rank's `tensor` to the rank `shift` places after it in
    `group`'s ring; returns what the rank `shift` places before it sent
    (the reference's `jax.lax.ppermute` with perm i -> i + shift)."""
    d = _dist()
    n, r = d.get_world_size(group), d.get_rank(group)
    t = tensor.contiguous()
    with _Span("ppermute", _nbytes(t)):
        stage = (t.device.type == "cuda"
                 and d.get_backend(group) == "gloo")
        if stage:
            _metrics.inc("executor.collective_emulated.ppermute")
            t = t.cpu()
        out = torch.empty_like(t)
        to = d.get_global_rank(group, (r + shift) % n)
        frm = d.get_global_rank(group, (r - shift) % n)
        for w in d.batch_isend_irecv([d.P2POp(d.isend, t, to, group),
                                      d.P2POp(d.irecv, out, frm, group)]):
            w.wait()
        return out.to(tensor.device) if stage else out


def all_to_all_single(tensor: torch.Tensor, group) -> torch.Tensor:
    """Rank j of `group` receives the j-th of the equal dim-0 blocks of
    every rank's `tensor`, stacked in rank order along dim 0."""
    t = tensor.contiguous()
    out = torch.empty_like(t)
    with _Span("all_to_all", _nbytes(t)):
        _dist().all_to_all_single(out, t, group=group)
    return out


# --- DTensor's functional collectives on CUDA under gloo -------------------

_functional_libs = {}
_RED_BY_NAME = {"sum": "sum", "max": "max", "min": "min",
                "product": "prod", "prod": "prod"}


def _group_of(group_name):
    if isinstance(group_name, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(group_name)
    return group_name


def _sync(op, fn):
    """A functional collective as the synchronous c10d call `fn` (counted
    `executor.collective_emulated.<op>`)."""
    def impl(*args):
        _metrics.inc(f"executor.collective_emulated.{op}")
        return fn(*args)
    return impl


def install_gloo_functionals(dispatch_key: str = "CUDA") -> None:
    """Serve DTensor's functional collectives (`_c10d_functional`) on
    `dispatch_key` tensors by the synchronous c10d calls, which gloo runs
    on CUDA tensors. On the H100 (torch 2.11) gloo completes the
    asynchronous functional form of a CUDA all-gather with a segmentation
    fault in `wait_tensor`, where the synchronous `all_gather_into_tensor`
    works; so under gloo on CUDA every functional collective is the
    synchronous call and `wait_tensor` has nothing left to wait for.
    Idempotent; a process with a gloo mesh on CUDA installs it once
    (parallel/mesh.py)."""
    if dispatch_key in _functional_libs:
        return
    d = _dist()

    def red(op):
        # gloo has no AVG: a sum, divided by the group's size after
        op = str(op).lower()
        return _red("sum" if op == "avg" else _RED_BY_NAME[op])

    def averaged(out, op, group):
        if str(op).lower() == "avg":
            out.div_(d.get_world_size(group))
        return out

    def all_reduce_(x, op, group_name):
        group = _group_of(group_name)
        d.all_reduce(x, op=red(op), group=group)
        return averaged(x, op, group)

    def all_reduce(x, op, group_name):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                           op, group_name)

    def all_gather(x, group_size, group_name):
        x = x.contiguous()
        out = x.new_empty((x.shape[0] * group_size,) + tuple(x.shape[1:]))
        d.all_gather_into_tensor(out, x, group=_group_of(group_name))
        return out

    def reduce_scatter(x, op, group_size, group_name):
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // group_size,) + tuple(x.shape[1:]))
        group = _group_of(group_name)
        d.reduce_scatter_tensor(out, x, op=red(op), group=group)
        return averaged(out, op, group)

    def all_to_all(x, out_splits, in_splits, group_name):
        x = x.contiguous()
        out = x.new_empty((int(sum(out_splits)),) + tuple(x.shape[1:]))
        d.all_to_all_single(out, x, [int(n) for n in out_splits],
                            [int(n) for n in in_splits],
                            group=_group_of(group_name))
        return out

    def broadcast(x, src, group_name):
        out = x.clone(memory_format=torch.contiguous_format)
        d.broadcast(out, src=src, group=_group_of(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name, op, fn in (("all_reduce", "all_reduce", all_reduce),
                         ("all_reduce_", "all_reduce", all_reduce_),
                         ("all_gather_into_tensor", "all_gather",
                          all_gather),
                         ("reduce_scatter_tensor", "reduce_scatter",
                          reduce_scatter),
                         ("all_to_all_single", "all_to_all", all_to_all),
                         ("broadcast", "broadcast", broadcast)):
        lib.impl(name, _sync(op, fn), dispatch_key)
    lib.impl("wait_tensor", lambda t: t, dispatch_key)
    _functional_libs[dispatch_key] = lib


def split_batch(array, axis: int = 0):
    """This rank's contiguous block of a global batch along dim 0: what
    the reference's `P("dp")` gives shard `rank`."""
    world, rank = get_world_size(), get_rank()
    n = int(np.shape(array)[0])
    if n % world:
        raise ValueError(f"split_batch: a batch of {n} rows does not split "
                         f"over {world} ranks")
    k = n // world
    return array[rank * k:(rank + 1) * k]


def _single(name):
    d = _dist()
    return getattr(d, f"{name}_single", None) or getattr(
        d, {"reduce_scatter": "reduce_scatter_tensor",
            "all_gather": "all_gather_into_tensor"}[name])


def _size_rank(group):
    """(size, this rank's index) of `group` (None: the default group)."""
    if group is None:
        return get_world_size(), get_rank()
    d = _dist()
    return d.get_world_size(group), d.get_rank(group)


def reduce_scatter_flat(flat: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the ranks of `group` (the default group: every rank)
    of this rank's `[n/size]` slice of the flat buffer `flat` ([n], n
    divisible by the group's size); a new tensor."""
    world, rank = _size_rank(group)
    shard = flat.numel() // world
    with _Span("reduce_scatter", _nbytes(flat)):
        if _emulated("reduce_scatter", flat, group):
            full = flat.clone()
            _dist().all_reduce(full, group=group)
            return full[rank * shard:(rank + 1) * shard].clone()
        out = torch.empty(shard, dtype=flat.dtype, device=flat.device)
        _single("reduce_scatter")(out, flat.contiguous(), group=group)
        return out


def all_gather_flat(shard: torch.Tensor, group=None) -> torch.Tensor:
    """The `[n/size]` shards of the ranks of `group` (the default group:
    every rank) concatenated in their order in the group: `[n]`."""
    world, rank = _size_rank(group)
    s = shard.contiguous()
    n = s.numel()
    with _Span("all_gather", _nbytes(s) * world):
        out = torch.empty(n * world, dtype=s.dtype, device=s.device)
        if _emulated("all_gather", s, group):
            for r in range(world):
                piece = out[r * n:(r + 1) * n]
                if r == rank:
                    piece.copy_(s)
                src = r if group is None \
                    else _dist().get_global_rank(group, r)
                _dist().broadcast(piece, src=src, group=group)
        else:
            _single("all_gather")(out, s, group=group)
        return out
