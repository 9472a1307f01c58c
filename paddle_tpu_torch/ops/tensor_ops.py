"""Tensor creation / manipulation lowerings (counterpart of
paddle_tpu/ops/tensor_ops.py): the ones the BERT pretrain, GPT LM and
startup programs use, and the ones the static LR schedules emit."""
from __future__ import annotations

import torch

from .registry import register
# on-device dtype policy: int64 ids live as int32 (framework/dtype.py)
from ..framework.dtype import device_dtype as convert_dtype


@register("fill_constant")
def _fill_constant(ctx, ins, attrs):
    shape = attrs.get("shape", [1])
    dtype = convert_dtype(attrs.get("dtype", "float32"))
    value = attrs.get("value", 0.0)
    return {"Out": [torch.full(tuple(shape), value, dtype=dtype,
                               device=ctx.device)]}


@register("fill_zeros_like")
def _fill_zeros_like(ctx, ins, attrs):
    return {"Out": [torch.zeros_like(ins["X"][0])]}


@register("truncated_gaussian_random", is_random=True)
def _truncated_gaussian_random(ctx, ins, attrs):
    """Normal(mean, std) cut at two standard deviations, drawn from a
    generator seeded by the op's key (the values differ from the
    reference's jax.random draw; parity tests carry startup arrays
    across instead)."""
    shape = tuple(attrs.get("shape", [1]))
    dtype = convert_dtype(attrs.get("dtype", "float32"))
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    out = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    if not ctx.is_eval_shape:
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                    generator=ctx.generator(attrs))
        out = out * std + mean
    return {"Out": [out.to(dtype)]}


def _xshape(x):
    return torch.zeros((0,), dtype=x.dtype, device=x.device)


@register("reshape2")
def _reshape2(ctx, ins, attrs):
    x = ins["X"][0]
    shape = list(attrs["shape"])
    # fluid semantics: 0 copies the input dim at that position; -1 infers
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    return {"Out": [x.reshape(tuple(shape))], "XShape": [_xshape(x)]}


@register("transpose2")
def _transpose2(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.permute(*attrs["axis"])], "XShape": [_xshape(x)]}


@register("unsqueeze2")
def _unsqueeze2(ctx, ins, attrs):
    x = ins["X"][0]
    out = x
    for a in sorted(attrs["axes"]):
        out = out.unsqueeze(a)
    return {"Out": [out], "XShape": [_xshape(out)]}


@register("split")
def _split(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        outs = torch.split(x, list(sections), dim=axis)
    else:
        num = attrs.get("num", 0)
        outs = torch.split(x, x.shape[axis] // num, dim=axis)
    return {"Out": list(outs)}


@register("stack")
def _stack(ctx, ins, attrs):
    """The startup program stacks a rolled program's per-layer initial
    values into its `@LAYERS` parameters with this op
    (parallel/transforms.py `apply_layer_scan`)."""
    return {"Y": [torch.stack(list(ins["X"]), dim=attrs.get("axis", 0))]}


@register("unstack")
def _unstack(ctx, ins, attrs):
    return {"Y": list(torch.unbind(ins["X"][0], dim=attrs.get("axis", 0)))}


def _mesh_slice(x, bounds):
    """`x[bounds]` on the local shards of a DTensor sharded along a sliced
    dim, when each rank's part of the slice is the block DTensor's Shard
    gives it in the result (a slice that drops fewer rows at the end than
    there are ranks: the shifted-label rows [0, S-1) of a sequence-sharded
    activation); None otherwise (DTensor's own slice, which gathers)."""
    from ..parallel import gspmd
    if not any(p.is_shard() and p.dim % x.dim() in bounds
               for p in x.placements):
        return None
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    local = {}
    for a, (s, e) in bounds.items():
        dims = [i for i, p in enumerate(x.placements)
                if p.is_shard() and p.dim % x.dim() == a]
        if not dims:
            local[a] = slice(s, e)
            continue
        n, size = mesh.size(dims[0]), int(x.shape[a])
        if len(dims) > 1 or size % n:
            return None
        c = size // n
        got = [(max(r * c, s) - s,
                max(0, min((r + 1) * c, e) - max(r * c, s)))
               for r in range(n)]
        want = gspmd.chunks(e - s, n)
        if [g[1] for g in got] != [w[1] for w in want] or any(
                g != w for g, w in zip(got, want) if w[1]):
            return None
        lo = coord[dims[0]] * c
        local[a] = slice(max(s - lo, 0), max(min(e - lo, c), 0))
    shape = [int(n) for n in x.shape]
    for a, (s, e) in bounds.items():
        shape[a] = e - s
    idx = [slice(None)] * x.dim()
    for a, sl in local.items():
        idx[a] = sl
    return gspmd.local_call(lambda t: t[tuple(idx)], (x,), [x.placements],
                            shapes=[shape])


@register("slice")
def _slice(ctx, ins, attrs):
    x = ins["Input"][0]
    idx = [slice(None)] * x.dim()
    bounds = {}
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        a = a % x.dim()
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
        bounds[a] = (s, e)
    out = None
    if getattr(ctx, "mesh", None) is not None \
            and not attrs.get("decrease_axis"):
        from ..parallel.gspmd import is_dtensor
        if is_dtensor(x):
            out = _mesh_slice(x, bounds)
    if out is None:
        out = x[tuple(idx)]
    for a in sorted(attrs.get("decrease_axis", []), reverse=True):
        out = out.squeeze(a)
    return {"Out": [out]}



@register("gather", nondiff_slots=("Index",))
def _gather(ctx, ins, attrs):
    """Slices of X at Index along `axis`: Out's shape is X's with that dim
    replaced by Index's shape (reference tensor_ops.py:247, jnp.take)."""
    x, idx = ins["X"][0], ins["Index"][0]
    axis = attrs.get("axis", 0) % x.dim()
    if getattr(ctx, "mesh", None) is not None and axis == 0 \
            and x.dim() == 2 and idx.dim() == 1:
        return {"Out": [_mesh_lookup(x, idx)]}
    if axis == 0 and x.dim() == 2:
        # a table lookup (GPT's tied wte): embedding's CUDA backward sums
        # repeated ids in a fixed order, where index_select's atomics
        # would make every step's table gradient differ in its last bits
        return {"Out": [torch.nn.functional.embedding(idx.long(), x)]}
    out = torch.index_select(x, axis, idx.reshape(-1).long())
    return {"Out": [out.reshape(x.shape[:axis] + idx.shape
                                + x.shape[axis + 1:])]}


@register("assign")
def _assign(ctx, ins, attrs):
    return {"Out": [ins["X"][0]]}


@register("assign_value")
def _assign_value(ctx, ins, attrs):
    """A constant array from the op's attrs, built from one `torch.full`
    per value: no host-to-device copy, so it may run inside a captured
    step. float64 means float32, as under the reference's 32-bit
    policy."""
    dtype = convert_dtype(attrs.get("dtype", "float32"))
    if dtype == torch.float64:
        dtype = torch.float32
    values = attrs.get("values", attrs.get("fp32_values", []))
    out = torch.stack([torch.full((), v, dtype=dtype, device=ctx.device)
                       for v in values])
    return {"Out": [out.reshape(tuple(attrs["shape"]))]}


@register("increment")
def _increment(ctx, ins, attrs):
    x = ins["X"][0]
    step = torch.full((), attrs.get("step", 1.0), dtype=x.dtype,
                      device=x.device)
    return {"Out": [x + step]}


@register("where", nondiff_slots=("Condition",))
def _where(ctx, ins, attrs):
    return {"Out": [torch.where(ins["Condition"][0], ins["X"][0],
                                ins["Y"][0])]}


@register("expand")
def _expand(ctx, ins, attrs):
    return {"Out": [torch.tile(ins["X"][0], tuple(attrs["expand_times"]))]}


def _mesh_lookup(table, idx):
    """A table lookup on a tp/sp mesh (parallel/gspmd.py). A table whose
    rows are sharded is the Megatron vocab-parallel embedding: each rank
    looks up the ids its rows hold, zero elsewhere, and the result is a
    partial sum over the sharding dims (one all-reduce where it is next
    read); the table's gradient stays on its shard, a partial sum over the
    dims that shard the ids. A replicated table is the plain lookup."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from ..parallel import gspmd
    if not gspmd.is_dtensor(table) or not any(
            isinstance(p, Shard) and p.dim == 0 for p in table.placements):
        return torch.nn.functional.embedding(idx.long(), table)
    mesh = table.device_mesh
    if not gspmd.is_dtensor(idx):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    idx = idx.redistribute(mesh, [p if isinstance(p, Shard) else Replicate()
                                  for p in idx.placements])
    rows = table.shape[0]
    coords = mesh.get_coordinate()
    n_local = table.to_local().shape[0]
    # the first global row of this rank's shard (even shards, row-major
    # over the mesh dims that shard the rows)
    first, stride = 0, rows
    for d, p in enumerate(table.placements):
        if isinstance(p, Shard) and p.dim == 0:
            stride //= mesh.size(d)
            first += coords[d] * stride
    out_pl = [Partial() if isinstance(tp, Shard) and tp.dim == 0 else ip
              for tp, ip in zip(table.placements, idx.placements)]

    def body(t, i):
        i = i.long() - first
        hit = (i >= 0) & (i < n_local)
        rows_ = torch.nn.functional.embedding(
            torch.where(hit, i, torch.zeros_like(i)), t)
        return torch.where(hit.unsqueeze(-1), rows_,
                           torch.zeros((), dtype=t.dtype, device=t.device))

    # the table's gradient: on its shard over the dims that shard its
    # rows, a partial sum over the dims that shard the ids (the batch
    # over dp: each rank's rows hold its own ids' part)
    grad_pl = [Partial() if isinstance(ip, Shard) and not (
        isinstance(tp, Shard) and tp.dim == 0) else tp
        for tp, ip in zip(table.placements, idx.placements)]
    return gspmd.local_call(body, (table, idx), [out_pl],
                            grad_placements=[grad_pl, None])
