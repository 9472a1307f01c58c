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
    out = torch.full(tuple(shape), value, dtype=dtype, device=ctx.device)
    # a build-time constant: an op that takes a shape from a tensor reads
    # it here instead of on the host (ops/tail_ops.py `_host_shape`)
    out._const_value = value
    return {"Out": [out]}


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


# ---------------------------------------------------------------------------
# The rest of the reference's tensor_ops.py: creation, random draws,
# shape manipulation, selection and sorting.
# ---------------------------------------------------------------------------

def _canonical(dtype):
    """The reference's 32-bit device policy: int64 lives as int32 and a
    float64 request means float32 (jax without x64)."""
    d = convert_dtype(dtype)
    return torch.float32 if d == torch.float64 else d


def _full(shape, value, dtype, device):
    return torch.full(tuple(shape), value, dtype=dtype, device=device)


@register("fill_constant_batch_size_like")
def _fill_constant_bsl(ctx, ins, attrs):
    ref = ins["Input"][0]
    shape = list(attrs.get("shape", [1]))
    shape[attrs.get("output_dim_idx", 0)] = \
        ref.shape[attrs.get("input_dim_idx", 0)]
    return {"Out": [_full(shape, attrs.get("value", 0.0),
                          _canonical(attrs.get("dtype", "float32")),
                          ref.device)]}


@register("fill_any_like")
def _fill_any_like(ctx, ins, attrs):
    x = ins["X"][0]
    dt = attrs.get("dtype")
    return {"Out": [_full(x.shape, attrs.get("value", 0.0),
                          _canonical(dt) if dt else x.dtype, x.device)]}


@register("shape", nondiff_slots=("Input",))
def _shape(ctx, ins, attrs):
    """The dims as an int32 vector, built by fills (no host copy)."""
    x = ins["Input"][0]
    if not x.dim():
        return {"Out": [torch.zeros((0,), dtype=torch.int32,
                                    device=x.device)]}
    return {"Out": [torch.stack([_full((), int(d), torch.int32, x.device)
                                 for d in x.shape])]}


def _random_bits(ctx, attrs, shape, stream: int):
    """uint32 bits (in int64) for each element of `shape`: fmix32 of the
    element index mixed with the op's device key (ctx.op_seed) and a
    stream number, so the draw depends on the run seed and the op alone,
    runs inside a captured step, and touches no global RNG (the values
    differ from the reference's jax.random draws)."""
    from .registry import fmix32
    from .kernels.flash_attention import _U32, _mul32
    n = 1
    for d in shape:
        n *= int(d)
    key = ctx.op_seed(attrs).long() & _U32
    idx = torch.arange(n, dtype=torch.int64, device=ctx.device)
    x = fmix32((_mul32(idx, 0x9E37_79B9) ^ key) & _U32)
    x = fmix32(x ^ (((stream + 1) * 0x85EB_CA6B) & _U32))
    return x.reshape(tuple(shape))


def _uniform01(bits):
    """[0, 1) f32 from the top 24 bits."""
    return (bits >> 8).float() * (1.0 / (1 << 24))


@register("uniform_random", is_random=True)
def _uniform_random(ctx, ins, attrs):
    shape = tuple(attrs.get("shape", [1]))
    dtype = _canonical(attrs.get("dtype", "float32"))
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    if ctx.is_eval_shape:
        return {"Out": [torch.empty(shape, dtype=dtype, device=ctx.device)]}
    u = _uniform01(_random_bits(ctx, attrs, shape, 0))
    return {"Out": [(u * (hi - lo) + lo).to(dtype)]}


@register("gaussian_random", is_random=True)
def _gaussian_random(ctx, ins, attrs):
    """Box-Muller over two uniform streams of the op's key."""
    shape = tuple(attrs.get("shape", [1]))
    dtype = _canonical(attrs.get("dtype", "float32"))
    if ctx.is_eval_shape:
        return {"Out": [torch.empty(shape, dtype=dtype, device=ctx.device)]}
    u1 = 1.0 - _uniform01(_random_bits(ctx, attrs, shape, 0))   # (0, 1]
    u2 = _uniform01(_random_bits(ctx, attrs, shape, 1))
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2 * torch.pi) * u2)
    out = z * attrs.get("std", 1.0) + attrs.get("mean", 0.0)
    return {"Out": [out.to(dtype)]}


@register("randint", is_random=True, nondiff_slots=("X",))
def _randint(ctx, ins, attrs):
    shape = tuple(attrs.get("shape", [1]))
    dtype = _canonical(attrs.get("dtype", "int64"))
    if ctx.is_eval_shape:
        return {"Out": [torch.empty(shape, dtype=dtype, device=ctx.device)]}
    low, high = int(attrs.get("low", 0)), int(attrs.get("high", 100))
    bits = _random_bits(ctx, attrs, shape, 0)
    return {"Out": [(low + bits % (high - low)).to(dtype)]}


@register("reshape")
def _reshape(ctx, ins, attrs):
    return {"Out": _reshape2(ctx, ins, attrs)["Out"]}


@register("transpose")
def _transpose(ctx, ins, attrs):
    return {"Out": [ins["X"][0].permute(*attrs["axis"])]}


@register("flatten2")
def _flatten2(ctx, ins, attrs):
    x = ins["X"][0]
    ax = attrs.get("axis", 1)
    lead = 1
    for d in x.shape[:ax]:
        lead *= int(d)
    return {"Out": [x.reshape(lead, -1)], "XShape": [_xshape(x)]}


@register("flatten_contiguous_range")
def _flatten_contiguous_range(ctx, ins, attrs):
    x = ins["X"][0]
    start = attrs.get("start_axis", 1)
    stop = attrs.get("stop_axis", -1)
    if stop < 0:
        stop += x.dim()
    shape = tuple(x.shape[:start]) + (-1,) + tuple(x.shape[stop + 1:])
    return {"Out": [x.reshape(shape)], "XShape": [_xshape(x)]}


@register("squeeze2")
def _squeeze2(ctx, ins, attrs):
    """Only the listed axes of size 1 go; no axes squeezes every 1."""
    x = ins["X"][0]
    axes = attrs.get("axes", [])
    if axes:
        dims = tuple(a % x.dim() for a in axes if x.shape[a % x.dim()] == 1)
        out = x.squeeze(dims) if dims else x
    else:
        out = x.squeeze()
    return {"Out": [out], "XShape": [_xshape(x)]}


@register("concat")
def _concat(ctx, ins, attrs):
    return {"Out": [torch.cat(list(ins["X"]), dim=attrs.get("axis", 0))]}


@register("tile")
def _tile(ctx, ins, attrs):
    return {"Out": [torch.tile(ins["X"][0], tuple(attrs["repeat_times"]))]}


@register("expand_v2")
def _expand_v2(ctx, ins, attrs):
    x = ins["X"][0]
    shape = list(attrs["shape"])
    for i, s in enumerate(shape):
        if s == -1:
            shape[i] = x.shape[i - len(shape) + x.dim()]
    return {"Out": [torch.broadcast_to(x, tuple(shape))]}


@register("expand_as_v2")
def _expand_as_v2(ctx, ins, attrs):
    return {"Out": [torch.broadcast_to(ins["X"][0], ins["Y"][0].shape)]}


@register("gather_nd", nondiff_slots=("Index",))
def _gather_nd(ctx, ins, attrs):
    x, idx = ins["X"][0], ins["Index"][0].long()
    return {"Out": [x[tuple(idx[..., i] for i in range(idx.shape[-1]))]]}


@register("scatter", nondiff_slots=("Ids",))
def _scatter(ctx, ins, attrs):
    """Rows `Ids` of X set to (or, without `overwrite`, added to) the
    rows of Updates."""
    x, ids, upd = ins["X"][0], ins["Ids"][0].long(), ins["Updates"][0]
    return {"Out": [x.index_put((ids,), upd,
                                accumulate=not attrs.get("overwrite",
                                                         True))]}


@register("strided_slice")
def _strided_slice(ctx, ins, attrs):
    """Python slicing per axis, negative strides included (a flip, then
    the positive stride)."""
    out = ins["Input"][0]
    for a, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                           attrs.get("strides", [1] * len(attrs["axes"]))):
        dim = out.shape[a]
        r = range(*slice(s, e, st).indices(dim))
        idx = [slice(None)] * out.dim()
        if st > 0 or not len(r):
            idx[a] = slice(r.start, r.stop, abs(st)) if len(r) \
                else slice(0, 0)
            out = out[tuple(idx)]
        else:
            idx[a] = slice(dim - 1 - r.start, dim - r[-1], -st)
            out = out.flip(a)[tuple(idx)]
    return {"Out": [out]}


def _sorted_desc(x, dim):
    """Descending values and indices along `dim`, tied values in index
    order (lax.top_k's and the stable jnp.argsort's tie rule, which
    torch.topk does not promise)."""
    return torch.sort(x, dim=dim, descending=True, stable=True)


@register("top_k", nondiff_slots=())
def _top_k(ctx, ins, attrs):
    k = attrs.get("k", 1)
    vals, idxs = _sorted_desc(ins["X"][0], -1)
    return {"Out": [vals[..., :k]],
            "Indices": [idxs[..., :k].to(torch.int32)]}


@register("top_k_v2", nondiff_slots=())
def _top_k_v2(ctx, ins, attrs):
    k = attrs.get("k", 1)
    vals, idxs = _sorted_desc(ins["X"][0], attrs.get("axis", -1))
    axis = attrs.get("axis", -1)
    return {"Out": [vals.narrow(axis, 0, k)],
            "Indices": [idxs.narrow(axis, 0, k).to(torch.int32)]}


@register("arg_max", nondiff_slots=("X",))
def _arg_max(ctx, ins, attrs):
    """The first of tied maxima, as jnp.argmax."""
    axis = attrs.get("axis", -1)
    out = torch.argmax(ins["X"][0], dim=axis,
                       keepdim=attrs.get("keepdims", False))
    return {"Out": [out.to(_canonical(attrs.get("dtype", "int64")))]}


@register("arg_min", nondiff_slots=("X",))
def _arg_min(ctx, ins, attrs):
    out = torch.argmin(ins["X"][0], dim=attrs.get("axis", -1))
    return {"Out": [out.to(torch.int32)]}


@register("argsort", nondiff_slots=())
def _argsort(ctx, ins, attrs):
    """A stable sort: tied values keep their index order either way."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    vals, idx = torch.sort(x, dim=axis,
                           descending=attrs.get("descending", False),
                           stable=True)
    return {"Out": [vals], "Indices": [idx.to(torch.int32)]}


@register("where_index", nondiff_slots=("Condition",))
def _where_index(ctx, ins, attrs):
    """Data-dependent output shape: eager only (a host sync)."""
    return {"Out": [torch.nonzero(ins["Condition"][0]).to(torch.int32)]}


@register("masked_select", nondiff_slots=("Mask",))
def _masked_select(ctx, ins, attrs):
    """Data-dependent output shape: eager only."""
    return {"Y": [ins["X"][0][ins["Mask"][0].bool()]]}


@register("index_select", nondiff_slots=("Index",))
def _index_select(ctx, ins, attrs):
    x, idx = ins["X"][0], ins["Index"][0]
    return {"Out": [torch.index_select(x, attrs.get("dim", 0) % x.dim(),
                                       idx.long())]}


@register("range", nondiff_slots=("Start", "End", "Step"))
def _range(ctx, ins, attrs):
    """From concrete scalars only (eager: reads them on the host)."""
    import numpy as np
    s, e, st = ins["Start"][0], ins["End"][0], ins["Step"][0]
    vals = np.arange(float(s), float(e), float(st))
    return {"Out": [torch.from_numpy(vals).to(s.dtype).to(s.device)]}


@register("linspace", nondiff_slots=("Start", "Stop", "Num"))
def _linspace(ctx, ins, attrs):
    """From concrete scalars only (eager)."""
    import numpy as np
    s, e, n = ins["Start"][0], ins["Stop"][0], ins["Num"][0]
    vals = np.linspace(float(s), float(e), int(n)).astype(np.float32)
    return {"Out": [torch.from_numpy(vals).to(s.device)]}


@register("eye")
def _eye(ctx, ins, attrs):
    n = attrs["num_rows"]
    return {"Out": [torch.eye(n, attrs.get("num_columns", n),
                              dtype=_canonical(attrs.get("dtype",
                                                         "float32")),
                              device=ctx.device)]}


@register("tril_triu")
def _tril_triu(ctx, ins, attrs):
    x, diag = ins["X"][0], attrs.get("diagonal", 0)
    fn = torch.tril if attrs.get("lower", True) else torch.triu
    return {"Out": [fn(x, diag)]}


@register("meshgrid")
def _meshgrid(ctx, ins, attrs):
    return {"Out": list(torch.meshgrid(*ins["X"], indexing="ij"))}


@register("flip")
def _flip(ctx, ins, attrs):
    axis = attrs["axis"]
    return {"Out": [torch.flip(ins["X"][0], list(axis) if isinstance(
        axis, (list, tuple)) else [axis])]}


@register("roll")
def _roll(ctx, ins, attrs):
    """Without axes the flattened tensor rolls, as jnp.roll(axis=None)."""
    axis = attrs.get("axis")
    shifts = attrs["shifts"]
    if not axis:
        return {"Out": [torch.roll(ins["X"][0], shifts)]}
    return {"Out": [torch.roll(ins["X"][0], shifts, tuple(axis))]}


@register("unique", nondiff_slots=("X",))
def _unique(ctx, ins, attrs):
    """Sorted unique values and each element's index among them
    (data-dependent shape: eager only)."""
    u, inv = torch.unique(ins["X"][0], sorted=True, return_inverse=True)
    return {"Out": [u], "Index": [inv.to(torch.int32)]}
