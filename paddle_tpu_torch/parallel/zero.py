"""Gradient bucketing and ZeRO stages 0-3 on one process (counterpart of
paddle_tpu/parallel/zero.py).

1. **Program pass** (`apply_grad_bucketing`, run by
   `fleet.DistributedOptimizer.minimize` whenever `fuse_grad_size_in_mb`
   > 0): groups the per-parameter gradients into flat buckets of at most
   `fuse_grad_size_in_mb`, in gradient-production order, and sinks each
   bucket's op to right after the last op producing its gradients
   (`transforms.sink_op_to_producers`).
   * stage 0: one `__bucket_sync__` per bucket (the grouped gradient sync);
   * stage 1: each bucket's optimizer state moves into flat `[padded]` vars
     (padded to a multiple of 64) and its per-parameter update ops collapse
     into ONE `__zero_update__`;
   * stage 2: the bucket's gradient also stays in a resident flat buffer;
   * stage 3: parameter storage moves into flat buckets too, packed by
     `__zero_pack__` in the startup program and unpacked before the
     bucket's first forward use by `__zero_gather__`.
   A bucket whose gradients are clipped or regularised before the update
   is `pre_synced`: its raw gradients keep a `__bucket_sync__`.
2. **Lowerings**: on one process there is no data-parallel group
   (`current_manual_dp()` is None), so `__bucket_sync__` is the identity
   and `__zero_update__` takes the reference's full-width branch
   (`zero.py:346-355`): concatenate the bucket, run the update over the
   flat bucket through `_apply_update_rule`, the one funnel, which
   launches the fused kernels B6-B8 on the card
   (ops/kernels/zero_update.py), and split the parameters back. The flat
   state, and at stage 3 the flat parameters, are updated in place; at
   stages 1-2 the updated pieces are copied back into the scope's
   parameter tensors.

Not ported (ROADMAP Queue 1): data parallelism over `torch.distributed`
(the `psum_scatter` / `all_gather` / `pmean` branches and the manual-dp
runner `plan_manual_dp` / `build_manual_jit`); the stacked `@LAYERS`
stage-3 path (`_plan_stacked_stage3`, `_zero_update_stacked`: layer scan
is not ported, so such a program raises); the checkpoint round trip
(`adopt_unsharded_state`, `unbucket_state_for_save`); and the
`checked_pass` verifier (analysis/ is not ported).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from ..framework.dtype import convert_dtype, dtype_name
from ..framework.program import OpRole, Operator, Program, grad_var_name
from ..observability import metrics
from ..ops import registry
from ..ops.registry import register

# Padding multiple for flat buckets: the flat layout does not depend on the
# number of data-parallel ranks (any power-of-two dp up to 64 divides it).
PAD_MULTIPLE = 64

# Update op types the flat-bucket update supports: the elementwise rules,
# for which updating the flat concatenation equals updating each
# parameter alone.
_UPDATE_STATE_SLOTS: Dict[str, Dict[str, tuple]] = {
    "sgd": {},
    "momentum": {"velocity": ("Velocity", "VelocityOut")},
    "adam": {"moment1": ("Moment1", "Moment1Out"),
             "moment2": ("Moment2", "Moment2Out")},
    "adamw": {"moment1": ("Moment1", "Moment1Out"),
              "moment2": ("Moment2", "Moment2Out")},
}
# extra replicated [1]-inputs forwarded verbatim to the inner rule
_UPDATE_EXTRA_SLOTS = {
    "sgd": (), "momentum": (),
    "adam": ("Beta1Pow", "Beta2Pow"), "adamw": ("Beta1Pow", "Beta2Pow"),
}


def count_fallback(cause: str) -> None:
    """Per-cause accounting of a sharding request the pass could not take:
    the total under `executor.zero_manual_fallbacks` plus a `.<cause>`
    breakdown (observability/metrics.py)."""
    metrics.inc("executor.zero_manual_fallbacks")
    metrics.inc(f"executor.zero_manual_fallbacks.{cause}")


def current_manual_dp() -> Optional[tuple]:
    """(axis_name, dp) inside a data-parallel step. The port runs one
    process without a process group, so always None."""
    return None


def _apply_update_rule(ctx, op_type: str, inner_ins, update_attrs):
    """The ONE funnel for the flat-bucket parameter update: the fused
    kernel (ops/kernels/zero_update.py; on CPU tensors its plain version,
    the registry rule) for the ops it covers, else the registry rule."""
    from ..ops.kernels import zero_update as zk
    if zk.supports(op_type, inner_ins):
        return zk.fused_flat_update(op_type, inner_ins, update_attrs)
    return registry.get(op_type).lower(ctx, inner_ins, update_attrs)


# ---------------------------------------------------------------------------
# op lowerings
# ---------------------------------------------------------------------------

def _infer_noop(block, op):
    block.program.bump_version()


def _flat_concat(vals, dt, padded):
    """Flatten, cast to the bucket dtype, concatenate, zero-pad."""
    parts = [v.reshape(-1).to(dt) for v in vals]
    total = sum(p.numel() for p in parts)
    if padded > total:
        parts.append(torch.zeros(padded - total, dtype=dt,
                                 device=parts[0].device))
    return torch.cat(parts)


@register("__bucket_sync__", infer=_infer_noop,
          nondiff_slots=("X",), stateful_outputs=("Out",))
def _lower_bucket_sync(ctx, ins, attrs):
    """One grouped gradient sync per bucket: the identity on one process
    (the gradients are already the whole batch's)."""
    return {"Out": list(ins["X"])}


@register("__zero_pack__", infer=_infer_noop, nondiff_slots=("X",),
          stateful_outputs=("Out",))
def _lower_zero_pack(ctx, ins, attrs):
    """Pack per-parameter values into the flat [padded] bucket layout: the
    startup-program side of ZeRO-3 parameter storage."""
    if attrs.get("layout") == "stacked":
        raise NotImplementedError(
            "__zero_pack__ of a stacked @LAYERS bucket: layer scan is not "
            "ported (ROADMAP)")
    return {"Out": [_flat_concat(ins["X"], convert_dtype(attrs["dtype"]),
                                 int(attrs["padded"]))]}


@register("__zero_gather__", infer=_infer_noop, nondiff_slots=("FlatParam",))
def _lower_zero_gather(ctx, ins, attrs):
    """ZeRO-3 on-demand parameter materialisation: unpack the bucket's
    flat storage into the per-parameter values the forward ops read.
    They are copies, as the reference's slices are new arrays, so the
    in-place update of the flat storage never changes a value an earlier
    op of the step saved."""
    flat = ins["FlatParam"][0]
    outs, off = [], 0
    for size, shape, dt in zip(attrs["sizes"], attrs["shapes"],
                               attrs["dtypes"]):
        outs.append(flat[off:off + size].reshape(tuple(shape))
                    .to(convert_dtype(dt), copy=True))
        off += size
    return {"Out": outs}


@register("__zero_update__", infer=_infer_noop,
          nondiff_slots=("Param", "Grad", "LearningRate", "Beta1Pow",
                         "Beta2Pow", "FlatState", "FlatParam"),
          stateful_outputs=("ParamOut", "FlatStateOut", "FlatParamOut",
                            "FlatGradOut"))
def _lower_zero_update(ctx, ins, attrs):
    """Staged ZeRO bucket update at full bucket width (one process): the
    update rule over the flat bucket against the flat optimizer state,
    in place. Stages 1-2 concatenate the parameters, update the flat copy
    and copy the pieces back into the scope's parameter tensors; stage 3
    updates the flat parameter storage itself. Stage >= 2 also emits the
    flat gradient as resident state (`FlatGradOut`)."""
    if attrs.get("layout") == "stacked":
        raise NotImplementedError(
            "__zero_update__ of a stacked @LAYERS bucket: layer scan is not "
            "ported (ROADMAP)")
    op_type = attrs["update_op"]
    stage = int(attrs.get("stage", 1))
    sizes = list(attrs["sizes"])
    padded = int(attrs["padded"])
    kinds = list(attrs["state_kinds"])
    dt = convert_dtype(attrs["dtype"])
    with torch.no_grad():
        flat_g = _flat_concat(ins["Grad"], dt, padded)
        if stage >= 3:
            flat_p = ins["FlatParam"][0]
        else:
            params = ins["Param"]
            flat_p = _flat_concat(params, dt, padded)
        inner_ins = {"Param": [flat_p], "Grad": [flat_g],
                     "LearningRate": ins["LearningRate"]}
        for extra in _UPDATE_EXTRA_SLOTS[op_type]:
            inner_ins[extra] = ins[extra]
        slot_map = _UPDATE_STATE_SLOTS[op_type]
        for kind, val in zip(kinds, ins["FlatState"]):
            inner_ins[slot_map[kind][0]] = [val]
        res = _apply_update_rule(ctx, op_type, inner_ins,
                                 dict(attrs["update_attrs"]))
        p_new = res["ParamOut"][0]
        outs = {}
        if stage >= 3:
            outs["FlatParamOut"] = [p_new]
        else:
            off = 0
            for size, p in zip(sizes, params):
                p.copy_(p_new[off:off + size].reshape(p.shape))
                off += size
            outs["ParamOut"] = list(params)
    outs["FlatStateOut"] = [res[slot_map[kind][1]][0] for kind in kinds]
    if stage >= 2:
        outs["FlatGradOut"] = [flat_g]
    return outs


# ---------------------------------------------------------------------------
# the program pass
# ---------------------------------------------------------------------------

def _plan_buckets(items: Sequence[tuple], bucket_bytes: int,
                  key_fn) -> List[List[tuple]]:
    """Greedy in-order grouping into buckets of <= bucket_bytes, split on a
    change of key (dtype / update-op signature)."""
    buckets: List[List[tuple]] = []
    cur: List[tuple] = []
    cur_key, cur_bytes = None, 0
    for it in items:
        k = key_fn(it)
        nb = it[-1]          # trailing element = nbytes
        if cur and (k != cur_key or cur_bytes + nb > bucket_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur_key = k
        cur.append(it)
        cur_bytes += nb
    if cur:
        buckets.append(cur)
    return buckets


def _numel(var) -> int:
    n = 1
    for d in var.shape:
        n *= max(int(d), 1)
    return n


def _var_nbytes(var) -> int:
    return _numel(var) * torch.empty(0, dtype=convert_dtype(var.dtype)) \
        .element_size()


def _pad64(n: int) -> int:
    return int(math.ceil(n / PAD_MULTIPLE) * PAD_MULTIPLE)


def apply_grad_bucketing(program: Program, startup_program: Program,
                         params_grads, bucket_bytes: int,
                         stage: int = 0) -> Optional[dict]:
    """Rewrite `program` (and `startup_program`) in place; returns the
    bucket metadata (also stored as `program._grad_buckets`) or None when
    nothing was bucketable.

    stage=0: per-bucket `__bucket_sync__` ops, each sunk to its bucket's
    backward-ready point. stage=1: each supported bucket's optimizer state
    moves into flat `[padded]` vars (startup-initialised) and its
    per-parameter update ops become one `__zero_update__`. stage=2: the
    bucket's gradient becomes resident flat state too. stage=3: parameter
    storage moves into flat buckets with on-demand `__zero_gather__`."""
    block = program.global_block()
    dense_pgs = []
    for p, g in params_grads or []:
        gv = block.find_var_recursive(g.name if hasattr(g, "name") else g)
        pv = block.find_var_recursive(p.name if hasattr(p, "name") else p)
        if gv is None or pv is None:
            continue
        dense_pgs.append((pv, gv))
    if not dense_pgs:
        return None

    # Buckets form in GRADIENT-PRODUCTION order (the index of the last op
    # producing each gradient): reverse forward order.
    prod_idx: Dict[str, int] = {}
    for i, op in enumerate(block.ops):
        for n in op.output_names():
            if n != "@EMPTY@":
                prod_idx[n] = i
    dense_pgs.sort(key=lambda pg: prod_idx.get(pg[1].name, 1 << 30))

    raw_grads = {g.name for _, g in dense_pgs}
    # param -> the single per-param update op consuming it (stage 1 targets)
    update_ops: Dict[str, Operator] = {}
    grad_consumers: Dict[str, int] = {g: 0 for g in raw_grads}
    for op in block.ops:
        for n in op.input_names():
            if n in grad_consumers:
                grad_consumers[n] += 1
        if op.type in _UPDATE_STATE_SLOTS \
                and op.attrs.get("op_role", 0) == OpRole.Optimize:
            gname = (op.inputs.get("Grad") or [None])[0]
            pname = (op.inputs.get("Param") or [None])[0]
            pouts = op.outputs.get("ParamOut") or [None]
            if gname and pname and pouts[0] == pname:
                update_ops[pname] = op

    if stage >= 3 and getattr(program, "_layer_stacks", None):
        raise NotImplementedError(
            "ZeRO stage 3 over stacked @LAYERS parameters (the reference's "
            "_plan_stacked_stage3): layer scan is not ported (ROADMAP)")

    zero_meta: List[dict] = []
    if stage >= 1:
        # group params whose update op shares (type, attrs, lr, pows, dtype)
        def upd_key(item):
            pv = item[0]
            op = update_ops.get(pv.name)
            if op is None:
                return None
            at = tuple(sorted((k, repr(v)) for k, v in op.attrs.items()
                              if k != "op_role"))
            extras = tuple(tuple(op.inputs.get(s, ()))
                           for s in _UPDATE_EXTRA_SLOTS[op.type])
            return (op.type, at, dtype_name(pv.dtype),
                    tuple(op.inputs.get("LearningRate", ())), extras)

        items = [(pv, gv, _var_nbytes(pv)) for pv, gv in dense_pgs]
        for group in _plan_buckets(items, bucket_bytes, upd_key):
            if upd_key(group[0]) is None:
                count_fallback("unsupported_rule")
                continue   # unsupported rule: stage-0 sync only (below)
            zero_meta.append(_build_zero_bucket(
                startup_program, block, [(pv, gv) for pv, gv, _ in group],
                update_ops, len(zero_meta), grad_consumers, stage=stage))

    # buckets that consume their raw gradients directly need no sync op
    # (their __zero_update__ would reduce-scatter them itself); every other
    # dense gradient gets a grouped sync op
    sync_meta: List[dict] = []
    rs_grads = {g for b in zero_meta if not b["pre_synced"]
                for g in b["grads"]}
    synced_grads = [(pv, gv) for pv, gv in dense_pgs
                    if gv.name not in rs_grads]
    sync_ops = []
    if synced_grads:
        items = [(pv, gv, _var_nbytes(gv)) for pv, gv in synced_grads]
        for group in _plan_buckets(items, bucket_bytes,
                                   lambda it: dtype_name(it[1].dtype)):
            gvars = [gv for _, gv, _ in group]
            sync_meta.append({
                "grads": [g.name for g in gvars],
                "sizes": [_numel(g) for g in gvars],
                "shapes": [list(g.shape) for g in gvars],
                "dtype": dtype_name(gvars[0].dtype),
            })
        # insert every sync op right after the last op writing any of the
        # bucketed grads; the sink below moves each to ITS bucket's point
        sync_names = {g for m in sync_meta for g in m["grads"]}
        last_w = max((i for i, op in enumerate(block.ops)
                      if sync_names & set(op.output_names())), default=None)
        if last_w is None:
            return None
        at = last_w + 1
        for m in sync_meta:
            sync_ops.append(block._insert_op(
                at, "__bucket_sync__",
                inputs={"X": list(m["grads"])},
                outputs={"Out": list(m["grads"])},
                attrs={"sizes": m["sizes"], "shapes": m["shapes"],
                       "dtype": m["dtype"], "op_role": OpRole.Optimize}))
            at += 1

    if stage >= 3:
        _insert_zero_gathers(block, zero_meta)

    from .transforms import sink_op_to_producers
    for op in sync_ops + [op for op in block.ops
                          if op.type == "__zero_update__"]:
        sink_op_to_producers(block, op)

    meta = {"stage": int(stage), "bucket_bytes": int(bucket_bytes),
            "sync_buckets": sync_meta, "zero_buckets": zero_meta}
    program._grad_buckets = meta
    program.bump_version()
    return meta


def _drop_startup_inits(startup_block, names) -> None:
    """Remove `names`' init ops and vars from the startup program (their
    per-parameter values are exactly what the flat state replaces)."""
    doomed = set(names)
    startup_block.ops = [op for op in startup_block.ops
                         if not (set(op.output_names()) & doomed)]
    for n in doomed:
        startup_block.vars.pop(n, None)


def _startup_flat_zeros(startup_block, name, shape, dtype) -> None:
    startup_block.create_var(name=name, shape=tuple(shape), dtype=dtype,
                             persistable=True, stop_gradient=True)
    startup_block.append_op(
        "fill_constant", inputs={}, outputs={"Out": [name]},
        attrs={"shape": list(shape), "dtype": dtype, "value": 0.0})


def _build_zero_bucket(startup_program, block, group, update_ops, idx,
                       grad_consumers, stage=1) -> dict:
    """Replace `group`'s per-param update ops with one __zero_update__ over
    flat bucket state; returns the bucket's metadata record."""
    from ..framework import unique_name

    ops = [update_ops[pv.name] for pv, _ in group]
    op0 = ops[0]
    params = [pv for pv, _ in group]
    upd_grads = [op.inputs["Grad"][0] for op in ops]
    sizes = [_numel(pv) for pv in params]
    padded = _pad64(sum(sizes))
    dtype = dtype_name(params[0].dtype)
    kinds = sorted(_UPDATE_STATE_SLOTS[op0.type])
    label = f"zero{stage}_b{idx}"

    # update ops that consume the raw gradients, and nothing else reads
    # them; an intervening clip or regularisation op makes the bucket
    # pre-synced instead
    raw_direct = all(
        g == grad_var_name(pv.name) and grad_consumers.get(g, 0) == 1
        for (pv, _), g in zip(group, upd_grads))

    per_param_state = {}
    flat = {}
    startup_block = startup_program.global_block() \
        if startup_program is not None else None
    for kind in kinds:
        in_slot = _UPDATE_STATE_SLOTS[op0.type][kind][0]
        per_param = {pv.name: op.inputs[in_slot][0]
                     for (pv, _), op in zip(group, ops)}
        fname = unique_name.generate(f"{label}_{kind}")
        block.create_var(name=fname, shape=(padded,), dtype=dtype,
                         persistable=True, stop_gradient=True)
        flat[kind] = fname
        for pn, mn in per_param.items():
            per_param_state.setdefault(pn, {})[kind] = mn
        # drop the per-param accumulators and their startup init ops
        for mn in per_param.values():
            block.vars.pop(mn, None)
        if startup_block is not None:
            _drop_startup_inits(startup_block, set(per_param.values()))
            _startup_flat_zeros(startup_block, fname, (padded,), dtype)

    flat_grad = flat_param = None
    if stage >= 2:
        # a resident flat buffer for the bucket's gradient, written every
        # step by __zero_update__
        flat_grad = unique_name.generate(f"{label}_gradbuf")
        block.create_var(name=flat_grad, shape=(padded,), dtype=dtype,
                         persistable=True, stop_gradient=True)
        if startup_block is not None:
            _startup_flat_zeros(startup_block, flat_grad, (padded,), dtype)
    if stage >= 3:
        # parameter STORAGE moves into the flat bucket; the per-param vars
        # demote to transients materialised by __zero_gather__
        flat_param = unique_name.generate(f"zero3_b{idx}_param")
        block.create_var(name=flat_param, shape=(padded,), dtype=dtype,
                         persistable=True, stop_gradient=True)
        for pv in params:
            pv.persistable = False
        if startup_block is not None:
            pnames = [pv.name for pv in params]
            if all(n in startup_block.vars for n in pnames):
                for n in pnames:
                    startup_block.vars[n].persistable = False
                startup_block.create_var(
                    name=flat_param, shape=(padded,), dtype=dtype,
                    persistable=True, stop_gradient=True)
                startup_block.append_op(
                    "__zero_pack__", inputs={"X": pnames},
                    outputs={"Out": [flat_param]},
                    attrs={"sizes": sizes, "padded": padded,
                           "dtype": dtype})

    extra_inputs = {s: list(op0.inputs.get(s, ()))
                    for s in _UPDATE_EXTRA_SLOTS[op0.type]}
    update_attrs = {k: v for k, v in op0.attrs.items() if k != "op_role"}

    pos = min(block.ops.index(op) for op in ops)
    for op in ops:
        block.ops.remove(op)
    inputs = {"Grad": list(upd_grads),
              "LearningRate": list(op0.inputs.get("LearningRate", ())),
              "FlatState": [flat[k] for k in kinds]}
    outputs = {"FlatStateOut": [flat[k] for k in kinds]}
    if stage >= 3:
        inputs["FlatParam"] = [flat_param]
        outputs["FlatParamOut"] = [flat_param]
    else:
        inputs["Param"] = [pv.name for pv in params]
        outputs["ParamOut"] = [pv.name for pv in params]
    if stage >= 2:
        outputs["FlatGradOut"] = [flat_grad]
    inputs.update(extra_inputs)
    block.ops.insert(pos, Operator(
        block, "__zero_update__", inputs, outputs,
        {"update_op": op0.type, "update_attrs": update_attrs,
         "sizes": sizes, "shapes": [list(pv.shape) for pv in params],
         "padded": padded, "dtype": dtype, "state_kinds": kinds,
         "pre_synced": not raw_direct, "stage": int(stage),
         "layout": "flat", "op_role": OpRole.Optimize}))

    return {"op_type": op0.type, "params": [pv.name for pv in params],
            "grads": list(upd_grads), "sizes": sizes,
            "shapes": [list(pv.shape) for pv in params],
            "padded": padded, "flat_numel": padded, "dtype": dtype,
            "flat": flat, "per_param_state": per_param_state,
            "pre_synced": not raw_direct, "stage": int(stage),
            "layout": "flat", "flat_grad": flat_grad,
            "flat_param": flat_param}


def _insert_zero_gathers(block, zero_meta) -> None:
    """Insert one `__zero_gather__` per stage-3 bucket, right before the
    FIRST op reading any of the bucket's params, so the materialised
    parameters live as briefly as possible."""
    plans = []
    for b in zero_meta:
        if not b.get("flat_param"):
            continue
        pset = set(b["params"])
        first = next((i for i, op in enumerate(block.ops)
                      if pset & set(op.input_names())), len(block.ops))
        plans.append((first, b))
    # insert from the back so earlier indices stay valid
    for first, b in sorted(plans, key=lambda t: -t[0]):
        dtypes = []
        for n in b["params"]:
            v = block.find_var_recursive(n)
            dtypes.append(dtype_name(v.dtype) if v is not None
                          else b["dtype"])
        block._insert_op(
            first, "__zero_gather__",
            inputs={"FlatParam": [b["flat_param"]]},
            outputs={"Out": list(b["params"])},
            attrs={"sizes": b["sizes"], "shapes": b["shapes"],
                   "dtypes": dtypes, "padded": b["padded"],
                   "op_role": OpRole.Forward})
