"""Gradient bucketing and ZeRO stages 0-3, on one process and across
processes (counterpart of paddle_tpu/parallel/zero.py).

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
2. **Lowerings.** Inside a data-parallel step (`current_manual_dp()` is
   ("dp", dp): the executor's manual-dp plan, framework/executor.py) they
   compute what the reference's manual path computes, over the port's
   collectives (distributed/collective.py), one process per rank:
   * `__bucket_sync__`: concatenate, all-reduce (sum), then `* 1/dp`, in
     that order (reference :197-212), split back;
   * `__zero_update__` at stages 1-2, when dp divides the padding:
     reduce-scatter the flat gradient and scale it (a `pre_synced` bucket
     slices its synced gradient instead), then ONE update of this rank's
     `[padded/dp]` shard through `_apply_update_rule` (on the card, one
     B6-B8 launch at the shard's width) against the rank's flat state
     shard, then all-gather the parameters and copy them back; stage 2
     keeps the gradient shard resident; stage 3 updates the rank's
     parameter shard and gathers nothing;
   * `__zero_gather__` (stage 3) all-gathers the bucket's shard before
     its first forward use;
   * a dp that does not divide the padding runs the update at full width,
     the gradient all-reduced and scaled first (:347-355), and is counted
     (`indivisible_padding`).
   The flat state of a rank is its shard (`shard_names`,
   `shard_flat_state`: the executor slices the startup's `[padded]`
   values), so state bytes per rank fall by dp (`optimizer_state_bytes`).
   On one process there is no data-parallel group: `__bucket_sync__` is
   the identity and `__zero_update__` runs the full-width branch.
3. **The checkpoint round trip** (reference `unbucket_state_for_save`
   :1090, `adopt_unsharded_state` :1030): checkpoints are always written
   unsharded, each flat bucket split back into its per-parameter entries
   under the names a stage-0 program uses (stage-2 flat gradients are
   per-step scratch and are dropped), so a stage-k checkpoint loads into a
   stage-0 program and into the reference, and back, at any dp. At dp > 1
   the save all-gathers the shards first (`gather_flat_shards`, io.py);
   a load packs the per-parameter entries and takes this rank's shard
   (`take_shards`). A stage-k program packs per-parameter entries into its
   flat buckets: on the host when a loader knows the program
   (`pack_unsharded_arrays`), or from the scope at the start of the next
   run (`adopt_unsharded_state`, called by the executor's `_prepare` as
   the reference's `_ensure_zero_state` calls it). Either way the packed
   bucket is `copy_`'d into the scope's existing flat tensor, so a captured
   step bound to it stays valid. This is the elastic resize: train at dp
   4, resume at dp 2.

Not ported: the stacked `@LAYERS` stage-3 path (`_plan_stacked_stage3`,
`_zero_update_stacked`: layer scan is ROADMAP item 16, so such a program
raises); and the `checked_pass` verifier (analysis/, item 20).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
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


def cross_batch_cause(op_type: str) -> str:
    """The fallback cause a cross-batch op counts under (the port's copy of
    paddle_tpu/analysis/op_specs.py `cross_batch_cause`)."""
    return "batch_norm" if op_type in _BATCH_STATS_OPS else "cross_batch"


# Ops whose semantics couple examples ACROSS the batch beyond a trailing
# mean-reduced loss (the port's copy of the reference's `cross_batch` op
# specs, paddle_tpu/analysis/op_specs.py:293-384): a rank's local batch
# would compute local statistics, so a dp > 1 program holding one raises.
_BATCH_STATS_OPS = frozenset({"batch_norm", "data_norm", "inplace_abn"})
CROSS_BATCH_OPS = _BATCH_STATS_OPS | frozenset({"switch_moe", "auc"})

_manual_dp: List[tuple] = []   # stack of (axis_name, dp)


class _manual_ctx:
    """The executor runs a data-parallel step inside this context."""

    def __init__(self, dp: int, axis: str = "dp"):
        self._entry = (axis, int(dp))

    def __enter__(self):
        _manual_dp.append(self._entry)
        return self

    def __exit__(self, *exc):
        _manual_dp.pop()
        return False


def current_manual_dp() -> Optional[tuple]:
    """(axis_name, dp) inside a data-parallel step, else None."""
    return _manual_dp[-1] if _manual_dp else None


def _rank() -> int:
    from ..distributed.parallel import get_rank
    return get_rank()


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
    """One grouped gradient sync per bucket: concatenate, all-reduce,
    `* 1/dp`, split back (the reference's GradAllReduce: sum, then the
    1/nranks scale). The identity on one process (the gradients are
    already the whole batch's)."""
    grads = ins["X"]
    manual = current_manual_dp()
    if manual is None:
        return {"Out": list(grads)}
    from ..distributed.collective import all_reduce
    dp = manual[1]
    dt = convert_dtype(attrs["dtype"])
    with torch.no_grad():
        flat = torch.cat([g.reshape(-1).to(dt) for g in grads])
        flat = all_reduce(flat) * (1.0 / dp)
        outs, off = [], 0
        for g, size, shape in zip(grads, attrs["sizes"], attrs["shapes"]):
            outs.append(flat[off:off + size].reshape(tuple(shape))
                        .to(g.dtype))
            off += size
    return {"Out": outs}


@register("__zero_pack__", infer=_infer_noop, nondiff_slots=("X",),
          stateful_outputs=("Out",))
def _lower_zero_pack(ctx, ins, attrs):
    """Pack per-parameter values into the flat [padded] bucket layout: the
    startup-program side of ZeRO-3 parameter storage."""
    if attrs.get("layout") == "stacked":
        raise NotImplementedError(
            "__zero_pack__ of a stacked @LAYERS bucket: layer scan is not "
            "ported (ROADMAP item 16)")
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
    if current_manual_dp() is not None \
            and flat.shape[0] != int(attrs["padded"]):
        from ..distributed.collective import all_gather_flat
        with torch.no_grad():
            flat = all_gather_flat(flat)
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
    """Staged ZeRO bucket update, in place. Inside a data-parallel step
    whose dp divides the padding: reduce-scatter the bucket's gradients
    (or slice pre-synced ones), update this rank's `[padded/dp]` shard
    against its flat state shard, then all-gather the parameters (stages
    1-2) or keep the parameter shard (stage 3). Otherwise the update runs
    at full width, the local gradients all-reduced first inside a
    data-parallel step. Stages 1-2 copy the updated parameters back into
    the scope's parameter tensors; stage >= 2 also emits the (averaged)
    gradient shard as resident state (`FlatGradOut`)."""
    if attrs.get("layout") == "stacked":
        raise NotImplementedError(
            "__zero_update__ of a stacked @LAYERS bucket: layer scan is not "
            "ported (ROADMAP item 16)")
    from ..distributed import collective as coll
    op_type = attrs["update_op"]
    stage = int(attrs.get("stage", 1))
    sizes = list(attrs["sizes"])
    padded = int(attrs["padded"])
    kinds = list(attrs["state_kinds"])
    dt = convert_dtype(attrs["dtype"])
    manual = current_manual_dp()
    with torch.no_grad():
        flat_g = _flat_concat(ins["Grad"], dt, padded)
        if stage >= 3:
            flat_p = ins["FlatParam"][0]
            shard_mode = manual is not None and flat_p.shape[0] != padded
        else:
            params = ins["Param"]
            flat_p = _flat_concat(params, dt, padded)
            shard_mode = (manual is not None and manual[1] > 1
                          and padded % manual[1] == 0)
        if shard_mode:
            dp = manual[1]
            shard = padded // dp
            lo = _rank() * shard
            if attrs.get("pre_synced"):
                g_shard = flat_g[lo:lo + shard]
            else:
                g_shard = coll.reduce_scatter_flat(flat_g) * (1.0 / dp)
            p_shard = flat_p if stage >= 3 else flat_p[lo:lo + shard]
        else:
            if manual is not None and not attrs.get("pre_synced"):
                flat_g = coll.all_reduce(flat_g) * (1.0 / manual[1])
            g_shard, p_shard = flat_g, flat_p
        inner_ins = {"Param": [p_shard], "Grad": [g_shard],
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
            if p_new.shape[0] != padded:
                p_new = coll.all_gather_flat(p_new)
            off = 0
            for size, p in zip(sizes, params):
                p.copy_(p_new[off:off + size].reshape(p.shape))
                off += size
            outs["ParamOut"] = list(params)
    outs["FlatStateOut"] = [res[slot_map[kind][1]][0] for kind in kinds]
    if stage >= 2:
        outs["FlatGradOut"] = [g_shard]
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
            "_plan_stacked_stage3): layer scan is not ported (ROADMAP item "
            "16)")

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


# ---------------------------------------------------------------------------
# the checkpoint round trip
# ---------------------------------------------------------------------------

def zero_buckets(program) -> List[dict]:
    return (getattr(program, "_grad_buckets", None) or {}).get(
        "zero_buckets") or []


def _flat_groups(program, b) -> List[tuple]:
    """(flat var, per-entry names in bucket order) for each flat array of
    bucket `b` that stands for per-parameter checkpoint entries: the state
    kinds whose per-parameter vars the pass removed, and at stage 3 the
    parameters themselves."""
    gb = program.global_block()
    groups = []
    for kind, fname in b["flat"].items():
        legacy = [b["per_param_state"][p][kind] for p in b["params"]]
        if not any(gb.has_var(n) for n in legacy):
            groups.append((fname, legacy))
    if b.get("flat_param"):
        groups.append((b["flat_param"], list(b["params"])))
    return groups


def unbucket_state_for_save(program, arrays: dict) -> dict:
    """Host arrays of a checkpoint -> the unsharded format: each flat
    bucket entry replaced by its per-parameter views, the stage-2 flat
    gradients dropped."""
    buckets = zero_buckets(program)
    if not buckets:
        return arrays
    out = dict(arrays)
    for b in buckets:
        for fname, legacy in _flat_groups(program, b):
            flat = out.pop(fname, None)
            if flat is None:
                continue
            flat, off = np.asarray(flat).reshape(-1), 0
            for n, size, shape in zip(legacy, b["sizes"], b["shapes"]):
                out[n] = flat[off:off + size].reshape(tuple(shape))
                off += size
        if b.get("flat_grad"):
            out.pop(b["flat_grad"], None)
    return out


def _packable(values, b) -> bool:
    return all(tuple(np.shape(v)) == tuple(shape)
               for v, shape in zip(values, b["shapes"]))


def pack_unsharded_arrays(program, arrays: dict) -> dict:
    """Inverse of `unbucket_state_for_save` on host arrays: where every
    per-parameter entry of a flat group is present with the bucket's
    shapes, they are replaced by the packed [padded] flat array. A partial
    set is left as it is (ambiguous, as in the reference)."""
    buckets = zero_buckets(program)
    if not buckets:
        return arrays
    out = dict(arrays)
    for b in buckets:
        for fname, legacy in _flat_groups(program, b):
            if not all(n in out for n in legacy):
                continue
            vals = [np.asarray(out[n]) for n in legacy]
            if not _packable(vals, b):
                continue
            flat = np.zeros(int(b["padded"]),
                            dtype=np.dtype(vals[0].dtype))
            off = 0
            for v in vals:
                flat[off:off + v.size] = v.reshape(-1)
                off += v.size
            for n in legacy:
                del out[n]
            out[fname] = flat
    return out


def adopt_unsharded_state(program, scope, device=None) -> None:
    """Scope side of the round trip (the executor's `_prepare`):
    when every per-parameter entry of a flat group is in the scope (an
    unsharded checkpoint or snapshot was restored there without the
    program), pack them into the flat var, in place when the scope holds
    it, and erase the per-parameter entries; at dp > 1 this rank's shard
    of it. Loaded values win over the flat values; only the program's own
    recorded names are touched."""
    from ..framework.scope import load_arrays, to_numpy
    for b in zero_buckets(program):
        for fname, legacy in _flat_groups(program, b):
            if not all(scope.has(n) for n in legacy):
                continue
            host = {n: to_numpy(scope.find(n)) for n in legacy}
            packed = pack_unsharded_arrays(program, host)
            if fname not in packed:
                continue
            load_arrays(scope, take_shards(program, {fname: packed[fname]}),
                        device=device)
            for n in legacy:
                scope.erase(n)


# ---------------------------------------------------------------------------
# data parallelism: the rank's shards of the flat storage
# ---------------------------------------------------------------------------

def _dp_width(program) -> int:
    """The dp width the program runs at: the default group's size when the
    program was minimized for more than one rank (fleet records it)."""
    if int(getattr(program, "_dp", 1) or 1) <= 1:
        return 1
    from ..distributed.parallel import get_world_size
    return get_world_size()


def shard_names(program) -> Dict[str, int]:
    """{flat var: padded} of every flat array a rank holds as its
    `[padded/dp]` shard: the state kinds, stage-2 gradient buffers and
    stage-3 parameter storage of each bucket whose padding dp divides."""
    dp = _dp_width(program)
    out: Dict[str, int] = {}
    if dp <= 1:
        return out
    for b in zero_buckets(program):
        padded = int(b["padded"])
        if padded % dp:
            continue
        for n in list(b["flat"].values()) + [b.get("flat_grad"),
                                             b.get("flat_param")]:
            if n:
                out[n] = padded
    return out


def take_shards(program, arrays: dict) -> dict:
    """Host arrays -> the same with every full `[padded]` flat array of
    `shard_names` cut to this rank's shard (what a load writes)."""
    names = shard_names(program)
    if not names:
        return arrays
    dp, rank = _dp_width(program), _rank()
    out = dict(arrays)
    for n, padded in names.items():
        v = out.get(n)
        if v is not None and np.size(v) == padded:
            k = padded // dp
            out[n] = np.asarray(v).reshape(-1)[rank * k:(rank + 1) * k]
    return out


def shard_flat_state(program, scope) -> None:
    """At dp > 1, replace each full `[padded]` flat tensor of
    `shard_names` in the scope (the startup program's values, or a rebound
    load) with this rank's `[padded/dp]` slice."""
    names = shard_names(program)
    if not names:
        return
    dp, rank = _dp_width(program), _rank()
    for n, padded in names.items():
        v = scope.find(n)
        if isinstance(v, torch.Tensor) and v.numel() == padded:
            k = padded // dp
            scope.set(n, v.reshape(-1)[rank * k:(rank + 1) * k].clone())


def gather_flat_shards(program, scope, arrays: dict) -> dict:
    """Host arrays of the scope with each flat shard of `shard_names`
    replaced by the full `[padded]` array gathered from every rank (a
    collective: every rank calls it)."""
    names = shard_names(program)
    if not names:
        return arrays
    from ..distributed.collective import all_gather_flat
    from ..framework.scope import to_numpy
    out = dict(arrays)
    for n, padded in sorted(names.items()):
        v = scope.find(n)
        if n in out and isinstance(v, torch.Tensor) and v.numel() != padded:
            with torch.no_grad():
                out[n] = to_numpy(all_gather_flat(v))
    return out


def optimizer_state_bytes(program, dp: int = 1) -> dict:
    """Per-rank state accounting from program metadata (the reference's
    :1120): flat bucket bytes divide by dp when the padding does;
    per-parameter accumulators count at full width on every rank; stage
    >= 2 adds the resident gradient-shard bytes and stage 3 the
    parameter-shard bytes."""
    buckets = zero_buckets(program)
    meta = getattr(program, "_grad_buckets", None) or {}
    flat_total = grad_total = param_total = 0
    for b in buckets:
        item = torch.empty(0, dtype=convert_dtype(b["dtype"])).element_size()
        numel = b.get("flat_numel", b["padded"])
        flat_total += numel * item * len(b["flat"])
        if b.get("flat_grad"):
            grad_total += numel * item
        if b.get("flat_param"):
            param_total += numel * item
    block = program.global_block()
    repl_total = 0
    seen = set()
    for op in block.ops:
        if op.type not in _UPDATE_STATE_SLOTS \
                or op.attrs.get("op_role", 0) != OpRole.Optimize:
            continue
        for kind, (in_slot, _out) in _UPDATE_STATE_SLOTS[op.type].items():
            for n in op.inputs.get(in_slot, ()):
                if n in seen:
                    continue
                seen.add(n)
                v = block.find_var_recursive(n)
                if v is not None:
                    repl_total += _var_nbytes(v)
    sharded = all(b["padded"] % max(dp, 1) == 0 for b in buckets)
    div = dp if (dp > 1 and sharded) else 1
    flat_per_dev = flat_total // div
    return {"flat_state_bytes_total": int(flat_total),
            "flat_state_bytes_per_device": int(flat_per_dev),
            "flat_grad_bytes_total": int(grad_total),
            "flat_grad_bytes_per_device": int(grad_total // div),
            "flat_param_bytes_total": int(param_total),
            "flat_param_bytes_per_device": int(param_total // div),
            "replicated_state_bytes": int(repl_total),
            "state_bytes_per_device": int(flat_per_dev + repl_total),
            "dp": int(dp),
            "zero_stage": int(meta.get("stage", 1)) if buckets else 0}
