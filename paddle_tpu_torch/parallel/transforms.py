"""Program transforms (counterpart of paddle_tpu/parallel/transforms.py):
layer scan (`apply_layer_scan` and the `__layer_scan__` op, :35-477), the
`__segment__` op and `apply_recompute` (:58-105, :480-561), gradient merge
(`GradientMergeWrapper`, :564-668), `RecomputeWrapper` (:670-693) and
`sink_op_to_producers` (:174), which the gradient-bucket pass
(parallel/zero.py) uses.

* Layer scan rolls the N isomorphic per-layer op segments of a deep model
  (ending at `loss._layer_checkpoints`) into ONE `__layer_scan__` op over
  per-layer weights stacked along a new leading [L] axis
  (`<layer-0 name>@LAYERS`); its `sub_ops` attr holds the template
  layer's descs, `layer_seeds` each random op's `__rng_seed__` in every
  layer. The startup program stacks the per-layer initial values (a
  `stack` op); the executor restacks per-layer scope entries a load left
  there (framework/executor.py `_ensure_stacked_params`). Anything the
  roll cannot express falls back to the unrolled program, untouched.
  The lowering is a loop over the layers: layer i runs the template's
  lowerings over row i of each stacked input, the loop invariants and the
  carried activation, each random op keyed by its layer's seed, so the
  rolled program draws the unrolled program's dropout bits.
* The gradient of `__layer_scan__` (`_layer_scan_vjp`, the op's own
  `forward_vjp`) is a reverse loop over the layers, i = L-1 ... 0. Per
  layer it runs what the unrolled program runs for that layer: each op
  under torch.func.vjp with the program's AMP casts, then the pullbacks
  in reverse op order with the cotangents of a var with several readers
  summed by the `sum` lowering in append_backward's order. Row i of each
  stacked gradient is layer i's gradient, so rolled equals unrolled bit
  for bit; a loop invariant's gradient is one running sum over the
  layers (the unrolled program sums its contributions in the same order,
  but together with any reader outside the rolled region). Without
  `remat` the forward keeps every layer's pullbacks until the backward
  (as the unrolled program does); with `remat` it keeps only the L input
  carries, and the backward re-runs layer i just before its pullbacks:
  one layer's intermediates are alive at a time (`scan_stats`).
  ZeRO stage 3 (parallel/zero.py) stores a stacked parameter as an
  `[L, padded]` bucket, a rank's `[L, padded/dp]` shard at dp > 1: layer
  i all-gathers its row (again in the remat backward), and the reverse
  loop reduce-scatters layer i's gradient into row i of the rank's
  gradient. The collectives run outside torch.func.vjp.
* Recompute collapses the forward ops between two checkpoints into one
  `__segment__` op whose `sub_ops` attr holds their descs. Its lowering
  runs them through the registry's lowerings, each with the program's AMP
  casts (the executor's per-op casts; `LowerCtx.amp_dtype`). With `remat`
  the executor does not keep the segment's forward graph for its grad op
  (framework/executor.py `_grad_plan`): the forward runs once without one,
  and the `__vjp__` op re-runs it under torch.func.vjp
  (ops/registry.py `_lower_vjp`), so between the two only the segment's
  boundary values stay alive. The re-run draws the same dropout bits: a
  random op's key comes from the run seed and its `__rng_seed__` attr,
  which its desc in `sub_ops` keeps.
* Gradient merge accumulates each gradient into a persistable `@gm_acc`
  over k steps and gates every state write of the inner update with
  `where(mask, new, old)`, the mask `step % k == 0` from a persistable
  step counter. Everything is a device op on tensors bound in place, so a
  captured step replays the counter. The inner update ops write their
  outputs to temporaries; the executor hands such an op copies of the
  inputs it would otherwise update in place (its output names another
  var).

Not ported: `checked_pass` (the reference's analysis layer, ROADMAP
item 20).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..framework.program import OpRole, Operator, Parameter, Program
from ..ops import registry
from ..ops.registry import register

# Suffix of the stacked per-layer parameter vars `apply_layer_scan`
# creates; the executor's scope round trip restacks per-layer entries
# under it.
LAYER_STACK_SUFFIX = "@LAYERS"


# ---------------------------------------------------------------------------
# __segment__: a fused sub-graph op (the recompute unit)
# ---------------------------------------------------------------------------

def _settled(ctx, ins):
    """On a tp/sp mesh, every input with its partial sums reduced, as the
    executor's op loop settles an op's inputs (parallel/gspmd.py
    `settled`): a sub-op reduces a row-parallel product where the
    unrolled program's op would."""
    if getattr(ctx, "mesh", None) is None:
        return ins
    from .gspmd import settled
    return {s: [None if v is None else settled(v) for v in vs]
            for s, vs in ins.items()}


def _sub_op_ins(ctx, od, env):
    """The inputs of sub-op desc `od` from `env`, with the program's AMP
    casts (`ctx.amp_dtype`) as the executor's op loop applies them."""
    from ..framework.executor import _amp_cast_ins
    ins = {s: [None if n == "@EMPTY@" else env[n] for n in ns]
           for s, ns in od["inputs"].items()}
    if ctx.amp_dtype is not None:
        ins = _amp_cast_ins(od["type"], ins, ctx.amp_dtype)
    return _settled(ctx, ins)


def _with_seed(attrs, seed):
    """`attrs` with `__rng_seed__` = `seed` (None: as they are)."""
    return attrs if seed is None else {**attrs, "__rng_seed__": seed}


def _run_sub_ops(ctx, sub_ops, env, seed_overrides=None):
    """Apply each op desc's lowering over `env` in order, with the
    program's AMP casts per op, and with `seed_overrides[j]` (when not
    None) as op j's `__rng_seed__`: a layer's own seeds inside the layer
    scan."""
    for j, od in enumerate(sub_ops):
        opdef = registry.get(od["type"])
        ins = _sub_op_ins(ctx, od, env)
        attrs = od["attrs"] if seed_overrides is None \
            else _with_seed(od["attrs"], seed_overrides[j])
        outs = opdef.lower(ctx, ins, attrs)
        for s, ns in od["outputs"].items():
            for n, v in zip(ns, outs.get(s, ())):
                if n != "@EMPTY@" and v is not None:
                    env[n] = v
    return env


def _lower_segment(ctx, ins, attrs):
    env = _run_sub_ops(ctx, attrs["sub_ops"],
                       dict(zip(attrs["in_names"], ins["X"])))
    return {"Out": [env[n] for n in attrs["out_names"]]}


# ---------------------------------------------------------------------------
# taped sub-graphs: per-op pullbacks replayed in append_backward's order
# ---------------------------------------------------------------------------

class _Body:
    """A fused op's sub-graph: each op's OpDef and differentiable output
    slots and, for a layer scan, each layer's `__rng_seed__` overrides."""

    def __init__(self, sub_ops, layer_seeds=None, n_layers=1):
        self.sub_ops = sub_ops
        self.opdefs = [registry.get(od["type"]) for od in sub_ops]
        self.out_slots = [[s for s in od["outputs"]
                           if s not in d.stateful_outputs]
                          for od, d in zip(sub_ops, self.opdefs)]
        self.seeds = [None] * n_layers if layer_seeds is None else [
            [None if s is None else int(s[i]) for s in layer_seeds]
            for i in range(n_layers)]

    def reach(self, sources) -> set:
        """The sub-graph's vars downstream of `sources` (append_backward's
        forward closure)."""
        got = set(sources)
        for od, out_slots in zip(self.sub_ops, self.out_slots):
            if any(n in got for ns in od["inputs"].values() for n in ns):
                got.update(n for s in out_slots for n in od["outputs"][s]
                           if n != "@EMPTY@")
        return got

    def taped(self, ctx, env, reach, layer=0) -> "_Tape":
        """Run the sub-graph over `env` (in place) with each op that reads
        a var of `reach` under torch.func.vjp, as the executor runs a
        paired forward op; returns the tape of pullbacks."""
        tape = _Tape()
        seeds = self.seeds[layer]
        for j, od in enumerate(self.sub_ops):
            opdef = self.opdefs[j]
            ins = _sub_op_ins(ctx, od, env)
            attrs = od["attrs"] if seeds is None \
                else _with_seed(od["attrs"], seeds[j])
            diff = [(s, k) for s, ns in od["inputs"].items()
                    if s not in opdef.nondiff_slots
                    for k, n in enumerate(ns)
                    if n in reach and ins[s][k] is not None
                    and ins[s][k].is_floating_point()]
            if diff:
                outs, pullback = registry.forward_vjp(
                    opdef, ctx, ins, attrs, diff, self.out_slots[j])
                tape.ops.append((j, diff, pullback, outs))
            else:
                outs = opdef.lower(ctx, ins, attrs)
            for s, ns in od["outputs"].items():
                for n, v in zip(ns, outs.get(s, ())):
                    if n != "@EMPTY@" and v is not None:
                        env[n] = v
        return tape

    def untape(self, ctx, tape, contribs, sums=None):
        """The tape's pullbacks in reverse op order from the cotangents in
        `contribs` ({var: [contributions]}), as the unrolled program's
        grad ops run them: a var's contributions are summed (`_grad_sum`)
        just before the pullback of the op that wrote it reads them.
        Gradients of the vars in `sums` accumulate there as running sums
        instead; the rest are appended to `contribs`."""
        from ..framework.executor import _amp_cast_ins
        for j, diff, pullback, outs in reversed(tape.ops):
            od, out_slots = self.sub_ops[j], self.out_slots[j]
            if not any(contribs.get(n) for s in out_slots
                       for n in od["outputs"][s]):
                continue
            og = {f"OG:{s}": [_finalize(ctx, contribs, n)
                              for n in od["outputs"][s]]
                  for s in out_slots}
            if ctx.amp_dtype is not None:
                og = _amp_cast_ins(od["type"], og, ctx.amp_dtype)
            og = _settled(ctx, og)
            cts = registry.cotangents(
                og, out_slots, {s: len(od["outputs"][s]) for s in out_slots},
                outs)
            for (s, k), g in zip(diff, pullback(cts)):
                n = od["inputs"][s][k]
                if sums is not None and n in sums:
                    prev = sums[n]
                    sums[n] = g if prev is None \
                        else _grad_sum(ctx, [prev, g])
                else:
                    contribs.setdefault(n, []).append(g)


class _Tape:
    """One forward of a sub-graph under torch.func.vjp: per op that has
    differentiable inputs, (op index, diff entries, pullback, outputs).
    `live` / `peak` count the tapes alive at once (`scan_stats`)."""

    live = 0
    peak = 0

    def __init__(self):
        self.ops = []
        _Tape.live += 1
        _Tape.peak = max(_Tape.peak, _Tape.live)

    def __del__(self):
        _Tape.live -= 1


def scan_stats(reset: bool = False) -> dict:
    """{"live_layers", "peak_live_layers"}: the taped sub-graph forwards
    (a layer of a scan, a segment holding one) whose pullbacks are alive
    now, and the most alive at once since the last reset. A remat scan's
    peak is 1, another's L."""
    out = {"live_layers": _Tape.live, "peak_live_layers": _Tape.peak}
    if reset:
        _Tape.peak = _Tape.live
    return out


def _finalize(ctx, contribs, n):
    """The gradient of `n`: its contributions summed (in place in
    `contribs`), or None."""
    vals = contribs.get(n)
    if not vals:
        return None
    if len(vals) > 1:
        contribs[n] = vals = [_grad_sum(ctx, vals)]
    return vals[0]


def _grad_sum(ctx, vals):
    """The `sum` op append_backward emits for a var with several gradient
    contributions, with its AMP casts."""
    from ..framework.executor import _amp_cast_ins
    ins = {"X": list(vals)}
    if ctx.amp_dtype is not None:
        ins = _amp_cast_ins("sum", ins, ctx.amp_dtype)
    return registry.get("sum").lower(ctx, _settled(ctx, ins), {})["Out"][0]


def _holds_scan(sub_ops) -> bool:
    return any(od["type"] == "__layer_scan__" for od in sub_ops)


def _segment_vjp(ctx, ins, attrs, diff, out_slots):
    """`forward_vjp` of `__segment__`. A segment holding a layer scan (the
    fleet's recompute around a rolled program) runs taped, so the scan's
    own reverse loop (and its remat) does the work inside it; any other
    segment is one torch.func.vjp over its lowering."""
    if not _holds_scan(attrs["sub_ops"]):
        return registry.func_vjp(registry.get("__segment__").lower, ctx,
                                 ins, attrs, diff, out_slots)
    in_names, out_names = attrs["in_names"], attrs["out_names"]
    body = _Body(attrs["sub_ops"])
    env = dict(zip(in_names, ins["X"]))
    reach = body.reach(in_names[k] for _, k in diff)
    tape = body.taped(ctx, env, reach)
    outs = {"Out": [env[n] for n in out_names]}

    def pullback(cts):
        it = iter(cts)
        contribs = {n: [next(it)] for n, v in zip(out_names, outs["Out"])
                    if v is not None and v.is_floating_point()}
        body.untape(ctx, tape, contribs)
        grads = []
        for _, k in diff:
            g = _finalize(ctx, contribs, in_names[k])
            grads.append(torch.zeros_like(ins["X"][k]) if g is None else g)
        return grads

    return outs, pullback


register("__segment__", vjp=_segment_vjp)(_lower_segment)


# ---------------------------------------------------------------------------
# __layer_scan__: N isomorphic layer segments rolled into one loop
# ---------------------------------------------------------------------------

class _Scan:
    """One run of a `__layer_scan__` op over its inputs."""

    def __init__(self, ctx, ins, attrs):
        self.ctx = ctx
        self.n_layers = int(attrs["num_layers"])
        self.body = _Body(attrs["sub_ops"], attrs["layer_seeds"],
                          self.n_layers)
        self.carry_in, self.carry_out = attrs["carry_in"], attrs["carry_out"]
        self.inv = dict(zip(attrs["inv_names"], ins.get("Inv", [])))
        self.stacked_names = list(attrs["stacked_names"])
        self.stacked = list(ins.get("Stacked", []))
        self.zero3 = attrs.get("zero3_flat") \
            or [None] * len(self.stacked_names)

    def layer_value(self, k, i):
        """Layer i's value of stacked input k: its row, or at ZeRO stage 3
        the row of the `[L, padded]` bucket (a rank's shard gathered
        first) unpacked to the parameter's shape."""
        row = self.stacked[k][i]
        z = self.zero3[k]
        if z is None:
            return row
        if row.shape[0] != int(z["padded"]):
            from ..distributed.collective import all_gather_flat
            with torch.no_grad():
                row = all_gather_flat(row)
        return row[:int(z["size"])].reshape(tuple(z["shape"]))

    def env(self, i, carry):
        env = dict(self.inv)
        env[self.carry_in] = carry
        for k, n in enumerate(self.stacked_names):
            env[n] = self.layer_value(k, i)
        return env

    def layer(self, i, carry):
        """Layer i without gradients: its output carry."""
        env = _run_sub_ops(self.ctx, self.body.sub_ops, self.env(i, carry),
                           self.body.seeds[i])
        return env[self.carry_out]

    def taped_layer(self, i, carry, reach):
        """Layer i under torch.func.vjp: (output carry, its _Tape)."""
        env = self.env(i, carry)
        tape = self.body.taped(self.ctx, env, reach, layer=i)
        return env[self.carry_out], tape

    def backward(self, tape, ct, inv_sums):
        """Layer i's pullbacks from the cotangent `ct` of its output carry:
        {var: gradient} of the carry and the stacked parameters; the loop
        invariants' contributions go into the running `inv_sums`."""
        contribs: Dict[str, list] = {self.carry_out: [ct]}
        self.body.untape(self.ctx, tape, contribs, inv_sums)
        return {n: _finalize(self.ctx, contribs, n)
                for n in [self.carry_in] + self.stacked_names}

    def stacked_row(self, k, g):
        """Row of stacked gradient k from one layer's gradient `g`: the
        gradient itself, or at ZeRO stage 3 flattened, zero-padded to the
        bucket and, for a rank's shard, reduce-scattered (unscaled: the
        update scales by 1/dp)."""
        z = self.zero3[k]
        if z is None:
            return g
        store = self.stacked[k]
        with torch.no_grad():
            flat = torch.zeros(int(z["padded"]), dtype=store.dtype,
                               device=store.device)
            flat[:int(z["size"])] = g.reshape(-1)
            if store.shape[-1] != int(z["padded"]):
                from ..distributed.collective import reduce_scatter_flat
                flat = reduce_scatter_flat(flat)
        return flat


def _infer_layer_scan(block, op):
    """The scan carries one activation: Out is shaped exactly like X."""
    block.program.bump_version()
    vi = block.find_var_recursive(op.inputs["X"][0])
    vo = block.find_var_recursive(op.outputs["Out"][0])
    if vi is not None and vo is not None:
        vo.shape = tuple(vi.shape)
        vo.dtype = vi.dtype


def _layer_scan_vjp(ctx, ins, attrs, diff, out_slots):
    """`forward_vjp` of `__layer_scan__` (module docstring): runs the
    forward now and returns (outs, pullback). The pullback maps [the
    cotangent of Out] to one gradient per `diff` entry: X's, each Inv's
    (a running sum over the layers) and each Stacked input's ([L, ...],
    row i layer i's; at ZeRO stage 3 the bucket's or shard's layout)."""
    scan = _Scan(ctx, ins, attrs)
    remat = bool(attrs.get("remat", False))
    sources = set()
    for s, k in diff:
        if s == "X":
            sources.add(scan.carry_in)
        elif s == "Inv":
            sources.add(attrs["inv_names"][k])
        elif s == "Stacked":
            sources.add(scan.stacked_names[k])
    # the carry is differentiable inside the layers whenever anything
    # upstream of it is: every layer's output feeds the next
    sources.add(scan.carry_in)
    reach = scan.body.reach(sources)

    carry = ins["X"][0]
    carries, tapes = [], []
    for i in range(scan.n_layers):
        if remat:
            carries.append(carry)
            carry = scan.layer(i, carry)
        else:
            carry, tape = scan.taped_layer(i, carry, reach)
            tapes.append(tape)
    outs = {"Out": [carry]}

    def pullback(cts):
        ct = cts[0] if cts else torch.zeros_like(carry)
        inv_sums = {attrs["inv_names"][k]: None for s, k in diff
                    if s == "Inv"}
        # each stacked gradient is written row by row as the loop makes
        # it, so a layer's gradient is freed as soon as it is stored
        stacked = {k: _StackedGrad(scan.n_layers)
                   for s, k in diff if s == "Stacked"}
        for i in reversed(range(scan.n_layers)):
            if remat:
                _, tape = scan.taped_layer(i, carries[i], reach)
            else:
                tape = tapes.pop()
            grads = scan.backward(tape, ct, inv_sums)
            del tape
            for k, out in stacked.items():
                g = grads[scan.stacked_names[k]]
                if g is not None:
                    out.put(i, scan.stacked_row(k, g))
            ct = grads[scan.carry_in]
            if ct is None:
                ct = torch.zeros_like(carries[i] if remat else ins["X"][0])
        out = []
        for s, k in diff:
            if s == "X":
                out.append(ct)
            elif s == "Inv":
                g = inv_sums[attrs["inv_names"][k]]
                out.append(torch.zeros_like(ins["Inv"][k]) if g is None
                           else g)
            else:
                out.append(stacked[k].value(scan.stacked[k]))
        return out

    return outs, pullback


class _StackedGrad:
    """An [L, ...] gradient filled row by row (a layer without a gradient
    leaves its row 0). On a tp/sp mesh the rows are DTensors, each in its
    layer's placements: they are kept and stacked at the end (the stack's
    placements shift one dim right, as the `@LAYERS` parameter's do)."""

    def __init__(self, n_layers):
        self.n_layers = n_layers
        self.buf = None
        self.rows = {}

    def put(self, i, row):
        from .gspmd import is_dtensor
        if is_dtensor(row):
            self.rows[i] = row.detach()
            return
        if self.buf is None:
            self.buf = torch.empty((self.n_layers,) + tuple(row.shape),
                                   dtype=row.dtype, device=row.device)
        with torch.no_grad():
            self.buf[i].copy_(row)
        self.rows[i] = None

    def value(self, like):
        if not self.rows:
            return torch.zeros_like(like)
        with torch.no_grad():
            if self.buf is None:
                first = next(iter(self.rows.values()))
                return torch.stack([
                    self.rows[i] if i in self.rows
                    else torch.zeros_like(first)
                    for i in range(self.n_layers)])
            for i in set(range(self.n_layers)) - set(self.rows):
                self.buf[i].zero_()
        return self.buf


@register("__layer_scan__", infer=_infer_layer_scan, vjp=_layer_scan_vjp)
def _lower_layer_scan(ctx, ins, attrs):
    """The loop over the layers, without gradients (module docstring)."""
    scan = _Scan(ctx, ins, attrs)
    carry = ins["X"][0]
    for i in range(scan.n_layers):
        carry = scan.layer(i, carry)
    return {"Out": [carry]}


def apply_recompute(program: Program, checkpoints: List[str]):
    """Fuse the forward ops into `__segment__` ops split after each op
    that writes a checkpoint var. Must run before append_backward."""
    block = program.global_block()
    ck = set(checkpoints)
    fwd_ops = [op for op in block.ops
               if op.attrs.get("op_role", 0) == OpRole.Forward]
    if len(fwd_ops) != len(block.ops):
        raise ValueError("apply_recompute must run before append_backward")

    segments: List[List] = [[]]
    for op in fwd_ops:
        segments[-1].append(op)
        if ck & set(op.output_names()):
            segments.append([])
    if not segments[-1]:
        segments.pop()

    all_reads = set()
    for seg in segments:
        for op in seg:
            all_reads.update(op.input_names())
    new_ops = []
    for i, seg in enumerate(segments):
        if len(seg) <= 1:
            new_ops.extend(seg)
            continue
        seg_produced, seg_inputs = set(), []
        for op in seg:
            for n in op.input_names():
                if n not in seg_produced and n not in seg_inputs \
                        and n != "@EMPTY@":
                    seg_inputs.append(n)
            seg_produced.update(op.output_names())
        later_reads = set()
        for s2 in segments[i + 1:]:
            for op in s2:
                later_reads.update(op.input_names())
        # visible after the segment: read later, a checkpoint, or read by
        # nothing yet (the loss, metrics: backward and fetches read them)
        seg_outputs = [n for n in seg_produced
                       if n in later_reads or n in ck or n not in all_reads]
        sub_descs = [{"type": op.type, "inputs": op.inputs,
                      "outputs": op.outputs, "attrs": dict(op.attrs)}
                     for op in seg]
        new_ops.append(Operator(block, "__segment__",
                                {"X": seg_inputs}, {"Out": seg_outputs},
                                {"sub_ops": sub_descs,
                                 "in_names": seg_inputs,
                                 "out_names": seg_outputs, "remat": True,
                                 "op_role": OpRole.Forward}))
    block.ops = new_ops
    program.bump_version()
    return program


# ---------------------------------------------------------------------------
# Gradient merge (micro-batch accumulation)
# ---------------------------------------------------------------------------

class GradientMergeWrapper:
    """Wraps any optimizer: accumulates the gradients k steps, then applies
    the inner update, every state write of which is gated by the step mask
    (the moments and beta pows move on merge steps only)."""

    def __init__(self, inner, k_steps: int, avg: bool = True):
        self.inner = inner
        self.k = k_steps
        self.avg = avg

    def __getattr__(self, item):
        return getattr(self.inner, item)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.inner.backward(loss, startup_program,
                                           parameter_list, no_grad_set)
        self.apply_gradients_merged(loss.block.program, params_grads)
        return [], params_grads

    def apply_gradients_merged(self, program, params_grads):
        from .. import layers
        from ..framework import unique_name
        block = program.global_block()
        # the gated update is not the per-parameter update the bucket pass
        # (parallel/zero.py) rewrites
        program._grad_bucketing_unsafe = True
        merge_start = len(block.ops)

        step = layers.create_global_var([1], 0.0, "float32", persistable=True,
                                        name=unique_name.generate("gm_step"))
        step_new = layers.increment(step, value=1.0, in_place=False)
        layers.assign(step_new, step)
        k_var = layers.fill_constant([1], "float32", float(self.k))
        rem = layers.elementwise_mod(step, k_var)
        zero = layers.fill_constant([1], "float32", 0.0)
        apply_mask = layers.equal(rem, zero)           # bool [1]

        merged = []
        for p, g in params_grads:
            acc = layers.create_global_var(
                list(p.shape), 0.0, "float32", persistable=True,
                name=unique_name.generate(f"{p.name}_gm_acc"))
            acc_new = layers.sums([acc, g])
            eff = (layers.scale(acc_new, scale=1.0 / self.k) if self.avg
                   else acc_new)
            merged.append((p, eff))
            zeros = layers.zeros_like(acc)
            kept = layers.where(apply_mask, zeros, acc_new)
            layers.assign(kept, acc)

        inner = self.inner
        if inner._grad_clip is not None:
            merged = inner._grad_clip(merged)
        merged = inner._append_regularization(merged)
        inner._create_accumulators(block, [p for p, _ in merged])
        inner._create_lr_var()
        for pg in merged:
            op = inner._append_optimize_op(block, pg)
            op.attrs["op_role"] = OpRole.Optimize
            self._gate_outputs(block, op, apply_mask)
        for op in inner._finalize_optimize_ops(block):
            op.attrs["op_role"] = OpRole.Optimize
            self._gate_outputs(block, op, apply_mask)
        # exactly the ops this transform appended
        for op in block.ops[merge_start:]:
            if op.attrs.get("op_role", 0) == 0:
                op.attrs["op_role"] = OpRole.Optimize

    def _gate_outputs(self, block, op, mask_var):
        """Rewrite the op's outputs to temporaries, then
        out = where(mask, temporary, old)."""
        from ..framework import unique_name
        pairs = []
        for names in op.outputs.values():
            for i, n in enumerate(names):
                tmp = block.create_var(
                    name=unique_name.generate(f"{n}_gated"),
                    shape=block.var(n).shape, dtype=block.var(n).dtype,
                    stop_gradient=True)
                pairs.append((n, tmp.name))
                names[i] = tmp.name
        for orig, tmp in pairs:
            block.append_op("where",
                            inputs={"Condition": [mask_var.name],
                                    "X": [tmp], "Y": [orig]},
                            outputs={"Out": [orig]},
                            attrs={"op_role": OpRole.Optimize})
        block.program.bump_version()


class RecomputeWrapper:
    """Optimizer wrapper applying activation checkpointing before the
    backward (reference optimizer.py:4547 RecomputeOptimizer): the forward
    ops collapse into `__segment__` ops with remat, so only checkpoint
    activations stay alive."""

    def __init__(self, inner, checkpoints):
        self._inner = inner
        self._set_checkpoints(checkpoints)

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = [c.name if hasattr(c, "name") else c
                             for c in checkpoints]

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ..framework.program import default_main_program
        apply_recompute(default_main_program(), self._checkpoints)
        return self._inner.minimize(loss, startup_program, parameter_list,
                                    no_grad_set)


def sink_op_to_producers(block, op) -> int:
    """Move `op` EARLIER in the block's op list, to right after the last op
    it has a dataflow edge with: an op writing any of its inputs, or
    reading/writing any of its outputs. A bucket's sync/update op placed at
    the backward->optimize boundary sinks back to its bucket's ready point,
    the moment its last gradient is produced. The motion never crosses a
    producer of an input, a reader of an output, or another writer of an
    output, so the program computes the same values. Returns the new
    index."""
    ops = block.ops
    pos = ops.index(op)
    ins = {n for n in op.input_names() if n != "@EMPTY@"}
    outs = {n for n in op.output_names() if n != "@EMPTY@"}
    new = pos
    for i in range(pos - 1, -1, -1):
        other = ops[i]
        o_out = set(other.output_names())
        if (o_out & ins) or (o_out & outs) \
                or (set(other.input_names()) & outs):
            break
        new = i
    if new < pos:
        ops.pop(pos)
        ops.insert(new, op)
        block.program.bump_version()
    return new


# ---------------------------------------------------------------------------
# apply_layer_scan: the roll
# ---------------------------------------------------------------------------

def _attr_val_equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.shape == b.shape and bool(np.array_equal(a, b)))
    return type(a) == type(b) and a == b            # noqa: E721


def _attrs_equal(a: dict, b: dict) -> bool:
    if set(a) != set(b):
        return False
    return all(_attr_val_equal(a[k], b[k]) for k in a)


class _SegmentMapper:
    """Builds the name correspondence template segment -> segment i, or
    reports non-isomorphism: two segments are isomorphic when their op
    sequences match type-, slot- and attr-wise (attrs modulo the per-op
    `__rng_seed__`) under a consistent bijective renaming of vars."""

    def __init__(self, template):
        self.template = template

    def map_segment(self, seg) -> Optional[Dict[str, str]]:
        if len(seg) != len(self.template):
            return None
        f: Dict[str, str] = {}
        rev: Dict[str, str] = {}

        def bind(n0, ni):
            if n0 == "@EMPTY@" or ni == "@EMPTY@":
                return n0 == ni
            if n0 in f:
                return f[n0] == ni
            if ni in rev:
                return False
            f[n0] = ni
            rev[ni] = n0
            return True

        for op0, opi in zip(self.template, seg):
            if op0.type != opi.type:
                return None
            if sorted(op0.inputs) != sorted(opi.inputs) \
                    or sorted(op0.outputs) != sorted(opi.outputs):
                return None
            a0 = {k: v for k, v in op0.attrs.items() if k != "__rng_seed__"}
            ai = {k: v for k, v in opi.attrs.items() if k != "__rng_seed__"}
            if not _attrs_equal(a0, ai):
                return None
            if ("__rng_seed__" in op0.attrs) != ("__rng_seed__" in opi.attrs):
                return None
            for slots0, slotsi in ((op0.inputs, opi.inputs),
                                   (op0.outputs, opi.outputs)):
                for slot in slots0:
                    if len(slots0[slot]) != len(slotsi[slot]):
                        return None
                    for n0, ni in zip(slots0[slot], slotsi[slot]):
                        if not bind(n0, ni):
                            return None
        return f


def _segment_externals(seg) -> List[str]:
    """Segment inputs produced outside it, in first-read order."""
    ext, seen, internal = [], set(), set()
    for op in seg:
        for n in op.input_names():
            if n != "@EMPTY@" and n not in internal and n not in seen:
                seen.add(n)
                ext.append(n)
        internal.update(n for n in op.output_names() if n != "@EMPTY@")
    return ext


def apply_layer_scan(program: Program, boundaries: List,
                     remat: bool = False, startup_program=None,
                     min_layers: int = 2) -> Optional[List[str]]:
    """Roll the N isomorphic per-layer segments ending at `boundaries`
    into one `__layer_scan__` op over [L]-stacked weights (reference
    :278-477).

    Segment i is the op run producing boundaries[i] from boundaries[i-1].
    Segments must be equally spaced and isomorphic (`_SegmentMapper`),
    the only renamed externals being the carried activation and per-layer
    persistable parameters of one shape, dtype and trainability. The
    program is left untouched (and None returned) on any other shape:
    unequal spacing, non-isomorphic segments (differing attrs, such as
    `pipeline_stage` under pp, included), a persistable written inside a
    segment, two carried vars, or a value produced inside the rolled
    region and read outside it (but the last boundary).

    Per-layer params are replaced by stacked `<layer-0 name>@LAYERS`
    Parameters ([L, ...]), recorded in `program._layer_stacks`. With
    `startup_program`, a `stack` op there stacks their initial values
    (the per-layer vars turn non-persistable in it). Must run before
    append_backward. Returns the interior boundaries the roll consumed
    (callers drop them from recompute checkpoints: `remat` already
    re-computes per layer), or None on fallback."""
    block = program.global_block()
    bounds = [b.name if hasattr(b, "name") else str(b) for b in boundaries]
    if len(bounds) < max(int(min_layers), 2):
        return None
    ops = block.ops
    if any(op.attrs.get("op_role", 0) != OpRole.Forward for op in ops):
        raise ValueError("apply_layer_scan must run before append_backward")

    producer = {}
    for idx, op in enumerate(ops):
        for n in op.output_names():
            if n != "@EMPTY@":
                producer[n] = idx
    if any(b not in producer for b in bounds):
        return None
    e = [producer[b] for b in bounds]
    n_layers = len(bounds)
    if any(e[i] >= e[i + 1] for i in range(n_layers - 1)):
        return None
    seg_len = e[1] - e[0]
    # equal spacing is the cheap pre-check (and fixes segment 0's start)
    if seg_len <= 0 or any(e[i + 1] - e[i] != seg_len
                           for i in range(n_layers - 1)):
        return None
    start0 = e[0] - seg_len + 1
    if start0 < 0:
        return None
    segments = [ops[e[i] - seg_len + 1: e[i] + 1] for i in range(n_layers)]

    template = segments[0]
    mapper = _SegmentMapper(template)
    maps = [None] + [mapper.map_segment(s) for s in segments[1:]]
    if any(m is None for m in maps[1:]):
        return None
    if any(maps[i].get(bounds[0]) != bounds[i] for i in range(1, n_layers)):
        return None

    # no segment may write a persistable (running statistics)
    for seg in segments:
        for op in seg:
            for n in op.output_names():
                v = block.find_var_recursive(n)
                if v is not None and v.persistable:
                    return None

    # the template's externals: loop-invariant, the carry, or stacked
    externals = _segment_externals(template)
    carry_in = None
    stacked_templates: List[str] = []
    for n0 in externals:
        images = [maps[i].get(n0, n0) for i in range(1, n_layers)]
        if all(ni == n0 for ni in images):
            continue
        if images == bounds[:-1]:
            if carry_in is not None:
                return None                            # two carried vars
            carry_in = n0
            continue
        v0 = block.find_var_recursive(n0)
        if v0 is None or not v0.persistable:
            return None
        for ni in images:
            vi = block.find_var_recursive(ni)
            if vi is None or not vi.persistable \
                    or tuple(vi.shape) != tuple(v0.shape) \
                    or vi.dtype != v0.dtype \
                    or vi.trainable != v0.trainable \
                    or vi.stop_gradient != v0.stop_gradient:
                return None
        stacked_templates.append(n0)
    if carry_in is None:
        return None
    cv = block.find_var_recursive(carry_in)
    bv = block.find_var_recursive(bounds[0])
    if cv is None or bv is None or tuple(cv.shape) != tuple(bv.shape) \
            or cv.dtype != bv.dtype:
        return None

    # nothing produced inside the rolled region may be read outside it,
    # except the final boundary (the scan's Out)
    inner_produced = set()
    for seg in segments:
        for op in seg:
            inner_produced.update(n for n in op.output_names()
                                  if n != "@EMPTY@")
    inner_produced.discard(bounds[-1])
    for op in ops[:start0] + ops[e[-1] + 1:]:
        if inner_produced & set(op.input_names()):
            return None

    inv_names = [n for n in externals
                 if n != carry_in and n not in stacked_templates]

    # the template's op descs, seeds stripped (each layer's ride along)
    sub_descs, layer_seeds = [], []
    for j, op0 in enumerate(template):
        at = {k: v for k, v in op0.attrs.items() if k != "__rng_seed__"}
        sub_descs.append({"type": op0.type,
                          "inputs": {k: list(v)
                                     for k, v in op0.inputs.items()},
                          "outputs": {k: list(v)
                                      for k, v in op0.outputs.items()},
                          "attrs": at})
        if "__rng_seed__" in op0.attrs:
            layer_seeds.append([int(segments[i][j].attrs["__rng_seed__"])
                                for i in range(n_layers)])
        else:
            layer_seeds.append(None)

    # the stacked parameter vars; the per-layer Parameters leave the block
    stacks: Dict[str, List[str]] = {}
    for n0 in stacked_templates:
        group = [n0] + [maps[i][n0] for i in range(1, n_layers)]
        tvar = block.var(n0)
        sname = n0 + LAYER_STACK_SUFFIX
        p = Parameter(block, name=sname,
                      shape=(n_layers,) + tuple(tvar.shape),
                      dtype=tvar.dtype, trainable=tvar.trainable)
        p.regularizer = getattr(tvar, "regularizer", None)
        if hasattr(tvar, "optimize_attrs"):
            p.optimize_attrs = dict(tvar.optimize_attrs)
        block.vars[sname] = p
        stacks[sname] = group
    for group in stacks.values():
        for n in group:
            block.vars.pop(n, None)

    scan_op = Operator(
        block, "__layer_scan__",
        {"X": [carry_in], "Inv": inv_names,
         "Stacked": [n0 + LAYER_STACK_SUFFIX for n0 in stacked_templates]},
        {"Out": [bounds[-1]]},
        {"sub_ops": sub_descs, "num_layers": n_layers,
         "carry_in": carry_in, "carry_out": bounds[0],
         "inv_names": inv_names, "stacked_names": list(stacked_templates),
         "layer_seeds": layer_seeds, "remat": bool(remat),
         "op_role": OpRole.Forward})
    block.ops = ops[:start0] + [scan_op] + ops[e[-1] + 1:]
    registry.infer_op(block, scan_op)

    program._layer_stacks = {**getattr(program, "_layer_stacks", {}),
                             **stacks}
    program.bump_version()

    if startup_program is not None:
        sb = startup_program.global_block()
        for sname, group in stacks.items():
            if not all(g in sb.vars for g in group):
                continue        # initialised elsewhere: the executor's
            for g in group:     # restack covers them
                sb.vars[g].persistable = False
            sv = block.var(sname)
            sb.create_var(name=sname, shape=sv.shape, dtype=sv.dtype,
                          persistable=True, stop_gradient=True)
            sb.append_op("stack", inputs={"X": list(group)},
                         outputs={"Y": [sname]}, attrs={"axis": 0})
        startup_program.bump_version()
    return bounds[:-1]
