"""Program transforms (counterpart of paddle_tpu/parallel/transforms.py):
the `__segment__` op and `apply_recompute` (:58-105, :480-561), gradient
merge (`GradientMergeWrapper`, :564-668), `RecomputeWrapper` (:670-693)
and `sink_op_to_producers` (:174), which the gradient-bucket pass
(parallel/zero.py) uses.

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

Not ported: layer scan (`apply_layer_scan`, `__layer_scan__`; ROADMAP
item 16) and `checked_pass` (the reference's analysis layer).
"""
from __future__ import annotations

from typing import List

from ..framework.program import OpRole, Operator, Program
from ..ops import registry
from ..ops.registry import register


# ---------------------------------------------------------------------------
# __segment__: a fused sub-graph op (the recompute unit)
# ---------------------------------------------------------------------------

def _run_sub_ops(ctx, sub_ops, env):
    """Apply each op desc's lowering over `env` in order, with the
    program's AMP casts per op (`ctx.amp_dtype`), as the executor's op
    loop applies them."""
    from ..framework.executor import _amp_cast_ins
    for od in sub_ops:
        opdef = registry.get(od["type"])
        ins = {s: [None if n == "@EMPTY@" else env[n] for n in ns]
               for s, ns in od["inputs"].items()}
        if ctx.amp_dtype is not None:
            ins = _amp_cast_ins(od["type"], ins, ctx.amp_dtype)
        outs = opdef.lower(ctx, ins, od["attrs"])
        for s, ns in od["outputs"].items():
            for n, v in zip(ns, outs.get(s, ())):
                if n != "@EMPTY@" and v is not None:
                    env[n] = v
    return env


@register("__segment__")
def _lower_segment(ctx, ins, attrs):
    env = _run_sub_ops(ctx, attrs["sub_ops"],
                       dict(zip(attrs["in_names"], ins["X"])))
    return {"Out": [env[n] for n in attrs["out_names"]]}


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
