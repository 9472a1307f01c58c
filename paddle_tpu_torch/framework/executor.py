"""Executor: runs a Program's global block op by op on one device
(counterpart of paddle_tpu/framework/executor.py: `Executor.run` :1081,
`_run_block` :358-399, AMP casts :585-623, feed coercion :626).

The reference traces a whole block into one jitted XLA computation. The
port runs eagerly: each op's lowering is called in program order on the
Executor's device (`cuda` unless the caller asks for the CPU), reading
feeds, the scope's persistable tensors and earlier ops' outputs.

* Gradients. A `__vjp__` op pulls cotangents back through its forward
  op. Where the executor can pair a grad op with its forward op (same
  type, inputs and attrs, no stateful outputs), it runs that forward op
  under torch.func.vjp and keeps the pullback until the grad op runs, so
  the forward is computed once per step (flash attention's B1 launches
  once per layer). An unpaired grad op recomputes its forward
  (ops/registry.py `_lower_vjp`); both draw identical dropout masks from
  the op's key.
* State stays resident in the scope: the optimizer updates parameters
  and moments in place (ops/optimizer_ops.py), the analog of the
  reference's buffer donation; other persistable outputs are written back.
* AMP: with `program._amp` set (fleet's strategy.amp), white-list ops see
  their floating inputs cast to bfloat16 and black-list ops to float32;
  a grad op takes the policy of the op it differentiates.
* Fetches come back as numpy arrays (bfloat16 as float32) unless
  `return_numpy=False`, which returns the device tensors.

Not ported (ROADMAP): `run_steps`, `stage`, prefetch, the microbatch
runner, the shard_map manual-dp branch, `FetchHandle` lazy fetches.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from . import errors
from .program import Program, Variable, default_main_program
from .scope import Scope, global_scope, to_numpy
from ..device import resolve_device
from ..observability import metrics as _metrics
from ..ops import registry


def _attrs_key(attrs) -> str:
    return repr(sorted(attrs.items()))


def _grad_plan(block) -> Dict[int, int]:
    """{forward op index: index of the __vjp__ op differentiating it}.
    A grad op pairs with the latest unpaired forward op of the same type,
    input names and attrs."""
    pending, plan = {}, {}
    for idx, op in enumerate(block.ops):
        if op.type == "__vjp__":
            a = op.attrs
            fwd_ins = {s: op.inputs.get(s, []) for s in a["fwd_input_slots"]}
            key = (a["fwd_type"], repr(sorted(fwd_ins.items())),
                   _attrs_key(a["fwd_attrs"]))
            cands = pending.get(key)
            if cands:
                plan[cands.pop()] = idx
        elif registry.has(op.type) \
                and not registry.get(op.type).stateful_outputs:
            key = (op.type, repr(sorted(op.inputs.items())),
                   _attrs_key(op.attrs))
            pending.setdefault(key, []).append(idx)
    return plan


def _amp_cast(op, ins, low_dtype):
    """White-list ops run in the low dtype, black-list ops in f32; grad
    ops re-derive the policy from their forward type."""
    from ..amp.auto_cast import black_list, keep_f32_slots, white_list
    op_type = op.attrs.get("fwd_type", op.type) if op.type == "__vjp__" \
        else op.type
    if op_type in white_list:
        target = low_dtype
    elif op_type in black_list:
        target = torch.float32
    else:
        return ins
    skip = keep_f32_slots.get(op_type, ())
    out = {}
    for slot, vals in ins.items():
        # grad ops see forward slots plus OG:<slot> cotangents
        base_slot = slot[3:] if slot.startswith(("OG:", "IG:")) else slot
        if base_slot in skip:
            out[slot] = vals
            continue
        out[slot] = [v.to(target) if (v is not None and v.is_floating_point()
                                      and v.dtype != target) else v
                     for v in vals]
    return out


def _coerce_feed_value(block, name, value, device):
    """Feed -> tensor on `device` in the var's declared dtype; 64-bit ints
    live as int32 on the device, with a range check instead of a silent
    wrap."""
    t = value if isinstance(value, torch.Tensor) \
        else torch.as_tensor(np.asarray(value))
    v = block.find_var_recursive(name)
    if v is not None:
        want = v.dtype
        if want == torch.int64:
            info = torch.iinfo(torch.int32)
            if t.numel() and (int(t.max()) > info.max
                              or int(t.min()) < info.min):
                raise errors.InvalidArgument(
                    "feed %r holds int64 ids outside int32 range; device "
                    "tensors are 32-bit (framework/dtype.py)", name)
            want = torch.int32
        if t.dtype != want:
            t = t.to(want)
    return t.to(device)


def _next_run_seed(scope: Scope, seed: int) -> int:
    """A fresh run seed per run, from the program's seed and a counter kept
    in the scope (the reference splits a jax key kept there)."""
    ctr = scope.find("__rng_state__") or 0
    scope.set("__rng_state__", ctr + 1)
    return (int(seed or 0) << 32) + ctr


class Executor:
    """fluid.Executor on one device. `place` is a device spec ("cuda",
    "cpu", a torch.device); None means `cuda`."""

    def __init__(self, place=None):
        self.device = resolve_device(place)
        self._plans: Dict[tuple, Dict[int, int]] = {}

    def _plan(self, program: Program, use_cache: bool) -> Dict[int, int]:
        key = (program._uid, program._version)
        plan = self._plans.get(key) if use_cache else None
        if plan is None:
            plan = _grad_plan(program.global_block())
            if use_cache:
                self._plans[key] = plan
        return plan

    def run(self, program: Optional[Program] = None,
            feed: Optional[dict] = None, fetch_list: Optional[list] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True,
            use_program_cache: bool = True):
        """Run the program's global block once; returns the fetches."""
        program = program or default_main_program()
        feed = feed or {}
        scope = scope or global_scope()
        block = program.global_block()
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        for n in fetch_names:
            if not block.has_var(n):
                raise errors.NotFound(
                    "fetch target %r is not a variable of this program", n,
                    var=n)
        env = {name: _coerce_feed_value(block, name, value, self.device)
               for name, value in feed.items()}
        ctx = registry.LowerCtx(
            run_seed=_next_run_seed(scope, program.random_seed),
            device=self.device)
        amp_dtype = (torch.bfloat16
                     if getattr(program, "_amp_dtype", "bfloat16")
                     == "bfloat16" else torch.float16) \
            if getattr(program, "_amp", False) else None
        t0 = time.perf_counter()
        _run_block(block, self._plan(program, use_program_cache), env, scope,
                   ctx, amp_dtype)
        _metrics.observe("executor.step_host_ms",
                         (time.perf_counter() - t0) * 1000.0)
        fetches = []
        for n in fetch_names:
            val = env[n] if n in env else scope.find(n)
            if val is None:
                raise errors.NotFound("fetch target %r was not computed", n,
                                      var=n)
            fetches.append(val)
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return fetches


def _run_block(block, plan, env, scope, ctx, amp_dtype):
    """Apply each op's lowering in order over `env` (feeds and
    temporaries; persistable values live in the scope)."""
    saved = {}     # __vjp__ op index -> (pullback, forward outputs)

    def lookup(n, op):
        if n == "@EMPTY@":
            return None
        v = env.get(n)
        if v is None:
            v = scope.find(n)
            if v is None:
                raise errors.NotFound(
                    "input %r of op %s has no value: feed it or run the "
                    "startup program first", n, op.type, op=op.type, var=n)
        return v

    for idx, op in enumerate(block.ops):
        opdef = registry.get(op.type)
        if idx in saved:
            # paired grad op: only its cotangents are needed
            ins = {s: [lookup(n, op) for n in names]
                   for s, names in op.inputs.items() if s.startswith("OG:")}
        else:
            ins = {s: [lookup(n, op) for n in names]
                   for s, names in op.inputs.items()}
        if amp_dtype is not None:
            ins = _amp_cast(op, ins, amp_dtype)
        if idx in plan:
            vop = block.ops[plan[idx]]
            diff = [tuple(e) for e in vop.attrs["diff_entries"]]
            outs, pullback = registry.forward_vjp(
                opdef, ctx, ins, op.attrs, diff,
                vop.attrs["fwd_output_slots"])
            saved[plan[idx]] = (pullback, outs)
        elif idx in saved:
            pullback, fwd_outs = saved.pop(idx)
            a = op.attrs
            cts = registry.cotangents(ins, a["fwd_output_slots"],
                                      a["fwd_output_counts"], fwd_outs)
            outs = registry.grads_by_slot(
                [tuple(e) for e in a["diff_entries"]], pullback(cts),
                a["fwd_input_slots"])
        else:
            outs = opdef.lower(ctx, ins, op.attrs)
        for slot, names in op.outputs.items():
            for n, v in zip(names, outs.get(slot, ())):
                if n == "@EMPTY@" or v is None:
                    continue
                var = block.find_var_recursive(n)
                if var is not None and var.persistable:
                    scope.set(n, v)
                else:
                    env[n] = v
