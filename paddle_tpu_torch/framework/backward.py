"""append_backward: graph-level reverse-mode autodiff on the Program IR
(counterpart of paddle_tpu/framework/backward.py).

Each forward op's gradient is one generic `__vjp__` op whose lowering is
torch.func.vjp over the forward lowering (ops/registry.py). Gradients of a
var with several consumers accumulate by rename + `sum`, as in the
reference. An `is_sparse` lookup's table gets a
`lookup_table_sparse_grad` op instead (ops/sparse_grad.py), whose
gradient var is marked `_is_selected_rows`; a `sum` of such gradients
alone stays one. Not ported: `gradients()`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from .dtype import is_floating
from .program import OpRole, Parameter, Variable, grad_var_name
from ..ops import registry


def _forward_closure(block, seed_names: Set[str], no_grad: Set[str]) -> Set[str]:
    """Vars computationally downstream of the seeds."""
    reach = set(seed_names)
    for op in block.ops:
        if registry.has(op.type) and _op_nondiff(op):
            continue
        if set(op.input_names()) & reach:
            opdef = registry.get(op.type) if registry.has(op.type) else None
            for slot, names in op.outputs.items():
                if opdef and slot in opdef.stateful_outputs:
                    continue
                reach.update(n for n in names if n not in no_grad)
    return reach


def _backward_closure(block, target: str) -> Set[str]:
    """Vars the target depends on."""
    need = {target}
    for op in reversed(block.ops):
        if set(op.output_names()) & need:
            need.update(op.input_names())
    return need


def _op_nondiff(op) -> bool:
    return op.attrs.get("op_role", 0) in (OpRole.Optimize,)


class _GradAccumulator:
    """Grad contributions per var; a `sum` op merges several producers."""

    def __init__(self, block):
        self.block = block
        self.contribs: Dict[str, List[str]] = {}
        # names produced by earlier append_backward calls are taken
        self._taken = set()
        for op in block.ops:
            self._taken.update(n for n in op.output_names() if n != "@EMPTY@")

    def _base_name(self, var_name: str) -> str:
        gname = grad_var_name(var_name)
        k = 2
        while gname in self._taken:
            gname = f"{grad_var_name(var_name)}@{k}"
            k += 1
        return gname

    def add(self, var_name: str) -> str:
        lst = self.contribs.setdefault(var_name, [])
        gname = self._base_name(var_name)
        name = gname if not lst else f"{gname}@RENAME@{len(lst)}"
        lst.append(name)
        fwd = self.block.var(var_name)
        self.block.create_var(name=name, shape=fwd.shape, dtype=fwd.dtype,
                              stop_gradient=False)
        return name

    def finalize(self, var_name: str) -> Optional[str]:
        lst = self.contribs.get(var_name)
        if not lst:
            return None
        if len(lst) == 1:
            return lst[0]
        gname = self._base_name(var_name)
        sum_out = gname if lst[0] != gname else f"{gname}@MERGED"
        fwd = self.block.var(var_name)
        out_var = self.block.create_var(name=sum_out, shape=fwd.shape,
                                        dtype=fwd.dtype, stop_gradient=False)
        self.block.append_op("sum", inputs={"X": list(lst)},
                             outputs={"Out": [sum_out]},
                             attrs={"op_role": OpRole.Backward})
        if all(getattr(self.block.var(n), "_is_selected_rows", False)
               for n in lst):
            out_var._is_selected_rows = True
        self.contribs[var_name] = [sum_out]
        return sum_out


def append_backward(loss: Variable, parameter_list=None,
                    no_grad_set: Optional[Set[str]] = None, callbacks=None):
    """Append backward ops computing d(loss)/d(param) for every trainable
    parameter. Returns [(param, grad_var)]."""
    block = loss.block
    program = block.program
    no_grad = set(no_grad_set or ())
    for v in block.vars.values():
        if v.stop_gradient and not isinstance(v, Parameter):
            no_grad.add(v.name)

    if parameter_list:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in program.all_parameters() if p.trainable]
    param_names = {p.name for p in params}

    relevant = (_forward_closure(block, param_names, no_grad)
                & _backward_closure(block, loss.name))
    relevant |= param_names

    acc = _GradAccumulator(block)
    loss_grad = acc._base_name(loss.name)
    block.create_var(name=loss_grad, shape=loss.shape, dtype=loss.dtype,
                     stop_gradient=True)
    block.append_op("fill_constant", inputs={},
                    outputs={"Out": [loss_grad]},
                    attrs={"shape": list(loss.shape) or [],
                           "dtype": "float32", "value": 1.0,
                           "op_role": OpRole.Backward | OpRole.Loss})
    acc.contribs[loss.name] = [loss_grad]

    fwd_ops = [op for op in block.ops
               if op.attrs.get("op_role", 0) & OpRole.Optimize == 0
               and not (op.attrs.get("op_role", 0) & OpRole.Loss)]

    for op in reversed(fwd_ops):
        if not registry.has(op.type):
            continue
        opdef = registry.get(op.type)
        out_slots = [s for s in op.outputs if s not in opdef.stateful_outputs]
        if not any(acc.contribs.get(n) for s in out_slots
                   for n in op.outputs[s]):
            continue
        diff_entries = []
        for slot, names in op.inputs.items():
            if slot in opdef.nondiff_slots:
                continue
            for i, n in enumerate(names):
                v = block.find_var_recursive(n)
                if v is None or not is_floating(v.dtype) or n in no_grad:
                    continue
                if n in relevant:
                    diff_entries.append((slot, i))
        if not diff_entries:
            continue

        # ops that overwrite their own inputs: snapshot the pre-op values
        out_names = {n for ns in op.outputs.values() for n in ns
                     if n != "@EMPTY@"}
        overlap = {n for ns in op.inputs.values() for n in ns
                   if n != "@EMPTY@" and n in out_names}
        snap = {}
        if overlap:
            pos = block.ops.index(op)
            for n in sorted(overlap):
                sname = f"{n}@PRE"
                while block.find_var_recursive(sname) is not None:
                    sname += "_"
                fv = block.var(n)
                block.create_var(name=sname, shape=fv.shape, dtype=fv.dtype,
                                 stop_gradient=True)
                block._insert_op(pos, "assign", inputs={"X": [n]},
                                 outputs={"Out": [sname]})
                snap[n] = sname
                pos += 1

        grad_inputs = {slot: [snap.get(n, n) for n in names]
                       for slot, names in op.inputs.items()}
        for slot in out_slots:
            og_names = []
            for n in op.outputs[slot]:
                g = acc.finalize(n)
                og_names.append(g if g is not None else "@EMPTY@")
            grad_inputs[f"OG:{slot}"] = og_names

        grad_outputs = {}
        for slot, names in op.inputs.items():
            ig, slot_has = [], False
            for i, n in enumerate(names):
                if (slot, i) in diff_entries:
                    ig.append(acc.add(n))
                    slot_has = True
                else:
                    ig.append("@EMPTY@")
            if slot_has:
                grad_outputs[f"IG:{slot}"] = ig

        if op.type in ("lookup_table", "lookup_table_v2") \
                and op.attrs.get("is_sparse", False) \
                and list(grad_outputs) == ["IG:W"]:
            # the table's rows that were looked up (reference :231-243)
            block.append_op(
                "lookup_table_sparse_grad", inputs=grad_inputs,
                outputs=grad_outputs,
                attrs={"padding_idx": op.attrs.get("padding_idx", -1),
                       "op_role": OpRole.Backward})
            block.var(grad_outputs["IG:W"][0])._is_selected_rows = True
            continue
        block.append_op("__vjp__", inputs=grad_inputs, outputs=grad_outputs,
                        attrs=registry.make_vjp_attrs(op, diff_entries,
                                                      out_slots))

    params_and_grads = []
    for p in params:
        g = acc.finalize(p.name)
        if g is not None:
            params_and_grads.append((p, block.var(g)))
    return params_and_grads
