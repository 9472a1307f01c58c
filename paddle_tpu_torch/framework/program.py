"""Program IR: the static-graph representation (counterpart of
paddle_tpu/framework/program.py:27-506).

Variable / Parameter / Operator / Block / Program with the reference's
JSON-serialisable desc form (`to_desc` / `from_desc`), so a program built
in either package can be compared with, or handed to, the other. The
Executor (framework/executor.py) runs a block op by op on one device.

Not ported: sub-blocks (control flow), `clone`, the Variable operator
sugar (`a + b` building ops), `device_guard` (pipeline stages) and the
dygraph switches.
"""
from __future__ import annotations

import contextlib
import itertools
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from . import unique_name
from .dtype import convert_dtype, dtype_name


class OpRole:
    """Op role markers (distributed/AMP transforms classify ops by them)."""
    Forward = 0
    Backward = 1
    Optimize = 2
    RPC = 3
    Dist = 4
    LRSched = 16
    Loss = 256


class Variable:
    """A named tensor slot in a Block: static metadata only; values live in
    a Scope at run time. `shape` may hold -1 for batch-polymorphic dims."""

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 persistable=False, stop_gradient=False, trainable=True,
                 is_data=False, type="lod_tensor", initializer=None):
        self.block = block
        self.name = name or unique_name.generate("_generated_var")
        self.shape = tuple(shape) if shape is not None else ()
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.trainable = trainable
        self.is_data = is_data
        self.type = type
        self.initializer = initializer

    def to_desc(self):
        return {
            "name": self.name,
            "shape": list(self.shape),
            "dtype": dtype_name(self.dtype),
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "trainable": self.trainable,
            "is_data": self.is_data,
            "type": self.type,
        }

    def __repr__(self):
        return (f"Var(name={self.name}, shape={self.shape}, "
                f"dtype={dtype_name(self.dtype)}, "
                f"persistable={self.persistable})")


class Parameter(Variable):
    """Persistable trainable variable."""

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 trainable=True, regularizer=None, initializer=None,
                 is_distributed=False, **kw):
        super().__init__(block, name=name, shape=shape, dtype=dtype,
                         persistable=True, stop_gradient=not trainable,
                         trainable=trainable, initializer=initializer, **kw)
        self.regularizer = regularizer
        self.is_distributed = is_distributed
        self.optimize_attrs = {"learning_rate": 1.0}


class Operator:
    """One op node: type + named input/output slots (slot -> list of var
    names) + attrs."""

    def __init__(self, block, type: str, inputs: Dict[str, List[str]],
                 outputs: Dict[str, List[str]], attrs: Optional[dict] = None):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in inputs.items()}
        self.outputs = {k: list(v) for k, v in outputs.items()}
        self.attrs = dict(attrs or {})
        self.attrs.setdefault("op_role", OpRole.Forward)

    def input_names(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    def to_desc(self):
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs,
                "attrs": _jsonable_attrs(self.attrs)}

    def __repr__(self):
        return f"Op({self.type}: {self.inputs} -> {self.outputs})"


def _jsonable_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, np.generic):
            out[k] = v.item()
        else:
            out[k] = v
    return out


class Block:
    """Ordered list of ops + var table."""

    def __init__(self, program, idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: "OrderedDict[str, Variable]" = OrderedDict()
        self.ops: List[Operator] = []

    @property
    def parent_block(self):
        return (None if self.parent_idx < 0
                else self.program.blocks[self.parent_idx])

    def create_var(self, **kw) -> Variable:
        v = Variable(self, **kw)
        self.vars[v.name] = v
        return v

    def create_parameter(self, **kw) -> Parameter:
        p = Parameter(self, **kw)
        # parameters always live in the global block
        gb = self.program.global_block()
        gb.vars[p.name] = p
        p.block = gb
        return p

    def var(self, name: str) -> Variable:
        v = self.find_var_recursive(name)
        if v is None:
            raise ValueError(f"Variable {name!r} not found in block "
                             f"{self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return self.find_var_recursive(name) is not None

    def find_var_recursive(self, name: str) -> Optional[Variable]:
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        return None

    def append_op(self, type: str, inputs=None, outputs=None,
                  attrs=None) -> Operator:
        op = Operator(self, type, _normalize_slots(inputs),
                      _normalize_slots(outputs), attrs)
        self.ops.append(op)
        from ..ops import registry
        registry.infer_op(self, op)  # build-time shape/dtype inference
        return op

    def _insert_op(self, index: int, type: str, inputs=None, outputs=None,
                   attrs=None) -> Operator:
        op = Operator(self, type, _normalize_slots(inputs),
                      _normalize_slots(outputs), attrs)
        self.ops.insert(index, op)
        from ..ops import registry
        registry.infer_op(self, op)
        return op

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def to_desc(self):
        return {"idx": self.idx, "parent_idx": self.parent_idx,
                "vars": [v.to_desc() for v in self.vars.values()],
                "ops": [op.to_desc() for op in self.ops]}


def _normalize_slots(slots):
    """Accept {'X': var | 'name' | [vars/names]} and normalise to name
    lists."""
    out = {}
    for k, v in (slots or {}).items():
        if v is None:
            continue
        if not isinstance(v, (list, tuple)):
            v = [v]
        out[k] = [x.name if isinstance(x, Variable) else x for x in v]
    return out


class Program:
    """A whole computation: a list of Blocks. `version` increments on every
    structural mutation, so cached run plans are never stale."""

    _uid_counter = itertools.count()

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0
        self._uid = next(Program._uid_counter)

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def all_parameters(self) -> List[Parameter]:
        return self.global_block().all_parameters()

    def bump_version(self):
        self._version += 1

    def to_desc(self):
        return {"blocks": [b.to_desc() for b in self.blocks],
                "random_seed": self.random_seed}

    @staticmethod
    def from_desc(desc) -> "Program":
        p = Program()
        p.random_seed = desc.get("random_seed", 0)
        p.blocks = []
        for bd in desc["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                v = Variable(b, name=vd["name"], shape=vd["shape"],
                             dtype=vd["dtype"],
                             persistable=vd["persistable"],
                             stop_gradient=vd["stop_gradient"],
                             is_data=vd.get("is_data", False),
                             type=vd.get("type", "lod_tensor"))
                v.trainable = vd.get("trainable", True)
                if vd["persistable"] and vd.get("trainable", True) \
                        and not vd.get("is_data"):
                    # restore Parameter-ness for optimizer re-use
                    v.__class__ = Parameter
                    v.regularizer = None
                    v.is_distributed = False
                    v.optimize_attrs = {"learning_rate": 1.0}
                b.vars[v.name] = v
            for od in bd["ops"]:
                attrs = {}
                for k, val in od["attrs"].items():
                    if isinstance(val, dict) and "__ndarray__" in val:
                        attrs[k] = np.array(val["__ndarray__"],
                                            dtype=val["dtype"])
                    else:
                        attrs[k] = val
                b.ops.append(Operator(b, od["type"], od["inputs"],
                                      od["outputs"], attrs))
            p.blocks.append(b)
        return p


def grad_var_name(name: str) -> str:
    return name + "@GRAD"


# ---------------------------------------------------------------------------
# Default programs and program_guard
# ---------------------------------------------------------------------------
_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, p
    return old


def switch_startup_program(p: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, p
    return old


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)
