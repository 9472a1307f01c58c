"""Control-flow layers and the lowerings of their sub-block ops
(counterpart of paddle_tpu/layers/control_flow.py).

Builders: `cond`, `While` (with `bound`), `while_loop`, the LoDTensorArray
functions (`create_array`, `array_write`, `array_read`, `array_length`),
`StaticRNN`, `Switch`, the rank-table family (lowerings in
ops/lod_ops.py) and `DynamicRNN`; `increment` lives in layers/tensor.py.
They build the reference's ops, attrs and block structure, so a program
built in either package has the same desc.

Lowerings. A sub-block op runs its block with the executor's
`run_sub_block` (framework/executor.py) over an env of its `Free`,
`Carried`, `X` and `Init` values; every write stays in that env.

* `__while__` with `trip_bound` > 0 (DynamicRNN sets the padded length)
  runs exactly `bound` iterations and keeps the old carry where the
  predicate is false (`torch.where`): it reads nothing on the host, so a
  CUDA graph can capture it and torch.func.vjp differentiates it. With
  bound 0 it reads the predicate on the host each iteration (one sync an
  iteration); such a program cannot be captured, and it has no gradient:
  its grad op raises `UnimplementedError`, as the reference's
  `lax.while_loop` has no reverse rule.
* `__cond__` / `__switch__` read their predicates on the host and run the
  taken branch only; under capture (`LowerCtx.capturing`) they run every
  branch and select the outputs with `torch.where`. The forward values
  are the taken branch's, and so is the gradient: a branch's inputs are
  cut from the gradient (a `where` with their detached copies) unless it
  is the branch taken, so a branch not taken adds nothing, not even the
  NaN of a zero cotangent times an infinite local derivative.
* `__scan__` (StaticRNN) runs its block once a step over the leading
  axis of its inputs.
* Arrays are `(buffer or None, length)` pairs: a `capacity`-slot buffer
  made on the first write (or by `create_array(element_shape=)`), grown
  when a build-time index outgrows it. A write at an index past the
  capacity is dropped and a read past the end is clamped, as the
  reference's scatter (`mode="drop"`) and `dynamic_index_in_dim` do: the
  write goes through a clamped index under a `where` on the index being
  in range (an out-of-range `index_copy` on CUDA is a device-side
  assert, not an exception). `array_length` reports the high-water
  index.
* Every iteration of a loop body sees the same `LowerCtx`, so a random op
  inside it draws the same mask each iteration, as the reference hands
  every iteration the same key.
"""
from __future__ import annotations

import contextlib

import torch

from ..framework import errors
from ..framework.dtype import device_dtype, dtype_name
from ..layer_helper import LayerHelper
from ..ops.registry import func_vjp, register
from .tensor import increment

__all__ = ["cond", "increment", "array_write", "array_read", "array_length",
           "create_array", "While", "while_loop", "StaticRNN", "Switch",
           "lod_rank_table", "max_sequence_len", "lod_tensor_to_array",
           "array_to_lod_tensor", "shrink_memory", "split_lod_tensor",
           "merge_lod_tensor", "reorder_lod_tensor_by_rank",
           "tensor_array_to_tensor", "DynamicRNN"]


# ---------------------------------------------------------------------------
# shared sub-block read/write analysis
# ---------------------------------------------------------------------------

def _outer_reads_writes(block):
    """Names read from / written to enclosing blocks by `block`'s ops: a
    name not in `block.vars` touches the outer scope."""
    reads, writes = [], []
    rset, wset = set(), set()
    for op in block.ops:
        for n in op.input_names():
            if n != "@EMPTY@" and n not in block.vars and n not in rset:
                reads.append(n)
                rset.add(n)
        for n in op.output_names():
            if n != "@EMPTY@" and n not in block.vars and n not in wset:
                writes.append(n)
                wset.add(n)
    return reads, writes


def _noop_infer(block, op):
    return None


def _sub_block(attr_idx):
    from ..framework.executor import _current_lowering_program
    return _current_lowering_program().blocks[int(attr_idx)]


def _run(block, env, out_names, ctx):
    from ..framework.executor import run_sub_block
    return run_sub_block(block, env, out_names, ctx)


def _host_true(pred) -> bool:
    """A predicate read on the host (one sync on CUDA)."""
    return bool(pred.reshape(()).item())


def _select(pred, a, b):
    """`a` where the [] / [1] bool `pred` holds, else `b`: tensors, arrays
    (buffer and length apart) and None alike."""
    if isinstance(a, tuple):
        return tuple(_select(pred, x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a if b is None else b
    return torch.where(pred.reshape(()).to(torch.bool), a, b)


def _grad_where(taken, v):
    """`v` (a tensor, or a pair of them) with its gradient cut unless the
    [] bool `taken` holds: the same values, a `where` between `v` and its
    detached copy."""
    if isinstance(v, tuple):
        parts = [_grad_where(taken, x) for x in v]
        return type(v)(*parts) if hasattr(v, "_fields") else tuple(parts)
    if not isinstance(v, torch.Tensor) or not v.is_floating_point():
        return v
    return torch.where(taken, v, v.detach())


def _taken_only(taken, env):
    """A branch's env under capture: its inputs' gradients flow only where
    it is the branch taken. The selected outputs give a branch not taken
    a zero cotangent, and zero times an infinite local derivative (a
    division by zero there) would be NaN; so its inputs are cut from the
    gradient instead, and the captured step's gradient is the eager
    one's."""
    return {n: _grad_where(taken, v) for n, v in env.items()}


# ---------------------------------------------------------------------------
# cond
# ---------------------------------------------------------------------------

def cond(pred, true_fn=None, false_fn=None, name=None):
    """paddle.static.nn.cond: both branches captured as sub-blocks, one
    `__cond__` op. Branch outputs must match in shape and dtype."""
    helper = LayerHelper("cond")
    program = helper.main_program
    parent = program.current_block()

    true_block = program.create_block()
    true_out = true_fn() if true_fn is not None else None
    program.rollback()
    false_block = program.create_block()
    false_out = false_fn() if false_fn is not None else None
    program.rollback()

    t_outs = true_out if isinstance(true_out, (list, tuple)) else [true_out]
    f_outs = false_out if isinstance(false_out, (list, tuple)) else [false_out]
    assert len(t_outs) == len(f_outs), "cond branches must match arity"

    t_free, _ = _outer_reads_writes(true_block)
    f_free, _ = _outer_reads_writes(false_block)
    all_free = sorted(set(t_free) | set(f_free))

    outs = [helper.create_variable_for_type_inference(v.dtype)
            for v in t_outs]
    for o, tv in zip(outs, t_outs):
        o.shape = tuple(tv.shape)
    parent.append_op(
        "__cond__",
        inputs={"Cond": [pred], "Free": all_free},
        outputs={"Out": [o.name for o in outs]},
        attrs={"true_block": true_block.idx, "false_block": false_block.idx,
               "true_outs": [v.name for v in t_outs],
               "false_outs": [v.name for v in f_outs],
               "free_names": all_free})
    return outs[0] if len(outs) == 1 else outs


@register("__cond__", infer=_noop_infer)
def _lower_cond(ctx, ins, attrs):
    pred = ins["Cond"][0]
    env = dict(zip(attrs["free_names"], ins["Free"]))
    tb, fb = _sub_block(attrs["true_block"]), _sub_block(attrs["false_block"])
    if ctx.capturing:
        p = pred.reshape(()).to(torch.bool)
        t = _run(tb, _taken_only(p, env), attrs["true_outs"], ctx)
        f = _run(fb, _taken_only(~p, env), attrs["false_outs"], ctx)
        return {"Out": [_select(pred, a, b) for a, b in zip(t, f)]}
    if _host_true(pred):
        return {"Out": _run(tb, env, attrs["true_outs"], ctx)}
    return {"Out": _run(fb, env, attrs["false_outs"], ctx)}


# ---------------------------------------------------------------------------
# While / while_loop
# ---------------------------------------------------------------------------

class While:
    """fluid.layers.While (reference control_flow.py:153). Usage:

        i = layers.fill_constant([1], "int32", 0)
        n = layers.fill_constant([1], "int32", 10)
        flag = layers.less_than(i, n)
        w = While(flag)
        with w.block():
            ... ops reading/writing outer vars ...
            layers.increment(i)
            layers.less_than(i, n, cond=flag)   # update the loop predicate

    Every outer variable written in the block is loop-carried state of one
    `__while__` op; reads of untouched outer vars close over their pre-loop
    values. `bound` (a static trip-count bound) makes the loop a masked run
    of `bound` iterations: capturable and differentiable.
    """

    def __init__(self, cond, is_test=False, name=None, bound=None):
        self.cond_var = cond
        self.helper = LayerHelper("while")
        self.bound = bound

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent = program.current_block()
        sub = program.create_block()
        try:
            yield
        finally:
            program.rollback()
        reads, writes = _outer_reads_writes(sub)
        carried = list(writes)
        if self.cond_var.name not in carried:
            carried.insert(0, self.cond_var.name)
        free = [n for n in reads if n not in set(carried)]
        parent.append_op(
            "__while__",
            inputs={"Cond": [self.cond_var], "Carried": carried,
                    "Free": free},
            outputs={"Out": carried},
            attrs={"sub_block": sub.idx, "carried_names": carried,
                   "free_names": free, "cond_name": self.cond_var.name,
                   "trip_bound": int(self.bound) if self.bound else 0})


def _while_vjp(ctx, ins, attrs, diff, out_slots):
    if not int(attrs.get("trip_bound", 0) or 0):
        raise errors.Unimplemented(
            "an unbounded While has no gradient (the reference's "
            "lax.while_loop has no reverse rule): give the loop a static "
            "bound (While(..., bound=N), as DynamicRNN does) or use "
            "StaticRNN on the training path", op="__while__")
    return func_vjp(_lower_while, ctx, ins, attrs, diff, out_slots)


@register("__while__", infer=_noop_infer, vjp=_while_vjp)
def _lower_while(ctx, ins, attrs):
    sub = _sub_block(attrs["sub_block"])
    carried_names = attrs["carried_names"]
    cond_idx = carried_names.index(attrs["cond_name"])
    free = dict(zip(attrs["free_names"], ins["Free"]))
    for name, val in zip(carried_names, ins["Carried"]):
        if isinstance(val, tuple) and val[0] is None:
            raise ValueError(
                f"TensorArray {name!r} enters a While loop un-materialized: "
                "its buffer shape is unknown, which a loop carry cannot "
                "represent. Either array_write once before the loop or pass "
                "element_shape= to create_array.")
    carry = list(ins["Carried"])

    def body(carry):
        env = dict(free)
        env.update(zip(carried_names, carry))
        return _run(sub, env, carried_names, ctx)

    bound = int(attrs.get("trip_bound", 0) or 0)
    if bound > 0:
        # exactly `bound` iterations, the old carry kept where the
        # predicate is false: the while loop whenever its trip count is at
        # most `bound`, with no host read
        for _ in range(bound):
            pred = carry[cond_idx]
            carry = [_select(pred, n, o) for n, o in zip(body(carry), carry)]
    else:
        while _host_true(carry[cond_idx]):
            carry = body(carry)
    return {"Out": carry}


def while_loop(cond, body, loop_vars, is_test=False, name=None):
    """Functional while (reference fluid.layers.while_loop): `cond` and
    `body` are Python callables over Variables; one `__while__` op."""
    from . import tensor as tensor_layers
    if not isinstance(loop_vars, (list, tuple)) or not loop_vars:
        raise TypeError("loop_vars must be a non-empty list")
    loop_vars = list(loop_vars)
    pred = cond(*loop_vars)
    w = While(pred)
    with w.block():
        new_vars = body(*loop_vars)
        if not isinstance(new_vars, (list, tuple)):
            new_vars = [new_vars]
        assert len(new_vars) == len(loop_vars), \
            "body must return as many values as loop_vars"
        for old, new in zip(loop_vars, new_vars):
            if new is not old:
                tensor_layers.assign(new, old)
        new_pred = cond(*loop_vars)
        tensor_layers.assign(new_pred, pred)
    return loop_vars


# ---------------------------------------------------------------------------
# LoDTensorArray
# ---------------------------------------------------------------------------

_DEFAULT_ARRAY_CAPACITY = 128


def create_array(dtype, initialized_list=None, capacity=_DEFAULT_ARRAY_CAPACITY,
                 element_shape=None):
    """fluid.layers.create_array. With `element_shape` the
    `capacity`-slot buffer is made at once (needed when the first write
    is inside a While); otherwise on the first `array_write`."""
    helper = LayerHelper("create_array")
    arr = helper.main_program.current_block().create_var(
        dtype=dtype, type="lod_tensor_array")
    arr._array_capacity = int(capacity)
    helper.append_op("create_array", outputs={"Out": [arr]},
                     attrs={"dtype": dtype_name(arr.dtype),
                            "capacity": int(capacity),
                            "element_shape":
                                (None if element_shape is None
                                 else [int(s) for s in element_shape])})
    if initialized_list:
        from . import tensor as tensor_layers
        for k, v in enumerate(initialized_list):
            i = tensor_layers.fill_constant([1], "int32", k)
            array_write(v, i, array=arr)
    return arr


def _zero_length(device):
    return torch.zeros((), dtype=torch.int32, device=device)


@register("create_array", infer=_noop_infer)
def _lower_create_array(ctx, ins, attrs):
    shape = attrs.get("element_shape")
    if shape is not None:
        buf = torch.zeros((int(attrs["capacity"]),) + tuple(shape),
                          dtype=device_dtype(attrs.get("dtype", "float32")),
                          device=ctx.device)
        return {"Out": [(buf, _zero_length(ctx.device))]}
    return {"Out": [(None, _zero_length(ctx.device))]}


def array_write(x, i, array=None, capacity=None):
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(dtype_name(x.dtype),
                             capacity=capacity or _DEFAULT_ARRAY_CAPACITY)
    cap = capacity or getattr(array, "_array_capacity",
                              _DEFAULT_ARRAY_CAPACITY)
    # an index known at build time (a python int or a fill_constant)
    # grows the declared capacity, as the reference's growing
    # LoDTensorArray; data-dependent indices keep the bounded buffer
    static_i = i if isinstance(i, int) else getattr(i, "_const_value", None)
    if static_i is not None and int(static_i) >= cap:
        cap = max(2 * cap, int(static_i) + 1)
        array._array_capacity = cap
    helper.append_op("array_write",
                     inputs={"X": [x], "I": [i], "Array": [array]},
                     outputs={"Out": [array]},
                     attrs={"capacity": int(cap)})
    return array


def _slot(i, n):
    """A scalar index normalised as jnp does (negative from the end),
    clamped into [0, n) ([1] int64), and whether the clamp kept it."""
    i = i.reshape(1).to(torch.int64)
    j = torch.where(i < 0, i + n, i)
    at = j.clamp(0, n - 1)
    return at, at == j


@register("array_write", infer=_noop_infer)
def _lower_array_write(ctx, ins, attrs):
    x = ins["X"][0]
    i = ins["I"][0].reshape(()).to(torch.int32)
    arr = ins["Array"][0]
    buffer, length = (None, _zero_length(x.device)) if arr is None else arr
    want_cap = int(attrs.get("capacity", _DEFAULT_ARRAY_CAPACITY))
    if buffer is None:
        buffer = torch.zeros((want_cap,) + tuple(x.shape), dtype=x.dtype,
                             device=x.device)
    if want_cap > buffer.shape[0]:
        pad = buffer.new_zeros((want_cap - buffer.shape[0],)
                               + tuple(buffer.shape[1:]))
        buffer = torch.cat([buffer, pad], dim=0)
    at, ok = _slot(i, buffer.shape[0])
    old = buffer.index_select(0, at)
    row = torch.where(ok.reshape((1,) * buffer.dim()),
                      x.to(buffer.dtype).unsqueeze(0), old)
    buffer = buffer.index_copy(0, at, row)
    length = torch.maximum(length, i + 1)
    return {"Out": [(buffer, length)]}


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op("array_read", inputs={"Array": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


@register("array_read", infer=_noop_infer)
def _lower_array_read(ctx, ins, attrs):
    buffer, _ = ins["Array"][0]
    if buffer is None:
        raise ValueError("array_read from an empty LoDTensorArray; write at "
                         "least once before reading (buffers are bounded: "
                         "see the module docstring)")
    at, _ = _slot(ins["I"][0], buffer.shape[0])
    return {"Out": [buffer.index_select(0, at).squeeze(0)]}


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int32")
    out.shape = (1,)
    helper.append_op("array_length", inputs={"Array": [array]},
                     outputs={"Out": [out]})
    return out


@register("array_length", infer=_noop_infer)
def _lower_array_length(ctx, ins, attrs):
    arr = ins["Array"][0]
    length = _zero_length(ctx.device) if arr is None else arr[1]
    return {"Out": [length.reshape(1)]}


# ---------------------------------------------------------------------------
# StaticRNN
# ---------------------------------------------------------------------------

class StaticRNN:
    """Static sequence loop (reference control_flow.py:406). Inputs are
    time-major [seq_len, ...]; the step block is one `__scan__` op whose
    carry is the declared memories.

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)            # x: [seq, batch, d]
            h_prev = rnn.memory(init=h0)
            h = layers.fc(...) over (x_t, h_prev)
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()                            # [seq, batch, d]
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn")
        self._sub = None
        self._parent = None
        self._seq_len = None
        self._seq_inputs = []     # (outer_name, inner var)
        self._mems = []           # dict(pre=inner var, init=outer name, upd=None)
        self._outputs = []        # inner vars
        self._outer_outs = None

    @contextlib.contextmanager
    def step(self):
        program = self.helper.main_program
        self._parent = program.current_block()
        self._sub = program.create_block()
        try:
            yield
        finally:
            program.rollback()
            self._complete()

    def step_input(self, x):
        assert self._sub is not None, "step_input must be called inside step()"
        if self._seq_len is None:
            self._seq_len = x.shape[0]
        inner = self._sub.create_var(shape=tuple(x.shape[1:]), dtype=x.dtype)
        self._seq_inputs.append((x.name, inner))
        return inner

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=1, dtype="float32"):
        assert self._sub is not None, "memory must be called inside step()"
        if init is None:
            assert shape is not None and batch_ref is not None, (
                "memory needs either init= or (shape=, batch_ref=)")
            ref_name = batch_ref.name
            for outer_name, inner in self._seq_inputs:
                if inner.name == ref_name:
                    # batch_ref is an in-block step input: the init op
                    # reads the outer [seq, ...] var, whose batch dim sits
                    # one axis later
                    ref_name = outer_name
                    ref_batch_dim_idx = ref_batch_dim_idx + 1
                    break
            init_var = self._parent.create_var(
                shape=tuple(shape), dtype=dtype)
            self._parent.append_op(
                "fill_constant_batch_size_like",
                inputs={"Input": [ref_name]},
                outputs={"Out": [init_var.name]},
                attrs={"shape": [int(s) for s in shape],
                       "value": float(init_value),
                       "dtype": dtype_name(init_var.dtype),
                       "input_dim_idx": int(ref_batch_dim_idx),
                       "output_dim_idx": int(init_batch_dim_idx)})
            init = init_var
        pre = self._sub.create_var(shape=tuple(init.shape), dtype=init.dtype)
        self._mems.append({"pre": pre, "init": init.name, "upd": None})
        return pre

    def update_memory(self, mem, var):
        for m in self._mems:
            if m["pre"].name == mem.name:
                m["upd"] = var.name
                return
        raise ValueError(f"{mem.name} is not a memory of this StaticRNN")

    def step_output(self, o):
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete(self):
        assert self._outputs, "StaticRNN needs at least one step_output"
        for m in self._mems:
            assert m["upd"] is not None, (
                f"memory {m['pre'].name} was never update_memory()'d")
        reads, _ = _outer_reads_writes(self._sub)
        special = {n for n, _ in self._seq_inputs}
        special |= {m["init"] for m in self._mems}
        free = [n for n in reads if n not in special]
        outer_outs = []
        for o in self._outputs:
            ov = self._parent.create_var(
                shape=(self._seq_len,) + tuple(o.shape), dtype=o.dtype)
            outer_outs.append(ov)
        self._parent.append_op(
            "__scan__",
            inputs={"X": [n for n, _ in self._seq_inputs],
                    "Init": [m["init"] for m in self._mems],
                    "Free": free},
            outputs={"Out": [v.name for v in outer_outs]},
            attrs={"sub_block": self._sub.idx,
                   "x_names": [v.name for _, v in self._seq_inputs],
                   "mem_pre_names": [m["pre"].name for m in self._mems],
                   "mem_upd_names": [m["upd"] for m in self._mems],
                   "out_names": [o.name for o in self._outputs],
                   "free_names": free})
        self._outer_outs = outer_outs

    def __call__(self):
        outs = self._outer_outs
        return outs[0] if len(outs) == 1 else outs


@register("__scan__", infer=_noop_infer)
def _lower_scan(ctx, ins, attrs):
    sub = _sub_block(attrs["sub_block"])
    mem_upd, out_names = attrs["mem_upd_names"], attrs["out_names"]
    free = dict(zip(attrs["free_names"], ins["Free"]))
    xs = list(ins["X"])
    carry = list(ins["Init"])
    ys = []
    for t in range(xs[0].shape[0]):
        env = dict(free)
        env.update(zip(attrs["mem_pre_names"], carry))
        env.update(zip(attrs["x_names"], (x[t] for x in xs)))
        got = _run(sub, env, list(mem_upd) + list(out_names), ctx)
        carry = got[:len(mem_upd)]
        ys.append(got[len(mem_upd):])
    return {"Out": [torch.stack(list(step)) for step in zip(*ys)]}


# ---------------------------------------------------------------------------
# Switch
# ---------------------------------------------------------------------------

class Switch:
    """fluid.layers.Switch (used by LR schedulers): the first case whose
    condition holds runs; its writes to outer vars take effect.

        with Switch() as switch:
            with switch.case(cond1): layers.assign(a, lr)
            with switch.default():   layers.assign(b, lr)
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("switch")
        self._cases = []          # (cond_name or None, block)
        self._has_default = False

    def __enter__(self):
        return self

    @contextlib.contextmanager
    def case(self, condition):
        program = self.helper.main_program
        sub = program.create_block()
        try:
            yield
        finally:
            program.rollback()
        self._cases.append((condition.name, sub))

    @contextlib.contextmanager
    def default(self):
        program = self.helper.main_program
        sub = program.create_block()
        try:
            yield
        finally:
            program.rollback()
        self._cases.append((None, sub))
        self._has_default = True

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        program = self.helper.main_program
        parent = program.current_block()
        written, free = [], []
        wset, fset = set(), set()
        for _, blk in self._cases:
            r, w = _outer_reads_writes(blk)
            for n in w:
                if n not in wset:
                    written.append(n)
                    wset.add(n)
            for n in r:
                if n not in fset:
                    free.append(n)
                    fset.add(n)
        free = [n for n in free if n not in wset]
        cond_names = [c for c, _ in self._cases if c is not None]
        parent.append_op(
            "__switch__",
            inputs={"Conds": cond_names, "Carried": written, "Free": free},
            outputs={"Out": written},
            attrs={"case_blocks": [b.idx for _, b in self._cases],
                   "case_conds": [c for c, _ in self._cases],
                   "written_names": written, "free_names": free})
        return False


@register("__switch__", infer=_noop_infer)
def _lower_switch(ctx, ins, attrs):
    written = attrs["written_names"]
    free = dict(zip(attrs["free_names"], ins["Free"]))
    conds = dict(zip([c for c in attrs["case_conds"] if c is not None],
                     ins["Conds"]))
    carried = list(ins["Carried"])

    def run_case(block_idx, taken=None):
        env = dict(free)
        env.update(zip(written, carried))
        if taken is not None:
            env = _taken_only(taken, env)
        return _run(_sub_block(block_idx), env, written, ctx)

    cases = list(zip(attrs["case_conds"], attrs["case_blocks"]))
    if not ctx.capturing:
        for cname, bidx in cases:
            # the default is last by contract, and unconditional
            if cname is None or _host_true(conds[cname]):
                return {"Out": run_case(bidx)}
        return {"Out": carried}
    # every case, selected from the last to the first; a case's inputs
    # carry gradients only where it is the case taken (`_taken_only`)
    taken, rest = [], None          # rest: no earlier case holds
    for cname, _ in cases:
        c = None if cname is None else conds[cname].reshape(()).to(
            torch.bool)
        taken.append(c if rest is None else rest if c is None else rest & c)
        if c is not None:
            rest = ~c if rest is None else rest & ~c
    out = carried
    for (cname, bidx), mine in reversed(list(zip(cases, taken))):
        got = run_case(bidx, mine)
        out = got if cname is None else [
            _select(conds[cname], a, b) for a, b in zip(got, out)]
    return {"Out": out}


# ---------------------------------------------------------------------------
# LoD rank-table family (lowerings in ops/lod_ops.py)
# ---------------------------------------------------------------------------

def lod_rank_table(x, level=0, length=None):
    """Reference fluid.layers.lod_rank_table. Padded-dense sequences carry
    their lengths in an explicit `length=` Variable (the reference reads
    them from x's LoD level)."""
    if length is None:
        raise ValueError(
            "lod_rank_table needs length= (padded-dense sequences have no "
            "LoD metadata; pass the per-sequence length vector)")
    if level != 0:
        raise ValueError("only LoD level 0 is supported (one nesting level)")
    helper = LayerHelper("lod_rank_table")
    table = helper.create_variable_for_type_inference("int32")
    table.shape = (length.shape[0] if length.shape else -1, 2)
    helper.append_op("lod_rank_table",
                     inputs={"X": [x], "Length": [length]},
                     outputs={"Out": [table]})
    return table


def max_sequence_len(rank_table):
    helper = LayerHelper("max_sequence_len")
    out = helper.create_variable_for_type_inference("int32")
    out.shape = (1,)
    helper.append_op("max_sequence_len", inputs={"RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out


def lod_tensor_to_array(x, table):
    """Padded [B, T, ...] to a time-major TensorArray in rank
    (desc-length) order, dead rows zeroed."""
    helper = LayerHelper("lod_tensor_to_array")
    arr = helper.main_program.current_block().create_var(
        dtype=x.dtype, type="lod_tensor_array")
    arr._array_capacity = int(x.shape[1]) if len(x.shape) > 1 and \
        x.shape[1] and x.shape[1] > 0 else _DEFAULT_ARRAY_CAPACITY
    helper.append_op("lod_tensor_to_array",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [arr]})
    return arr


def array_to_lod_tensor(x, table, max_len=None):
    """Inverse of lod_tensor_to_array, back to the original order,
    zero-padded; `max_len` bounds the time dimension (default: the
    array's build-time capacity)."""
    helper = LayerHelper("array_to_lod_tensor")
    out = helper.create_variable_for_type_inference(x.dtype)
    cap = max_len or getattr(x, "_array_capacity", None)
    helper.append_op("array_to_lod_tensor",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [out]},
                     attrs={} if cap is None else {"max_len": int(cap)})
    return out


def shrink_memory(x, i, table):
    """Memory rows of the sequences alive at step i (dead rows zeroed)."""
    helper = LayerHelper("shrink_memory")
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = tuple(x.shape)
    helper.append_op("shrink_rnn_memory",
                     inputs={"X": [x], "I": [i], "RankTable": [table]},
                     outputs={"Out": [out]})
    return out


def split_lod_tensor(input, mask, level=0):
    """Rows routed by a boolean mask into (true, false) outputs, stably
    front-compacted, zero-padded."""
    helper = LayerHelper("split_lod_tensor")
    out_true = helper.create_variable_for_type_inference(input.dtype)
    out_false = helper.create_variable_for_type_inference(input.dtype)
    out_true.shape = tuple(input.shape)
    out_false.shape = tuple(input.shape)
    helper.append_op("split_lod_tensor",
                     inputs={"X": [input], "Mask": [mask]},
                     outputs={"OutTrue": [out_true],
                              "OutFalse": [out_false]},
                     attrs={"level": int(level)})
    return out_true, out_false


def merge_lod_tensor(in_true, in_false, x, mask, level=0):
    """Inverse of split_lod_tensor."""
    helper = LayerHelper("merge_lod_tensor")
    out = helper.create_variable_for_type_inference(in_true.dtype)
    out.shape = tuple(in_true.shape)
    helper.append_op("merge_lod_tensor",
                     inputs={"InTrue": [in_true], "InFalse": [in_false],
                             "X": [x], "Mask": [mask]},
                     outputs={"Out": [out]},
                     attrs={"level": int(level)})
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    """Batch rows permuted into the rank table's order."""
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = tuple(x.shape)
    helper.append_op("reorder_lod_tensor_by_rank",
                     inputs={"X": [x], "RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out


def tensor_array_to_tensor(input, axis=1, use_stack=False, name=None):
    """An array's slots stacked or concatenated. Returns (out,
    out_index)."""
    helper = LayerHelper("tensor_array_to_tensor")
    out = helper.create_variable_for_type_inference(input.dtype)
    idx = helper.create_variable_for_type_inference("int32")
    helper.append_op("tensor_array_to_tensor",
                     inputs={"X": [input]},
                     outputs={"Out": [out], "OutIndex": [idx]},
                     attrs={"axis": int(axis), "use_stack": bool(use_stack)})
    return out, idx


class DynamicRNN:
    """Ragged-batch RNN (reference fluid.layers.DynamicRNN,
    control_flow.py:795). Sequences are sorted by length descending (the
    rank table); each step processes the sequences still alive, with
    static shapes: dead rows are zeroed, and the outputs come back in the
    original order, zero-padded. The first `step_input` passes the
    per-sequence lengths (`length=`); the loop is a `While` bounded by the
    padded length, so it captures and trains::

        drnn = layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(emb, length=lens)     # [B, T, D] + [B]
            prev = drnn.memory(shape=[H], value=0.0)
            h = layers.fc(layers.concat([word, prev], 1), H, act="tanh")
            drnn.update_memory(prev, h)
            drnn.output(h)
        hidden_seq = drnn()                              # [B, T, H]
    """

    BEFORE_RNN, IN_RNN, AFTER_RNN = 0, 1, 2

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn")
        self.status = DynamicRNN.BEFORE_RNN
        self.rank_table = None
        self.max_seq_len = None
        self.step_idx = None
        self.zero_idx = None
        self.cond = None
        self.while_op = None
        self.mem_dict = {}
        self.mem_link = []
        self.input_array = []
        self.output_array = []
        self.outputs = []
        self._max_t = None
        self._in0 = None

    @contextlib.contextmanager
    def _parent(self):
        """Append ops to the parent block: the set-up ops live outside
        the loop body."""
        prog = self.helper.main_program
        saved = prog.current_block_idx
        prog.current_block_idx = prog.blocks[saved].parent_idx
        try:
            yield
        finally:
            prog.current_block_idx = saved

    @contextlib.contextmanager
    def block(self):
        if self.status != DynamicRNN.BEFORE_RNN:
            raise ValueError("block() can only be entered once")
        from . import tensor as T
        from . import nn as N
        self.step_idx = T.fill_constant([1], "int64", 0)
        self.zero_idx = T.fill_constant([1], "int64", 0)
        self.cond = T.fill_constant([1], "bool", True)
        self.while_op = While(self.cond)
        self.status = DynamicRNN.IN_RNN
        with self.while_op.block():
            yield
            if self.rank_table is None:
                raise ValueError("DynamicRNN.block() used without any "
                                 "step_input()")
            increment(self.step_idx)
            for new_mem, mem_array in self.mem_link:
                array_write(new_mem, self.step_idx, array=mem_array)
            N.less_than(self.step_idx, self.max_seq_len, cond=self.cond)
        self.status = DynamicRNN.AFTER_RNN
        for arr in self.output_array:
            self.outputs.append(
                array_to_lod_tensor(arr, self.rank_table,
                                    max_len=self._max_t))

    def _assert_in_rnn(self, method):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError(f"{method}() can only be used inside block()")

    def _first_slot(self):
        if self._in0 is None:
            with self._parent():
                self._in0 = array_read(self.input_array[0], self.zero_idx)
        return self._in0

    def step_input(self, x, level=0, length=None):
        """The current step's rows [B, ...] (rank order, dead rows
        zeroed). The first call defines the rank table and needs
        `length=` [B]."""
        self._assert_in_rnn("step_input")
        from . import nn as N
        with self._parent():
            if self.rank_table is None:
                if length is None:
                    raise ValueError(
                        "the first step_input needs length= (padded-dense "
                        "sequences carry no LoD)")
                self.rank_table = lod_rank_table(x, level=level,
                                                 length=length)
                self.max_seq_len = max_sequence_len(self.rank_table)
                self._max_t = int(x.shape[1])
                # the bounded loop: captured and differentiated
                self.while_op.bound = self._max_t
                N.less_than(self.step_idx, self.max_seq_len, cond=self.cond)
            arr = lod_tensor_to_array(x, self.rank_table)
            self.input_array.append(arr)
        ret = array_read(arr, self.step_idx)
        # a time-step slice is [B, ...x's feature dims]
        ret.shape = (x.shape[0],) + tuple(x.shape[2:])
        return ret

    def static_input(self, x):
        """Per-step view of a non-sequence input: in rank order, rows of
        finished sequences zeroed."""
        self._assert_in_rnn("static_input")
        if self.rank_table is None:
            raise RuntimeError("static_input() must come after step_input()")
        with self._parent():
            reordered = reorder_lod_tensor_by_rank(x, self.rank_table)
        return shrink_memory(reordered, self.step_idx, self.rank_table)

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype="float32"):
        self._assert_in_rnn("memory")
        from . import tensor as T
        if self.rank_table is None:
            raise ValueError("memory() must come after step_input()")
        if init is not None:
            with self._parent():
                init_t = reorder_lod_tensor_by_rank(init, self.rank_table) \
                    if need_reorder else init
                mem_array = array_write(init_t, self.zero_idx,
                                        capacity=self._max_t + 1)
        else:
            if shape is None:
                raise ValueError("memory() needs init= or shape=")
            in0 = self._first_slot()
            with self._parent():
                init_t = T.fill_constant_batch_size_like(
                    in0, shape=[-1] + list(shape), dtype=dtype, value=value)
                mem_array = array_write(init_t, self.zero_idx,
                                        capacity=self._max_t + 1)
        retv = array_read(mem_array, self.step_idx)
        retv.shape = tuple(init.shape) if init is not None \
            else (-1,) + tuple(int(d) for d in shape)
        retv = shrink_memory(retv, self.step_idx, self.rank_table)
        self.mem_dict[retv.name] = mem_array
        return retv

    def update_memory(self, ex_mem, new_mem):
        self._assert_in_rnn("update_memory")
        mem_array = self.mem_dict.get(ex_mem.name)
        if mem_array is None:
            raise ValueError("update_memory's first arg must be a memory() "
                             "result")
        self.mem_link.append((new_mem, mem_array))

    def output(self, *outputs):
        self._assert_in_rnn("output")
        from . import tensor as T
        in0 = self._first_slot()
        for o in outputs:
            with self._parent():
                prime = T.fill_constant_batch_size_like(
                    in0, shape=[-1] + [int(d) for d in o.shape[1:]],
                    dtype=dtype_name(o.dtype), value=0.0)
                arr = array_write(prime, self.zero_idx,
                                  capacity=self._max_t + 1)
            array_write(o, self.step_idx, array=arr)
            self.output_array.append(arr)

    def __call__(self):
        if self.status != DynamicRNN.AFTER_RNN:
            raise ValueError("DynamicRNN outputs are available only after "
                             "block() closes")
        return self.outputs[0] if len(self.outputs) == 1 else self.outputs
