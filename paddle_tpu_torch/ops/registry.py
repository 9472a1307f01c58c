"""Op registry: op name -> PyTorch lowering + build-time shape inference
(counterpart of paddle_tpu/ops/registry.py).

Lowering signature, as in the reference:

    lower(ctx, ins: Dict[slot, List[Tensor]], attrs: dict)
        -> Dict[slot, List[Tensor]]

* Build-time inference (`infer_op`) runs the lowering on `meta`-device
  tensors, with a sentinel size standing in for unknown (-1) dims, then
  maps the sentinel back. Nothing is allocated and no kernel launches.
* Gradients: `append_backward` emits one generic `__vjp__` op per forward
  op. Its lowering is `torch.func.vjp` over the forward lowering
  (`forward_vjp`); the Executor reuses the same function to keep the
  forward's graph instead of recomputing it (framework/executor.py).
* Randomness: the run seed lives in a device tensor (`LowerCtx.seed`,
  int64 []), and `LowerCtx.op_seed` derives each random op's key from it
  and the op's constant `__rng_seed__` attr ON THE DEVICE: a one-element
  int32 tensor holding uint32 bits. Dropout (ops/nn_ops.py) and the flash
  kernels hash element indices with that key, so a recomputed forward
  draws exactly the masks the forward drew, and a CUDA graph captured over
  a step draws a new mask on every replay from the seed written into its
  static seed tensor. Nothing random touches torch's global RNG. The
  startup program's initialisers (run eagerly, never captured) seed a
  host `torch.Generator` from `op_key`, which needs the run seed as an
  int.
"""
from __future__ import annotations

import threading

from typing import Callable, Dict, List, Optional

import torch

from ..framework.dtype import device_dtype
# uint32 arithmetic on int64 tensors or ints, shared with the flash
# kernels' counter hash
from .kernels.flash_attention import _U32, _mul32

# Sentinel concrete size standing in for -1 dims during build-time inference.
_DYN_SENTINEL = 8191
_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finaliser: a well-spread 64-bit hash of an int."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fmix32(x):
    """murmur3's 32-bit finaliser on uint32 values in int64 tensors or
    ints."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EB_CA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2_AE35)
    return x ^ (x >> 16)


class LowerCtx:
    """Per-run context handed to lowerings: the run seed, the device that
    ops without inputs create their outputs on, whether this is
    build-time inference on meta tensors, and the program's AMP low dtype
    (`amp_dtype`, None without AMP; the executor sets it, and a fused
    sub-graph op casts its inner ops' inputs by it).

    `run_seed` is an int, or an int64 [] tensor on `device` (the static
    seed buffer of a captured step). Keys derive from it on the device in
    either case, by the same ops, so an eager step and a replayed graph
    with the same seed value draw the same masks."""

    __slots__ = ("run_seed", "device", "is_eval_shape", "amp_dtype", "mesh",
                 "capturing", "_seed", "_run_key", "_keys")

    def __init__(self, run_seed=0, device=None, is_eval_shape: bool = False,
                 amp_dtype=None, mesh=None, capturing: bool = False):
        self.device = torch.device("cpu" if device is None else device)
        self.is_eval_shape = is_eval_shape
        self.amp_dtype = amp_dtype
        # the step is being captured into a CUDA graph (or warmed up for
        # one): a lowering must not read device values on the host, so
        # `__cond__` / `__switch__` run every branch and select
        # (layers/control_flow.py)
        self.capturing = capturing
        # the tp/sp mesh a step on DTensors runs over (parallel/gspmd.py)
        self.mesh = mesh
        if isinstance(run_seed, torch.Tensor):
            self.run_seed, self._seed = None, run_seed
        else:
            self.run_seed, self._seed = int(run_seed), None
        self._run_key = None
        self._keys = {}

    @property
    def seed(self) -> torch.Tensor:
        """The run seed as an int64 [] tensor on the device (a fill, not
        a host-to-device copy)."""
        if self._seed is None:
            self._seed = torch.full((), self.run_seed, dtype=torch.int64,
                                    device=self.device)
        return self._seed

    def op_seed(self, attrs) -> torch.Tensor:
        """The op's key: a [1] int32 tensor on the device holding the
        uint32 fmix32(fmix32(lo) ^ hi) ^ fmix32(`__rng_seed__`) of the run
        seed's halves, computed by device ops from `seed` (no host sync,
        safe under capture). The same attrs give the same tensor within a
        run, so the forward and its grad op draw one mask."""
        c = int(attrs.get("__rng_seed__", 0))
        key = self._keys.get(c)
        if key is None:
            if self._run_key is None:
                s = self.seed.reshape(1)
                self._run_key = fmix32(fmix32(s & _U32)
                                       ^ ((s >> 32) & _U32))
            k = self._run_key ^ fmix32(c * 0x9E37_79B9 & _U32)
            # uint32 bits as int32: subtract 2**32 from the upper half
            key = (k - ((k >> 31) << 32)).to(torch.int32)
            self._keys[c] = key
        return key

    def op_key(self, attrs) -> int:
        """Host per-op seed in [0, 2**63) for the initialisers' generators:
        (run seed, the op's stable `__rng_seed__`). Needs an int run
        seed."""
        if self.run_seed is None:
            raise RuntimeError(
                "op_key needs a host run seed; a captured step derives its "
                "keys on the device (LowerCtx.op_seed)")
        seed = int(attrs.get("__rng_seed__", 0))
        return _mix64(_mix64(self.run_seed) ^ seed) >> 1

    def generator(self, attrs, device=None) -> torch.Generator:
        """A torch.Generator on `device` seeded from `op_key(attrs)`."""
        g = torch.Generator(device=device or self.device)
        g.manual_seed(self.op_key(attrs))
        return g


class OpDef:
    def __init__(self, name: str, lower: Callable,
                 infer: Optional[Callable] = None, is_random: bool = False,
                 nondiff_slots=(), stateful_outputs=(), inplace=None,
                 vjp: Optional[Callable] = None, host_read=False,
                 shape_slot: Optional[str] = None):
        self.name = name
        self.lower = lower
        self.infer = infer
        self.is_random = is_random      # gets a stable __rng_seed__ at build
        self.nondiff_slots = frozenset(nondiff_slots)
        # output slots aliasing an input (optimizer ParamOut): excluded
        # from autodiff bookkeeping
        self.stateful_outputs = frozenset(stateful_outputs)
        # output slot -> input slot the lowering updates in place
        self.inplace = dict(inplace or {})
        # an op's own `forward_vjp` (same signature and contract), for an
        # op whose gradient is not one torch.func.vjp over its lowering
        self.vjp = vjp
        # reads device values on the host every step (a captured step
        # cannot): run_steps runs a program holding it eagerly
        self.host_read = host_read
        # the input slot whose values set the output's shape: read on the
        # host unless a build-time `fill_constant` made it
        self.shape_slot = shape_slot


_REGISTRY: Dict[str, OpDef] = {}
# modules of the package that register lowerings on import
_LOWERING_MODULES = ("ops.tensor_ops", "ops.math_ops", "ops.nn_ops",
                     "ops.metric_ops",
                     "ops.fused_ce", "ops.attention", "ops.optimizer_ops",
                     "ops.int8_ops", "ops.lod_ops", "ops.sequence_ops",
                     "ops.sparse_grad", "ops.dense_tail_ops",
                     "ops.extra_ops", "ops.detection_ops",
                     "ops.detection_assign_ops",
                     "layers.control_flow", "ops.tail_ops",
                     "ops.dense_tail_ops2", "ops.decode_ops",
                     "parallel.zero", "parallel.transforms")
_loaded = False
_loading = False
_load_lock = threading.RLock()


def _load_lowerings():
    """Import the lowering modules once (they register on import). Other
    threads wait until the first load has finished (serving replicas reach
    it from their service threads at once); a re-entry from the loading
    thread itself returns at once."""
    global _loaded, _loading
    if _loaded:
        return
    with _load_lock:
        if _loaded or _loading:
            return
        _loading = True
        try:
            import importlib
            root = __package__.rpartition(".")[0]
            for m in _LOWERING_MODULES:
                importlib.import_module(f"{root}.{m}")
            _loaded = True
        finally:
            _loading = False


def register(name: str, *, infer=None, is_random=False, nondiff_slots=(),
             stateful_outputs=(), inplace=None, vjp=None, host_read=False,
             shape_slot=None):
    def deco(fn):
        _REGISTRY[name] = OpDef(name, fn, infer=infer, is_random=is_random,
                                nondiff_slots=nondiff_slots,
                                stateful_outputs=stateful_outputs,
                                inplace=inplace, vjp=vjp,
                                host_read=host_read, shape_slot=shape_slot)
        return fn
    return deco


def get(name: str) -> OpDef:
    _load_lowerings()
    if name not in _REGISTRY:
        from ..framework import errors
        raise errors.Unimplemented(
            "op %r is not registered in the port (ROADMAP item 12 lists "
            "the op types still to port)", name)
    return _REGISTRY[name]


def has(name: str) -> bool:
    _load_lowerings()
    return name in _REGISTRY


# ---------------------------------------------------------------------------
# Build-time shape/dtype inference
# ---------------------------------------------------------------------------

def infer_op(block, op) -> None:
    block.program.bump_version()
    _load_lowerings()
    opdef = _REGISTRY.get(op.type)
    if opdef is None:
        return  # tolerated at build; execution fails loudly
    if opdef.is_random and "__rng_seed__" not in op.attrs:
        # per-program counter: two identically built programs draw the
        # same values under the same seed
        ctr = getattr(block.program, "_rng_op_counter", None)
        if ctr is None:
            ctr = 1 + max((o.attrs.get("__rng_seed__", 0)
                           for b in block.program.blocks for o in b.ops),
                          default=0)
        op.attrs["__rng_seed__"] = ctr
        block.program._rng_op_counter = ctr + 1
    if opdef.infer is not None:
        opdef.infer(block, op)
        return
    try:
        _generic_infer(block, op, opdef)
    except Exception:
        # advisory, as in the reference: execution specialises on real
        # shapes, so unknown shapes stay as they are
        pass


def _generic_infer(block, op, opdef) -> None:
    ins = {}
    for slot, names in op.inputs.items():
        ins[slot] = []
        for n in names:
            v = block.var(n)
            shape = tuple(_DYN_SENTINEL if d in (-1, None) else d
                          for d in v.shape)
            ins[slot].append(torch.empty(shape, dtype=device_dtype(v.dtype),
                                         device="meta"))
    ctx = LowerCtx(device="meta", is_eval_shape=True)
    outs = opdef.lower(ctx, ins, op.attrs)
    for slot, names in op.outputs.items():
        if slot not in outs:
            continue
        for n, t in zip(names, outs[slot]):
            if n == "@EMPTY@" or t is None:
                continue
            v = block.find_var_recursive(n)
            if v is None:
                continue
            v.shape = tuple(-1 if d == _DYN_SENTINEL else int(d)
                            for d in t.shape)
            v.dtype = device_dtype(t.dtype)


# ---------------------------------------------------------------------------
# Generic VJP grad op
# ---------------------------------------------------------------------------

def make_vjp_attrs(fwd_op, diff_entries, out_slots_order):
    """diff_entries: list of (slot, index) of forward inputs to
    differentiate."""
    return {
        "fwd_type": fwd_op.type,
        "fwd_attrs": dict(fwd_op.attrs),
        "fwd_input_slots": {k: len(v) for k, v in fwd_op.inputs.items()},
        "fwd_output_slots": list(out_slots_order),
        "fwd_output_counts": {s: len(fwd_op.outputs.get(s, []))
                              for s in out_slots_order},
        "diff_entries": [list(e) for e in diff_entries],
        "op_role": 1,  # OpRole.Backward
    }


def forward_vjp(opdef, ctx, ins, attrs, diff, out_slots):
    """Run `opdef`'s lowering under torch.func.vjp with respect to the
    forward inputs `diff` [(slot, index)].

    Returns (outs, vjp_fn): `outs` is the lowering's full output dict,
    `vjp_fn` maps the cotangents of the floating outputs of `out_slots`
    (in slot order, as `cotangents` builds them) to one grad per diff
    entry. Non-floating outputs (a dropout mask) and slots outside
    `out_slots` ride along as aux. An op with its own `vjp` (the layer
    scan's reverse loop, parallel/transforms.py) computes both itself."""
    if opdef.vjp is not None:
        return opdef.vjp(ctx, ins, attrs, diff, out_slots)
    return func_vjp(opdef.lower, ctx, ins, attrs, diff, out_slots)


def func_vjp(lower, ctx, ins, attrs, diff, out_slots):
    """`forward_vjp` as one torch.func.vjp over the lowering `lower`; on a
    tp/sp mesh (`ctx.mesh`, DTensor operands) through autograd instead
    (`_autograd_vjp`)."""
    if ctx.mesh is not None:
        return _autograd_vjp(lower, ctx, ins, attrs, diff, out_slots)
    # a LoDTensorArray (buffer or None, length) is differentiated through
    # its buffer: its primal, its output and its cotangent are the buffer
    # (an array without one stands in as an empty f32 tensor)
    primals = [_diff_part(ins[s][i]) for s, i in diff]
    layout = []                  # (slot, index, kind), plain metadata

    def f(*vals):
        cur = {s: list(vs) for s, vs in ins.items()}
        for (s, i), v in zip(diff, vals):
            old = cur[s][i]
            cur[s][i] = v if not isinstance(old, tuple) else (
                None if old[0] is None else v, old[1])
        outs = lower(ctx, cur, attrs)
        floats, aux = [], {}
        layout.clear()
        for s, vs in outs.items():
            for j, v in enumerate(vs):
                # how the value rides: "f" a float output, "fa" an array's
                # float buffer (its length in aux), "a" any other tensor,
                # "na" an array without a buffer (its length in aux),
                # "none" nothing (aux holds tensors only)
                if s in out_slots and _floating(v):
                    kind = "fa" if isinstance(v, tuple) else "f"
                elif v is None:
                    kind = "none"
                elif isinstance(v, tuple) and v[0] is None:
                    kind = "na"
                else:
                    kind = "a"
                layout.append((s, j, kind))
                if kind in ("f", "fa"):
                    floats.append(v[0] if kind == "fa" else v)
                if kind in ("fa", "na"):
                    aux[(s, j)] = v[1]
                elif kind == "a":
                    aux[(s, j)] = v
        return floats, aux

    floats, vjp_fn, aux = torch.func.vjp(f, *primals, has_aux=True)
    it = iter(floats)
    outs = {}
    for s, j, kind in layout:
        if kind == "f":
            v = next(it)
        elif kind == "fa":
            v = (next(it), aux[(s, j)])
        elif kind == "na":
            v = (None, aux[(s, j)])
        else:
            v = aux.get((s, j))
        outs.setdefault(s, []).append(v)
    return outs, vjp_fn


def _diff_part(v):
    """The differentiable tensor of an input value: an array's buffer."""
    if isinstance(v, tuple):
        return torch.zeros(0) if v[0] is None else v[0]
    return v


def _floating(v) -> bool:
    """A floating tensor, or an array with a floating buffer."""
    if isinstance(v, tuple):
        v = v[0]
    return v is not None and v.is_floating_point()


def _autograd_vjp(lower, ctx, ins, attrs, diff, out_slots):
    """`func_vjp` through torch.autograd: DTensor's methods (to_local,
    redistribute), which the DTensor lowerings call, are not reachable
    through torch.func's wrapped tensors. The same backward formulas run;
    an input the outputs do not depend on gets a zero gradient, as
    torch.func.vjp gives it."""
    cur = {s: list(vs) for s, vs in ins.items()}
    primals = []
    for s, i in diff:
        p = cur[s][i].detach().requires_grad_(True)
        cur[s][i] = p
        primals.append(p)
    with torch.enable_grad():
        outs = lower(ctx, cur, attrs)
    floats = [v for s in out_slots for v in outs.get(s, ())
              if v is not None and v.is_floating_point()]
    outs = {s: [v.detach() if isinstance(v, torch.Tensor) else v
                for v in vs] for s, vs in outs.items()}

    def pullback(cts):
        pairs = [(f, c) for f, c in zip(floats, cts) if f.requires_grad]
        if not pairs:
            return tuple(torch.zeros_like(p) for p in primals)
        from ..parallel.gspmd import align_grad
        # contiguous: DTensor's view rules assume a local shard laid out
        # as its shape (a permuted cotangent's shard may not be)
        grads = torch.autograd.grad([f for f, _ in pairs],
                                    primals,
                                    [align_grad(c, f).contiguous()
                                     for f, c in pairs],
                                    allow_unused=True)
        return tuple(torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, primals))

    return outs, pullback


def cotangents(ins, out_slots, counts, outs):
    """Cotangents for `forward_vjp`'s floating outputs. They arrive in
    slot "OG:<slot>", aligned with the forward op's output lists; missing
    ones (outputs nothing consumed) become zeros. AMP may deliver a
    cotangent in another float dtype than the output: align it."""
    cts = []
    for s in out_slots:
        ogs = ins.get(f"OG:{s}", [])
        vals = outs.get(s, [])
        for j in range(counts[s]):
            ref = vals[j] if j < len(vals) else None
            if not _floating(ref):
                continue
            # an array's cotangent is its buffer's
            ref = ref[0] if isinstance(ref, tuple) else ref
            ct = ogs[j] if j < len(ogs) else None
            ct = ct[0] if isinstance(ct, tuple) else ct
            if ct is None:
                ct = torch.zeros_like(ref)
            elif ct.dtype != ref.dtype:
                ct = ct.to(ref.dtype)
            cts.append(ct)
    return cts


def grads_by_slot(diff, grads, in_slot_counts):
    by_slot = {}
    for (s, i), g in zip(diff, grads):
        by_slot.setdefault(s, {})[i] = g
    return {f"IG:{s}": [m.get(i) for i in range(in_slot_counts[s])]
            for s, m in by_slot.items()}


def _lower_vjp(ctx, ins, attrs):
    """The recompute path: re-run the forward lowering under
    torch.func.vjp and pull the cotangents back through it."""
    fwd = get(attrs["fwd_type"])
    in_slot_counts = attrs["fwd_input_slots"]
    out_slots = attrs["fwd_output_slots"]
    diff = [tuple(e) for e in attrs["diff_entries"]]
    fwd_ins = {slot: list(ins[slot]) for slot in in_slot_counts}
    outs, vjp_fn = forward_vjp(fwd, ctx, fwd_ins, attrs["fwd_attrs"], diff,
                               out_slots)
    cts = cotangents(ins, out_slots, attrs["fwd_output_counts"], outs)
    return grads_by_slot(diff, vjp_fn(cts), in_slot_counts)


def _vjp_infer(block, op):
    """Grad vars take EXACTLY the forward inputs' shapes and dtypes."""
    block.program.bump_version()
    for slot, names in op.outputs.items():
        if not slot.startswith("IG:"):
            continue
        fwd_names = op.inputs.get(slot[3:], [])
        for n, src in zip(names, fwd_names):
            if n == "@EMPTY@" or src == "@EMPTY@":
                continue
            v = block.find_var_recursive(n)
            s = block.find_var_recursive(src)
            if v is not None and s is not None:
                v.shape = tuple(s.shape)
                v.dtype = s.dtype


_REGISTRY["__vjp__"] = OpDef("__vjp__", _lower_vjp, infer=_vjp_infer)
