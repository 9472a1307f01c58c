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
* Randomness: `LowerCtx.op_key` derives a deterministic int64 seed from the
  run seed and the op's `__rng_seed__` attr. A random lowering seeds its
  own `torch.Generator` from it and never touches torch's global RNG, so a
  recomputed forward draws exactly the masks the forward drew.
"""
from __future__ import annotations

import threading

from typing import Callable, Dict, List, Optional

import torch

from ..framework.dtype import device_dtype

# Sentinel concrete size standing in for -1 dims during build-time inference.
_DYN_SENTINEL = 8191
_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finaliser: a well-spread 64-bit hash of an int."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


class LowerCtx:
    """Per-run context handed to lowerings: the run seed, the device that
    ops without inputs create their outputs on, and whether this is
    build-time inference on meta tensors."""

    __slots__ = ("run_seed", "device", "is_eval_shape")

    def __init__(self, run_seed: int = 0, device=None,
                 is_eval_shape: bool = False):
        self.run_seed = int(run_seed)
        self.device = torch.device("cpu" if device is None else device)
        self.is_eval_shape = is_eval_shape

    def op_key(self, attrs) -> int:
        """Deterministic per-op seed in [0, 2**63): (run seed, the op's
        stable `__rng_seed__`). A grad op re-running the forward with the
        same attrs gets the same key, hence the same dropout mask."""
        seed = int(attrs.get("__rng_seed__", 0))
        return _mix64(_mix64(self.run_seed) ^ seed) >> 1

    def generator(self, attrs, device=None) -> torch.Generator:
        """A torch.Generator on `device` seeded from `op_key(attrs)`."""
        g = torch.Generator(device=device or self.device)
        g.manual_seed(self.op_key(attrs))
        return g

    def int32_seed(self, attrs) -> int:
        """`op_key` squeezed to the int32 the counter-hash dropout of the
        flash kernels keys on."""
        k = self.op_key(attrs)
        x = (k ^ (k >> 32)) & 0xFFFFFFFF
        return x - (1 << 32) if x >= (1 << 31) else x


class OpDef:
    def __init__(self, name: str, lower: Callable,
                 infer: Optional[Callable] = None, is_random: bool = False,
                 nondiff_slots=(), stateful_outputs=()):
        self.name = name
        self.lower = lower
        self.infer = infer
        self.is_random = is_random      # gets a stable __rng_seed__ at build
        self.nondiff_slots = frozenset(nondiff_slots)
        # output slots aliasing an input (optimizer ParamOut): excluded
        # from autodiff bookkeeping
        self.stateful_outputs = frozenset(stateful_outputs)


_REGISTRY: Dict[str, OpDef] = {}
# modules of the package that register lowerings on import
_LOWERING_MODULES = ("ops.tensor_ops", "ops.math_ops", "ops.nn_ops",
                     "ops.fused_ce", "ops.attention", "ops.optimizer_ops",
                     "ops.int8_ops", "parallel.zero")
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
             stateful_outputs=()):
    def deco(fn):
        _REGISTRY[name] = OpDef(name, fn, infer=infer, is_random=is_random,
                                nondiff_slots=nondiff_slots,
                                stateful_outputs=stateful_outputs)
        return fn
    return deco


def get(name: str) -> OpDef:
    _load_lowerings()
    if name not in _REGISTRY:
        from ..framework import errors
        raise errors.Unimplemented(
            "op %r is not registered in the port; the training slice "
            "lowers the BERT pretrain program's ops (ROADMAP lists the "
            "rest)", name)
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
    `out_slots` ride along as aux."""
    primals = [ins[s][i] for s, i in diff]
    layout = []                  # (slot, index, is_float), plain metadata

    def f(*vals):
        cur = {s: list(vs) for s, vs in ins.items()}
        for (s, i), v in zip(diff, vals):
            cur[s][i] = v
        outs = opdef.lower(ctx, cur, attrs)
        floats, aux = [], {}
        layout.clear()
        for s, vs in outs.items():
            for j, v in enumerate(vs):
                is_f = (s in out_slots and v is not None
                        and v.is_floating_point())
                layout.append((s, j, is_f))
                if is_f:
                    floats.append(v)
                else:
                    aux[(s, j)] = v
        return floats, aux

    floats, vjp_fn, aux = torch.func.vjp(f, *primals, has_aux=True)
    it = iter(floats)
    outs = {}
    for s, j, is_f in layout:
        outs.setdefault(s, []).append(next(it) if is_f else aux[(s, j)])
    return outs, vjp_fn


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
            if ref is None or not ref.is_floating_point():
                continue
            ct = ogs[j] if j < len(ogs) else None
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
