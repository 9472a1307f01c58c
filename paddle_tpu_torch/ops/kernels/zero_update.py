"""Fused flat-bucket optimizer updates B6-B8: the CUDA kernels' wrapper,
their plain version and their launch counts.

Counterpart of paddle_tpu/ops/pallas/zero_update.py (`FUSED_OPS` :40,
`supports` :60, `fused_flat_update` :151; kernels `_sgd_kernel` :89,
`_momentum_kernel` :94, `_adam_kernel` :108). The kernel source, with its
design and bound, is paddle_tpu_torch/csrc/zero_update.cu.

* On CUDA tensors `fused_flat_update` launches one kernel over the flat
  bucket on the current stream, updating Param and the optimizer state in
  place, or raises: float32 tensors only (the buckets hold the parameters'
  f32), contiguous, of one element count, on one card. There is no
  fallback, and no toggle: the reference's `FLAGS_pallas_opt` /
  `PADDLE_TPU_PALLAS_OPT` switch is dropped, because kernel and rule agree
  bit for bit.
* On CPU tensors it runs the plain version: the registered dense rule of
  ops/optimizer_ops.py, which is also the per-parameter lowering. One
  rule, used twice; the kernels repeat its operations in its order.
* `launches` counts kernel launches per kernel name (adam and adamw share
  `zero_adam`); it moves only where a kernel is launched (inside a CUDA
  graph capture, at each replay: ops/kernels/counts.py).
"""
from __future__ import annotations

import ctypes

import torch

from . import counts

FUSED_OPS = ("sgd", "momentum", "adam", "adamw")
KERNEL_NAMES = {"sgd": "zero_sgd", "momentum": "zero_momentum",
                "adam": "zero_adam", "adamw": "zero_adam"}
launches = {name: 0 for name in ("zero_sgd", "zero_momentum", "zero_adam")}
# the state slots each rule reads and updates in place, beside Param
_STATE_SLOTS = {"sgd": (), "momentum": ("Velocity",),
                "adam": ("Moment1", "Moment2"),
                "adamw": ("Moment1", "Moment2")}

_lib = None


def reset_launches():
    for name in launches:
        launches[name] = 0


def supports(op_type: str, ins) -> bool:
    """True when a fused kernel covers this update: a FUSED_OPS op with a
    dense floating gradient. A SelectedRows gradient stays on the
    registry's sparse rule (reference :62-67)."""
    if op_type not in FUSED_OPS:
        return False
    g = ins["Grad"][0]
    return (isinstance(g, torch.Tensor) and g.layout == torch.strided
            and g.is_floating_point())


def fused_flat_update_plain(op_type: str, ins, attrs):
    """The registered dense rule, in place (ops/optimizer_ops.py)."""
    from .. import registry
    return registry.get(op_type).lower(None, ins, attrs)


def _library():
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("zero_update")
        p, i, f, n = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_longlong)
        lib.zero_sgd.argtypes = [p, p, p, n, p]
        lib.zero_momentum.argtypes = [p, p, p, p, n, f, f, i, i, p]
        lib.zero_adam.argtypes = [p] * 7 + [n] + [f] * 6 + [i, p]
        for fn in (lib.zero_sgd, lib.zero_momentum, lib.zero_adam):
            fn.restype = i
        lib.zero_adam_blocks_per_sm.argtypes = []
        lib.zero_adam_blocks_per_sm.restype = i
        lib.zero_momentum_blocks_per_sm.argtypes = [i, i]
        lib.zero_momentum_blocks_per_sm.restype = i
        lib.zero_update_error_string.argtypes = [i]
        lib.zero_update_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_cuda(op_type, bucket, scalars):
    tensors = bucket + scalars
    bad = [str(t.dtype) for t in tensors if t.dtype != torch.float32]
    if bad:
        raise TypeError(f"fused_flat_update({op_type}): the kernels take "
                        f"float32 buckets, got {bad}")
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"fused_flat_update({op_type}): all tensors must be on one CUDA "
            f"device (or all on the CPU), got "
            f"{[str(t.device) for t in tensors]}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"fused_flat_update({op_type}): the kernels update "
                         f"contiguous buckets in place")
    if any(t.numel() != bucket[0].numel() for t in bucket) \
            or any(t.numel() != 1 for t in scalars):
        raise ValueError(
            f"fused_flat_update({op_type}): bucket tensors of one element "
            f"count and one-element scalars, got "
            f"{[tuple(t.shape) for t in tensors]}")


def _operands(op_type, ins):
    """(bucket tensors [Param, Grad, state...], [1]-scalars)."""
    bucket = [ins["Param"][0], ins["Grad"][0]] + \
        [ins[s][0] for s in _STATE_SLOTS[op_type]]
    scalars = [ins["LearningRate"][0]]
    if op_type in ("adam", "adamw"):
        scalars += [ins["Beta1Pow"][0], ins["Beta2Pow"][0]]
    return bucket, scalars


def fused_flat_update(op_type: str, ins, attrs):
    """Fused replacement for `registry.get(op_type).lower(...)` on a dense
    flat bucket ([S], or [L, S]: the same memory): same ins/attrs contract,
    same output dict, the outputs being the input tensors updated in
    place."""
    if op_type not in FUSED_OPS:
        raise ValueError(f"no fused kernel for op type {op_type!r}")
    bucket, scalars = _operands(op_type, ins)
    if all(t.device.type == "cpu" for t in bucket + scalars):
        return fused_flat_update_plain(op_type, ins, attrs)
    _check_cuda(op_type, bucket, scalars)
    dev = bucket[0].device
    with torch.cuda.device(dev):
        return launch(_library(), op_type, ins, attrs,
                      torch.cuda.current_stream(dev).cuda_stream)


def momentum_args(ins, attrs):
    """B7's arguments before the stream, (lr, p, g, v, n, mu, l2, use_l2,
    nesterov): the pointers of `ins`' checked operands and the rule's
    constants. (use_l2, nesterov) pick one of the kernel's four compiled
    instances."""
    (p, g, v), (lr,) = _operands("momentum", ins)
    rd = attrs.get("regularization_coeff", 0.0)
    use_l2 = attrs.get("regularization_method", "") == "l2_decay" \
        and bool(rd)
    return (lr.data_ptr(), p.data_ptr(), g.data_ptr(), v.data_ptr(),
            p.numel(), attrs.get("mu", 0.9), rd if use_l2 else 0.0,
            int(use_l2), int(bool(attrs.get("use_nesterov", False))))


def launch(lib, op_type: str, ins, attrs, stream: int):
    """One launch of `op_type`'s kernel from `lib` on `stream` over checked
    operands; counts it and returns the rule's output dict. Constants go
    as Python floats, which ctypes rounds to f32 as PyTorch rounds a scalar
    for an f32 tensor."""
    (p, g, *state), (lr, *pows) = _operands(op_type, ins)
    n = p.numel()
    if op_type == "sgd":
        rc = lib.zero_sgd(lr.data_ptr(), p.data_ptr(), g.data_ptr(), n,
                          stream)
        outs = {"ParamOut": [p]}
    elif op_type == "momentum":
        rc = lib.zero_momentum(*momentum_args(ins, attrs), stream)
        outs = {"ParamOut": [p], "VelocityOut": [state[0]]}
    else:
        # the kernel forms lr_t from LearningRate, Beta1Pow and Beta2Pow as
        # the rule's `adam_lr_t` does: one launch is the whole update
        m1, m2 = state
        b1 = attrs.get("beta1", 0.9)
        b2 = attrs.get("beta2", 0.999)
        decay = op_type == "adamw" and bool(attrs.get("with_decay", True))
        rc = lib.zero_adam(
            lr.data_ptr(), pows[0].data_ptr(), pows[1].data_ptr(),
            p.data_ptr(), g.data_ptr(), m1.data_ptr(), m2.data_ptr(), n,
            b1, 1 - b1, b2, 1 - b2,
            attrs.get("epsilon", 1e-8),
            attrs.get("coeff", 0.01) if decay else 0.0, int(decay), stream)
        outs = {"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2]}
    if rc != 0:
        raise RuntimeError(
            f"{KERNEL_NAMES[op_type]} launch failed: "
            f"{lib.zero_update_error_string(rc).decode()} (cudaError {rc})")
    counts.count(launches, KERNEL_NAMES[op_type])
    return outs
