"""Optimizer update lowerings (counterpart of paddle_tpu/ops/optimizer_ops.py
:21-138): the dense `sgd`, `momentum`, `adam` and `adamw` rules.

Each rule is written one torch op per jnp op of the reference, in the
reference's order, with Python-float constants (`b1 * m1 + (1 - b1) * gf`
is two multiplies and one add). No `add_(..., alpha=)`, `addcmul_` or
`lerp`: on CUDA those may contract into an FMA and round once where the
reference rounds twice. So a rule here equals the reference's rule on the
CPU to within the reference's own FMA formation under jit (tests hold it
to 1 ulp), and equals the fused update kernels B6-B8 on the card bit for
bit (ops/kernels/zero_update.py): these functions are both the
per-parameter lowerings and the kernels' plain versions.

The update happens IN PLACE on the scope's tensors (Param and the
optimizer state), the PyTorch analog of the reference's buffer donation:
the results are `copy_`'d into the input tensors, and the op's outputs name
those same tensors, so the Executor's write-back is a no-op for them. The
shared beta-pow pair advances in a separate `scale` op
(optimizer.py `_finalize_optimize_ops`).
"""
from __future__ import annotations

import torch

from .registry import register

_OPT = dict(nondiff_slots=("Param", "Grad", "LearningRate", "Moment1",
                           "Moment2", "Beta1Pow", "Beta2Pow", "Velocity"))


def _check_dense(op_type, g):
    if not isinstance(g, torch.Tensor) or g.layout != torch.strided:
        raise NotImplementedError(
            f"{op_type}: SelectedRows (row-sparse) gradients are not ported; "
            f"the port's optimizer rules take dense gradients only")


def adam_lr_t(lr, b1p, b2p):
    """Adam's bias-corrected step size on the [1] tensors (the reference's
    scalar prologue, `zero_update.py:187`)."""
    return lr * torch.sqrt(1 - b2p) / (1 - b1p)


@register("sgd", **_OPT)
def _sgd(ctx, ins, attrs):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    _check_dense("sgd", g)
    with torch.no_grad():
        p.copy_(p - lr.to(p.dtype) * g.to(p.dtype))
    return {"ParamOut": [p]}


@register("momentum", **_OPT)
def _momentum(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    v, lr = ins["Velocity"][0], ins["LearningRate"][0]
    _check_dense("momentum", g)
    mu = attrs.get("mu", 0.9)
    rd = attrs.get("regularization_coeff", 0.0)
    with torch.no_grad():
        if attrs.get("regularization_method", "") == "l2_decay" and rd:
            g = g + rd * p
        v_out = mu * v + g
        if attrs.get("use_nesterov", False):
            p_out = p - lr * (g + mu * v_out)
        else:
            p_out = p - lr * v_out
        p.copy_(p_out.to(p.dtype))
        v.copy_(v_out)
    return {"ParamOut": [p], "VelocityOut": [v]}


def _adam_update(op_type, ins, attrs, decay_coeff=None):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    _check_dense(op_type, g)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    with torch.no_grad():
        gf = g.to(m1.dtype)
        m1_out = b1 * m1 + (1 - b1) * gf
        m2_out = b2 * m2 + (1 - b2) * (gf * gf)
        lr_t = adam_lr_t(lr, b1p, b2p)
        p_out = p - (lr_t * m1_out / (torch.sqrt(m2_out) + eps)).to(p.dtype)
        if decay_coeff is not None:
            # decoupled decay of the PRE-update parameter (:137)
            p_out = p_out - (lr * decay_coeff * p).to(p.dtype)
        p.copy_(p_out)
        m1.copy_(m1_out)
        m2.copy_(m2_out)
    return {"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2]}


@register("adam", **_OPT)
def _adam(ctx, ins, attrs):
    return _adam_update("adam", ins, attrs)


@register("adamw", **_OPT)
def _adamw(ctx, ins, attrs):
    coeff = attrs.get("coeff", 0.01) if attrs.get("with_decay", True) \
        else None
    return _adam_update("adamw", ins, attrs, decay_coeff=coeff)
