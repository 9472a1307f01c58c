"""Optimizer update lowerings (counterpart of paddle_tpu/ops/optimizer_ops.py):
the dense `adam` rule (`:84-117`).

The update happens IN PLACE on the scope's tensors (Param, Moment1,
Moment2), the PyTorch analog of the reference's buffer donation: no second
copy of the parameters or moments is ever allocated. The op's outputs name
the same tensors, so the Executor's write-back is a no-op for them. The
shared beta-pow pair advances in a separate `scale` op
(optimizer.py `_finalize_optimize_ops`).
"""
from __future__ import annotations

import torch

from .registry import register

@register("adam", nondiff_slots=("Param", "Grad", "LearningRate", "Moment1",
                                  "Moment2", "Beta1Pow", "Beta2Pow"))
def _adam(ctx, ins, attrs):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    if not isinstance(g, torch.Tensor) or g.layout != torch.strided:
        raise NotImplementedError(
            "adam: SelectedRows (row-sparse) gradients are not ported; the "
            "port's adam takes dense gradients only")
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    with torch.no_grad():
        gf = g.to(m1.dtype)
        m1.mul_(b1).add_(gf, alpha=1 - b1)
        m2.mul_(b2).addcmul_(gf, gf, value=1 - b2)
        lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
        p.sub_((lr_t * m1 / (torch.sqrt(m2) + eps)).to(p.dtype))
    return {"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2]}
