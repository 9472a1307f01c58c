"""Optimizer update lowerings (counterpart of paddle_tpu/ops/optimizer_ops.py
:21-275): the dense `sgd`, `momentum`, `adam` and `adamw` rules (the ones
the fused flat-bucket kernels B6-B8 cover), and `lars_momentum`, `adamax`,
`adagrad`, `adadelta`, `rmsprop`, `lamb`, `ftrl` and `decayed_adagrad`.

Each rule is written one torch op per jnp op of the reference, in the
reference's order, with Python-float constants (`b1 * m1 + (1 - b1) * gf`
is two multiplies and one add). No `add_(..., alpha=)`, `addcmul_` or
`lerp`: on CUDA those may contract into an FMA and round once where the
reference rounds twice. So a rule here equals the reference's rule on the
CPU to within the reference's own FMA formation under jit (tests hold it
to 1 ulp), and equals the fused update kernels B6-B8 on the card bit for
bit (ops/kernels/zero_update.py): these functions are both the
per-parameter lowerings and the kernels' plain versions.

A SelectedRows gradient (ops/sparse_grad.py, `embedding(is_sparse=True)`)
takes the reference's sparse branch in `sgd`, `momentum`, `adam`,
`adamw` and `adagrad`: the rule touches the looked-up rows only (Adam's
`lazy_mode`: moments and parameter at the merged ids). `sgd` adds each
row's step in the ids' order, duplicates included, as the reference's
scatter-add does; the others merge the ids (`merge_rows`) and compute
each touched row once, with the reference's operations in its order, and
write the rows back with one `index_put_` per tensor. Every other rule
raises on a SelectedRows gradient (`_check_dense`): none densifies it.

The update happens IN PLACE on the scope's tensors (Param and the
optimizer state), the PyTorch analog of the reference's buffer donation:
the results are `copy_`'d into the input tensors, and the op's outputs name
those same tensors, so the Executor's write-back is a no-op for them.
Each rule declares which input it updates for which output (`inplace`):
where an output names another var (gradient merge's gated update,
parallel/transforms.py), the executor hands the rule a copy of that
input. The
shared beta-pow pair advances in a separate `scale` op
(optimizer.py `_finalize_optimize_ops`).
"""
from __future__ import annotations

import torch

from .registry import register
from .sparse_grad import is_selected_rows, merge_rows, writer_slots

_OPT = dict(nondiff_slots=("Param", "Grad", "LearningRate", "Moment",
                           "Moment1", "Moment2", "Beta1Pow", "Beta2Pow",
                           "Velocity", "MeanSquare", "MeanGrad", "InfNorm",
                           "AvgSquaredGrad", "AvgSquaredUpdate",
                           "SquaredAccumulator", "LinearAccumulator"),
            # output slot -> the input slot whose tensor the rule updates
            inplace={"ParamOut": "Param", "VelocityOut": "Velocity",
                     "MomentOut": "Moment", "Moment1Out": "Moment1",
                     "Moment2Out": "Moment2", "InfNormOut": "InfNorm",
                     "MeanSquareOut": "MeanSquare",
                     "MeanGradOut": "MeanGrad",
                     "AvgSquaredGradOut": "AvgSquaredGrad",
                     "AvgSquaredUpdateOut": "AvgSquaredUpdate",
                     "SquaredAccumOut": "SquaredAccumulator",
                     "LinearAccumOut": "LinearAccumulator"})


def _update(ins, outs):
    """Copy each computed value into its input tensor (in place) and
    return the op's outputs naming those tensors. `outs` maps an output
    slot to (input slot, value)."""
    res = {}
    with torch.no_grad():
        for out_slot, (in_slot, val) in outs.items():
            t = ins[in_slot][0]
            t.copy_(val.to(t.dtype))
            res[out_slot] = [t]
    return res


def _check_dense(op_type, g):
    if not isinstance(g, torch.Tensor) or g.layout != torch.strided:
        raise NotImplementedError(
            f"{op_type}: a SelectedRows (row-sparse) gradient has no update "
            f"rule here, as in the reference: sgd, momentum, adam, adamw "
            f"and adagrad take one")


def _merged(g, p):
    """(ids, rows, writers) of the SelectedRows gradient `g` of `p`: the
    merged ids (int64), their summed rows and each slot's writer slot."""
    sr = merge_rows(g, p.shape[0])
    return sr.ids, sr.rows, writer_slots(sr.ids)


def _set_rows(t, ids, vals, writers):
    """t[ids] = vals in place, each padding slot writing its real slot's
    value (ops/sparse_grad.py)."""
    t.index_put_((ids,), vals[writers].to(t.dtype))


def adam_lr_t(lr, b1p, b2p):
    """Adam's bias-corrected step size on the [1] tensors (the reference's
    scalar prologue, `zero_update.py:187`)."""
    return lr * torch.sqrt(1 - b2p) / (1 - b1p)


@register("sgd", **_OPT)
def _sgd(ctx, ins, attrs):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    if is_selected_rows(g):
        # each row's step added in the ids' order, duplicates too (:25)
        with torch.no_grad():
            upd = (-lr.to(p.dtype)) * g.rows.to(p.dtype)
            p.index_put_((g.ids.reshape(-1).long(),), upd, accumulate=True)
        return {"ParamOut": [p]}
    _check_dense("sgd", g)
    with torch.no_grad():
        p.copy_(p - lr.to(p.dtype) * g.to(p.dtype))
    return {"ParamOut": [p]}


@register("momentum", **_OPT)
def _momentum(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    v, lr = ins["Velocity"][0], ins["LearningRate"][0]
    mu = attrs.get("mu", 0.9)
    rd = attrs.get("regularization_coeff", 0.0)
    if is_selected_rows(g):
        # merged rows only (:39)
        ids, gr, w = _merged(g, p)
        with torch.no_grad():
            gr = gr.to(v.dtype)
            if attrs.get("regularization_method", "") == "l2_decay" and rd:
                gr = gr + rd * p[ids].to(v.dtype)
            v_rows = mu * v[ids] + gr
            if attrs.get("use_nesterov", False):
                upd = lr * (gr + mu * v_rows)
            else:
                upd = lr * v_rows
            _set_rows(p, ids, p[ids] - upd.to(p.dtype), w)
            _set_rows(v, ids, v_rows, w)
        return {"ParamOut": [p], "VelocityOut": [v]}
    _check_dense("momentum", g)
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
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    if is_selected_rows(g):
        return _sparse_adam(ins, g, b1, b2, eps, decay_coeff)
    _check_dense(op_type, g)
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


def _sparse_adam(ins, g, b1, b2, eps, decay_coeff):
    """Adam's lazy rows (:92): moments and parameter at the merged ids
    only; AdamW's decay of those rows, after their update (:128)."""
    p, lr = ins["Param"][0], ins["LearningRate"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    ids, gr, w = _merged(g, p)
    with torch.no_grad():
        gf = gr.to(m1.dtype)
        m1_rows = b1 * m1[ids] + (1 - b1) * gf
        m2_rows = b2 * m2[ids] + (1 - b2) * (gf * gf)
        lr_t = adam_lr_t(lr, ins["Beta1Pow"][0], ins["Beta2Pow"][0])
        p_rows = p[ids] - (lr_t * m1_rows
                           / (torch.sqrt(m2_rows) + eps)).to(p.dtype)
        if decay_coeff is not None:
            p_rows = p_rows - (lr * decay_coeff * p_rows).to(p.dtype)
        _set_rows(p, ids, p_rows, w)
        _set_rows(m1, ids, m1_rows, w)
        _set_rows(m2, ids, m2_rows, w)
    return {"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2]}


@register("adam", **_OPT)
def _adam(ctx, ins, attrs):
    return _adam_update("adam", ins, attrs)


@register("adamw", **_OPT)
def _adamw(ctx, ins, attrs):
    coeff = attrs.get("coeff", 0.01) if attrs.get("with_decay", True) \
        else None
    return _adam_update("adamw", ins, attrs, decay_coeff=coeff)


@register("lars_momentum", **_OPT)
def _lars_momentum(ctx, ins, attrs):
    """Layer-wise trust-ratio scaled LR (reference :66)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    v, lr = ins["Velocity"][0], ins["LearningRate"][0]
    _check_dense("lars_momentum", g)
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    decay = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 0.0)
    with torch.no_grad():
        p_norm = torch.sqrt(torch.sum(torch.square(p)))
        g_norm = torch.sqrt(torch.sum(torch.square(g)))
        local_lr = lr * coeff * p_norm / (g_norm + decay * p_norm + eps)
        v_out = mu * v + local_lr * (g + decay * p)
        p_out = p - v_out
    return _update(ins, {"ParamOut": ("Param", p_out),
                         "VelocityOut": ("Velocity", v_out)})


@register("adamax", **_OPT)
def _adamax(ctx, ins, attrs):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    m, u = ins["Moment"][0], ins["InfNorm"][0]
    b1p = ins["Beta1Pow"][0]
    _check_dense("adamax", g)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    with torch.no_grad():
        m_out = b1 * m + (1 - b1) * g
        u_out = torch.maximum(b2 * u, torch.abs(g))
        p_out = p - (lr / (1 - b1p)) * m_out / (u_out + eps)
    return _update(ins, {"ParamOut": ("Param", p_out),
                         "MomentOut": ("Moment", m_out),
                         "InfNormOut": ("InfNorm", u_out)})


@register("adagrad", **_OPT)
def _adagrad(ctx, ins, attrs):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    m = ins["Moment"][0]
    eps = attrs.get("epsilon", 1e-6)
    if is_selected_rows(g):
        # merged rows only (:161)
        ids, gr, w = _merged(g, p)
        with torch.no_grad():
            gr = gr.to(m.dtype)
            m_rows = m[ids] + torch.square(gr)
            upd = (lr * gr / (torch.sqrt(m_rows) + eps)).to(p.dtype)
            _set_rows(p, ids, p[ids] - upd, w)
            _set_rows(m, ids, m_rows, w)
        return {"ParamOut": [p], "MomentOut": [m]}
    _check_dense("adagrad", g)
    with torch.no_grad():
        m_out = m + torch.square(g)
        p_out = p - lr * g / (torch.sqrt(m_out) + eps)
    return _update(ins, {"ParamOut": ("Param", p_out),
                         "MomentOut": ("Moment", m_out)})


@register("adadelta", **_OPT)
def _adadelta(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    avg_sq_g = ins["AvgSquaredGrad"][0]
    avg_sq_u = ins["AvgSquaredUpdate"][0]
    _check_dense("adadelta", g)
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    with torch.no_grad():
        g2 = rho * avg_sq_g + (1 - rho) * torch.square(g)
        upd = torch.sqrt(avg_sq_u + eps) / torch.sqrt(g2 + eps) * g
        u2 = rho * avg_sq_u + (1 - rho) * torch.square(upd)
        p_out = p - upd
    return _update(ins, {"ParamOut": ("Param", p_out),
                         "AvgSquaredGradOut": ("AvgSquaredGrad", g2),
                         "AvgSquaredUpdateOut": ("AvgSquaredUpdate", u2)})


@register("rmsprop", **_OPT)
def _rmsprop(ctx, ins, attrs):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    _check_dense("rmsprop", g)
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mu = attrs.get("momentum", 0.0)
    with torch.no_grad():
        ms_out = rho * ms + (1 - rho) * torch.square(g)
        if attrs.get("centered", False):
            mg = ins["MeanGrad"][0]
            mg_out = rho * mg + (1 - rho) * g
            denom = torch.sqrt(ms_out - torch.square(mg_out) + eps)
        else:
            mg_out = torch.zeros_like(g)
            denom = torch.sqrt(ms_out + eps)
        mom_out = mu * mom + lr * g / denom
        p_out = p - mom_out
    outs = {"ParamOut": ("Param", p_out),
            "MeanSquareOut": ("MeanSquare", ms_out),
            "MomentOut": ("Moment", mom_out)}
    if ins.get("MeanGrad"):
        outs["MeanGradOut"] = ("MeanGrad", mg_out)
    return _update(ins, outs)


@register("lamb", **_OPT)
def _lamb(ctx, ins, attrs):
    """Adam update scaled by the trust ratio ||p|| / ||r|| (reference
    :219). The shared beta pows advance in their own `scale` ops."""
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    _check_dense("lamb", g)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    with torch.no_grad():
        m1_out = b1 * m1 + (1 - b1) * g
        m2_out = b2 * m2 + (1 - b2) * torch.square(g)
        m1_hat = m1_out / (1 - b1p)
        m2_hat = m2_out / (1 - b2p)
        r = m1_hat / (torch.sqrt(m2_hat) + eps) + wd * p
        p_norm = torch.sqrt(torch.sum(torch.square(p)))
        r_norm = torch.sqrt(torch.sum(torch.square(r)))
        trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                            torch.ones_like(p_norm))
        p_out = p - lr * trust * r
    return _update(ins, {"ParamOut": ("Param", p_out),
                         "Moment1Out": ("Moment1", m1_out),
                         "Moment2Out": ("Moment2", m2_out)})


@register("ftrl", **_OPT)
def _ftrl(ctx, ins, attrs):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    _check_dense("ftrl", g)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    with torch.no_grad():
        new_sq = sq + torch.square(g)
        sigma = (new_sq ** (-power) - sq ** (-power)) / lr
        new_lin = lin + g - sigma * p
        pre = torch.clamp(new_lin, -l1, l1) - new_lin
        denom = new_sq ** (-power) / lr + 2 * l2
        p_out = pre / denom
    return _update(ins, {"ParamOut": ("Param", p_out),
                         "SquaredAccumOut": ("SquaredAccumulator", new_sq),
                         "LinearAccumOut": ("LinearAccumulator", new_lin)})


@register("decayed_adagrad", **_OPT)
def _decayed_adagrad(ctx, ins, attrs):
    p, g, lr = ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0]
    m = ins["Moment"][0]
    _check_dense("decayed_adagrad", g)
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    with torch.no_grad():
        m_out = decay * m + (1 - decay) * torch.square(g)
        p_out = p - lr * g / (torch.sqrt(m_out) + eps)
    return _update(ins, {"ParamOut": ("Param", p_out),
                         "MomentOut": ("Moment", m_out)})
