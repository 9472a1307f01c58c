"""Metric and AMP utility lowerings (counterpart of
paddle_tpu/ops/metric_ops.py): accuracy, streaming AUC, precision /
recall, and the loss-scaling pair. Counts are int32 and the AUC float32,
the reference's 32-bit device policy; every constant is a fill on the
device, so `accuracy` runs inside a captured step."""
from __future__ import annotations

import torch

from .registry import register


@register("accuracy", nondiff_slots=("Out", "Indices", "Label"))
def _accuracy(ctx, ins, attrs):
    """The share of rows whose top-k Indices hold the Label (reference
    metric_ops.py:15)."""
    indices = ins["Indices"][0].to(torch.int32)
    label = ins["Label"][0].to(torch.int32)
    col = label if label.dim() == indices.dim() else label.unsqueeze(-1)
    correct = (indices == col).any(dim=-1)
    num_correct = correct.float().sum()
    total = correct.numel()
    return {"Accuracy": [num_correct / float(total)],
            "Correct": [num_correct.to(torch.int32)],
            "Total": [torch.full((), total, dtype=torch.int32,
                                 device=indices.device)]}


@register("auc", nondiff_slots=("Predict", "Label", "StatPos", "StatNeg"))
def _auc(ctx, ins, attrs):
    """Streaming AUC over `num_thresholds` + 1 buckets of the positive
    class's probability; the counts accumulate in StatPos / StatNeg
    (reference metric_ops.py:37)."""
    pred = ins["Predict"][0]
    label = ins["Label"][0].reshape(-1)
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    nt = attrs.get("num_thresholds", 4095)
    prob = pred[:, -1] if pred.dim() == 2 else pred.reshape(-1)
    bucket = torch.clamp((prob * nt).to(torch.int32), 0, nt).long()
    is_pos = (label > 0).to(stat_pos.dtype)
    new_pos = stat_pos + torch.zeros_like(stat_pos).index_add(
        0, bucket, is_pos)
    new_neg = stat_neg + torch.zeros_like(stat_neg).index_add(
        0, bucket, 1 - is_pos)
    pos_rev = torch.cumsum(new_pos.flip(0), 0, dtype=new_pos.dtype)
    neg_rev = torch.cumsum(new_neg.flip(0), 0, dtype=new_neg.dtype)
    tot = pos_rev[-1].float() * neg_rev[-1].float()
    prev_pos = torch.cat([torch.zeros(1, dtype=pos_rev.dtype,
                                      device=pos_rev.device), pos_rev[:-1]])
    area = torch.sum((pos_rev + prev_pos) * new_neg.flip(0) / 2.0)
    auc = torch.where(tot > 0, area / tot, torch.zeros_like(area))
    return {"AUC": [auc.float()], "StatPosOut": [new_pos],
            "StatNegOut": [new_neg]}


@register("check_finite_and_unscale", nondiff_slots=("X", "Scale"))
def _check_finite_and_unscale(ctx, ins, attrs):
    """Gradients divided by the loss scale, and whether any value is not
    finite."""
    inv = 1.0 / ins["Scale"][0]
    found = None
    outs = []
    for x in ins["X"]:
        bad = ~torch.all(torch.isfinite(x))
        found = bad if found is None else found | bad
        outs.append((x.float() * inv).to(x.dtype))
    if found is None:
        found = torch.zeros((), dtype=torch.bool, device=inv.device)
    return {"Out": outs, "FoundInfinite": [found]}


@register("update_loss_scaling",
          nondiff_slots=("X", "FoundInfinite", "PrevLossScaling",
                         "InGoodSteps", "InBadSteps"))
def _update_loss_scaling(ctx, ins, attrs):
    """The dynamic loss scale's state machine; the gradients are zeroed
    on a step that overflowed."""
    found = ins["FoundInfinite"][0]
    scale = ins["PrevLossScaling"][0]
    good, bad = ins["InGoodSteps"][0], ins["InBadSteps"][0]
    zero_i = torch.zeros_like(bad)
    new_bad = torch.where(found, bad + 1, zero_i)
    new_good = torch.where(found, torch.zeros_like(good), good + 1)
    shrink = new_bad >= attrs.get("decr_every_n_nan_or_inf", 2)
    grow = new_good >= attrs.get("incr_every_n_steps", 1000)
    one = torch.ones_like(scale)
    new_scale = torch.where(
        shrink, torch.maximum(scale * attrs.get("decr_ratio", 0.5), one),
        torch.where(grow, scale * attrs.get("incr_ratio", 2.0), scale))
    new_bad = torch.where(shrink, zero_i, new_bad)
    new_good = torch.where(grow, torch.zeros_like(good), new_good)
    outs = [torch.where(found, torch.zeros_like(x), x) for x in ins["X"]]
    return {"Out": outs, "LossScaling": [new_scale],
            "OutGoodSteps": [new_good], "OutBadSteps": [new_bad]}


@register("precision_recall")
def _precision_recall(ctx, ins, attrs):
    """Per-class TP / FP / TN / FN of predicted Indices against Labels
    (optionally weighted), then [macro P, R, F1, micro P, R, F1] of the
    batch and of the states accumulated with StatesInfo (reference
    metric_ops.py:107)."""
    idx = ins["Indices"][0].reshape(-1).long()
    lbl = ins["Labels"][0].reshape(-1).long()
    weights = (ins.get("Weights") or [None])[0]
    states = (ins.get("StatesInfo") or [None])[0]
    c = attrs["class_number"]
    w = weights.reshape(-1).float() if weights is not None \
        else torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    cols = torch.arange(c, device=idx.device)
    onehot_i = (idx.unsqueeze(-1) == cols).float()
    onehot_l = (lbl.unsqueeze(-1) == cols).float()
    correct = (idx == lbl).float()
    tp = torch.sum(onehot_i * (correct * w).unsqueeze(-1), dim=0)
    fp = torch.sum(onehot_i * ((1 - correct) * w).unsqueeze(-1), dim=0)
    fn = torch.sum(onehot_l * ((1 - correct) * w).unsqueeze(-1), dim=0)
    tn = torch.sum(w) - tp - fp - fn
    batch = torch.stack([tp, fp, tn, fn], dim=1)

    def ratio(num, den, empty):
        return torch.where(den > 0, num / torch.clamp(den, min=1e-12),
                           torch.full_like(num, empty))

    def metrics(st):
        tp_, fp_, fn_ = st[:, 0], st[:, 1], st[:, 3]
        prec = ratio(tp_, tp_ + fp_, 1.0)
        rec = ratio(tp_, tp_ + fn_, 1.0)
        f1 = ratio(2 * prec * rec, prec + rec, 0.0)
        mtp, mfp, mfn = tp_.sum(), fp_.sum(), fn_.sum()
        mp = ratio(mtp, mtp + mfp, 1.0)
        mr = ratio(mtp, mtp + mfn, 1.0)
        mf = ratio(2 * mp * mr, mp + mr, 0.0)
        return torch.stack([prec.mean(), rec.mean(), f1.mean(), mp, mr, mf])

    accum = batch + states.float() if states is not None else batch
    return {"BatchMetrics": [metrics(batch)],
            "AccumMetrics": [metrics(accum)],
            "AccumStatesInfo": [accum]}
