"""Vocab-chunked LM-head cross-entropy `fused_lm_head_ce` (counterpart of
paddle_tpu/ops/fused_ce.py:63-170).

Per-token CE of the logits `x @ w^T (+ bias)` against `labels`, without
materialising the [B, S, V] logits: a Python loop over vocab chunks keeps
an online logsumexp (flash attention's trick applied to the classifier),
and the backward recomputes each chunk's logits instead of saving them.
Each chunk's logits are computed in f32 from the operands (bf16 operands
under AMP are exact in f32), as the reference's einsums accumulate in f32
with `preferred_element_type`. The [B*S, H] x [H, C] products are plain
`torch.matmul`, as the reference leaves them to XLA; there is no TPU
kernel here. A ragged final chunk simply has fewer columns, where the
reference pads it with -inf logits: the sums are the same.

Label contract, as in the reference: `ignore_index` tokens contribute zero
loss and zero grads; any other label outside [0, V) gives NaN for that
token, in the loss and in the gradients.
"""
from __future__ import annotations

import torch

from .registry import register

DEFAULT_CHUNK = 8192


def _token_grade(labels, v, ignore_index):
    ignored = labels == ignore_index
    valid = (labels >= 0) & (labels < v) & ~ignored
    return ignored, valid


def _chunk_logits(xf, w, b, c0, chunk):
    """f32 logits of vocab rows [c0, c0 + chunk): [B, S, C]."""
    return torch.matmul(xf, w[c0:c0 + chunk].float().t()) \
        + b[c0:c0 + chunk].float()


def _fwd_scan(x, w, b, labels, chunk, ignore_index):
    v = w.shape[0]
    xf = x.float()
    m = torch.full(labels.shape, float("-inf"), device=x.device)
    ssum = torch.zeros(labels.shape, device=x.device)
    lab = torch.zeros(labels.shape, device=x.device)
    for c0 in range(0, v, chunk):
        l_c = _chunk_logits(xf, w, b, c0, chunk)
        m_new = torch.maximum(m, l_c.amax(-1))
        ssum = ssum * torch.exp(m - m_new) \
            + torch.exp(l_c - m_new.unsqueeze(-1)).sum(-1)
        m = m_new
        width = l_c.shape[-1]
        in_chunk = (labels >= c0) & (labels < c0 + width)
        off = (labels - c0).clamp(0, width - 1)
        picked = torch.take_along_dim(l_c, off.unsqueeze(-1), dim=-1)[..., 0]
        lab = torch.where(in_chunk, picked, lab)
    lse = m + torch.log(ssum)
    ignored, valid = _token_grade(labels, v, ignore_index)
    nan = torch.full((), float("nan"), device=x.device)
    loss = torch.where(valid, lse - lab, nan)
    loss = torch.where(ignored, torch.zeros((), device=x.device), loss)
    return loss.unsqueeze(-1), lse


class ChunkedLMCE(torch.autograd.Function):
    """(x [B,S,H], w [V,H], b [V], labels [B,S] int) -> loss [B,S,1] f32.
    The backward recomputes each chunk (`setup_context` style, so that
    torch.func.vjp can trace it)."""

    @staticmethod
    def forward(x, w, b, labels, chunk, ignore_index):
        return _fwd_scan(x, w, b, labels, chunk, ignore_index)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, b, labels, chunk, ignore_index = inputs
        ctx.save_for_backward(x, w, b, labels, output[1])
        ctx.chunk, ctx.ignore_index = chunk, ignore_index
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, g, _g_lse):
        x, w, b, labels, lse = ctx.saved_tensors
        v, chunk = w.shape[0], ctx.chunk
        gf = g[..., 0].float()
        ignored, valid = _token_grade(labels, v, ctx.ignore_index)
        gf = torch.where(valid, gf, torch.full((), float("nan"),
                                               device=x.device))
        gf = torch.where(ignored, torch.zeros((), device=x.device), gf)
        xf = x.float()
        dx = torch.zeros(xf.shape, device=x.device)
        dw = torch.empty(w.shape, dtype=torch.float32, device=x.device)
        db = torch.empty(b.shape, dtype=torch.float32, device=x.device)
        for c0 in range(0, v, chunk):
            l_c = _chunk_logits(xf, w, b, c0, chunk)
            width = l_c.shape[-1]
            dl = torch.exp(l_c - lse.unsqueeze(-1)) * gf.unsqueeze(-1)
            in_chunk = (labels >= c0) & (labels < c0 + width)
            off = (labels - c0).clamp(0, width - 1)
            dl.scatter_add_(-1, off.unsqueeze(-1),
                            torch.where(in_chunk, -gf, torch.zeros_like(gf))
                            .unsqueeze(-1))
            dx = dx + torch.matmul(dl, w[c0:c0 + width].float())
            dw[c0:c0 + width] = torch.einsum("bsc,bsh->ch", dl, xf)
            db[c0:c0 + width] = dl.sum((0, 1))
        return (dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype), None, None,
                None)


@register("fused_lm_head_ce", nondiff_slots=("Label",))
def _fused_lm_head_ce(ctx, ins, attrs):
    x, w, label = ins["X"][0], ins["W"][0], ins["Label"][0]
    bias = (ins.get("Bias") or [None])[0]
    if attrs.get("w_layout", "vh") == "hv":          # fc-style [H, V]
        w = w.t()
    chunk = int(attrs.get("chunk") or DEFAULT_CHUNK)
    labels = label.long()
    if labels.dim() == x.dim():                      # [B, S, 1] -> [B, S]
        labels = labels[..., 0]
    chunk = min(chunk, max(int(w.shape[0]), 1))
    if bias is None:
        bias = torch.zeros((w.shape[0],), dtype=x.dtype, device=x.device)
    ignore_index = int(attrs.get("ignore_index", -100))
    loss, _ = ChunkedLMCE.apply(x, w, bias, labels, chunk, ignore_index)
    return {"Loss": [loss.float()]}
