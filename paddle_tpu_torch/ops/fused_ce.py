"""Vocab-chunked LM-head cross-entropy `fused_lm_head_ce` (counterpart of
paddle_tpu/ops/fused_ce.py:63-170).

Per-token CE of the logits `x @ w^T (+ bias)` against `labels`, without
materialising the [B, S, V] logits: a Python loop over vocab chunks keeps
an online logsumexp (flash attention's trick applied to the classifier),
and the backward recomputes each chunk's logits instead of saving them.

The logits GEMM (forward and backward recompute) takes x and w in the
dtype they arrive in and accumulates and returns f32, as the reference's
einsum with `preferred_element_type=f32` does (`_logits_mm`): under AMP
that is a bf16 x bf16 cuBLAS GEMM with f32 output (`torch.mm(...,
out_dtype=torch.float32)`); f32 operands, and every CPU call, take f32
copies (bf16 products are exact in f32, so both give the same products).
The dx and dw GEMMs are f32, as in the reference. These are plain library
products, as the reference leaves them to XLA; there is no TPU kernel
here. A ragged final chunk simply has fewer columns, where the reference
pads it with -inf logits: the sums are the same.

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


def _logits_mm(a, w_c):
    """f32 logits a [N, H] @ w_c [C, H]^T, from the operands in the dtype
    they arrive in. Two bf16 (or f16) operands off the CPU (on CUDA, a
    cuBLAS GEMM): one GEMM with f32 accumulation and output. Otherwise f32
    copies: f32 operands stay f32, and the CPU keeps f32 math."""
    if a.device.type != "cpu" and a.dtype == w_c.dtype \
            and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, w_c.t(), out_dtype=torch.float32)
    return torch.mm(a.float(), w_c.float().t())


def _chunk_logits(x2, w, b, c0, chunk):
    """f32 logits of vocab rows [c0, c0 + chunk) for x2 [N, H]: [N, C]."""
    return _logits_mm(x2, w[c0:c0 + chunk]) + b[c0:c0 + chunk].float()


def _fwd_scan(x, w, b, labels, chunk, ignore_index):
    """(loss [B, S, 1], lse [N]) with N = B·S tokens."""
    v = w.shape[0]
    x2, lab2 = x.reshape(-1, x.shape[-1]), labels.reshape(-1)
    m = torch.full(lab2.shape, float("-inf"), device=x.device)
    ssum = torch.zeros(lab2.shape, device=x.device)
    lab = torch.zeros(lab2.shape, device=x.device)
    for c0 in range(0, v, chunk):
        l_c = _chunk_logits(x2, w, b, c0, chunk)
        m_new = torch.maximum(m, l_c.amax(-1))
        ssum = ssum * torch.exp(m - m_new) \
            + torch.exp(l_c - m_new.unsqueeze(-1)).sum(-1)
        m = m_new
        width = l_c.shape[-1]
        in_chunk = (lab2 >= c0) & (lab2 < c0 + width)
        off = (lab2 - c0).clamp(0, width - 1)
        picked = torch.take_along_dim(l_c, off.unsqueeze(-1), dim=-1)[..., 0]
        lab = torch.where(in_chunk, picked, lab)
    lse = m + torch.log(ssum)
    ignored, valid = _token_grade(lab2, v, ignore_index)
    nan = torch.full((), float("nan"), device=x.device)
    loss = torch.where(valid, lse - lab, nan)
    loss = torch.where(ignored, torch.zeros((), device=x.device), loss)
    return loss.reshape(labels.shape).unsqueeze(-1), lse


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
        x2, lab2 = x.reshape(-1, x.shape[-1]), labels.reshape(-1)
        gf = g.reshape(-1).float()
        ignored, valid = _token_grade(lab2, v, ctx.ignore_index)
        gf = torch.where(valid, gf, torch.full((), float("nan"),
                                               device=x.device))
        gf = torch.where(ignored, torch.zeros((), device=x.device), gf)
        xf = x2.float()
        dx = torch.zeros(xf.shape, device=x.device)
        dw = torch.empty(w.shape, dtype=torch.float32, device=x.device)
        db = torch.empty(b.shape, dtype=torch.float32, device=x.device)
        for c0 in range(0, v, chunk):
            l_c = _chunk_logits(x2, w, b, c0, chunk)
            width = l_c.shape[-1]
            dl = torch.exp(l_c - lse.unsqueeze(-1)) * gf.unsqueeze(-1)
            in_chunk = (lab2 >= c0) & (lab2 < c0 + width)
            off = (lab2 - c0).clamp(0, width - 1)
            dl.scatter_add_(-1, off.unsqueeze(-1),
                            torch.where(in_chunk, -gf, torch.zeros_like(gf))
                            .unsqueeze(-1))
            # dx and dw in f32, as the reference's (`_ce_bwd`)
            dx = dx + torch.mm(dl, w[c0:c0 + width].float())
            dw[c0:c0 + width] = torch.mm(dl.t(), xf)
            db[c0:c0 + width] = dl.sum(0)
        return (dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype),
                db.to(b.dtype), None, None, None)


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
    if getattr(ctx, "mesh", None) is not None:
        return {"Loss": [_mesh_ce(x, w, bias, labels, chunk, ignore_index)]}
    loss, _ = ChunkedLMCE.apply(x, w, bias, labels, chunk, ignore_index)
    return {"Loss": [loss.float()]}


def _mesh_ce(x, w, bias, labels, chunk, ignore_index):
    """The op on a tp/sp mesh (parallel/gspmd.py): a vocab-sharded `w` (and
    bias) is gathered ONCE for the op, not once per chunk as the sharded
    slices of the scan would make DTensor do, and the scan runs on the
    local tokens. The gradients of `w` and the bias go back to their
    shards (the gather's backward); where the tokens are sharded over a
    mesh dim (the batch over dp, the sequence over sp), theirs are partial
    sums over it. The
    same function as the dense head; a vocab-parallel head is later work
    (ROADMAP item 16)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from ..parallel import gspmd
    xd = x if gspmd.is_dtensor(x) else None
    mesh = (xd if xd is not None else w).device_mesh
    rep = [Replicate()] * mesh.ndim

    def as_dt(t):
        return t if gspmd.is_dtensor(t) else DTensor.from_local(
            t, mesh, rep, run_check=False)

    x, w, bias, labels = (as_dt(t) for t in (x, w, bias, labels))
    x = gspmd.settled(x)
    w, bias = (t.redistribute(mesh, rep) for t in (w, bias))
    labels = labels.redistribute(mesh, x.placements)
    red = [Partial() if isinstance(p, Shard) else Replicate()
           for p in x.placements]

    def body(x, w, b, lab):
        return ChunkedLMCE.apply(x, w, b, lab, chunk, ignore_index)[0]

    # the rows may be sharded unevenly (the shifted [0, S-1) rows of a
    # sequence-sharded activation): the loss is [*labels' shape, 1]
    loss = gspmd.local_call(body, (x, w, bias, labels), [x.placements],
                            grad_placements=[None, red, red, None],
                            shapes=[tuple(labels.shape) + (1,)])
    return loss.float()
