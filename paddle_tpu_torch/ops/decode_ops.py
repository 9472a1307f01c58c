"""The linear-chain CRF and its Viterbi decoding (counterpart of
paddle_tpu/ops/decode_ops.py:26-124): `linear_chain_crf` and
`crf_decoding`. The file's other three types, `gather_tree`,
`beam_search` and `beam_search_decode`, go with serving's program path
(ROADMAP item 20).

Padded [b, T, C] emissions and a length vector stand for LoD, as in the
reference. The transition parameter has the reference's layout
(linear_chain_crf_op.h): row 0 the start weights, row 1 the stop weights,
rows 2.. the [C, C] matrix w[from, to].

* `linear_chain_crf` runs the forward algorithm as a Python loop of T - 1
  log-sum-exp steps; past a sequence's length alpha is carried unchanged,
  and the stop weight is taken at the label of position length - 1. Its
  gradient is the generic `__vjp__` (`torch.func.vjp` over the loop), as
  the reference's is `jax.vjp` over its scan: no hand-written Alpha /
  Beta backward. Alpha, EmissionExps and TransitionExps are filled as the
  reference fills them (exp of the raw emissions, which may overflow as
  the reference's does).
* `crf_decoding` keeps the first maximum of each max (`torch.argmax`,
  as `jnp.argmax`), so ties, which are real at initialisation, break the
  same way on any device; a backpointer past the length is -1 and the
  walk keeps the tag there. With Label the output is the 0/1 mask of the
  correct tags.
"""
from __future__ import annotations

import torch

from .dense_tail_ops import _lengths
from .registry import register


@register("linear_chain_crf", nondiff_slots=("Label", "SeqLen"))
def _linear_chain_crf(ctx, ins, attrs):
    """The negative log-likelihood of each sequence's label path [b, 1]:
    log Z by the forward algorithm minus the path's score (emissions,
    transitions, start and stop weights)."""
    em = ins["Emission"][0]               # [b, T, C]
    trans = ins["Transition"][0]          # [C + 2, C]
    b, T, C = em.shape
    dev = em.device
    lengths = _lengths(ins.get("SeqLen", [None])[0], b, T, dev)
    lbl = ins["Label"][0].reshape(b, T).long()
    start, stop, w = trans[0], trans[1], trans[2:]
    emf = em.float()
    valid = torch.arange(T, device=dev)[None, :] < lengths[:, None]

    alpha = start[None, :] + emf[:, 0]
    alphas = [alpha]
    for t in range(1, T):
        nxt = torch.logsumexp(alpha[:, :, None] + w[None], dim=1) + emf[:, t]
        alpha = torch.where(valid[:, t:t + 1], nxt, alpha)
        alphas.append(alpha)
    log_z = torch.logsumexp(alpha + stop[None, :], dim=1)

    rows = torch.arange(b, device=dev)[:, None]
    steps = torch.arange(T, device=dev)[None, :]
    em_score = torch.where(valid, emf[rows, steps, lbl], 0.0).sum(dim=1)
    tr_score = torch.where(valid[:, 1:], w[lbl[:, :-1], lbl[:, 1:]],
                           0.0).sum(dim=1)
    last = torch.clamp(lengths - 1, 0, T - 1)
    gold = em_score + tr_score + start[lbl[:, 0]] \
        + stop[lbl[rows[:, 0], last]]
    nll = (log_z - gold)[:, None]
    return {"LogLikelihood": [nll.to(em.dtype)],
            "Alpha": [torch.stack(alphas, dim=1)],
            "EmissionExps": [torch.exp(emf)],
            "TransitionExps": [torch.exp(trans.float())]}


@register("crf_decoding")
def _crf_decoding(ctx, ins, attrs):
    """Viterbi decoding [b, T] (int32; 0 past a length), or with Label
    the per-token 0/1 correctness of that path."""
    em = ins["Emission"][0]
    trans = ins["Transition"][0]
    label = ins.get("Label", [None])[0]
    b, T, C = em.shape
    dev = em.device
    lengths = _lengths(ins.get("SeqLen", [None])[0], b, T, dev)
    start, stop, w = trans[0], trans[1], trans[2:]
    emf = em.float()
    valid = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    minus_one = torch.full((), -1, dtype=torch.long, device=dev)

    v = start[None, :] + emf[:, 0]
    backps = []
    for t in range(1, T):
        cand = v[:, :, None] + w[None]                    # [b, from, to]
        arg = torch.argmax(cand, dim=1)                   # first maximum
        best = torch.amax(cand, dim=1) + emf[:, t]
        keep = valid[:, t:t + 1]
        v = torch.where(keep, best, v)
        backps.append(torch.where(keep, arg, minus_one))
    # v carries each sequence's last live step, so stop is added once
    tag = torch.argmax(v + stop[None, :], dim=1)          # [b]
    path = [tag]
    for bp in reversed(backps):
        prev = bp.gather(1, tag[:, None])[:, 0]
        tag = torch.where(prev >= 0, prev, tag)
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)                 # [b, T]
    zero = torch.zeros((), dtype=torch.long, device=dev)
    path = torch.where(valid, path, zero)
    if label is not None:
        lbl = label.reshape(b, T).long()
        path = torch.where(valid, (path == lbl).long(), zero)
    return {"ViterbiPath": [path.to(torch.int32)]}
