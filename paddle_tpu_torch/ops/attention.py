"""Fused attention op (counterpart of paddle_tpu/ops/attention.py:174).

On CUDA tensors the lowering always launches the port's flash kernels
B1-B3 (ops/kernels/flash_attention.py, csrc/flash_attention.cu), at every
sequence length they take; shapes they cannot take raise. There is no
dense path on the card. The reference's `S >= 512` gate (`_use_pallas`)
was a TPU A/B result and is dropped on purpose, as are its compile probe
and silent fallback (`_flash_probe`, `prewarm_flash`, the `except` around
the kernel call). On CPU tensors the same wrapper runs its plain version.
"""
from __future__ import annotations

import math

from .kernels.flash_attention import flash_attention
from .registry import register


@register("fused_attention", is_random=True, nondiff_slots=("Mask",))
def _fused_attention(ctx, ins, attrs):
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    mask = ins["Mask"][0] if ins.get("Mask") else None
    scale = attrs.get("scale", 1.0 / math.sqrt(q.shape[-1]))
    dropout = attrs.get("dropout", 0.0)
    if attrs.get("is_test", False):
        dropout = 0.0
    if attrs.get("sequence_parallel"):
        raise NotImplementedError(
            "fused_attention sequence_parallel (ring / Ulysses attention) "
            "is not ported yet: slice 3 (ROADMAP)")
    seed = ctx.int32_seed(attrs) if dropout else None
    return {"Out": [flash_attention(q, k, v, scale=scale,
                                    causal=attrs.get("causal", False),
                                    dropout=dropout, seed=seed, mask=mask)]}
