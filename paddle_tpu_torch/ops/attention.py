"""Fused attention op (counterpart of paddle_tpu/ops/attention.py:174).

On CUDA tensors the lowering always launches the port's flash kernels
B1-B3 (ops/kernels/flash_attention.py, csrc/flash_attention.cu), at every
sequence length they take; shapes they cannot take raise. There is no
dense path on the card. The reference's `S >= 512` gate (`_use_pallas`)
was a TPU A/B result and is dropped on purpose, as are its compile probe
and silent fallback (`_flash_probe`, `prewarm_flash`, the `except` around
the kernel call). On CPU tensors the same wrapper runs its plain version.

On a tp/sp mesh (a step on DTensors, parallel/gspmd.py; `ctx.mesh`):

* sp > 1 with `sequence_parallel`: `ring_attention`, or
  `ulysses_attention` when `sp_mode == "ulysses"`
  (parallel/ring_attention.py), as the reference dispatches; the output
  stays sharded over sp along the sequence (the reference's `out_specs`),
  so the rest of the layer runs on this rank's rows.
* otherwise: Q, K and V are laid out with the batch over dp, the heads
  over tp and the sequence whole, and B1-B3 run on this rank's heads
  (`local_call`), the dropout keyed on the global heads (`keying`), so
  the mask is the unsharded launch's. Only key-padding masks are taken
  there.
"""
from __future__ import annotations

import math

from .kernels.flash_attention import flash_attention
from .registry import register


def _mesh_attention(ctx, q, k, v, mask, scale, causal, dropout, seed,
                    attrs):
    import importlib
    from ..parallel import gspmd
    # the module (the package exports its function under the same name)
    ra = importlib.import_module("paddle_tpu_torch.parallel.ring_attention")
    mesh = ctx.mesh
    if attrs.get("sequence_parallel") and mesh.shape.get("sp", 1) > 1:
        fn = (ra.ulysses_attention if attrs.get("sp_mode") == "ulysses"
              else ra.ring_attention)
        # the output stays sharded over sp along the sequence, as the
        # reference's out_specs leave it: the rest of the layer runs on
        # this rank's rows (ops/math_ops.py `_mesh_mm` for its products)
        return fn(q, k, v, mesh=mesh, scale=scale, causal=causal, mask=mask,
                  dropout=dropout, seed=seed)
    # the sequence stays whole on every rank of an sp axis here
    q, k, v, mask, mesh, scale, pl = ra._prepare(
        q, k, v, mask, mesh, scale, dropout, seed, None)
    b_l, nh_l = q.to_local().shape[:2]
    keying = ra._keying(mesh, b_l, nh_l)

    def body(q, k, v, mask):
        return flash_attention(q, k, v, scale=scale, causal=causal,
                               dropout=dropout, seed=seed, mask=mask,
                               keying=keying)

    return gspmd.local_call(body, (q, k, v, mask), [pl])


@register("fused_attention", is_random=True, nondiff_slots=("Mask",))
def _fused_attention(ctx, ins, attrs):
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    mask = ins["Mask"][0] if ins.get("Mask") else None
    scale = attrs.get("scale", 1.0 / math.sqrt(q.shape[-1]))
    dropout = attrs.get("dropout", 0.0)
    if attrs.get("is_test", False):
        dropout = 0.0
    seed = ctx.op_seed(attrs) if dropout else None
    causal = attrs.get("causal", False)
    if getattr(ctx, "mesh", None) is not None:
        return {"Out": [_mesh_attention(ctx, q, k, v, mask, scale, causal,
                                        dropout, seed, attrs)]}
    # `sequence_parallel` off an sp mesh is the plain launch, as in the
    # reference
    return {"Out": [flash_attention(q, k, v, scale=scale, causal=causal,
                                    dropout=dropout, seed=seed, mask=mask)]}
