"""PyTorch/CUDA port of paddle_tpu, written for an NVIDIA H100 (sm_90a).

The JAX package `paddle_tpu` stays beside this one as the reference; this
package imports `torch`, numpy and the standard library only. Module paths
mirror the reference's so each counterpart is easy to find
(`paddle_tpu_torch.serving.engine` <-> `paddle_tpu.serving.engine`).

Entry points run on `cuda` unless the caller passes `device="cpu"` (see
`device.resolve_device`): serving (`serving.DecodeEngine`,
`models.gpt_decode.generate`), training (`framework.Executor` over a
program that `models.bert.build_pretrain_program` and
`optimizer.Adam.minimize` build), and the kernels' wrappers
(`ops.kernels.paged_attention.fused_paged_attention`,
`ops.kernels.flash_attention.flash_attention`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
