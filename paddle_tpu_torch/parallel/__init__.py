"""Parallel training for the port: gradient bucketing and ZeRO stages 0-3,
on one process and across processes (`zero`), the dp x tp x sp mesh and
its sharding rules (`mesh`, `spmd`), a program on DTensors over a tp/sp
mesh (`gspmd`), ring and Ulysses attention (`ring_attention`), the
pipeline runner (`pipeline`), and the program transforms: layer scan,
recompute, gradient merge (`transforms`)."""
from .mesh import ShardingRules, transformer_tp_rules
from .ring_attention import ring_attention, ulysses_attention

__all__ = ["ShardingRules", "transformer_tp_rules", "ring_attention",
           "ulysses_attention"]
