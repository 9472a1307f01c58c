"""fleet on one process (counterpart of paddle_tpu/distributed/fleet/base.py).

`init(is_collective=True)`, a `DistributedStrategy`, and
`distributed_optimizer`, whose `minimize` marks the program for AMP as the
reference does (`base.py:374-379`), delegates to the inner optimizer, then
applies gradient bucketing and the ZeRO stage (`base.py:460-516`,
parallel/zero.py): whenever `fuse_grad_size_in_mb` > 0, at every stage.
This is the entry point `bench.py:bench_bert` uses.

Honoured: `amp`, `amp_configs`, `fuse_grad_size_in_mb`, `sharding`,
`sharding_stage`, `sharding_configs` (`stage`, `fuse_grad_size_in_mb`) and
`FLAGS_zero_stage`. Any other strategy field set away from its default
raises: meshes, recompute, layer scan, gradient merge, pipelines, LocalSGD
and PS mode are not ported.
"""
from __future__ import annotations

__all__ = ["init", "DistributedStrategy", "distributed_optimizer", "fleet"]

_DEFAULTS = {
    "amp": False,
    "amp_configs": {"init_loss_scaling": 32768.0, "use_pure_bf16": True},
    "recompute": False, "recompute_configs": {"checkpoints": []},
    "layer_scan": False, "layer_scan_configs": {"segments": []},
    "gradient_merge": False, "gradient_merge_configs": {"k_steps": 1},
    "localsgd": False, "localsgd_configs": {"k_steps": 1},
    "dgc": False, "fp16_allreduce": False, "lars": False, "lars_configs": {},
    "lamb": False, "lamb_configs": {}, "pipeline": False,
    "pipeline_configs": {"micro_batch_size": 1, "accumulate_steps": 1},
    "sharding": False, "sharding_stage": 0, "sharding_configs": {},
    "fuse_grad_size_in_mb": 32, "tensor_parallel_degree": 1,
    "pipeline_parallel_degree": 1, "sequence_parallel_degree": 1,
    "expert_parallel_degree": 1, "tensor_parallel_rules": None,
    "nccl_comm_num": 1, "use_hierarchical_allreduce": False,
    "sync_batch_norm": False, "execution_strategy": {},
    "build_strategy": {}, "a_sync": False, "a_sync_configs": {},
    "sparse_cache_rows": 0,
}
_HONOURED = {"amp", "amp_configs", "fuse_grad_size_in_mb", "sharding",
             "sharding_stage", "sharding_configs"}


class DistributedStrategy:
    """The reference's strategy fields, with their defaults. Only AMP,
    bucketing and ZeRO fields act here; see the module docstring."""

    def __init__(self):
        for k, v in _DEFAULTS.items():
            object.__setattr__(self, k, v.copy() if isinstance(v, dict)
                               else v)

    def __setattr__(self, name, value):
        if name not in _DEFAULTS:
            raise AttributeError(
                f"unknown DistributedStrategy attribute {name!r}; known "
                f"attributes: {sorted(_DEFAULTS)}")
        if name not in _HONOURED and value != _DEFAULTS[name]:
            raise NotImplementedError(
                f"DistributedStrategy.{name} is not ported yet: the port's "
                f"fleet runs one process and honours only {sorted(_HONOURED)}")
        object.__setattr__(self, name, value)


class _Fleet:
    def __init__(self):
        self._strategy = None

    def init(self, role_maker=None, is_collective=True, strategy=None):
        if role_maker is not None or not is_collective:
            raise NotImplementedError(
                "fleet.init: only is_collective=True on one process is "
                "ported")
        self._strategy = strategy or DistributedStrategy()
        return self

    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is not None:
            self._strategy = strategy
        return DistributedOptimizer(optimizer,
                                    self._strategy or DistributedStrategy())


class DistributedOptimizer:
    def __init__(self, inner_opt, strategy: DistributedStrategy):
        self.inner_opt = inner_opt
        self.user_defined_strategy = strategy

    def __getattr__(self, item):
        return getattr(self.inner_opt, item)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        s = self.user_defined_strategy
        program = loss.block.program
        if s.amp:
            program._amp = True
            program._amp_dtype = ("bfloat16"
                                  if s.amp_configs.get("use_pure_bf16", True)
                                  else "float16")
            program.bump_version()
        result = self.inner_opt.minimize(loss, startup_program,
                                         parameter_list, no_grad_set)

        from ...flags import flag
        zero_stage = int(s.sharding_stage or 0)
        if s.sharding:
            zero_stage = max(zero_stage,
                             int((s.sharding_configs or {}).get("stage", 1)))
        if flag("FLAGS_zero_stage"):
            zero_stage = max(zero_stage, int(flag("FLAGS_zero_stage")))
        if zero_stage not in (0, 1, 2, 3):
            raise ValueError(
                f"sharding stage {zero_stage} is not supported: this build "
                "implements ZeRO stages 1 (optimizer state), 2 (+resident "
                "gradient shards) and 3 (+parameter storage) — "
                "parallel/zero.py; set strategy.sharding_stage to 1, 2 "
                "or 3")
        if zero_stage >= 3 and s.tensor_parallel_degree > 1:
            raise ValueError(
                "sharding_stage=3 flat-shards parameter STORAGE over dp and "
                "cannot compose with tensor_parallel_rules in this build "
                "(the TP rules would shard the same storage a second way); "
                "use stage <= 2 with tensor parallelism")
        bucket_mb = float((s.sharding_configs or {}).get(
            "fuse_grad_size_in_mb", s.fuse_grad_size_in_mb))
        if bucket_mb > 0:
            from ...framework.program import default_startup_program
            from ...parallel.zero import apply_grad_bucketing
            apply_grad_bucketing(
                program, startup_program or default_startup_program(),
                result[1], bucket_bytes=int(bucket_mb * (1 << 20)),
                stage=zero_stage)
        elif zero_stage >= 1:
            from ...parallel.zero import count_fallback
            count_fallback("bucketing_disabled")
        return result


fleet = _Fleet()
init = fleet.init
distributed_optimizer = fleet.distributed_optimizer
