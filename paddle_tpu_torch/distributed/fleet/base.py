"""fleet: role makers, DistributedStrategy, the fleet singleton and
`DistributedOptimizer.minimize` (counterpart of
paddle_tpu/distributed/fleet/base.py).

`init(is_collective=True)` reads the role from a role maker
(`PaddleCloudRoleMaker`, the env contract; or `UserDefinedRoleMaker`)
and, when the job has more than one worker, starts the process group
(distributed/parallel.py `init_parallel_env`) and builds the `dp` mesh
over it. `minimize` marks the program for AMP as the reference does
(`base.py:374-379`), delegates to the inner optimizer, then applies
gradient bucketing and the ZeRO stage (`base.py:460-516`,
parallel/zero.py) whenever `fuse_grad_size_in_mb` > 0, and records the
dp width in the program (`program._dp`). At dp > 1 the executor runs the
program as the reference's manual-dp path computes it (gradients averaged
per bucket, ZeRO state sharded over the ranks): a dp > 1 program with
`fuse_grad_size_in_mb` 0 raises, since it would train on each rank's
local gradients.

Honoured: `amp`, `amp_configs`, `fuse_grad_size_in_mb`, `sharding`,
`sharding_stage`, `sharding_configs` (`stage`, `fuse_grad_size_in_mb`) and
`FLAGS_zero_stage`. Any other strategy field set away from its default
raises: tensor, pipeline, sequence and expert parallelism, recompute,
layer scan and gradient merge are ROADMAP item 16; LocalSGD is what is
left of item 15.1; the parameter server and `a_sync` are item 19.2.
"""
from __future__ import annotations

import os

__all__ = ["init", "DistributedStrategy", "distributed_optimizer", "fleet",
           "PaddleCloudRoleMaker", "UserDefinedRoleMaker", "Role",
           "is_first_worker", "worker_index", "worker_num", "is_worker",
           "barrier_worker"]

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
# the ROADMAP item that owns each field the port does not take yet
_OWNER = {"a_sync": "19.2", "a_sync_configs": "19.2",
          "sparse_cache_rows": "19.2", "localsgd": "15.1",
          "localsgd_configs": "15.1"}


class Role:
    WORKER = 1
    SERVER = 2


class PaddleCloudRoleMaker:
    """The reference's env contract (role_maker.py:673-737):
    PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS,
    TRAINING_ROLE."""

    def __init__(self, is_collective=True, **kwargs):
        self._is_collective = is_collective
        self._rank = int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
        self._size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1)
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._endpoints = eps.split(",") if eps else []
        self._role = (Role.SERVER
                      if os.environ.get("TRAINING_ROLE") == "PSERVER"
                      else Role.WORKER)

    def worker_index(self):
        return self._rank

    def worker_num(self):
        return self._size

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def is_first_worker(self):
        return self._rank == 0 and self.is_worker()

    def get_trainer_endpoints(self):
        return self._endpoints


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    """A role given in code rather than read from the env; the group's
    rendezvous still comes from the env (distributed/parallel.py)."""

    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None, **kw):
        super().__init__()
        self._rank = int(current_id)
        self._size = int(worker_num)
        self._role = role
        self._server_eps = list(server_endpoints or [])


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
                f"DistributedStrategy.{name} is not ported yet (ROADMAP "
                f"item {_OWNER.get(name, '16')}): the port's fleet is data "
                f"parallel and honours only {sorted(_HONOURED)}")
        object.__setattr__(self, name, value)


class _Fleet:
    def __init__(self):
        self._role_maker = None
        self._strategy = None
        self._mesh = None

    def init(self, role_maker=None, is_collective=True, strategy=None):
        if not is_collective:
            raise NotImplementedError(
                "fleet.init(is_collective=False): parameter-server mode is "
                "not ported yet (ROADMAP item 19.2)")
        self._role_maker = role_maker or PaddleCloudRoleMaker(
            is_collective=is_collective)
        if not self._role_maker.is_worker():
            raise NotImplementedError(
                "a PSERVER role: the parameter server is not ported yet "
                "(ROADMAP item 19.2)")
        self._strategy = strategy or DistributedStrategy()
        from ...parallel import mesh as mesh_mod
        if self._role_maker.worker_num() > 1:
            from ..parallel import init_parallel_env
            init_parallel_env()
            from ..parallel import get_rank, get_world_size
            if (get_rank(), get_world_size()) != (
                    self._role_maker.worker_index(),
                    self._role_maker.worker_num()):
                raise ValueError(
                    f"the role maker says worker {self.worker_index()} of "
                    f"{self.worker_num()}, the process group rank "
                    f"{get_rank()} of {get_world_size()}")
        self._mesh = mesh_mod.build_mesh(dp=-1)
        mesh_mod.set_mesh(self._mesh)
        return self

    # -- info ---------------------------------------------------------------
    def worker_index(self):
        return self._role_maker.worker_index() if self._role_maker else 0

    def worker_num(self):
        return self._role_maker.worker_num() if self._role_maker else 1

    def is_worker(self):
        return self._role_maker.is_worker() if self._role_maker else True

    def is_first_worker(self):
        return self._role_maker.is_first_worker() if self._role_maker \
            else True

    def is_server(self):
        return self._role_maker.is_server() if self._role_maker else False

    def barrier_worker(self):
        from ..parallel import get_world_size
        if get_world_size() > 1:
            from ..collective import barrier
            barrier()

    @property
    def worker_endpoints(self):
        return self._role_maker.get_trainer_endpoints() \
            if self._role_maker else []

    def dp(self) -> int:
        return self._mesh.size if self._mesh is not None else 1

    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is not None:
            self._strategy = strategy
        return DistributedOptimizer(optimizer,
                                    self._strategy or DistributedStrategy(),
                                    self)


class DistributedOptimizer:
    def __init__(self, inner_opt, strategy: DistributedStrategy,
                 fleet_obj=None):
        self.inner_opt = inner_opt
        self.user_defined_strategy = strategy
        self._fleet = fleet_obj

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
        dp = self._fleet.dp() if self._fleet is not None else 1
        bucket_mb = float((s.sharding_configs or {}).get(
            "fuse_grad_size_in_mb", s.fuse_grad_size_in_mb))
        if bucket_mb <= 0 and dp > 1:
            raise ValueError(
                f"fuse_grad_size_in_mb={bucket_mb} at dp {dp}: the port "
                "averages gradients across ranks per bucket, so a dp > 1 "
                "program needs the bucket pass; without it every rank "
                "would train on its local gradients")
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
        program._dp = dp
        program.bump_version()
        return result


fleet = _Fleet()
init = fleet.init
distributed_optimizer = fleet.distributed_optimizer
is_first_worker = fleet.is_first_worker
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_worker = fleet.is_worker
barrier_worker = fleet.barrier_worker
