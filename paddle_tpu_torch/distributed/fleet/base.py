"""fleet: role makers, DistributedStrategy, the fleet singleton and
`DistributedOptimizer.minimize` (counterpart of
paddle_tpu/distributed/fleet/base.py).

`init(is_collective=True)` reads the role from a role maker
(`PaddleCloudRoleMaker`, the env contract; or `UserDefinedRoleMaker`)
and, when the job has more than one worker, starts the process group
(distributed/parallel.py `init_parallel_env`) and builds the mesh: `dp`
over the group, and `pipeline_parallel_degree` pp stage devices in this
process (parallel/mesh.py): `pipeline_configs["stage_devices"]`, a key of
the port's, or `cuda:0` ... `cuda:P-1` without it. `distributed_optimizer`
given a strategy rebuilds the mesh from it, as the reference does
(`base.py:209-212`). `minimize` applies the strategy in the
reference's order (`base.py:346-430`): AMP marks the program, layer scan
(`layer_scan` or FLAGS_layer_scan) rolls the per-layer segments ending at
`layer_scan_configs["segments"]` (default `loss._layer_checkpoints`)
into one `__layer_scan__` op with `remat` = `recompute`
(parallel/transforms.py), recompute fuses the forward into `__segment__`
ops at `recompute_configs["checkpoints"]` less the boundaries the roll
consumed, gradient merge wraps the optimizer
(`gradient_merge_configs` `k_steps`, `avg`), and pipeline wraps it in
PipelineOptimizer (`pipeline_configs["accumulate_steps"]` microbatches);
then it delegates to the optimizer, applies gradient bucketing and the
ZeRO stage (`base.py:460-516`, parallel/zero.py) whenever
`fuse_grad_size_in_mb` > 0, records the dp width in the program
(`program._dp`) and, over a pp > 1 mesh, attaches the mesh
(parallel/spmd.py) so the executor runs the stages as a pipeline.
Pipeline and gradient-merge programs skip the bucket pass, as the
reference's do; at ZeRO stage >= 1 that is counted under
`executor.zero_manual_fallbacks.<cause>`. Recompute programs keep it. At dp > 1 the executor runs the
program as the reference's manual-dp path computes it (gradients averaged
per bucket, ZeRO state sharded over the ranks): a dp > 1 program with
`fuse_grad_size_in_mb` 0 raises, since it would train on each rank's
local gradients.

Tensor and sequence parallelism: `tensor_parallel_degree` and
`sequence_parallel_degree` build a dp x tp x sp mesh of processes
(parallel/mesh.py), and `minimize` attaches it with
`tensor_parallel_rules` and the flat ZeRO state's dp specs
(parallel/spmd.py `DistConfig`), so the executor runs the program on
DTensors (parallel/gspmd.py): the reference's GSPMD attach
(`base.py:514-533`). The bucket pass runs there as on any mesh, exactly
when the reference's `bucketable` holds, and ZeRO stages 1 and 2 keep
their flat state sharded over dp (parallel/zero.py `_lower_zero_update`);
a sharding request the pass declines (gradient merge, pipeline) takes
`zero1_fallback_rules`, the per-parameter accumulators sharded over dp by
name. Layer scan rolls the layers before the attach, and pp composes with
tp and sp (parallel/mesh.py: P stage devices in each process). ZeRO
stage 3 with tp raises, as in the reference, and so does stage 3 with sp
(ROADMAP item 16). With tp above 1, an auto-selected fused LM head whose
weight the rules vocab-shard warns (`_warn_tp_fused_head`, reference
:310).

Honoured: `amp`, `amp_configs`, `recompute`, `recompute_configs`,
`layer_scan`, `layer_scan_configs`, `gradient_merge`,
`gradient_merge_configs`, `pipeline`, `pipeline_configs`,
`pipeline_parallel_degree`, `tensor_parallel_degree`,
`sequence_parallel_degree`, `tensor_parallel_rules`,
`fuse_grad_size_in_mb`, `sharding`, `sharding_stage`, `sharding_configs`
(`stage`, `fuse_grad_size_in_mb`), `FLAGS_layer_scan` and
`FLAGS_zero_stage`. dp and pp compose: each dp rank pipelines its batch
and the pipeline runner averages the gradients over the ranks
(parallel/pipeline.py). Any other strategy field set away from its
default raises: expert parallelism is ROADMAP item 12; LocalSGD is what
is left of item 15.1 (and raises with tp, sp or pp too, as at the
reference's :419-425); the parameter server and `a_sync` are item
19.2.
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
_HONOURED = {"amp", "amp_configs", "recompute", "recompute_configs",
             "layer_scan", "layer_scan_configs", "gradient_merge",
             "gradient_merge_configs", "pipeline", "pipeline_configs",
             "pipeline_parallel_degree", "tensor_parallel_degree",
             "sequence_parallel_degree", "tensor_parallel_rules",
             "fuse_grad_size_in_mb", "sharding", "sharding_stage",
             "sharding_configs"}
# the ROADMAP item that owns each field the port does not take yet
_OWNER = {"a_sync": "19.2", "a_sync_configs": "19.2",
          "sparse_cache_rows": "19.2", "localsgd": "15.1",
          "localsgd_configs": "15.1", "expert_parallel_degree": "12"}


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
    """The reference's strategy fields, with their defaults. The fields
    that act here are listed in the module docstring."""

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
                f"item {_OWNER.get(name, '16')}): the port's fleet honours "
                f"only {sorted(_HONOURED)}")
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
        self._build_mesh(self._strategy)
        return self

    def _build_mesh(self, s: DistributedStrategy):
        from ...parallel import mesh as mesh_mod
        self._mesh = mesh_mod.build_mesh(
            dp=-1, tp=s.tensor_parallel_degree,
            pp=s.pipeline_parallel_degree, sp=s.sequence_parallel_degree,
            devices=(s.pipeline_configs or {}).get("stage_devices"))
        mesh_mod.set_mesh(self._mesh)

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
            _check_stage3_tp(int(strategy.sharding_stage or 0), strategy)
            self._strategy = strategy
            self._build_mesh(strategy)
        return DistributedOptimizer(optimizer,
                                    self._strategy or DistributedStrategy(),
                                    self)


def _check_stage3_tp(zero_stage: int, s) -> None:
    """ZeRO stage 3 and tensor parallelism do not compose (reference
    :474); checked before the mesh is built too."""
    if zero_stage >= 3 and s.tensor_parallel_degree > 1:
        raise ValueError(
            "sharding_stage=3 flat-shards parameter STORAGE over dp and "
            "cannot compose with tensor_parallel_rules in this build "
            "(the TP rules would shard the same storage a second way); "
            "use stage <= 2 with tensor parallelism")


def _warn_tp_fused_head(program, strategy):
    """The build-then-init hole of the models' fused-head auto-select
    (reference :310, models/bert.py `_tp_vocab_shards_head`): a program
    built before the tp mesh existed may reach minimize with an
    auto-selected `fused_lm_head_ce` whose weight the tp rules vocab-shard.
    The port gathers such a weight once per op (ops/fused_ce.py), so the
    result is right, but the vocab-parallel head is lost: warn with the
    fix. A user-forced fused head has no `auto_selected` attr and is left
    alone."""
    rules = strategy.tensor_parallel_rules
    if rules is None:
        return
    for op in program.global_block().ops:
        if op.type != "fused_lm_head_ce" \
                or not op.attrs.get("auto_selected"):
            continue
        w = (op.inputs.get("W") or [None])[0]
        if w is None:
            continue
        vdim = 1 if op.attrs.get("w_layout", "vh") == "hv" else 0
        spec = list(rules.spec_for(w))
        ax = spec[vdim] if vdim < len(spec) else None
        if ax == "tp" or (isinstance(ax, (tuple, list)) and "tp" in ax):
            import warnings
            warnings.warn(
                f"auto-selected fused_lm_head_ce uses weight {w!r} that the "
                "tensor-parallel rules vocab-shard: the op gathers the whole "
                "weight on every rank, undoing the vocab-parallel head. "
                "Build the model AFTER fleet.init(strategy) so the "
                "auto-select sees the tp mesh, or force "
                "fused_mlm_head/fused_head=False.")


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
        opt = self.inner_opt
        if s.amp:
            program._amp = True
            program._amp_dtype = ("bfloat16"
                                  if s.amp_configs.get("use_pure_bf16", True)
                                  else "float16")
            program.bump_version()
        mesh = self._fleet._mesh if self._fleet is not None else None
        mixed = mesh is not None and mesh.mixed
        if s.tensor_parallel_degree > 1:
            _warn_tp_fused_head(program, s)
        from ...flags import flag
        # layer scan runs before recompute: the roll consumes the interior
        # layer boundaries, and remat becomes the scan body's
        rolled = None
        if s.layer_scan or flag("FLAGS_layer_scan"):
            segs = ((s.layer_scan_configs or {}).get("segments")
                    or getattr(loss, "_layer_checkpoints", None) or [])
            if segs:
                from ...framework.program import default_startup_program
                from ...parallel.transforms import apply_layer_scan
                rolled = apply_layer_scan(
                    program, segs, remat=bool(s.recompute),
                    startup_program=startup_program
                    or default_startup_program())
        if s.recompute and s.recompute_configs.get("checkpoints"):
            from ...parallel.transforms import apply_recompute
            consumed = set(rolled or ())
            ck = [c.name if hasattr(c, "name") else str(c)
                  for c in s.recompute_configs["checkpoints"]]
            ck = [c for c in ck if c not in consumed]
            if ck:
                apply_recompute(program, ck)
        gm_k = int(s.gradient_merge_configs.get("k_steps", 1)) \
            if s.gradient_merge else 1
        if gm_k > 1:
            from ...parallel.transforms import GradientMergeWrapper
            opt = GradientMergeWrapper(
                opt, gm_k, avg=s.gradient_merge_configs.get("avg", True))
        if s.pipeline and s.pipeline_configs.get("accumulate_steps", 1) > 1:
            from ...optimizer import PipelineOptimizer
            opt = PipelineOptimizer(
                opt, num_microbatches=s.pipeline_configs["accumulate_steps"])
        result = opt.minimize(loss, startup_program, parameter_list,
                              no_grad_set)

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
        _check_stage3_tp(zero_stage, s)
        if zero_stage >= 3 and mixed:
            raise NotImplementedError(
                f"ZeRO stage {zero_stage} with sequence parallelism: "
                f"parameter storage flat-sharded over dp on a tp/sp mesh is "
                f"not ported (ROADMAP item 16)")
        dp = self._fleet.dp() if self._fleet is not None else 1
        bucket_mb = float((s.sharding_configs or {}).get(
            "fuse_grad_size_in_mb", s.fuse_grad_size_in_mb))
        if bucket_mb <= 0 and dp > 1 and not mixed:
            raise ValueError(
                f"fuse_grad_size_in_mb={bucket_mb} at dp {dp}: the port "
                "averages gradients across ranks per bucket, so a dp > 1 "
                "program needs the bucket pass; without it every rank "
                "would train on its local gradients")
        pp = int(mesh.shape.get("pp", 1)) if mesh is not None else 1
        # a device_guard-staged program: a bucket op across stages would
        # break the pipeline runner's stage assignment
        pipelined = (getattr(program, "_microbatch_k", 0) or pp > 1
                     or s.pipeline_parallel_degree > 1
                     or any("pipeline_stage" in op.attrs
                            for op in program.global_block().ops))
        # the reference's `bucketable` (:492-512), on every mesh
        if bucket_mb > 0 and gm_k <= 1 and not pipelined:
            from ...framework.program import default_startup_program
            from ...parallel.zero import apply_grad_bucketing
            apply_grad_bucketing(
                program, startup_program or default_startup_program(),
                result[1], bucket_bytes=int(bucket_mb * (1 << 20)),
                stage=zero_stage)
        elif zero_stage >= 1:
            from ...parallel.zero import count_fallback
            count_fallback("grad_merge" if gm_k > 1 else
                           "pipeline" if pipelined else
                           "bucketing_disabled")
        if mixed or pp > 1:
            # the reference's attach (:514-533): the tp rules, the flat
            # ZeRO state's dp specs, and the per-parameter accumulators'
            # dp rows where a sharding request found no flat bucket
            from ...parallel.mesh import ShardingRules
            from ...parallel.spmd import DistConfig, attach, \
                zero1_fallback_rules
            from ...parallel.zero import zero_buckets
            rules = s.tensor_parallel_rules or ShardingRules()
            if zero_stage >= 1 and not zero_buckets(program):
                rules = zero1_fallback_rules(rules)
            attach(program, DistConfig(
                mesh=mesh, param_rules=rules,
                state_specs=getattr(program, "_zero_state_specs", None)))
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
