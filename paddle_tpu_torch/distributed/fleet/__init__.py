"""fleet: the distributed-training facade (counterpart of
paddle_tpu/distributed/fleet/): `init`, `distributed_optimizer`,
`DistributedStrategy` and the role makers live in `base.py`; `fleetrun`
is `launch.py`."""
from .base import (DistributedStrategy, PaddleCloudRoleMaker, Role,
                   UserDefinedRoleMaker, barrier_worker,
                   distributed_optimizer, fleet, init, is_first_worker,
                   is_worker, worker_index, worker_num)
from ..parallel import get_rank, get_world_size

__all__ = [
    "init", "is_first_worker", "worker_index", "worker_num", "is_worker",
    "barrier_worker", "distributed_optimizer", "DistributedStrategy",
    "PaddleCloudRoleMaker", "UserDefinedRoleMaker", "Role", "fleet",
    "get_rank", "get_world_size",
]
