"""paddle.distributed for the port: data parallelism across processes
(counterpart of paddle_tpu/distributed/). One process per rank
(`parallel.py`: the env contract, the process group and each rank's
device and backend), collectives over it (`collective.py`), `spawn`,
the supervised gang launcher (`launch.py`), fleet (`fleet/`) and the
host Gloo group for Python values (`gloo.py`). Submodules load on first
use: `import paddle_tpu_torch.distributed` alone imports no
torch.distributed machinery."""
from .parallel import (ParallelEnv, get_rank, get_world_size,
                       init_parallel_env)

__all__ = ["ParallelEnv", "init_parallel_env", "get_rank", "get_world_size",
           "collective", "fleet", "gloo", "launch", "spawn"]
