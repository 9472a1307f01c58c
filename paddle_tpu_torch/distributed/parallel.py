"""Data parallelism across processes: the process group (counterpart of
paddle_tpu/distributed/parallel.py and of the bootstrap half of
paddle_tpu/parallel/mesh.py, `init_parallel_env` :25).

Divergence from the reference, stated as the reference states its own
(distributed/collective.py:5-11): the reference is single-controller.
One process holds a `dp` mesh of devices and the whole training step
runs under `shard_map` over it, each device seeing its shard of a global
batch. The port runs ONE PROCESS PER RANK, the Paddle trainer contract:
each process holds one device, feeds its own local batch, and meets the
others in `torch.distributed` collectives. Rank r's local batch is what
`P("dp")` gives shard r of the reference's global batch: its r-th
contiguous block.

The environment (the reference's keys, `distributed/launch.py` sets them):
`PADDLE_TRAINER_ID`, `PADDLE_TRAINERS_NUM`, `PADDLE_TRAINER_ENDPOINTS`,
`PADDLE_CURRENT_ENDPOINT`; and the rendezvous torch needs in place of the
reference's `JAX_COORDINATOR_ADDRESS`: `PADDLE_DIST_INIT_METHOD` (a
`file://` store path or a `tcp://host:port` store) or `MASTER_ADDR` /
`MASTER_PORT` (rank 0 hosts a TCP store there). A group of one needs
neither.

Each rank's device and backend are explicit:

* device: the `device` argument, else `PADDLE_DIST_DEVICE`, else
  `cuda:<LOCAL_RANK>`; `cpu` only when asked for.
* backend: the `backend` argument, else `PADDLE_DIST_BACKEND`, else
  `nccl` on a CUDA device and `gloo` on the CPU.
* Two ranks on one card run only when the caller asks for it (both name
  `cuda:0`) under gloo. NCCL refuses two ranks on one GPU, so before the
  group is built every rank publishes its (host, device) in the store; a
  device named twice under `nccl` raises the typed
  `PreconditionNotMetError` on every rank, within the store's timeout,
  instead of hanging in NCCL's setup.
* The group's timeout is FLAGS_gloo_timeout_ms: a rank that cannot reach
  its group raises within it.

`tp`/`pp`/`sp`/`ep` > 1 raise in `parallel.mesh.build_mesh` (ROADMAP item
16).
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch

from ..device import resolve_device
from ..framework import errors

__all__ = ["ParallelEnv", "init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "rank_device", "backend", "destroy"]

_state = {"device": None, "backend": None}


class ParallelEnv:
    """The trainer env contract (reference ParallelEnv,
    role_maker.py:673-737)."""

    def __init__(self):
        self.rank = int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
        self.world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1")
                              or 1)
        self.device_id = int(os.environ.get("LOCAL_RANK", "0") or 0)
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self.trainer_endpoints = eps.split(",") if eps else []
        self.current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def nranks(self):
        return self.world_size

    @property
    def local_rank(self):
        return self.device_id


def is_initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    """This process's rank in the default group (0 without one)."""
    if is_initialized():
        import torch.distributed as dist
        return dist.get_rank()
    return 0


def get_world_size() -> int:
    """The default group's size (1 without one)."""
    if is_initialized():
        import torch.distributed as dist
        return dist.get_world_size()
    return 1


def rank_device() -> torch.device:
    """The device this rank's group was built for (`init_parallel_env`)."""
    if _state["device"] is None:
        raise errors.PreconditionNotMet(
            "no process group: call distributed.init_parallel_env() or "
            "fleet.init() first")
    return _state["device"]


def backend() -> Optional[str]:
    return _state["backend"]


def _timeout_s() -> float:
    from ..flags import flag
    return float(flag("FLAGS_gloo_timeout_ms")) / 1000.0


def _make_store(rank: int, world: int, timeout_s: float):
    import torch.distributed as dist
    timeout = datetime.timedelta(seconds=timeout_s)
    method = os.environ.get("PADDLE_DIST_INIT_METHOD", "")
    if method.startswith("file://"):
        return dist.FileStore(method[len("file://"):], world)
    if method.startswith("tcp://"):
        host, port = method[len("tcp://"):].rsplit(":", 1)
    elif os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        host, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
    elif world == 1:
        return dist.HashStore()
    else:
        raise errors.InvalidArgument(
            "init_parallel_env: %d ranks need a rendezvous: set "
            "PADDLE_DIST_INIT_METHOD (file:// or tcp://) or MASTER_ADDR / "
            "MASTER_PORT (distributed/launch.py sets them)", world)
    return dist.TCPStore(host, int(port), world, is_master=(rank == 0),
                         timeout=timeout)


def _device_identity(dev: torch.device) -> str:
    """(host, physical device) of a rank: two ranks naming the same one
    share a card."""
    if dev.type != "cuda":
        return f"{socket.gethostname()}|cpu|{os.getpid()}"
    props = torch.cuda.get_device_properties(dev)
    uid = getattr(props, "uuid", None)
    return f"{socket.gethostname()}|cuda|{uid or dev.index}"


def check_devices_distinct(identities, backend_name: str) -> None:
    """Raise the typed error when `nccl` is asked for with two ranks on one
    device. `identities` lists each rank's `_device_identity`, in rank
    order."""
    if backend_name != "nccl":
        return
    seen = {}
    for rank, ident in enumerate(identities):
        if ident in seen:
            raise errors.PreconditionNotMet(
                "NCCL cannot run two ranks on one GPU: ranks %d and %d both "
                "name %s. Give each rank its own card, or ask for the "
                "shared card explicitly with backend='gloo' "
                "(PADDLE_DIST_BACKEND=gloo)", seen[ident], rank,
                ident.split("|", 1)[1])
        seen[ident] = rank


def init_parallel_env(backend: Optional[str] = None, device=None,
                      timeout_s: Optional[float] = None) -> ParallelEnv:
    """Build this process's default group from the env contract (module
    docstring). Idempotent: a second call returns the env."""
    import torch.distributed as dist
    env = ParallelEnv()
    if is_initialized():
        return env
    rank, world = env.rank, env.world_size
    if not 0 <= rank < world:
        raise errors.InvalidArgument(
            "PADDLE_TRAINER_ID %d is outside PADDLE_TRAINERS_NUM %d", rank,
            world)
    dev = device or os.environ.get("PADDLE_DIST_DEVICE") \
        or f"cuda:{int(os.environ.get('LOCAL_RANK', '0') or 0)}"
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    name = backend or os.environ.get("PADDLE_DIST_BACKEND") \
        or ("nccl" if dev.type == "cuda" else "gloo")
    if name not in ("nccl", "gloo"):
        raise errors.InvalidArgument(
            "backend %r: the port runs 'nccl' (one card per rank) or "
            "'gloo'", name)
    if name == "nccl" and dev.type != "cuda":
        raise errors.InvalidArgument(
            "backend 'nccl' needs a CUDA device, got %s", dev)
    timeout_s = _timeout_s() if timeout_s is None else float(timeout_s)
    store = _make_store(rank, world, timeout_s)
    store.set_timeout(datetime.timedelta(seconds=timeout_s))
    store.set(f"paddle_dist/device/{rank}", _device_identity(dev))
    idents = [store.get(f"paddle_dist/device/{r}").decode()
              for r in range(world)]
    check_devices_distinct(idents, name)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(name, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _state.update(device=dev, backend=name)
    return env


def destroy() -> None:
    """Tear the default group down (idempotent)."""
    import torch.distributed as dist
    if is_initialized():
        dist.destroy_process_group()
    _state.update(device=None, backend=None)
