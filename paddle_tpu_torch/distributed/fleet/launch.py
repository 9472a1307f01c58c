"""fleetrun, collective mode (counterpart of
paddle_tpu/distributed/fleet/launch.py):

    python -m paddle_tpu_torch.distributed.fleet.launch [--ips a,b] \
        [--nproc_per_node N] train.py [args...]

One trainer per ip (or `--nproc_per_node` per ip), each with the trainer
env contract, under the supervised gang launcher
(distributed/launch.py: rendezvous deadline, fail-fast sibling kill).
PS mode (`--server_num`, `--servers`, `--worker_num`, `--workers`)
raises: the parameter server is ROADMAP item 19.2.
"""
from __future__ import annotations

import argparse

from ..launch import GangSupervisor, _parse_args
from ..spawn import free_ports


def _parse(argv=None):
    p = argparse.ArgumentParser("fleetrun")
    p.add_argument("--ips", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--server_num", type=int, default=0)
    p.add_argument("--worker_num", type=int, default=0)
    p.add_argument("--servers", default="", help="ip:port list (PS mode)")
    p.add_argument("--workers", default="")
    p.add_argument("--log_dir", default=None)
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def launch(argv=None):
    args = _parse(argv)
    if args.server_num or args.servers or args.worker_num or args.workers:
        raise NotImplementedError(
            "fleetrun in parameter-server mode: the parameter server is "
            "not ported yet (ROADMAP item 19.2)")
    ips = [ip for ip in args.ips.split(",") if ip]
    port = args.port or free_ports(1)[0]
    sup_argv = ["--ips", ",".join(ips), "--port", str(port),
                "--nproc_per_node", str(args.nproc_per_node)]
    if args.log_dir:
        sup_argv += ["--log_dir", args.log_dir]
    sup = GangSupervisor(_parse_args(
        sup_argv + [args.training_script] + args.training_script_args))
    raise SystemExit(sup.run())


if __name__ == "__main__":
    launch()
