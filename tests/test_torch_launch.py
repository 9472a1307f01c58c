"""PyTorch port, the supervised gang launcher
(paddle_tpu_torch/distributed/launch.py) and fleetrun
(distributed/fleet/launch.py), as tests/test_launch.py:28-164 holds the
reference's.

* `plan_gang`: every PADDLE_* key and value equal to the reference's
  plan, for two hosts x 2, one host x 4 and an elastic shrink; the
  reference's JAX_* keys replaced by torch's rendezvous (MASTER_ADDR /
  MASTER_PORT at the reference's coordinator port, RANK, WORLD_SIZE,
  LOCAL_RANK, LOCAL_WORLD_SIZE).
* Real gangs of stdlib workers, the supervisor in this process: a
  rendezvous straggler fails the launch with the typed
  DeadlineExceededError; one worker exiting non-zero kills its sleeping
  sibling; `--elastic_restarts` relaunches at the surviving world size; a
  SIGSTOPped worker's stale heartbeat fails the gang.
* A gang of two CPU ranks launched through the module entry point trains
  the fc model through fleet at ZeRO stage 1 over the launcher's
  MASTER_ADDR / MASTER_PORT rendezvous, both ranks with the same losses.
* `--collect-dumps` and `--elastic_full_world` raise naming ROADMAP item
  19.1; fleetrun's PS mode raises naming 19.2, its collective mode runs a
  gang.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from paddle_tpu.distributed.launch import plan_gang as ref_plan_gang
from paddle_tpu_torch.distributed.fleet import launch as fleetrun
from paddle_tpu_torch.distributed.launch import launch, plan_gang
from paddle_tpu_torch.distributed.spawn import free_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_KEYS = {"MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"}


@pytest.mark.parametrize("ips,nproc,world", [
    (["10.0.0.1", "10.0.0.2"], 2, None),
    (["127.0.0.1"], 4, None),
    (["127.0.0.1"], 4, 3)], ids=["two_hosts", "one_host", "elastic_shrink"])
def test_plan_gang_keeps_the_reference_contract(ips, nproc, world):
    ref = ref_plan_gang(ips, 6170, nproc, world)
    got = plan_gang(ips, 6170, nproc, world)
    assert len(got) == len(ref)
    for rank, (g, r) in enumerate(zip(got, ref)):
        paddle_keys = {k for k in r if not k.startswith("JAX_")}
        assert {k: g[k] for k in paddle_keys} == \
            {k: r[k] for k in paddle_keys}
        assert set(g) == paddle_keys | TORCH_KEYS
        host, port = r["JAX_COORDINATOR_ADDRESS"].rsplit(":", 1)
        assert (g["MASTER_ADDR"], g["MASTER_PORT"]) == (host, port)
        assert g["RANK"] == str(rank) == r["JAX_PROCESS_ID"]
        assert g["WORLD_SIZE"] == r["JAX_NUM_PROCESSES"]
        assert g["LOCAL_RANK"] == str(rank % nproc)


def _worker(tmp_path, body: str) -> str:
    path = str(tmp_path / "worker.py")
    with open(path, "w") as f:
        f.write(
            "import os, sys, time\n"
            "rank = int(os.environ['PADDLE_TRAINER_ID'])\n"
            "world = int(os.environ['PADDLE_TRAINERS_NUM'])\n"
            "restart = int(os.environ.get('PADDLE_ELASTIC_RESTART', '0'))\n"
            + body)
    return path


def _launch(argv) -> int:
    with pytest.raises(SystemExit) as e:
        launch(argv)
    return int(e.value.code or 0)


def _port():
    return str(free_ports(1)[0])


def test_rendezvous_straggler_kills_gang_typed(tmp_path, monkeypatch,
                                               capsys):
    script = _worker(tmp_path, "time.sleep(0.2)\n")
    monkeypatch.setenv("PADDLE_LAUNCH_STALL_RANKS", "1")
    t0 = time.monotonic()
    rc = _launch(["--nproc_per_node", "2", "--port", _port(),
                  "--rendezvous_deadline_ms", "1500",
                  "--grace_period_s", "1", script])
    assert rc != 0
    assert time.monotonic() - t0 < 30
    assert "DeadlineExceeded" in capsys.readouterr().err


def _gone(pid, within_s=10.0) -> bool:
    deadline = time.monotonic() + within_s
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.05)
    os.kill(pid, signal.SIGKILL)
    return False


def test_fail_fast_sibling_kill(tmp_path):
    pid_file = str(tmp_path / "sibling.pid")
    script = _worker(tmp_path, f"""
if rank == 0:
    time.sleep(0.3)
    sys.exit(7)
with open({pid_file!r}, "w") as f:
    f.write(str(os.getpid()))
time.sleep(600)
""")
    t0 = time.monotonic()
    rc = _launch(["--nproc_per_node", "2", "--port", _port(),
                  "--rendezvous_deadline_ms", "20000",
                  "--grace_period_s", "1", script])
    assert rc == 7
    assert time.monotonic() - t0 < 60
    with open(pid_file) as f:
        assert _gone(int(f.read())), "sibling survived the fail-fast kill"


def test_elastic_restart_at_surviving_world_size(tmp_path):
    log = str(tmp_path / "lives.log")
    script = _worker(tmp_path, f"""
with open({log!r}, "a") as f:
    f.write(f"restart={{restart}} world={{world}} rank={{rank}} "
            f"master={{os.environ['MASTER_PORT']}}\\n")
if world == 2 and rank == 0:
    sys.exit(3)
time.sleep(0.3 if world == 1 else 600)
""")
    port = _port()
    rc = _launch(["--nproc_per_node", "2", "--port", port,
                  "--rendezvous_deadline_ms", "20000",
                  "--grace_period_s", "1", "--elastic_restarts", "2",
                  script])
    assert rc == 0
    with open(log) as f:
        lives = f.read().splitlines()
    assert f"restart=0 world=2 rank=0 master={int(port) + 2}" in lives, lives
    assert f"restart=1 world=1 rank=0 master={int(port) + 2}" in lives, lives


def test_stale_heartbeat_detected_as_hung(tmp_path):
    pid_file = str(tmp_path / "victim.pid")
    script = _worker(tmp_path, f"""
if rank == 0:
    with open({pid_file!r}, "w") as f:
        f.write(str(os.getpid()))
time.sleep(600)
""")

    def stopper():
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if os.path.exists(pid_file):
                with open(pid_file) as f:
                    txt = f.read()
                if txt:
                    os.kill(int(txt), signal.SIGSTOP)
                    return
            time.sleep(0.05)

    t = threading.Thread(target=stopper, daemon=True)
    t.start()
    t0 = time.monotonic()
    rc = _launch(["--nproc_per_node", "2", "--port", _port(),
                  "--rendezvous_deadline_ms", "20000",
                  "--heartbeat_timeout_ms", "2000",
                  "--grace_period_s", "1", script])
    t.join(timeout=5)
    assert rc != 0
    assert time.monotonic() - t0 < 120


TRAIN = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, os.path.join({repo!r}, "tests"))
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torch_dist_ranks as ranks
    from paddle_tpu_torch.distributed import parallel
    rng = np.random.RandomState(0)
    init = {{"w1": rng.randn(8, 16).astype(np.float32) * 0.3,
             "b1": np.zeros(16, np.float32),
             "w2": rng.randn(16, 1).astype(np.float32) * 0.3,
             "b2": np.zeros(1, np.float32)}}
    xs = rng.randn(3, 8, 8).astype(np.float32)
    batches = [(x, x.sum(1, keepdims=True).astype(np.float32)) for x in xs]
    out = ranks.fc_arm(1, "adam", init, batches)
    with open(os.path.join({out!r}, f"rank{{parallel.get_rank()}}.json"),
              "w") as f:
        json.dump({{"losses": out["losses"],
                    "world": parallel.get_world_size(),
                    "backend": parallel.backend()}}, f)
    parallel.destroy()
    """)


def _train_env():
    return dict(os.environ, PADDLE_DIST_DEVICE="cpu",
                PADDLE_DIST_BACKEND="gloo")


@pytest.mark.parametrize("entry", ["launch", "fleetrun"])
def test_a_torch_gang_trains_through_the_launcher(tmp_path, entry):
    script = tmp_path / "train.py"
    script.write_text(TRAIN.format(repo=REPO, out=str(tmp_path)))
    module = ("paddle_tpu_torch.distributed.launch" if entry == "launch"
              else "paddle_tpu_torch.distributed.fleet.launch")
    cmd = [sys.executable, "-m", module, "--nproc_per_node", "2",
           "--port", _port()]
    if entry == "launch":
        cmd += ["--rendezvous_deadline_ms", "60000", "--grace_period_s", "2"]
    r = subprocess.run(cmd + [str(script)], cwd=REPO, env=_train_env(),
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    got = [json.loads((tmp_path / f"rank{k}.json").read_text())
           for k in range(2)]
    assert got[0] == got[1]
    assert got[0]["world"] == 2 and got[0]["backend"] == "gloo"
    assert len(got[0]["losses"]) == 3


def test_unported_launch_modes_raise_naming_their_item(tmp_path):
    script = _worker(tmp_path, "pass\n")
    for flag in ("--collect-dumps", "--elastic_full_world"):
        with pytest.raises(NotImplementedError, match="item 19.1"):
            launch(["--port", _port(), flag, script])
    with pytest.raises(NotImplementedError, match="item 19.2"):
        fleetrun.launch(["--server_num", "1", script])
