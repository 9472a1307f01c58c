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
* `--collect-dumps` writes the gang's pod dump dir on a clean exit;
  `--elastic_full_world` relaunches every rank after a failure; fleetrun's
  PS mode raises naming 19.2, its collective mode runs a gang.
* A gang of two CPU ranks training the fc model at ZeRO stage 1 under
  `--collect-dumps`: every worker dumps at exit, and the pod dump merges
  two lanes with a cross-rank flow pair for every `__zero_update__`
  marker of every step.
* A gang under `--elastic_full_world --collect-dumps` whose rank 1 dies
  (`os._exit`) after a replicated snapshot: the survivor's SIGTERM flush
  writes its own and its buddy's payloads, the full-world relaunch
  recovers rank 1 on the `peer` rung and rank 0 on the `local` one at
  the same step, both end equal to a run that was never interrupted, and
  the failed life's gang dump names rank 1 as `suspected_straggler`.
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
    """The two modes of item 19.1 are ported: --collect-dumps leaves a pod
    dump dir after a clean exit, --elastic_full_world relaunches at the
    original world size; the parameter server still raises (19.2)."""
    log = str(tmp_path / "lives.log")
    script = _worker(tmp_path, f"""
with open({log!r}, "a") as f:
    f.write(f"restart={{restart}} world={{world}} rank={{rank}}\\n")
if restart == 0 and rank == 1:
    sys.exit(3)
time.sleep(0.2 if restart else 600)
""")
    pod = str(tmp_path / "pod")
    rc = _launch(["--nproc_per_node", "2", "--port", _port(),
                  "--rendezvous_deadline_ms", "20000",
                  "--grace_period_s", "1", "--elastic_restarts", "1",
                  "--elastic_full_world", "--collect-dumps",
                  "--pod_dump_dir", pod, script])
    assert rc == 0
    with open(log) as f:
        lives = sorted(f.read().splitlines())
    assert lives == ["restart=0 world=2 rank=0", "restart=0 world=2 rank=1",
                     "restart=1 world=2 rank=0", "restart=1 world=2 rank=1"]
    with open(os.path.join(pod, "heartbeats.json")) as f:
        meta = json.load(f)
    assert (meta["status"], meta["world"], meta["restart_idx"]) == \
        ("ok", 2, 1)
    with pytest.raises(NotImplementedError, match="item 19.2"):
        fleetrun.launch(["--server_num", "1", script])


POD_TRAIN = textwrap.dedent("""
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
    xs = rng.randn({steps}, 8, 8).astype(np.float32)
    batches = [(x, x.sum(1, keepdims=True).astype(np.float32)) for x in xs]
    out = ranks.fc_arm(1, "adam", init, batches)
    with open(os.path.join({out!r}, f"rank{{parallel.get_rank()}}.json"),
              "w") as f:
        json.dump({{"losses": out["losses"], "plan": out["plan"]}}, f)
    parallel.destroy()
    """)


def test_collect_dumps_merges_a_training_gang(tmp_path):
    steps = 3
    script = tmp_path / "train.py"
    script.write_text(POD_TRAIN.format(repo=REPO, out=str(tmp_path),
                                       steps=steps))
    pod = str(tmp_path / "pod")
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--port", _port(),
         "--rendezvous_deadline_ms", "60000", "--grace_period_s", "2",
         "--collect-dumps", "--pod_dump_dir", pod, str(script)],
        cwd=REPO, env=dict(_train_env(),
                           FLAGS_flight_dump_dir=str(tmp_path / "flight")),
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    plan = json.loads((tmp_path / "rank0.json").read_text())["plan"]
    with open(os.path.join(pod, "pod_trace.json")) as f:
        merged = json.load(f)
    lanes = {e["pid"] for e in merged["traceEvents"]
             if e.get("name") == "process_name"}
    assert lanes == {0, 1}
    flows = [e for e in merged["traceEvents"]
             if e.get("cat") == "pod_collective" and e["ph"] == "s"]
    kinds = {e["args"]["kind"] for e in flows}
    assert kinds == {"__zero_update__"}
    # one flow pair for every bucket's marker of every training step
    assert merged["otherData"]["flow_pairs"] == steps * plan["zero"] \
        == len(flows)
    with open(os.path.join(pod, "straggler_report.json")) as f:
        report = json.load(f)
    assert report["world"] == 2
    assert report["summary"]["collective_keys_matched"] == steps * \
        plan["zero"]
    assert "pod dump: 2 rank dump(s)" in r.stdout


PEER_TRAIN = textwrap.dedent("""
    import json, os, sys, time
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from paddle_tpu_torch import initializer, layers, optimizer
    from paddle_tpu_torch.distributed import gloo
    from paddle_tpu_torch.framework import (Executor, default_main_program,
                                            default_startup_program)
    from paddle_tpu_torch.framework.scope import global_scope
    from paddle_tpu_torch.layer_helper import ParamAttr
    from paddle_tpu_torch.resilience import recover
    from paddle_tpu_torch.testing import reset_programs

    rank = int(os.environ["PADDLE_TRAINER_ID"])
    life = int(os.environ.get("PADDLE_ELASTIC_RESTART", "0"))
    reset_programs(0)
    init = initializer.TruncatedNormal(scale=0.3)
    x = layers.data(name="x", shape=[8], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    pred = layers.fc(x, 1, param_attr=ParamAttr(name="w", initializer=init),
                     bias_attr=ParamAttr(name="b"))
    loss = layers.mean(layers.square_error_cost(pred, y))
    optimizer.Adam(learning_rate=1e-2).minimize(loss)
    main = default_main_program()
    exe = Executor("cpu")
    exe.run(default_startup_program())
    start = 0
    if {mode!r} == "drill" and life > 0:
        rung, step = recover(global_scope(), rank=rank, program=main,
                             device="cpu", peer=True)
        start = step            # a snapshot's tag counts the steps done
    g = gloo.from_env() if {mode!r} == "drill" else None
    for step in range(start, 6):
        rng = np.random.RandomState(100 * rank + step)
        xv = rng.randn(4, 8).astype(np.float32)
        exe.run(main, feed={{"x": xv, "y": xv.sum(1, keepdims=True)}})
        if g is not None and step == 2:
            exe.snapshots.replicate(g)       # every rank: a collective
            if life == 0 and rank == 1:
                os._exit(1)                  # the lost host
        if g is not None and life == 0 and step == 3:
            # the survivor, a step ahead (no snapshot at tag 4): the
            # supervisor's SIGTERM flushes its own and its buddy's
            # payloads, both of tag 3
            time.sleep(120)
    with open(os.path.join({out!r}, f"{mode}_rank{{rank}}.json"), "w") as f:
        json.dump({{n: global_scope().numpy(n).tolist()
                   for n in ("w", "b")}}, f)
    """)


def test_elastic_full_world_recovers_a_killed_rank_from_its_peer(tmp_path):
    env = dict(_train_env(), FLAGS_snapshot_steps="3",
               FLAGS_flight_dump_dir=str(tmp_path / "flight"),
               PADDLE_SNAPSHOT_DIR=str(tmp_path / "snap"))
    outs = {}
    for mode in ("ref", "drill"):
        script = tmp_path / f"{mode}.py"
        script.write_text(PEER_TRAIN.format(repo=REPO, out=str(tmp_path),
                                            mode=mode))
        flags = (["--elastic_restarts", "1", "--elastic_full_world",
                  "--collect-dumps"] if mode == "drill" else [])
        outs[mode] = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", "2", "--port", _port(),
             "--rendezvous_deadline_ms", "60000", "--grace_period_s", "20"]
            + flags + [str(script)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert outs[mode].returncode == 0, \
            outs[mode].stdout + outs[mode].stderr
    log = outs["drill"].stdout
    assert "recovery: rank 1 rung=peer step=3" in log, log
    assert "recovery: rank 0 rung=local step=3" in log, log
    assert os.path.isdir(tmp_path / "snap" / "peer_of_rank1")
    for r in range(2):
        got = json.loads((tmp_path / f"drill_rank{r}.json").read_text())
        want = json.loads((tmp_path / f"ref_rank{r}.json").read_text())
        assert got == want, r
    failures = []
    for name in os.listdir(tmp_path / "flight"):
        if "gang_failure" in name:
            with open(tmp_path / "flight" / name) as f:
                failures.append(json.load(f)["extra"])
    assert [f["suspected_straggler"] for f in failures] == [1], failures
    assert "suspected straggler: rank 1" in log
