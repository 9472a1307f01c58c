"""Supervised gang launcher: `python -m paddle_tpu_torch.distributed.launch
--nproc_per_node N train.py [args]` (counterpart of
paddle_tpu/distributed/launch.py: `plan_gang` :157, `GangSupervisor` :192,
`_kill_gang` :314, `_rendezvous` :344, `_monitor` :371, `run` :542).

One process per rank. On one host, rank r's device is `cuda:<r>` unless
the job asks otherwise: `PADDLE_DIST_DEVICE` / `PADDLE_DIST_BACKEND` in
the launcher's environment reach every rank (two ranks sharing `cuda:0`
run only under `PADDLE_DIST_BACKEND=gloo`, distributed/parallel.py).

* **Env contract** (`plan_gang`): the reference's PADDLE_* keys, equal to
  the reference's (`PADDLE_TRAINER_ENDPOINTS` one endpoint per process,
  `PADDLE_TRAINERS_NUM` the real world size). The reference's `JAX_*`
  keys give way to the rendezvous torch needs: `MASTER_ADDR` /
  `MASTER_PORT` (rank 0's TCP store, on the port above every trainer
  endpoint, as the reference puts its coordinator), `RANK`,
  `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`.
* **Deadline-bounded rendezvous**: every worker checks in (its bootstrap
  creates a heartbeat file before user code runs) within
  `FLAGS_rendezvous_deadline_ms`, polled under a RetryPolicy whose
  exhaustion raises the typed DeadlineExceededError, or the whole gang
  is killed.
* **Heartbeat files**: each worker's bootstrap touches its file every
  `FLAGS_launch_heartbeat_interval_ms`; with `--heartbeat_timeout_ms > 0`
  a stale file is a hung worker and fails the gang.
* **Fail-fast sibling kill**: one worker exiting non-zero (or hanging)
  kills every sibling, SIGTERM first (`PADDLE_LAUNCH_GRACE_S` tells them
  their budget), SIGKILL past `--grace_period_s`. A dead peer never
  leaves the survivors blocked in a collective.
* **Bounded elastic restart** (`--elastic_restarts N`): after a failure
  the gang relaunches at the surviving world size, with
  `PADDLE_ELASTIC_RESTART` incremented, at most N times; trainers resume
  from their latest checkpoint (a ZeRO checkpoint is unsharded, so it
  loads at the new dp, parallel/zero.py). With `--elastic_full_world` it
  relaunches every rank instead (a replacement host): a rank whose
  process died recovers its state from the snapshot its ring buddy held
  and flushed for it in the grace window, the `peer` rung of
  resilience/snapshot.py's recovery ladder.
* **Pod-scope dumps**: every worker inherits one flight-dump dir and one
  snapshot dir for the gang; the heartbeat file is JSON that the
  trainers' flight recorder extends with the last step and its duration
  (observability/flight.py `end_step`). On a gang failure the supervisor
  names the suspected straggler from the heartbeats, in its log and in
  its `gang_failure` dump (`suspected_straggler`); on every failure, and
  on a clean exit with `--collect-dumps` (which also makes every worker
  dump at exit), it gathers the ranks' dumps of this gang life into one
  pod dump dir and writes the merged timeline and straggler report there
  (observability/podscope.py; `python -m
  paddle_tpu_torch.observability.pod_trace` merges a dir by hand). The
  timeline's t0 is the wall time at which every rank had checked in.

Chaos hook: `PADDLE_LAUNCH_STALL_RANKS="1,3"` in the launcher's env makes
those ranks sleep before check-in (a deterministic straggler).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

# The worker bootstrap is STDLIB-ONLY and runs before any user import: the
# check-in marker (heartbeat-file creation) means "the worker process is up
# and executing", independent of how long the training script's own imports
# take afterwards.
_BOOTSTRAP = r'''
import json, os, runpy, sys, threading, time
_stall = os.environ.get("PADDLE_LAUNCH_STALL_RANKS", "")
if _stall and os.environ.get("PADDLE_TRAINER_ID") in \
        [r.strip() for r in _stall.split(",")]:
    time.sleep(3600)          # chaos hook: a rendezvous straggler
_hb = os.environ.get("PADDLE_LAUNCH_HEARTBEAT_FILE")
if _hb:
    # heartbeat content is JSON: the bootstrap seeds {"pid": ...}, the
    # supervisor snapshots it into its gang-failure dump
    with open(_hb, "w") as _f:
        json.dump({"pid": os.getpid()}, _f)     # the rendezvous check-in
    _iv = float(os.environ.get("PADDLE_LAUNCH_HEARTBEAT_INTERVAL_S", "1"))

    def _beat():
        while True:
            time.sleep(_iv)
            try:
                os.utime(_hb)
            except OSError:
                try:                      # unlinked by a tmp reaper: a
                    with open(_hb, "w") as _g:      # dead beat reads as a
                        json.dump({"pid": os.getpid()}, _g)  # hung worker,
                except OSError:                  # so keep beating, never
                    pass                         # exit

    threading.Thread(target=_beat, daemon=True,
                     name="launch-heartbeat").start()
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
'''


def _parse_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--ips", type=str, default="127.0.0.1",
                   help="comma-separated host ips (reference --ips)")
    p.add_argument("--port", type=int, default=6170)
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="processes per host: one per card, or more sharing "
                        "a card under gloo (module docstring)")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--rendezvous_deadline_ms", type=float, default=-1.0,
                   help="every worker must check in within this budget or "
                        "the gang is killed with DeadlineExceededError "
                        "(-1: FLAGS_rendezvous_deadline_ms)")
    p.add_argument("--heartbeat_timeout_ms", type=float, default=0.0,
                   help="treat a worker whose heartbeat file is stale past "
                        "this as HUNG and fail it (0: disabled)")
    p.add_argument("--grace_period_s", type=float, default=10.0,
                   help="SIGTERM-to-SIGKILL grace when killing the gang "
                        "(long enough for a trainer's final "
                        "checkpoint)")
    p.add_argument("--elastic_restarts", type=int, default=0,
                   help="relaunch budget after a worker failure: the gang "
                        "restarts at the surviving world size, trainers "
                        "resume from their latest checkpoint")
    p.add_argument("--elastic_full_world", action="store_true",
                   help="elastic restarts keep the original world size "
                        "(replacement hosts) instead of shrinking to the "
                        "survivors: a relaunched rank whose process died "
                        "recovers from the snapshot its ring buddy flushed "
                        "for it (resilience/snapshot.py, the 'peer' rung)")
    p.add_argument("--collect-dumps", action="store_true",
                   dest="collect_dumps",
                   help="gather the ranks' flight dumps into one pod dump "
                        "dir on every gang exit (failures always collect) "
                        "with the merged timeline and straggler report; "
                        "sets PADDLE_FLIGHT_DUMP_AT_EXIT=1 so workers that "
                        "end cleanly leave a dump")
    p.add_argument("--pod_dump_dir", type=str, default=None,
                   help="where the pod collection lands (default: "
                        "pod_<restart>_<status> under the gang's flight "
                        "dump dir)")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def plan_gang(ips: List[str], port: int, nproc_per_node: int,
              world: Optional[int] = None) -> List[Dict[str, str]]:
    """Per-rank env for a gang of `len(ips) * nproc_per_node` processes
    (or its first `world` ranks after an elastic shrink): the reference's
    PADDLE_* keys, and the store rendezvous at `port + full world size`,
    above every trainer endpoint port, where the reference puts its
    coordinator."""
    nproc = max(int(nproc_per_node), 1)
    full_world = len(ips) * nproc
    world = full_world if world is None else min(int(world), full_world)
    endpoints = [f"{ip}:{port + local}"
                 for ip in ips for local in range(nproc)][:world]
    plans = []
    for rank in range(world):
        plans.append({
            # reference env contract (role_maker.py:673-737)
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
            "TRAINING_ROLE": "TRAINER",
            # torch.distributed's rendezvous (distributed/parallel.py)
            "MASTER_ADDR": ips[0],
            "MASTER_PORT": str(port + full_world),
            "RANK": str(rank),
            "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank % nproc),
            "LOCAL_WORLD_SIZE": str(min(nproc, world)),
        })
    return plans


class GangSupervisor:
    """Launch, watch, and (boundedly) relaunch one training gang."""

    def __init__(self, args):
        from ..flags import flag
        self.args = args
        self.ips = [ip.strip() for ip in args.ips.split(",") if ip.strip()]
        self.rendezvous_deadline_ms = (
            args.rendezvous_deadline_ms
            if args.rendezvous_deadline_ms >= 0
            else float(flag("FLAGS_rendezvous_deadline_ms")))
        self.heartbeat_interval_s = \
            float(flag("FLAGS_launch_heartbeat_interval_ms")) / 1000.0
        self.heartbeat_timeout_s = args.heartbeat_timeout_ms / 1000.0
        self.grace_period_s = args.grace_period_s
        self.collect_dumps = bool(getattr(args, "collect_dumps", False))
        # ONE flight-dump dir and ONE snapshot dir for the gang (an
        # operator-set env or flag wins): workers inherit them, and the
        # supervisor reads the ranks' recovery stamps back
        self._flight_dir = (os.environ.get("FLAGS_flight_dump_dir")
                            or str(flag("FLAGS_flight_dump_dir") or "")
                            or tempfile.mkdtemp(prefix="paddle_pod_flight_"))
        self._snapshot_dir = (os.environ.get("PADDLE_SNAPSHOT_DIR")
                              or str(flag("FLAGS_snapshot_dir") or "")
                              or tempfile.mkdtemp(prefix="paddle_pod_snap_"))
        # the wall time (us) at which the first gang life's ranks had all
        # checked in: the merged pod timeline's t0
        self._anchor_wall_us: Optional[float] = None
        self._last_heartbeats: Dict[int, dict] = {}

    # -- heartbeat content (JSON contract with bootstrap + flight.py) ------
    @staticmethod
    def _read_heartbeat(path: str) -> dict:
        try:
            with open(path) as f:
                txt = f.read()
        except OSError:
            return {}
        try:
            rec = json.loads(txt)
            return rec if isinstance(rec, dict) else {"pid": int(rec)}
        except (ValueError, TypeError):
            try:
                return {"pid": int(txt.strip())}   # pre-JSON format
            except ValueError:
                return {}

    def _snapshot_heartbeats(self, hb_files: Dict[int, str]) \
            -> Dict[int, dict]:
        return {rank: self._read_heartbeat(path)
                for rank, path in hb_files.items()}

    def _note_gang_failure(self, hb_files: Dict[int, str]) -> None:
        """Snapshot the heartbeat files (they die with the hb tempdir),
        name the ranks that never checked in and the suspected straggler
        (observability/podscope.py `suspect_from_heartbeats`)."""
        from ..observability import podscope
        self._last_heartbeats = self._snapshot_heartbeats(hb_files)
        missing = sorted(r for r, hb in self._last_heartbeats.items()
                         if not hb)
        if missing:
            print(f"[launch] rank(s) {missing} never checked in "
                  "(rendezvous stragglers)", flush=True)
        suspect = podscope.suspect_from_heartbeats(self._last_heartbeats)
        if suspect is not None:
            print(f"[launch] suspected straggler: rank {suspect[0]} "
                  f"({suspect[1]})", flush=True)

    # -- gang lifecycle ----------------------------------------------------
    def _spawn(self, world: int, restart_idx: int, hb_dir: str):
        args = self.args
        if args.log_dir:
            os.makedirs(args.log_dir, exist_ok=True)
        procs: Dict[int, subprocess.Popen] = {}
        hb_files: Dict[int, str] = {}
        logs = []
        for rank, plan in enumerate(plan_gang(self.ips, args.port,
                                              args.nproc_per_node, world)):
            hb_files[rank] = os.path.join(hb_dir, f"worker.{rank}.alive")
            env = dict(os.environ)
            env.update(plan)
            env.update({
                "PADDLE_LAUNCH_HEARTBEAT_FILE": hb_files[rank],
                "PADDLE_LAUNCH_HEARTBEAT_INTERVAL_S":
                    str(self.heartbeat_interval_s),
                # the SIGTERM-to-SIGKILL grace, exported so workers can
                # bound their own teardown inside it (a trainer writes
                # its final checkpoint, a snapshot flushes)
                "PADDLE_LAUNCH_GRACE_S": str(self.grace_period_s),
                "PADDLE_ELASTIC_RESTART": str(restart_idx),
                # the gang's dump and snapshot dirs, and when this gang
                # life began
                "FLAGS_flight_dump_dir": self._flight_dir,
                "PADDLE_SNAPSHOT_DIR": self._snapshot_dir,
                "PADDLE_LAUNCH_START_US":
                    str(self._gang_start_wall * 1e6),
            })
            if self.collect_dumps:
                env["PADDLE_FLIGHT_DUMP_AT_EXIT"] = "1"
            log = None
            if args.log_dir:
                log = open(os.path.join(args.log_dir,
                                        f"worker.{rank}.log"), "a")
                logs.append(log)
            procs[rank] = subprocess.Popen(
                [sys.executable, "-c", _BOOTSTRAP, args.training_script]
                + args.training_script_args,
                env=env, stdout=log,
                stderr=subprocess.STDOUT if log else None)
        return procs, hb_files, logs

    def _kill_gang(self, procs: Dict[int, subprocess.Popen]) -> None:
        """SIGTERM everyone still alive (trainers write their final
        checkpoint), SIGKILL whoever outlives the grace window. A dead peer must never leave survivors wedged in a
        collective."""
        alive = [p for p in procs.values() if p.poll() is None]
        for p in alive:
            try:
                p.terminate()
            except OSError:
                pass
        deadline = time.monotonic() + self.grace_period_s
        for p in alive:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        for p in alive:
            if p.poll() is None:
                try:
                    p.kill()
                    p.wait()
                except OSError:
                    pass

    class _WorkerFailed(RuntimeError):
        def __init__(self, rank: int, rc: int, why: str):
            super().__init__(f"worker {rank} {why} (rc={rc})")
            self.rank, self.rc = rank, rc

    def _rendezvous(self, procs, hb_files) -> None:
        """Block until every worker has checked in (created its heartbeat
        file), bounded by the rendezvous deadline via the shared
        resilience.RetryPolicy — exhaustion raises the typed
        DeadlineExceededError (the caller kills the gang). A worker dying
        during rendezvous fails immediately (_WorkerFailed, not
        retryable)."""
        from ..framework import errors
        from ..resilience.retry import RetryPolicy

        def probe():
            for rank, p in procs.items():
                rc = p.poll()
                if rc is not None and rc != 0:
                    raise self._WorkerFailed(rank, rc, "died in rendezvous")
            missing = sorted(r for r in procs
                             if not os.path.exists(hb_files[r]))
            if missing:
                raise errors.Unavailable(
                    "rendezvous: waiting for rank(s) %s", missing)

        policy = RetryPolicy(
            max_attempts=None, base_delay_s=0.05, max_delay_s=0.2,
            jitter=0.0, deadline_s=self.rendezvous_deadline_ms / 1000.0,
            retry_on=(errors.UnavailableError,))
        policy.call(probe, site="launch.rendezvous")

    def _monitor(self, procs, hb_files) -> Tuple[str, int, int]:
        """Watch the running gang. Returns ("ok", world, 0) when every
        worker exits 0, else ("failed", survivors_at_failure, rc) after
        the fail-fast sibling kill."""
        done: set = set()
        while len(done) < len(procs):
            failed: Optional[Tuple[int, int, str]] = None
            now = time.time()     # wall clock: compared against file mtimes
            for rank, p in procs.items():
                if rank in done:
                    continue
                rc = p.poll()
                if rc is None:
                    if self.heartbeat_timeout_s > 0:
                        try:
                            age = now - os.path.getmtime(hb_files[rank])
                        except OSError:
                            # fail CLOSED: the file existed at rendezvous,
                            # so missing/unreadable now means the liveness
                            # signal is gone, not that the worker is fresh
                            age = float("inf")
                        if age > self.heartbeat_timeout_s:
                            why = ("missing" if age == float("inf")
                                   else f"stale for {age:.1f}s")
                            print(f"[launch] worker {rank} heartbeat {why} "
                                  f"(> {self.heartbeat_timeout_s:.1f}s): "
                                  "treating as hung", flush=True)
                            try:
                                p.kill()
                                p.wait()
                            except OSError:
                                pass
                            failed = (rank, -9, "hung (stale heartbeat)")
                            break
                    continue
                if rc == 0:
                    done.add(rank)
                    continue
                failed = (rank, rc, "exited")
                break
            if failed is not None:
                rank, rc, why = failed
                survivors = sum(1 for r, q in procs.items()
                                if r != rank and q.poll() is None)
                print(f"[launch] worker {rank} {why} rc={rc}: "
                      f"fail-fast, terminating {survivors} sibling(s)",
                      flush=True)
                self._kill_gang(procs)
                return ("failed", survivors, rc if rc > 0 else 1)
            time.sleep(0.05)
        return ("ok", len(procs), 0)

    def launch_once(self, world: int, restart_idx: int) \
            -> Tuple[str, int, int]:
        import shutil
        hb_dir = tempfile.mkdtemp(prefix="paddle_launch_hb_")
        # pod-collection cutoff: the shared flight dir outlives elastic
        # restarts, so dumps older than THIS life (removed ranks, previous
        # failures) must not be merged into this life's report
        self._gang_start_wall = time.time()
        procs, hb_files, logs = self._spawn(world, restart_idx, hb_dir)
        try:
            try:
                self._rendezvous(procs, hb_files)
                if self._anchor_wall_us is None:
                    self._anchor_wall_us = time.time() * 1e6
            except self._WorkerFailed as e:
                survivors = sum(1 for p in procs.values()
                                if p.poll() is None)
                print(f"[launch] {e}: fail-fast, terminating "
                      f"{survivors} sibling(s)", flush=True)
                self._note_gang_failure(hb_files)
                self._kill_gang(procs)
                return ("failed", survivors, e.rc if e.rc > 0 else 1)
            except Exception:
                # rendezvous deadline (DeadlineExceededError) or any other
                # supervisor error: never leave a half-launched gang behind
                self._note_gang_failure(hb_files)
                self._kill_gang(procs)
                raise
            result = self._monitor(procs, hb_files)
            if result[0] == "failed":
                self._note_gang_failure(hb_files)
            else:
                self._last_heartbeats = self._snapshot_heartbeats(hb_files)
            return result
        finally:
            for log in logs:
                try:
                    log.close()
                except OSError:
                    pass
            shutil.rmtree(hb_dir, ignore_errors=True)

    def collect_pod_dumps(self, status: str, world: int, rc: int,
                          restart_idx: int) -> Optional[str]:
        """Gather this gang life's per-rank flight dumps into one pod dump
        dir and write the merged timeline and straggler report beside
        them (observability/podscope.py). Runs on every failure and, with
        --collect-dumps, on clean exits. Never raises: collection must
        not turn a diagnosed failure into a crash of its own."""
        import shutil
        from ..observability import podscope
        try:
            dumps = podscope.find_rank_dumps(self._flight_dir)
            # this life's ranks only: the shared dir outlives restarts
            cutoff = getattr(self, "_gang_start_wall", None)
            if cutoff is not None:
                dumps = {r: d for r, d in dumps.items()
                         if float(d.get("wall_time") or 0.0) >= cutoff - 1.0}
            if world > 0:
                dumps = {r: d for r, d in dumps.items() if r < world}
            if not dumps and not self.collect_dumps:
                return None
            pod_dir = self.args.pod_dump_dir or os.path.join(
                self._flight_dir, f"pod_{restart_idx}_{status}")
            os.makedirs(pod_dir, exist_ok=True)
            for dump in dumps.values():
                src = dump.get("_path")
                if src and os.path.dirname(os.path.abspath(src)) \
                        != os.path.abspath(pod_dir):
                    shutil.copy(src, pod_dir)
            hb = self._last_heartbeats
            with open(os.path.join(pod_dir, "heartbeats.json"), "w") as f:
                json.dump({"status": status, "world": world, "rc": rc,
                           "restart_idx": restart_idx,
                           "anchor_us": self._anchor_wall_us,
                           "heartbeats": {str(r): v
                                          for r, v in sorted(hb.items())}},
                          f, indent=1)
            if not dumps:
                print(f"[launch] pod dump dir {pod_dir}: no per-rank "
                      "flight dumps found (workers exited before dumping "
                      "or FLAGS_flight_recorder=0)", flush=True)
                return pod_dir
            res = podscope.write_pod_dump(
                dumps, pod_dir, heartbeats=hb,
                anchor_us=self._anchor_wall_us,
                extra_meta={"status": status, "world": world, "rc": rc,
                            "restart_idx": restart_idx})
            summary = res["summary"]
            suspect = ("none" if res["suspect"] is None
                       else f"rank {res['suspect']}")
            print(f"[launch] pod dump: {len(dumps)} rank dump(s) -> "
                  f"{res['trace']} ({res['meta']['flow_pairs']} cross-rank "
                  f"collective flow pair(s)); straggler report: "
                  f"{res['report']} (suspect: {suspect}, step-time spread "
                  f"{summary['step_time_spread_ms']:.1f} ms, collective "
                  f"stall fraction {summary['collective_stall_fraction']})",
                  flush=True)
            return pod_dir
        except Exception as e:        # noqa: BLE001 - documented above
            print(f"[launch] pod dump collection failed: {e!r}", flush=True)
            return None

    def _log_recovery_rungs(self) -> None:
        """Stamp each rank's chosen recovery rung (peer / local / disk:
        resilience/snapshot.py writes the records at restore time) into
        the gang log, scoped to this gang life."""
        from ..resilience.snapshot import read_recovery_stamps
        since = getattr(self, "_gang_start_wall", 0.0) or 0.0
        for rec in read_recovery_stamps(self._snapshot_dir,
                                        since=since - 1.0):
            print(f"[launch] recovery: rank {rec.get('rank')} "
                  f"rung={rec.get('rung')} step={rec.get('step')}",
                  flush=True)

    def run(self) -> int:
        args = self.args
        world = len(self.ips) * max(args.nproc_per_node, 1)
        full_world = world
        restarts = 0
        while True:
            status, survivors, rc = self.launch_once(world, restarts)
            self._log_recovery_rungs()
            if status == "ok":
                if self.collect_dumps:
                    self.collect_pod_dumps("ok", world, 0, restarts)
                return 0
            # black-box the failed launch: the supervisor's own timeline
            # next to the trainers' logs, in the flight-dump format
            from ..observability import flight as _flight
            from ..observability import podscope
            suspect = podscope.suspect_from_heartbeats(self._last_heartbeats)
            path = _flight.dump(
                "gang_failure",
                extra={"world": world, "survivors": survivors,
                       "rc": rc, "restart_idx": restarts,
                       "suspected_straggler":
                           None if suspect is None else suspect[0],
                       "heartbeats": {str(r): v for r, v in
                                      sorted(self._last_heartbeats.items())}})
            if path:
                print(f"[launch] flight-recorder dump: {path}", flush=True)
            self.collect_pod_dumps("failed", world, rc, restarts)
            if restarts >= args.elastic_restarts or survivors < 1:
                return rc
            restarts += 1
            if args.elastic_full_world:
                world = full_world
                print(f"[launch] elastic restart {restarts}/"
                      f"{args.elastic_restarts}: relaunching at full world "
                      f"size {world}; replaced rank(s) recover from peer "
                      "snapshots (resilience/snapshot.py)", flush=True)
            else:
                world = survivors
                print(f"[launch] elastic restart {restarts}/"
                      f"{args.elastic_restarts}: relaunching at world size "
                      f"{world}; trainers resume from their latest "
                      "checkpoint", flush=True)


def launch(argv=None):
    sup = GangSupervisor(_parse_args(argv))
    try:
        rc = sup.run()
    except Exception as e:
        # a typed failure (the rendezvous DeadlineExceededError, ...): one
        # clear line and a non-zero exit; a broken launch fails, never
        # hangs
        from ..observability import flight as _flight
        path = _flight.dump("gang_failure", extra={"error": repr(e)})
        print(f"[launch] FAILED: {e!r}" + (
            f" (flight-recorder dump: {path})" if path else ""),
            file=sys.stderr, flush=True)
        sup.collect_pod_dumps("failed", 0, 1, 0)
        raise SystemExit(1)
    sys.exit(rc)


if __name__ == "__main__":
    launch()
