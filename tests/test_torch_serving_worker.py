"""PyTorch port, the supervised decode worker
(paddle_tpu_torch/serving/frontend.py `worker_main`) against the
reference's (paddle_tpu/serving/frontend.py:113), tiny GPT on the CPU.

* Shards and rows: for rank 0 and rank 1 of a world of 2, the port's
  worker takes the same requests (row i to rank i mod world) and writes
  the same row keys and states as the reference's worker.
* Tokens: the worker builds the GPT from the startup program seeded 0 and
  serves it with `params_from_scope`; its greedy and seeded tokens equal
  an in-process DecodeEngine's over the same parameters, and its greedy
  tokens equal the reference's engine's over the same weights carried as
  numpy (f32).
* Under the launcher: two workers, each writing `rank<r>.jsonl` with its
  shard's tokens, exit 0.
* SIGTERM mid-serve: the worker drains, writes the unstarted requests as
  `handed_back` and the in-flight ones as done, and exits 0.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from paddle_tpu_torch.distributed.spawn import free_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = dict(max_slots=3, max_len=32, window=4, block_size=8,
              num_blocks=24)


def _rows(n, vocab=512, seed=7, max_new=6):
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        row = {"uid": f"q{i}",
               "prompt": rng.randint(0, vocab, (3 + i % 5,)).tolist(),
               "max_new": max_new}
        if i % 3 == 2:
            row.update(temperature=0.8, top_k=20, seed=100 + i)
        rows.append(row)
    return rows


def _write_rows(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _read(path):
    with open(path) as f:
        return {r["uid"]: r for r in (json.loads(ln) for ln in f if ln)}


def _port_worker(tmp_path, rank, world, rows, monkeypatch):
    from paddle_tpu_torch.serving.frontend import worker_main
    req = str(tmp_path / "req.jsonl")
    _write_rows(req, rows)
    monkeypatch.setenv("PADDLE_TRAINER_ID", str(rank))
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", str(world))
    out = str(tmp_path / "port")
    assert worker_main(req, out, model="tiny", device="cpu", **ENGINE) == 0
    return _read(os.path.join(out, f"rank{rank}.jsonl"))


@pytest.mark.parametrize("rank", [0, 1])
def test_shards_and_rows_equal_reference(tmp_path, monkeypatch, rank):
    from paddle_tpu.serving.frontend import worker_main as ref_worker
    rows = _rows(5)
    got = _port_worker(tmp_path, rank, 2, rows, monkeypatch)
    req = str(tmp_path / "req.jsonl")
    ref_out = str(tmp_path / "ref")
    assert ref_worker(req, ref_out, model="tiny",
                      **{k: v for k, v in ENGINE.items()
                         if k in ("max_slots", "max_len", "window")}) == 0
    want = _read(os.path.join(ref_out, f"rank{rank}.jsonl"))
    assert sorted(got) == sorted(want) == [f"q{i}" for i in range(5)
                                           if i % 2 == rank]
    for uid in got:
        assert set(got[uid]) == set(want[uid])
        assert got[uid]["state"] == want[uid]["state"] == "done"
        assert got[uid]["rank"] == want[uid]["rank"] == rank
        assert len(got[uid]["tokens"]) == len(want[uid]["tokens"]) == 6


def _tiny_params():
    """The worker's GPT: the startup program seeded 0, on the CPU."""
    from paddle_tpu_torch.framework import Executor, default_startup_program
    from paddle_tpu_torch.models.gpt import GPTConfig, build_lm_program
    from paddle_tpu_torch.models.gpt_decode import params_from_scope
    from paddle_tpu_torch.testing import reset_programs
    reset_programs(seed=0)
    cfg = GPTConfig.tiny()
    build_lm_program(cfg)
    Executor("cpu").run(default_startup_program())
    return cfg, params_from_scope(cfg, device="cpu")


def _engine_tokens(rows):
    from paddle_tpu_torch import serving
    cfg, params = _tiny_params()
    eng = serving.DecodeEngine(params, cfg, device="cpu", **ENGINE)
    try:
        comps = eng.generate([serving.Request(
            prompt=np.asarray(r["prompt"]), max_new_tokens=r["max_new"],
            temperature=r.get("temperature", 0.0), top_k=r.get("top_k", 0),
            seed=r.get("seed", 0), uid=r["uid"]) for r in rows],
            timeout=240)
    finally:
        eng.stop()
    return {c.uid: list(c.tokens) for c in comps}, cfg, params


def test_tokens_equal_the_engine_and_the_reference(tmp_path, monkeypatch):
    import jax.numpy as jnp
    from paddle_tpu.models.gpt import GPTConfig as RefGPTConfig
    from paddle_tpu.serving import DecodeEngine as RefEngine
    from paddle_tpu.serving import Request as RefRequest
    rows = _rows(6)
    got = _port_worker(tmp_path, 0, 1, rows, monkeypatch)
    want, cfg, params = _engine_tokens(rows)
    assert {u: r["tokens"] for u, r in got.items()} == want
    ref_cfg = RefGPTConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(RefGPTConfig)
                              if hasattr(cfg, f.name)})
    ref_params = {n: jnp.asarray(t.numpy()) for n, t in params.items()}
    greedy = [r for r in rows if "temperature" not in r]
    eng = RefEngine(ref_params, ref_cfg, decode_kernel=False,
                    **{k: v for k, v in ENGINE.items()})
    try:
        comps = eng.generate([RefRequest(prompt=np.asarray(r["prompt"],
                                                           np.int32),
                                         max_new_tokens=r["max_new"],
                                         uid=r["uid"]) for r in greedy],
                             timeout=240)
    finally:
        eng.stop()
    for c in comps:
        assert list(c.tokens) == got[c.uid]["tokens"], c.uid


WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(1)
    from paddle_tpu_torch.serving import frontend
    marker = {marker!r}
    if marker:
        generate = frontend.ServingFrontend.generate

        def noted(self, requests, timeout=300.0):
            with open(marker, "w") as f:
                f.write(str(os.getpid()))
            return generate(self, requests, timeout)

        frontend.ServingFrontend.generate = noted
    sys.exit(frontend.worker_main({req!r}, {out!r}, model="tiny",
                                  device="cpu", **{engine!r}))
    """)


def test_a_gang_of_workers_under_the_launcher(tmp_path):
    rows = _rows(6)
    req, out = str(tmp_path / "req.jsonl"), str(tmp_path / "out")
    _write_rows(req, rows)
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO, marker="", req=req, out=out,
                                    engine=ENGINE))
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--port", str(free_ports(1)[0]),
         "--rendezvous_deadline_ms", "60000", "--grace_period_s", "5",
         str(script)], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    want, _, _ = _engine_tokens(rows)
    for rank in range(2):
        got = _read(os.path.join(out, f"rank{rank}.jsonl"))
        assert sorted(got) == [f"q{i}" for i in range(6) if i % 2 == rank]
        for uid, row in got.items():
            assert row["state"] == "done" and row["tokens"] == want[uid]


def test_sigterm_drains_and_hands_back(tmp_path):
    rows = _rows(16, max_new=24)
    req, out = str(tmp_path / "req.jsonl"), str(tmp_path / "out")
    marker = str(tmp_path / "serving.pid")
    _write_rows(req, rows)
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(
        repo=REPO, marker=marker, req=req, out=out,
        engine=dict(ENGINE, max_slots=1)))
    env = dict(os.environ, PADDLE_LAUNCH_GRACE_S="20")
    proc = subprocess.Popen([sys.executable, str(script)], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(marker) and time.monotonic() < deadline:
            assert proc.poll() is None, proc.communicate()[0]
            time.sleep(0.05)
        time.sleep(0.3)
        proc.send_signal(signal.SIGTERM)
        log, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log
    got = _read(os.path.join(out, "rank0.jsonl"))
    states = [got[f"q{i}"]["state"] for i in range(16)]
    assert "handed_back" in states and "done" in states, states
    # FCFS with one slot: the finished requests come first
    first = states.index("handed_back")
    assert set(states[:first]) == {"done"}
    assert set(states[first:]) == {"handed_back"}
