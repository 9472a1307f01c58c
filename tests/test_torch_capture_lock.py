"""PyTorch port: one CUDA graph capture at a time in the process, and no
collection inside anyone's capture (`paddle_tpu_torch.device`).

* `collector_paused` collects only when no other hold is active: a
  second thread entering while the first holds it does not call
  `gc.collect` (a stand-in counts the calls), and the collector stays off
  until the last hold ends.
* `capture_lock` is one reentrant lock for the process: while one thread
  holds it (as a capture does, from its warm-up to its end), another
  thread's `collector_paused` waits, so its collection runs only after
  the capture; the holding thread may enter `collector_paused` itself.
* Both capture sites take it: the serving engine's `_Captured` and the
  Executor's `_CapturedStep.capture`.
* On a CUDA card (marker `cuda`, skipped here; run it there with
  `python -m pytest -m cuda tests/test_torch_capture_lock.py`): a dead
  executor cycle pending with the collector set to run at every
  allocation, one thread captures a training step while another starts a
  serving engine that captures its decode window. Both captures succeed,
  the dead cycle is freed while no capture is under way, the captured
  steps equal eager runs bit for bit and the engine's greedy tokens equal
  a second engine's, built alone.
"""
import gc
import inspect
import threading
import weakref

import numpy as np
import pytest
import torch

from paddle_tpu_torch import device as port_device
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch import serving as port_serving
from paddle_tpu_torch.device import capture_lock, collector_paused
from paddle_tpu_torch.framework import Executor, Scope, load_numpy
from paddle_tpu_torch.framework import executor as port_executor
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.models import gpt as port_gpt
from paddle_tpu_torch.models import gpt_decode as port_decode
from paddle_tpu_torch.serving import engine as port_engine

K = 3


class _CountingCollect:
    def __init__(self):
        self.calls = 0

    def __call__(self, *args):
        self.calls += 1
        return 0


def test_second_hold_does_not_collect_while_the_first_is_active(
        monkeypatch):
    collect = _CountingCollect()
    monkeypatch.setattr(port_device.gc, "collect", collect)
    inside, release = threading.Event(), threading.Event()
    seen = {}

    def other():
        with collector_paused():
            seen["calls_inside"] = collect.calls
            inside.set()
            release.wait(10)

    with collector_paused():
        assert collect.calls == 1 and not gc.isenabled()
        t = threading.Thread(target=other)
        t.start()
        assert inside.wait(10)
        # the other thread's hold began while this one was active
        assert seen["calls_inside"] == 1
    assert not gc.isenabled()          # the other hold is still active
    release.set()
    t.join(10)
    assert not t.is_alive() and gc.isenabled()
    with collector_paused():           # no hold active: collects again
        assert collect.calls == 2


def test_capture_lock_holds_off_other_threads_collection(monkeypatch):
    """A thread holding `capture_lock` (a capture in progress) keeps
    another thread's `collector_paused` (and its collection) waiting until
    it lets go; the holding thread itself may nest `collector_paused`."""
    collect = _CountingCollect()
    monkeypatch.setattr(port_device.gc, "collect", collect)
    started, entered = threading.Event(), threading.Event()

    def other():
        started.set()
        with collector_paused():
            entered.set()

    with capture_lock:
        with collector_paused():       # reentrant in the capturing thread
            assert collect.calls == 1
            t = threading.Thread(target=other)
            t.start()
            assert started.wait(10)
            assert not entered.wait(0.3)
            assert collect.calls == 1
    t.join(10)
    assert not t.is_alive() and entered.is_set()
    assert collect.calls == 2 and gc.isenabled()


def test_both_capture_sites_take_the_process_lock():
    assert not hasattr(port_engine, "_capture_lock")
    for fn in (port_engine._Captured.__init__,
               port_executor._CapturedStep.capture):
        src = inspect.getsource(fn)
        assert "with capture_lock:" in src, fn
    assert port_engine.capture_lock is port_executor.capture_lock \
        is capture_lock
    assert isinstance(capture_lock, type(threading.RLock()))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _gpt_cfg():
    # head_dim 64: the flash kernels' and B4's width
    return port_gpt.GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                              num_heads=2, intermediate_size=256,
                              max_position=64, seq_len=64)


def _program(cfg):
    main, start = port_program.Program(), port_program.Program()
    with port_program.program_guard(main, start), port_unique_name.guard():
        cfg.hidden_dropout = cfg.attention_dropout = 0.1
        _, loss = port_gpt.build_lm_program(cfg)
        port_optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, start, loss


class _Cycle:
    def __init__(self):
        self.me = self


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captures run only there")
    return torch.device("cuda")


def run_two_thread_captures():
    """The card check, also run by chip_smoke.py: returns a dict of what
    it saw, and raises AssertionError if a contract broke."""
    cfg = _gpt_cfg()
    main, start, loss = _program(cfg)
    scope0 = Scope()
    Executor("cuda").run(start, scope=scope0)
    arrays = {n: scope0.numpy(n) for n in scope0.local_names()
              if not n.startswith("__")}
    weights = {n: arrays[n] for n in port_decode.param_names(cfg)}
    rng = np.random.RandomState(0)
    feeds = {"tokens": rng.randint(0, cfg.vocab_size,
                                   (K, 2, cfg.seq_len)).astype(np.int64)}
    prompts = [rng.randint(0, cfg.vocab_size, (n,)) for n in (5, 9)]
    engine_kw = dict(max_slots=2, block_size=16, num_blocks=16, max_len=48,
                     window=4, dtype="float32", device="cuda")

    def serve():
        eng = port_serving.DecodeEngine(weights, cfg, **engine_kw)
        try:
            comps = eng.generate([port_serving.Request(
                prompt=p, max_new_tokens=8) for p in prompts], timeout=300)
            stats = eng.stats()
        finally:
            eng.stop()
        assert all(c.ok for c in comps), comps
        return [list(c.tokens) for c in comps], stats

    # a captured executor, dropped inside a reference cycle
    first = Executor("cuda")
    first.run_steps(K, main, feed=feeds, fetch_list=[loss],
                    scope=load_numpy(Scope(), arrays, "cuda"))
    in_flight = [0]
    freed_during = []
    holder = _Cycle()
    holder.exe = first
    weakref.finalize(holder, lambda: freed_during.append(in_flight[0]))
    del first, holder

    begin, end = torch.cuda.CUDAGraph.capture_begin, \
        torch.cuda.CUDAGraph.capture_end

    def counted_begin(self, *a, **kw):
        in_flight[0] += 1
        return begin(self, *a, **kw)

    def counted_end(self, *a, **kw):
        try:
            return end(self, *a, **kw)
        finally:
            in_flight[0] -= 1

    results, errors = {}, []
    barrier = threading.Barrier(2)
    cap, b = Executor("cuda"), load_numpy(Scope(), arrays, "cuda")

    def train():
        try:
            barrier.wait(30)
            results["train"] = cap.run_steps(K, main, feed=feeds,
                                             fetch_list=[loss], scope=b)[0]
        except BaseException as e:
            errors.append(("train", e))

    def serving():
        try:
            barrier.wait(30)
            results["serve"] = serve()
        except BaseException as e:
            errors.append(("serve", e))

    thresholds = gc.get_threshold()
    torch.cuda.CUDAGraph.capture_begin = counted_begin
    torch.cuda.CUDAGraph.capture_end = counted_end
    gc.set_threshold(1, 1, 1)
    try:
        threads = [threading.Thread(target=f) for f in (train, serving)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    finally:
        gc.set_threshold(*thresholds)
        torch.cuda.CUDAGraph.capture_begin = begin
        torch.cuda.CUDAGraph.capture_end = end
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert freed_during == [0], freed_during
    assert cap.stats["captures"] == 1 and cap.stats["eager_steps"] == 0
    eager, a = Executor("cuda"), load_numpy(Scope(), arrays, "cuda")
    runs = np.stack([eager.run(main, feed={"tokens": feeds["tokens"][j]},
                               fetch_list=[loss], scope=a)[0]
                     for j in range(K)])
    np.testing.assert_array_equal(results["train"], runs)
    tokens, stats = results["serve"]
    alone, _ = serve()
    assert tokens == alone
    assert stats["eager_calls"] == 0 and stats["graph_replays"], stats
    return {"train_captures": cap.stats["captures"],
            "serve_graph_replays": stats["graph_replays"],
            "dead_cycle_freed_with_captures_in_flight": freed_during,
            "losses": results["train"].tolist()}


@pytest.mark.cuda
def test_training_and_serving_capture_from_two_threads(cuda_card):
    run_two_thread_captures()
