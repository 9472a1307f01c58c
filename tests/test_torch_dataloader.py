"""PyTorch port, paddle.io data loading (`paddle_tpu_torch/dataloader/`)
held against the reference's `paddle_tpu.dataloader`, modelled on the
reference's tests/test_data_pipeline.py, tests/test_async_dispatch.py
(prefetch) and tests/test_resilience.py (the worker fault site).

* Samplers: RandomSampler (seeded, with and without replacement, a
  num_samples cut, three epochs), BatchSampler (drop_last either way) and
  DistributedBatchSampler (shuffled, three ranks, `set_epoch`) give the
  reference's orders; random_split, TensorDataset and DataFeeder too.
* DataLoader: the same batches in the same order as the reference's for
  one seed, in one process and with 1 and 4 worker processes; reshuffled
  between epochs; a loader rebuilt at the same seed, advanced past the
  batches a checkpoint covered, yields the next batch bit for bit;
  from_generator's three readers give the reference's batches and feed
  training (GPT-tiny, f32, one batch four times: the reference's losses
  within rtol 1e-5, and falling).
* Workers: a worker's error surfaces naming it; a SIGKILLed worker is
  caught by the liveness poll within seconds; a batch still in the dead
  worker's pipe is drained instead of failing; workers retiring cleanly
  are not deaths; a `dataloader.worker` kill is respawned within
  FLAGS_dataloader_max_respawns (counted, the same batches), the default
  budget 0 fails fast naming exit code 43, and an exhausted budget names
  it too.
* prefetch: through an executor every staged feed is consumed by
  identity (no coercion at the run, nothing left staged, h2d time
  counted) and the losses equal the host path's bit for bit, as without
  an executor; close() mid-epoch never wedges and is idempotent; an
  abandoned iterator's thread ends and its staged windows are purged;
  non-dict batches are refused.
"""
import gc
import os
import signal
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu import dataloader as ref_dl
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu.models import gpt as ref_gpt

from paddle_tpu_torch import dataloader as port_dl
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import monitor
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.dataloader import dataloader as port_dl_impl
from paddle_tpu_torch.flags import flag, set_flags
from paddle_tpu_torch.framework import Executor, Scope, load_numpy
from paddle_tpu_torch.framework import executor as port_executor
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.models import gpt as port_gpt
from paddle_tpu_torch.resilience.faults import clear_plan, install_plan

SEQ, BATCH = 32, 4


@pytest.fixture(autouse=True)
def no_fault_plan():
    clear_plan()
    yield
    clear_plan()


def _arrays(n=23):
    return [np.arange(n, dtype=np.float32)[:, None],
            (np.arange(n) ** 2).astype(np.int64)]


def _epochs(sampler, n=3):
    return [list(sampler) for _ in range(n)]


@pytest.mark.parametrize("kw", [dict(generator=3),
                                dict(generator=5, num_samples=7),
                                dict(generator=11, replacement=True,
                                     num_samples=40)])
def test_random_sampler_orders_match_the_reference(kw):
    ds = list(range(23))
    got = _epochs(port_dl.RandomSampler(ds, **kw))
    assert got == _epochs(ref_dl.RandomSampler(ds, **kw))
    assert got[0] != got[1]                 # the next epoch reshuffles
    assert len(port_dl.RandomSampler(ds, **kw)) == len(got[0])


@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_sampler_matches_the_reference(drop_last):
    ds = list(range(23))

    def make(m):
        return m.BatchSampler(sampler=m.RandomSampler(ds, generator=2),
                              batch_size=5, drop_last=drop_last)

    got = _epochs(make(port_dl))
    assert got == _epochs(make(ref_dl))
    assert len(make(port_dl)) == len(got[0]) == (4 if drop_last else 5)
    seq = list(port_dl.BatchSampler(dataset=ds, batch_size=10))
    assert seq == [list(range(10)), list(range(10, 20)), [20, 21, 22]]
    with pytest.raises(ValueError, match="exactly one"):
        port_dl.BatchSampler(dataset=ds, sampler=port_dl.SequenceSampler(ds))


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_distributed_batch_sampler_matches_the_reference(rank):
    ds = list(range(20))

    def make(m):
        return m.DistributedBatchSampler(ds, batch_size=3, num_replicas=3,
                                         rank=rank, shuffle=True)

    port, ref = make(port_dl), make(ref_dl)
    for epoch in (0, 4):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert list(port) == list(ref)
    assert list(port) == list(ref)          # epoch 5, advanced by iter
    assert len(port) == len(ref) == 3
    assert len([i for b in make(port_dl) for i in b]) == 7


def test_random_split_tensor_dataset_and_feeder_match_the_reference():
    xs, ys = _arrays(10)
    pa = port_dl.random_split(port_dl.TensorDataset([xs, ys]), [7, 3],
                              generator=0)
    ra = ref_dl.random_split(ref_dl.TensorDataset([xs, ys]), [7, 3],
                             generator=0)
    assert [s.indices for s in pa] == [s.indices for s in ra]
    for i in range(3):
        for a, b in zip(pa[1][i], ra[1][i]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        port_dl.random_split(port_dl.TensorDataset([xs, ys]), [7, 4])
    with pytest.raises(ValueError, match="dim 0"):
        port_dl.TensorDataset([xs, ys[:3]])
    main, start = port_program.Program(), port_program.Program()
    from paddle_tpu_torch import layers as port_layers
    with port_program.program_guard(main, start), port_unique_name.guard():
        x = port_layers.data(name="x", shape=[1], dtype="float32")
        y = port_layers.data(name="y", shape=[1], dtype="int64")
    feed = port_dl.DataFeeder(feed_list=[x, y]).feed(
        [(xs[i], ys[i]) for i in range(4)])
    assert feed["x"].shape == (4, 1) and feed["x"].dtype == np.float32
    assert feed["y"].shape == (4, 1) and feed["y"].dtype == np.int64
    assert port_io.DataLoader is port_dl.DataLoader
    assert port_io.DistributedBatchSampler is port_dl.DistributedBatchSampler


def _port_loader(arrays, seed, num_workers, **kw):
    ds = port_dl.TensorDataset(arrays)
    return port_dl.DataLoader(
        ds, batch_sampler=port_dl.BatchSampler(
            sampler=port_dl.RandomSampler(ds, generator=seed),
            batch_size=4), num_workers=num_workers, **kw)


def _ref_batches(arrays, seed, epochs=1):
    ds = ref_dl.TensorDataset(arrays)
    dl = ref_dl.DataLoader(ds, batch_sampler=ref_dl.BatchSampler(
        sampler=ref_dl.RandomSampler(ds, generator=seed), batch_size=4),
        use_buffer_reader=False)
    return [[tuple(np.asarray(f) for f in b) for b in dl]
            for _ in range(epochs)]


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_workers", [0, 1, 4])
def test_dataloader_batches_match_the_reference(num_workers):
    arrays = _arrays(31)
    dl = _port_loader(arrays, seed=9, num_workers=num_workers)
    assert len(dl) == 8
    want = _ref_batches(arrays, seed=9, epochs=2)
    for epoch in range(2):           # the second epoch reshuffles
        _same_batches(list(dl), want[epoch])
    first = np.concatenate([b[0] for b in want[0]]).ravel()
    second = np.concatenate([b[0] for b in want[1]]).ravel()
    assert sorted(first) == sorted(second) and not np.array_equal(
        first, second)


def test_resumed_loader_yields_the_next_batch_bit_for_bit():
    """A checkpoint taken after 5 batches of epoch 0: the loader rebuilt
    at the same seed (epoch 0) and advanced past those 5 gives batch 5."""
    arrays = _arrays(48)
    straight = list(_port_loader(arrays, seed=4, num_workers=2))
    resumed = iter(_port_loader(arrays, seed=4, num_workers=2))
    for _ in range(5):
        next(resumed)
    for a, b in zip(next(resumed), straight[5]):
        np.testing.assert_array_equal(a, b)


class _BadDataset(port_dl.Dataset):
    """Module level: forkserver workers unpickle it by reference."""

    def __getitem__(self, i):
        if i == 3:
            raise ValueError("boom-at-3")
        return np.float32([i])

    def __len__(self):
        return 8


def test_worker_error_surfaces_naming_the_worker():
    dl = port_dl.DataLoader(_BadDataset(), batch_size=2, num_workers=2,
                            use_buffer_reader=False)
    with pytest.raises(RuntimeError, match=r"worker \d: ValueError"):
        list(dl)


class _SlowAtZeroDataset(port_dl.Dataset):
    """Index 0 stalls long enough for the test to SIGKILL its worker."""

    def __getitem__(self, i):
        if i == 0:
            time.sleep(120)
        return np.float32([i])

    def __len__(self):
        return 8


def test_killed_worker_is_caught_by_the_liveness_poll():
    batches = [[i, i + 1] for i in range(0, 8, 2)]
    it = port_dl_impl._MultiprocessIter(
        _SlowAtZeroDataset(), batches, port_dl_impl.default_collate_fn,
        num_workers=2)
    victim = it._workers[0]        # owns batch 0, asleep in it
    time.sleep(1.0)
    os.kill(victim.pid, signal.SIGKILL)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="died unexpectedly.*SIGKILL"):
        next(it)
    assert time.perf_counter() - t0 < 30


def test_batch_in_a_dead_workers_pipe_is_drained_not_fatal():
    """The put-then-exit race, simulated: the first poll misses (the batch
    is still in the pipe) while the death check says the worker died
    owing it; the drain must pick the batch up."""
    import queue as queue_mod

    class _FirstPollMisses:
        def __init__(self, q):
            self._q, self._missed = q, False

        def get(self, timeout=None):
            if not self._missed:
                self._missed = True
                raise queue_mod.Empty
            return self._q.get(timeout=timeout)

        def __getattr__(self, name):
            return getattr(self._q, name)

    xs, ys = _arrays(2)
    it = port_dl_impl._MultiprocessIter(
        port_dl.TensorDataset([xs, ys]), [[0, 1]],
        port_dl_impl.default_collate_fn, num_workers=1)
    in_flight = it._data_queue.get(timeout=60)
    it._data_queue.put(in_flight)
    it._data_queue = _FirstPollMisses(it._data_queue)
    orig = it._abnormal_deaths
    it._abnormal_deaths = lambda: orig() if 0 in it._received else [(0, 1)]
    feats, squares = next(it)
    np.testing.assert_array_equal(feats.ravel(), [0.0, 1.0])
    np.testing.assert_array_equal(squares, [0, 1])
    with pytest.raises(StopIteration):
        next(it)


def test_workers_retiring_cleanly_are_not_deaths():
    xs, ys = _arrays(16)
    dl = port_dl.DataLoader(port_dl.TensorDataset([xs, ys]), batch_size=4,
                            num_workers=2, use_buffer_reader=False)
    out = np.concatenate([b[0] for b in dl]).ravel()
    np.testing.assert_array_equal(out, np.arange(16, dtype=np.float32))


def _kill_iter(n_batches, budget):
    xs, ys = _arrays(2 * n_batches)
    return port_dl_impl._MultiprocessIter(
        port_dl.TensorDataset([xs, ys]),
        [[i, i + 1] for i in range(0, 2 * n_batches, 2)],
        port_dl_impl.default_collate_fn, num_workers=1,
        max_respawns=budget)


def test_worker_kill_is_respawned_within_the_budget_and_counted():
    """One worker, 4 batches, killed at its 3rd: the respawned worker owns
    batches 2 and 3 and completes the epoch; one respawn. The delay rule
    fires before the kill on the same call, so the dying worker's queue
    feeder has flushed what it delivered (a bare kill can die holding the
    data queue's write lock)."""
    install_plan("dataloader.worker:delay=0.25:at=3;"
                 "dataloader.worker:kill:at=3")
    before = monitor.stat_get("resilience.worker_respawns")
    with pytest.warns(UserWarning, match="fault-injection kill"):
        feats = np.concatenate([b[0] for b in _kill_iter(4, budget=1)])
    np.testing.assert_array_equal(feats.ravel(),
                                  np.arange(8, dtype=np.float32))
    assert monitor.stat_get("resilience.worker_respawns") == before + 1


def test_default_budget_fails_fast_naming_the_exit_code():
    assert flag("FLAGS_dataloader_max_respawns") == 0
    install_plan("dataloader.worker:kill:at=1")
    with pytest.raises(RuntimeError,
                       match=r"exitcode 43 \(fault-injection kill\)"):
        next(_kill_iter(2, budget=None))


def test_exhausted_budget_fails_naming_the_exit_code():
    install_plan("dataloader.worker:kill:every=1")   # dies on every batch
    set_flags({"FLAGS_dataloader_max_respawns": 1})
    try:
        with pytest.warns(UserWarning, match="respawning"), \
                pytest.raises(RuntimeError,
                              match=r"exitcode 43 \(fault-injection kill\)"):
            next(_kill_iter(2, budget=None))
    finally:
        set_flags({"FLAGS_dataloader_max_respawns": 0})


# ---------------------------------------------------------------------------
# from_generator, feeding training; prefetch
# ---------------------------------------------------------------------------

def _token_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 512, (n, BATCH, SEQ)).astype(np.int64)


@pytest.mark.parametrize("reader", ["sample", "sample_list", "batch"])
def test_from_generator_readers_match_the_reference(reader):
    toks = _token_batches(3).reshape(-1, SEQ)         # 12 samples

    def build(m):
        dl = m.DataLoader.from_generator(capacity=2)
        if reader == "sample":
            return dl.set_sample_generator(lambda: iter(toks), batch_size=5,
                                           drop_last=False)
        if reader == "sample_list":
            return dl.set_sample_list_generator(lambda: iter(
                [[(t,) for t in toks[i:i + 4]] for i in range(0, 12, 4)]))
        return dl.set_batch_generator(lambda: iter(
            [(toks[i:i + 6],) for i in range(0, 12, 6)]))

    got = [tuple(np.asarray(f) for f in b) for b in build(port_dl)]
    ref = build(ref_dl)
    ref.use_buffer_reader = False
    _same_batches(got, [tuple(np.asarray(f) for f in b) for b in ref])


def _port_gpt():
    main, start = port_program.Program(), port_program.Program()
    with port_program.program_guard(main, start), port_unique_name.guard():
        cfg = port_gpt.GPTConfig.tiny()
        tokens, loss = port_gpt.build_lm_program(cfg)
        port_optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, tokens, loss


@pytest.fixture(scope="module")
def gpt_init():
    main, start = ref_program.Program(), ref_program.Program()
    with ref_program.program_guard(main, start), ref_unique_name.guard():
        tokens, loss = ref_gpt.build_lm_program(ref_gpt.GPTConfig.tiny())
        paddle.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    scope = RefScope()
    fluid.Executor().run(start, scope=scope)
    init = {n: np.asarray(scope.find(n)) for n in scope.local_names()
            if not n.startswith("__")}
    return init, main, tokens, loss


def _generator_loader(m, feed_list, batches):
    dl = m.DataLoader.from_generator(feed_list=feed_list, capacity=4)
    return dl.set_batch_generator(lambda: iter([(b,) for b in batches]))


def test_from_generator_feeds_training_like_the_reference(gpt_init):
    init, rmain, rtokens, rloss = gpt_init
    batches = np.repeat(_token_batches(1, seed=1), 4, axis=0)
    rscope = RefScope()
    for n, a in init.items():
        rscope.set(n, a)
    rexe = fluid.Executor()
    want = [float(np.asarray(rexe.run(rmain, feed={
        k: np.asarray(v) for k, v in feed.items()}, fetch_list=[rloss],
        scope=rscope)[0])) for feed in _generator_loader(
            ref_dl, [rtokens], batches)]
    main, tokens, loss = _port_gpt()
    exe, scope = Executor("cpu"), load_numpy(Scope(), init, "cpu")
    got = [float(exe.run(main, feed=feed, fetch_list=[loss],
                         scope=scope)[0])
           for feed in _generator_loader(port_dl, [tokens], batches)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def _prefetch_arm(init, batches, mode):
    """Losses of GPT-tiny trained on `batches`: fed as host dicts
    ("host"), through prefetch with the executor ("executor") or without
    it ("device")."""
    main, tokens, loss = _port_gpt()
    exe, scope = Executor("cpu"), load_numpy(Scope(), init, "cpu")
    if mode == "host":
        feeds = iter([{"tokens": b} for b in batches])
    else:
        feeds = _generator_loader(port_dl, [tokens], batches).prefetch(
            executor=exe if mode == "executor" else None, depth=2,
            program=main, device="cpu")
    losses = []
    for feed in feeds:
        if mode != "host":
            assert all(isinstance(v, torch.Tensor) for v in feed.values())
        losses.append(exe.run(main, feed=feed, fetch_list=[loss],
                              scope=scope)[0])
    return np.stack(losses), exe


def test_prefetch_is_consumed_by_identity_and_matches_the_host_path(
        gpt_init, monkeypatch):
    init = gpt_init[0]
    batches = _token_batches(5, seed=3)
    want, _ = _prefetch_arm(init, batches, "host")
    coerced = []
    real = port_executor._coerce_feed_value
    monkeypatch.setattr(port_executor, "_coerce_feed_value",
                        lambda *a: coerced.append(a[1]) or real(*a))
    h2d = monitor.stat_get("executor.h2d_ms")
    got, exe = _prefetch_arm(init, batches, "executor")
    np.testing.assert_array_equal(got, want)
    assert coerced == []             # every run took its staged window
    assert not exe._staged
    assert monitor.stat_get("executor.h2d_ms") > h2d
    plain, _ = _prefetch_arm(init, batches, "device")
    np.testing.assert_array_equal(plain, want)


def test_prefetch_close_never_wedges_mid_epoch(gpt_init):
    main, tokens, loss = _port_gpt()
    it = _generator_loader(port_dl, [tokens], _token_batches(8)).prefetch(
        depth=1, program=main, device="cpu")
    next(iter(it))
    it.close()                       # abandon mid-epoch: must not hang
    it.close()                       # idempotent
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)


def test_abandoned_prefetch_iterator_is_finalized_and_purged(gpt_init):
    init = gpt_init[0]
    main, tokens, loss = _port_gpt()
    exe, scope = Executor("cpu"), load_numpy(Scope(), init, "cpu")
    it = _generator_loader(port_dl, [tokens], _token_batches(8)).prefetch(
        executor=exe, depth=2, program=main)
    feed = next(iter(it))
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    deadline = time.monotonic() + 10
    while len(exe._staged) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)             # the fill thread stages ahead
    assert exe._staged
    th = it._thread
    del it, feed
    gc.collect()
    th.join(timeout=10)
    assert not th.is_alive(), "abandoned prefetch iterator leaked its thread"
    assert len(exe._staged) == 0, "abandoned prefetch left staged windows"


def test_prefetch_refuses_non_dict_batches():
    dl = port_dl.DataLoader.from_generator(capacity=2)
    dl.set_batch_generator(lambda: iter([(np.zeros((2, 6), np.float32),)]))
    main, _, _ = _port_gpt()
    it = dl.prefetch(program=main, device="cpu")
    with pytest.raises(TypeError, match="feed dicts"):
        next(it)
    with pytest.raises(port_executor.errors.UnimplementedError):
        port_dl.DataLoader.from_generator(iterable=False)
    with pytest.raises(TypeError, match="no static length"):
        len(dl)
