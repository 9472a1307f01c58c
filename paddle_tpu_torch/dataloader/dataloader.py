"""DataLoader: batching, worker processes, the prefetch thread and device
prefetch through the executor's staging (counterpart of
paddle_tpu/dataloader/dataloader.py).

The pipeline: worker processes (forkserver) collate numpy batches and send
them over pipes; the training process re-sequences them by batch index; a
fill thread stays a few batches ahead. `DataLoader.prefetch(executor)`
runs the executor's feed coercion and the host-to-device copy on that
thread (`Executor.stage`: pinned memory, a copy stream), so the consuming
`Executor.run` finds its feeds already on the device and takes them by
identity.

Workers come from a FORKSERVER context: the training process holds a CUDA
context and threads, and a forked child would inherit both. The server
preloads this module, so each worker starts with torch imported. Datasets
and collate functions are pickled (a class is pickled by reference: the
module that defines it must be importable without side effects). Workers
return numpy and never touch CUDA.

Worker death: the workers are the forkserver's children, so no SIGCHLD
reaches the training process; while blocked on the data queue it polls
the workers' liveness every second, and a worker that died owing a batch
fails the epoch within seconds, naming the worker and its exit code (the
reference's SIGCHLD path), unless FLAGS_dataloader_max_respawns allows a
respawn: a fresh worker then takes over exactly the dead one's undelivered
batches (counted in `resilience.worker_respawns`).
"""
from __future__ import annotations

import collections
import multiprocessing as mp
import queue as queue_mod
import threading
import time
import weakref
from typing import List, Optional

import numpy as np

from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler


def default_collate_fn(batch):
    """list of samples -> stacked arrays (tuple-of-fields or single field)."""
    first = batch[0]
    if isinstance(first, (tuple, list)):
        return tuple(np.stack([np.asarray(s[i]) for s in batch])
                     for i in range(len(first)))
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in batch]) for k in first}
    return np.stack([np.asarray(s) for s in batch])


def _worker_loop(dataset, index_queue, data_queue, collate_fn, worker_id,
                 fault_spec="", fault_seed=0):
    # the fault plan rides in as a picklable (spec, seed) pair: forkserver
    # children do not share the parent's installed plan object, and each
    # worker replays its own deterministic counter stream
    plan = None
    if fault_spec:
        from ..resilience.faults import FaultPlan
        plan = FaultPlan(fault_spec, fault_seed)
    while True:
        item = index_queue.get()
        if item is None:
            break
        seq, indices = item
        try:
            if plan is not None:
                plan.fire("dataloader.worker")   # may raise or os._exit
            batch = collate_fn([dataset[i] for i in indices])
            data_queue.put((seq, batch, None))
        except Exception as e:  # surface worker errors to the main process
            data_queue.put((seq, None, f"worker {worker_id}: {e!r}"))


class _MultiprocessIter:
    """Ordered multiprocess fetch: batches dispatched to the workers,
    results re-sequenced by batch index. Backpressure comes from windowed
    dispatch: each worker holds at most _PREFETCH outstanding batches,
    refilled as its results come back, so memory stays at a small window
    rather than an epoch."""

    _GET_TIMEOUT = 300.0
    _POLL = 1.0  # death-check cadence while blocked on the queue
    _PREFETCH = 2  # outstanding batches per worker (the backpressure bound)

    def __init__(self, dataset, batches: List[List[int]], collate_fn,
                 num_workers: int, max_respawns: Optional[int] = None):
        from ..resilience.faults import current_plan
        if max_respawns is None:
            from ..flags import flag
            max_respawns = int(flag("FLAGS_dataloader_max_respawns"))
        plan = current_plan()
        self._fault_spec = plan.spec if plan is not None else ""
        self._fault_seed = plan.seed if plan is not None else 0
        self._ctx = ctx = mp.get_context("forkserver")
        # the server imports this module (and torch) once, before it forks
        # a worker, so a worker does not import them again
        ctx.set_forkserver_preload([__name__])
        self._dataset = dataset
        self._collate_fn = collate_fn
        self._batches = list(batches)
        self._respawns_left = max_respawns
        # The data queue is UNBOUNDED: a bounded mp.Queue's capacity
        # semaphore is taken by the producer's put() and given back only
        # when the consumer reads the item, so a worker that dies between
        # put() and its feeder thread's flush leaks a slot for good.
        self._data_queue = ctx.Queue()
        self._index_queues = []
        self._workers = []
        for w in range(num_workers):
            iq, p = self._spawn_worker(w)
            self._index_queues.append(iq)
            self._workers.append(p)
        self._total = len(batches)
        self._next_seq = 0
        self._reorder = {}
        self._received = set()
        self._undispatched = collections.deque(range(len(batches)))
        self._inflight = {w: set() for w in range(num_workers)}
        self._closed = set()   # workers already sent the end sentinel
        for _ in range(self._PREFETCH):
            for w in range(num_workers):
                self._dispatch(w)

    def _dispatch(self, w):
        """Feed worker `w` its next batch, or the end sentinel once per
        incarnation when nothing is left."""
        if self._undispatched:
            s = self._undispatched.popleft()
            self._inflight[w].add(s)
            self._index_queues[w].put((s, self._batches[s]))
        elif w not in self._closed:
            self._closed.add(w)
            self._index_queues[w].put(None)

    def _on_batch(self, seq, batch):
        """Record an arrived batch and refill the worker that made it. A
        duplicate (a respawn re-queued a batch whose original was still in
        the dead worker's pipe) is dropped."""
        if seq in self._received:
            return
        self._received.add(seq)
        self._reorder[seq] = batch
        for w, inflight in self._inflight.items():
            if seq in inflight:
                inflight.discard(seq)
                self._dispatch(w)
                break

    def _spawn_worker(self, w):
        iq = self._ctx.Queue()
        p = self._ctx.Process(
            target=_worker_loop,
            args=(self._dataset, iq, self._data_queue, self._collate_fn, w,
                  self._fault_spec, self._fault_seed),
            daemon=True)
        p.start()
        return iq, p

    def _respawn(self, w, exitcode):
        """Replace dead worker `w` with a fresh process owning exactly its
        undelivered batches (bounded by FLAGS_dataloader_max_respawns,
        counted in `resilience.worker_respawns`)."""
        import warnings
        from ..monitor import stat_add
        self._respawns_left -= 1
        stat_add("resilience.worker_respawns")
        warnings.warn(
            f"DataLoader worker {w} died ({_describe_exit(exitcode)}); "
            f"respawning ({self._respawns_left} respawn(s) left)")
        old_iq = self._index_queues[w]
        old_iq.cancel_join_thread()
        old_iq.close()
        owed = sorted(self._inflight[w] - self._received)
        self._inflight[w] = set()
        self._closed.discard(w)
        iq, p = self._spawn_worker(w)
        self._index_queues[w] = iq
        self._workers[w] = p
        for s in owed:
            self._inflight[w].add(s)
            iq.put((s, self._batches[s]))
        if not self._undispatched:
            self._closed.add(w)
            iq.put(None)

    def __iter__(self):
        return self

    def _abnormal_deaths(self):
        """(worker_id, exitcode) of dead workers that still OWE a batch: a
        worker that delivered everything and then exited nonzero is a
        retirement, not a failure."""
        return [(w, p.exitcode) for w, p in enumerate(self._workers)
                if self._inflight[w] and not p.is_alive()
                and p.exitcode not in (0, None)]

    def _get(self, timeout):
        seq, batch, err = self._data_queue.get(timeout=timeout)
        if err is not None:
            self._join()
            raise RuntimeError(f"DataLoader worker failed: {err}")
        self._on_batch(seq, batch)

    def __next__(self):
        if self._next_seq >= self._total:
            self._join()
            raise StopIteration
        waited = 0.0
        while self._next_seq not in self._reorder:
            try:
                self._get(self._POLL)
                continue
            except queue_mod.Empty:
                waited += self._POLL
            dead = self._abnormal_deaths()
            if dead:
                # a worker can put its last owed batch on the queue (still
                # in the feeder pipe) and THEN exit nonzero: drain what is
                # in flight before calling the death fatal
                deadline = time.monotonic() + 2.0
                while (self._next_seq not in self._reorder
                       and time.monotonic() < deadline):
                    try:
                        self._get(0.1)
                    except queue_mod.Empty:
                        continue
                if self._next_seq in self._reorder:
                    break
                dead = self._abnormal_deaths()
            if dead and self._respawns_left > 0:
                for w, c in dead:
                    if self._respawns_left <= 0:
                        break
                    self._respawn(w, c)
                waited = 0.0
                continue
            if dead:
                self._join()
                raise RuntimeError(
                    "DataLoader worker(s) died unexpectedly "
                    + ", ".join(
                        f"worker {w} exitcode {c} ({_describe_exit(c)})"
                        for w, c in dead)
                    + f" while waiting for batch {self._next_seq} "
                    f"(liveness poll caught it after {waited:.0f}s, "
                    f"not the {self._GET_TIMEOUT:.0f}s queue timeout)")
            if waited >= self._GET_TIMEOUT:
                self._join()
                raise RuntimeError(
                    f"DataLoader timed out after {waited:.0f}s waiting "
                    f"for batch {self._next_seq}")
        batch = self._reorder.pop(self._next_seq)
        self._next_seq += 1
        return batch

    def _join(self):
        for p in self._workers:
            p.join(timeout=1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=1)
        # drain and detach the queues, so that a dead worker's feeder pipe
        # cannot wedge teardown, nor our index queues' feeder threads
        # block interpreter exit flushing to a reader that is gone
        try:
            while True:
                self._data_queue.get_nowait()
        except (queue_mod.Empty, OSError, ValueError):
            pass
        for q in [self._data_queue] + self._index_queues:
            try:
                q.cancel_join_thread()
                q.close()
            except (OSError, ValueError):
                pass   # already closed (by a respawn)
        self._workers = []
        self._index_queues = []


def _describe_exit(exitcode):
    """A worker's exit in words: the signal's name for a negative code, the
    fault-injection kill code called out."""
    if exitcode is None:
        return "still running"
    if exitcode < 0:
        import signal as _signal
        try:
            return f"killed by signal {_signal.Signals(-exitcode).name}"
        except ValueError:
            return f"killed by signal {-exitcode}"
    from ..resilience.faults import FaultPlan
    if exitcode == FaultPlan.KILL_EXIT_CODE:
        return "fault-injection kill"
    return f"exited with status {exitcode}"


def _bounded_put(stop, q, item) -> bool:
    """A put that gives up when `stop` is set: True iff enqueued."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return True
        except queue_mod.Full:
            continue
    return False


def _drain_queue(stop, q):
    """Finalizer body: unblock a filling thread and drop buffered items.
    Module-level, with its state passed in, so the finalizer holds no
    reference back to the prefetcher."""
    stop.set()
    while True:
        try:
            q.get_nowait()
        except queue_mod.Empty:
            break


def _purge_executor_stages(exe_ref, tag):
    """Finalizer body of an executor-routed prefetch: drop this iterator's
    pending windows from the executor's staging queue (a weak reference,
    so the finalizer never pins the executor)."""
    exe = exe_ref()
    if exe is not None:
        exe._purge_staged(tag)


def _prefetch_fill(ref, it, stop, q, end):
    """Fill-thread body. Holds only a WEAK reference to the prefetcher
    between batches: an iterator the consumer abandons mid-epoch is
    collected, its finalizer sets `stop`, and this thread exits at the
    next batch boundary (releasing the source iterator, its worker
    processes and files with it)."""
    err_box = None
    try:
        for item in it:
            if stop.is_set():
                return
            self = ref()
            if self is None:
                return
            try:
                out = self._transform(item)
            except Exception as e:
                self._err = e
                del self
                return                     # END in finally
            del self                       # no strong reference across a
            if not _bounded_put(stop, q, out):   # blocking put
                return
    except Exception as e:                 # the source iterator raised
        err_box = e
    finally:
        if err_box is not None:
            self = ref()
            if self is not None:
                self._err = err_box
            del self
        _bounded_put(stop, q, end)


class _Prefetcher:
    """Double buffering on the host: a thread stays `capacity` batches
    ahead of the consumer.

    Teardown: close() signals the fill thread, drains the bounded queue so
    that a blocked put() cannot wedge interpreter exit, and joins. An
    abandoned iterator (nothing calls close) is handled by a
    weakref.finalize: the fill thread never holds the prefetcher strongly,
    so collection fires the finalizer, which stops and drains the
    thread."""

    _END = object()

    def __init__(self, it, capacity=2):
        self._q = queue_mod.Queue(maxsize=capacity)
        self._stop = threading.Event()
        self._err = None
        self._thread = threading.Thread(
            target=_prefetch_fill,
            args=(weakref.ref(self), it, self._stop, self._q, self._END),
            daemon=True, name="dataloader-prefetch")
        self._finalizer = weakref.finalize(self, _drain_queue, self._stop,
                                           self._q)
        self._thread.start()

    def _transform(self, item):
        """Per-batch work on the fill thread (overlaps the consumer)."""
        return item

    def __iter__(self):
        return self

    def __next__(self):
        # after close() the queue is drained (the END sentinel included)
        # and nothing refills it: a closed, empty queue is the end
        while True:
            if self._stop.is_set():
                try:
                    item = self._q.get_nowait()
                except queue_mod.Empty:
                    raise StopIteration
            else:
                try:
                    item = self._q.get(timeout=0.2)
                except queue_mod.Empty:
                    continue
            if item is self._END:
                if self._err is not None:
                    raise self._err
                raise StopIteration
            return item

    def close(self):
        """Stop, drain and join (idempotent); safe mid-epoch."""
        self._finalizer()                    # stop + unblock the put
        self._thread.join(timeout=10)
        # drain again with the producer gone: a put blocked when stop was
        # set can slip one item in after the finalizer's drain
        _drain_queue(self._stop, self._q)


class _DevicePrefetcher(_Prefetcher):
    """The iterator `DataLoader.prefetch` returns: the fill thread runs the
    executor's feed coercion and the host-to-device copy for each batch,
    `depth` batches ahead, so that the training loop finds batch n+1 on
    the device. Staging time is counted in `executor.h2d_ms`.

    With an executor, each batch goes through `Executor.stage` under this
    iterator's tag: the consuming `run()` takes it by identity and skips
    coercion, and abandoning or closing the iterator purges its pending
    windows. Without one, batches are coerced against `program` and
    copied to `device`."""

    def __init__(self, it, program, executor=None, depth=2, device=None):
        self._program = program
        self._block = program.global_block()
        self._executor = executor
        if executor is None:
            from ..device import resolve_device
            self._device = resolve_device(device)
        # marks this iterator's entries in the executor's staging queue
        self._stage_tag = object()
        super().__init__(it, capacity=depth)
        if executor is not None:
            self._purge_finalizer = weakref.finalize(
                self, _purge_executor_stages, weakref.ref(executor),
                self._stage_tag)

    def _transform(self, item):
        from ..framework.executor import _coerce_feed_value
        from ..monitor import stat_add
        from ..observability import trace as _trace
        if not isinstance(item, dict):
            raise TypeError(
                "DataLoader.prefetch needs feed dicts: construct the "
                "loader with feed_list= and return_list=False (or yield "
                "dicts from the generator)")
        with _trace.RecordEvent("prefetch.fill", args={"feeds": len(item)}):
            if self._executor is not None:
                # up to capacity + 1 (in this transform) + 1 (popped by the
                # consumer, not yet run) windows can be pending at once;
                # evicting one would lose its identity match
                return self._executor.stage(item, program=self._program,
                                            depth=self._q.maxsize + 2,
                                            tag=self._stage_tag)
            t0 = time.perf_counter()
            out = {name: _coerce_feed_value(self._block, name, value,
                                            self._device)
                   for name, value in item.items()}
            stat_add("executor.h2d_ms", (time.perf_counter() - t0) * 1000.0)
            return out

    def close(self):
        super().close()
        fin = getattr(self, "_purge_finalizer", None)
        if fin is not None:
            fin()           # drop this iterator's staged windows now


class DataLoader:
    """2.0-style over a Dataset, or fluid-style through from_generator.

    Iterating yields host batches (numpy), buffered by a thread when
    `use_buffer_reader`; `prefetch(executor)` yields the same batches as
    device feeds. With `feed_list` and `return_list=False` a batch is a
    feed dict keyed by the variables' names."""

    def __init__(self, dataset: Optional[Dataset] = None, feed_list=None,
                 places=None, return_list=True, batch_sampler=None,
                 batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, num_workers=0, use_buffer_reader=True,
                 use_shared_memory=True, timeout=0, worker_init_fn=None):
        self.dataset = dataset
        self.feed_list = feed_list
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.use_buffer_reader = use_buffer_reader
        self._iterable_src = None       # from_generator path
        if dataset is not None and not isinstance(dataset, IterableDataset):
            self.batch_sampler = batch_sampler or BatchSampler(
                dataset=dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
        else:
            self.batch_sampler = None
            self._batch_size = batch_size
            self._drop_last = drop_last

    # ---- fluid-style constructors -----------------------------------------
    @staticmethod
    def from_generator(feed_list=None, capacity=16, use_double_buffer=True,
                       iterable=True, return_list=False,
                       use_multiprocess=False, drop_last=True):
        if not iterable:
            from ..framework import errors
            raise errors.Unimplemented(
                "non-iterable DataLoader (program-inserted py_reader ops): "
                "iterate the loader and pass its feeds")
        dl = DataLoader.__new__(DataLoader)
        dl.dataset = None
        dl.batch_sampler = None
        dl.feed_list = feed_list
        dl.return_list = return_list
        dl.collate_fn = default_collate_fn
        dl.num_workers = 0
        dl.use_buffer_reader = use_double_buffer
        dl._capacity = capacity
        dl._iterable_src = None
        return dl

    def set_sample_generator(self, reader, batch_size, drop_last=True,
                             places=None):
        def gen():
            batch = []
            for sample in reader():
                batch.append(sample if isinstance(sample, (tuple, list))
                             else (sample,))
                if len(batch) == batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not drop_last:
                yield self.collate_fn(batch)
        self._iterable_src = gen
        return self

    def set_sample_list_generator(self, reader, places=None):
        def gen():
            for sample_list in reader():
                yield self.collate_fn(sample_list)
        self._iterable_src = gen
        return self

    def set_batch_generator(self, reader, places=None):
        self._iterable_src = reader
        return self

    # ---- iteration ---------------------------------------------------------
    def _feedify(self, it):
        """Pair batch fields with feed_list variable names -> feed dicts."""
        names = [getattr(v, "name", str(v)) for v in self.feed_list]
        for batch in it:
            fields = batch if isinstance(batch, (tuple, list)) else (batch,)
            yield dict(zip(names, fields))

    def _base_iter(self):
        """The unbuffered batch stream (workers and feed dicts, no fill
        thread), shared by __iter__ and prefetch()."""
        if self._iterable_src is not None:
            it = self._iterable_src()
        elif self.batch_sampler is not None:
            batches = list(self.batch_sampler)
            if self.num_workers > 0:
                it = _MultiprocessIter(self.dataset, batches,
                                       self.collate_fn, self.num_workers)
            else:
                ds, cf = self.dataset, self.collate_fn
                it = (cf([ds[i] for i in idxs]) for idxs in batches)
        else:  # IterableDataset
            ds = self.dataset
            bs, drop = self._batch_size, self._drop_last

            def gen():
                batch = []
                for s in ds:
                    batch.append(s if isinstance(s, (tuple, list)) else (s,))
                    if len(batch) == bs:
                        yield self.collate_fn(batch)
                        batch = []
                if batch and not drop:
                    yield self.collate_fn(batch)
            it = gen()
        if self.feed_list is not None and not self.return_list:
            it = self._feedify(it)
        return it

    def __iter__(self):
        it = self._base_iter()
        if self.use_buffer_reader:
            it = _Prefetcher(it, capacity=getattr(self, "_capacity", 2))
        return iter(it)

    def prefetch(self, executor=None, depth: int = 2, program=None,
                 device=None):
        """An iterator of device feed dicts, `depth` batches ahead: a
        thread runs the feed coercion and the host-to-device copy while
        the current step runs. With `executor`, each batch is staged
        through `executor.stage` (the consuming `run()` with the same feed
        dict takes it by identity and skips coercion); without, batches
        are coerced against `program` (default: the main program) and
        copied to `device` (default cuda). Worker death handling comes
        from the worker iterator underneath; close() or collection of the
        iterator never wedges on a full buffer. Needs dict batches:
        construct the loader with `feed_list=` and `return_list=False`, or
        yield dicts from the generator."""
        from ..framework.program import default_main_program
        prog = program or default_main_program()
        return _DevicePrefetcher(self._base_iter(), prog, executor=executor,
                                 depth=max(1, int(depth)), device=device)

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        raise TypeError("this DataLoader has no static length")
