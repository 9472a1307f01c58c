"""fluid.dataset: file-list datasets over the native data plane
(counterpart of paddle_tpu/dataset.py).

`DatasetFactory().create_dataset("InMemoryDataset" | "QueueDataset")`
gives a dataset configured like the reference's (batch size, threads,
the feed variables as MultiSlot slots, the file list) that yields feed
dicts {variable name: array [batch, ...]} for `Executor.train_from_dataset`.
The parsing and packing run in native/dataplane.cc (its Python version
where g++ cannot build it: `.plane.native` says which).

InMemoryDataset loads every file into host memory once
(`load_into_memory`, in file order), shuffles it with a seed that
advances at each `local_shuffle` (1, 2, ...), and serves every epoch from
memory. `global_shuffle` shuffles this process's file shard with a seed
mixed with its rank: across processes (fleet) it waits for multi-process
data parallelism (ROADMAP item 15.1).
"""
from __future__ import annotations

import os
from typing import List, Optional

from .native.dataplane import NativeDataPlane, SlotSpec


class DatasetFactory:
    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        raise ValueError(f"unknown dataset class {datafeed_class!r}")


def _rank_world():
    return (int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0),
            int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1))


class DatasetBase:
    def __init__(self):
        self._batch_size = 1
        self._thread = 1
        self._filelist: List[str] = []
        self._slots: List[SlotSpec] = []
        self._use_vars = []
        self._plane: Optional[NativeDataPlane] = None
        self._shuffle_seed = 0

    # -- configuration (reference dataset.py setters) -----------------------
    def set_batch_size(self, batch_size):
        self._batch_size = int(batch_size)
        self._plane = None

    def set_thread(self, thread_num):
        self._thread = int(thread_num)
        self._plane = None

    def set_filelist(self, filelist):
        self._filelist = list(filelist)
        if self._plane is not None:
            self._plane.set_files(self._local_files())

    def set_use_var(self, var_list):
        """Slot order, type and width from the feed variables: an integer
        variable is an int64 slot, any other a float slot, of the product
        of the variable's known dims past the batch."""
        from .framework.dtype import dtype_name
        self._use_vars = list(var_list)
        self._slots = []
        for v in var_list:
            dim = 1
            for d in v.shape[1:] if len(v.shape) > 1 else v.shape:
                if d and d > 0:
                    dim *= int(d)
            dt = dtype_name(v.dtype)
            self._slots.append(SlotSpec(
                v.name, "int64" if dt.startswith("int") else "float", dim))
        self._plane = None

    def set_pipe_command(self, cmd):
        self._pipe_command = cmd   # accepted for API parity; files are
        # parsed natively, not piped through a subprocess

    def set_hdfs_config(self, fs_name, fs_ugi):
        self._hdfs = (fs_name, fs_ugi)

    def desc(self):
        return {
            "batch_size": self._batch_size, "thread_num": self._thread,
            "slots": [(s.name, s.dtype, s.dim) for s in self._slots],
            "filelist": self._filelist,
        }

    # -- plumbing ------------------------------------------------------------
    def _local_files(self):
        """This process's round-robin share of the file list."""
        rank, world = _rank_world()
        if world <= 1:
            return self._filelist
        return self._filelist[rank::world]

    @property
    def plane(self) -> NativeDataPlane:
        """The data plane, created on first use."""
        if self._plane is None:
            if not self._slots:
                raise ValueError("call set_use_var before loading data")
            self._plane = NativeDataPlane(self._slots, self._batch_size,
                                          n_threads=self._thread)
            self._plane.set_files(self._local_files())
        return self._plane

    def __iter__(self):
        """Yields feed dicts {var_name: array[batch, dim]} reshaped to the
        vars' trailing shapes."""
        shapes = {v.name: [int(d) for d in v.shape[1:]]
                  if len(v.shape) > 1 else [] for v in self._use_vars}
        for batch in self.plane:
            out = {}
            for name, arr in batch.items():
                tail = shapes.get(name)
                if tail and all(d > 0 for d in tail):
                    arr = arr.reshape((arr.shape[0],) + tuple(tail))
                out[name] = arr
            yield out


class QueueDataset(DatasetBase):
    """Streaming dataset (files parsed on the fly each epoch)."""


class InMemoryDataset(DatasetBase):
    """Load once, shuffle per epoch, serve from host memory."""

    def load_into_memory(self):
        self.plane.load_into_memory()

    def local_shuffle(self):
        self._shuffle_seed += 1
        self.plane.local_shuffle(self._shuffle_seed)

    def global_shuffle(self, fleet=None, thread_num=12):
        if fleet is not None:
            from .framework import errors
            raise errors.Unimplemented(
                "global_shuffle across processes (fleet) waits for "
                "multi-process data parallelism (ROADMAP item 15.1)")
        rank, _ = _rank_world()
        self._shuffle_seed += 1
        self.plane.local_shuffle(self._shuffle_seed * 9973 + rank)

    def release_memory(self):
        if self._plane is not None:
            self._plane.release_memory()

    def get_memory_data_size(self, fleet=None):
        return self.plane.memory_size()

    def get_shuffle_data_size(self, fleet=None):
        return self.get_memory_data_size(fleet)


__all__ = ["DatasetFactory", "DatasetBase", "QueueDataset",
           "InMemoryDataset"]
