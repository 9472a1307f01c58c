"""The native data plane (dataplane.cc) through ctypes, and its plain Python
version (counterpart of paddle_tpu/native/dataplane.py).

Slots: a list of SlotSpec(name, type, dim), type "float" or "int64". A
batch is {slot name: np.ndarray [rows, dim]} (float32 / int64), rows =
batch size except the epoch's last batch.

`NativeDataPlane` runs the C++ plane where g++ builds it (native/
__init__.py) and `_PyDataPlane` otherwise; `.native` says which. The two
parse the same lines into the same samples and batches. Shuffles differ:
the C++ plane draws a Fisher-Yates shuffle from std::mt19937_64, the
Python one numpy's `RandomState.shuffle`, as in the reference.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np

from . import load_native


class SlotSpec:
    def __init__(self, name: str, dtype: str, dim: int):
        if dtype not in ("float", "int64"):
            raise ValueError(f"slot {name!r}: type {dtype!r} is not "
                             f"'float' or 'int64'")
        self.name = name
        self.dtype = dtype
        self.dim = int(dim)


class NativeDataPlane:
    """One epoch-restartable multithreaded file -> batch pipeline."""

    def __init__(self, slots: Sequence[SlotSpec], batch_size: int,
                 n_threads: int = 4, capacity: int = 64):
        self.slots = list(slots)
        self.batch_size = int(batch_size)
        self._lib = load_native("dataplane")
        self._files: List[str] = []
        # output order: float slots first, then int64 (as dp_next fills)
        self._out_order = ([s for s in self.slots if s.dtype == "float"]
                           + [s for s in self.slots if s.dtype == "int64"])
        self._h = None
        if self._lib is not None:
            self._configure_ctypes()
            types = (ctypes.c_int * len(self.slots))(
                *[0 if s.dtype == "float" else 1 for s in self.slots])
            dims = (ctypes.c_int * len(self.slots))(
                *[s.dim for s in self.slots])
            self._h = self._lib.dp_create(len(self.slots), types, dims,
                                          self.batch_size, n_threads, capacity)
        else:
            self._py = _PyDataPlane(self.slots, self.batch_size)

    @property
    def native(self) -> bool:
        """Whether the C++ plane runs (False: the Python plane)."""
        return self._lib is not None

    def _configure_ctypes(self):
        lib = self._lib
        lib.dp_create.restype = ctypes.c_void_p
        lib.dp_create.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int]
        lib.dp_set_files.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_char_p),
                                     ctypes.c_int]
        lib.dp_start.argtypes = [ctypes.c_void_p]
        lib.dp_next.restype = ctypes.c_int
        lib.dp_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_void_p)]
        lib.dp_load_into_memory.argtypes = [ctypes.c_void_p]
        lib.dp_local_shuffle.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.dp_memory_size.restype = ctypes.c_longlong
        lib.dp_memory_size.argtypes = [ctypes.c_void_p]
        lib.dp_release_memory.argtypes = [ctypes.c_void_p]
        lib.dp_destroy.argtypes = [ctypes.c_void_p]

    # -- api ----------------------------------------------------------------
    def set_files(self, paths: Sequence[str]):
        self._files = [str(p) for p in paths]
        if self._h is not None:
            arr = (ctypes.c_char_p * len(self._files))(
                *[p.encode() for p in self._files])
            self._lib.dp_set_files(self._h, arr, len(self._files))
        else:
            self._py.set_files(self._files)

    def load_into_memory(self):
        if self._h is not None:
            self._lib.dp_load_into_memory(self._h)
        else:
            self._py.load_into_memory()

    def local_shuffle(self, seed: int = 0):
        if self._h is not None:
            self._lib.dp_local_shuffle(self._h, int(seed))
        else:
            self._py.local_shuffle(seed)

    def memory_size(self) -> int:
        if self._h is not None:
            return int(self._lib.dp_memory_size(self._h))
        return self._py.memory_size()

    def release_memory(self):
        if self._h is not None:
            self._lib.dp_release_memory(self._h)
        else:
            self._py.release_memory()

    def __iter__(self):
        """Yields one epoch of {slot_name: np.ndarray[rows, dim]} dicts."""
        if self._h is None:
            yield from self._py
            return
        self._lib.dp_start(self._h)
        n_out = len(self._out_order)
        while True:
            bufs = [np.empty((self.batch_size, s.dim),
                             np.float32 if s.dtype == "float" else np.int64)
                    for s in self._out_order]
            ptrs = (ctypes.c_void_p * n_out)(
                *[b.ctypes.data_as(ctypes.c_void_p).value for b in bufs])
            rows = self._lib.dp_next(self._h, ptrs)
            if rows == 0:
                return
            yield {s.name: bufs[k][:rows]
                   for k, s in enumerate(self._out_order)}

    def close(self):
        """Stop the plane's threads and free it (idempotent)."""
        if self._h is not None:
            self._lib.dp_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            self.close()


class _PyDataPlane:
    """The plain version: the same MultiSlot parse and packing, one
    thread."""

    def __init__(self, slots, batch_size):
        self.slots = slots
        self.batch_size = batch_size
        self.files: List[str] = []
        self.memory: List[Tuple] = []
        self.in_memory = False

    def set_files(self, paths):
        self.files = list(paths)

    def _parse_file(self, path):
        with open(path) as f:
            for line in f:
                toks = line.split()
                if not toks:
                    continue
                pos = 0
                vals = []
                ok = True
                for s in self.slots:
                    try:
                        n = int(toks[pos])
                        raw = toks[pos + 1: pos + 1 + n]
                        pos += 1 + n
                    except (ValueError, IndexError):
                        ok = False
                        break
                    conv = (np.float32 if s.dtype == "float" else np.int64)
                    v = np.zeros(s.dim, conv)
                    take = min(n, s.dim)
                    v[:take] = np.asarray(raw[:take], conv)
                    vals.append(v)
                if ok:
                    yield tuple(vals)

    def _samples(self):
        if self.in_memory:
            yield from self.memory
        else:
            for p in self.files:
                yield from self._parse_file(p)

    def load_into_memory(self):
        self.memory = [s for p in self.files for s in self._parse_file(p)]
        self.in_memory = True

    def local_shuffle(self, seed=0):
        np.random.RandomState(seed).shuffle(self.memory)

    def memory_size(self):
        return len(self.memory)

    def release_memory(self):
        self.memory = []
        self.in_memory = False

    def __iter__(self):
        batch = []
        for s in self._samples():
            batch.append(s)
            if len(batch) == self.batch_size:
                yield self._pack(batch)
                batch = []
        if batch:
            yield self._pack(batch)

    def _pack(self, batch):
        return {s.name: np.stack([row[i] for row in batch])
                for i, s in enumerate(self.slots)}
