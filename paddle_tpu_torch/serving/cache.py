"""Paged KV cache: block pools on the device, page tables and the host-side
allocator (counterpart of paddle_tpu/serving/cache.py; `RadixPrefixCache`
and the speculative mapped/reserve split are not ported yet).

The cache is ONE preallocated pool per k/v on the device,
[L, num_blocks, nh, block_size, hd], and a sequence owns an ordered list of
blocks recorded in its slot's page-table row. Allocation is host-side and
happens only between decode windows (admission/retirement). Admission
reserves a request's WHOLE budget (prompt bucket + max_new_tokens) up
front, so there is no mid-flight allocation and no mid-flight OOM: a
request that cannot be fully funded stays queued.

Block 0 is the SCRATCH block (ops/paged_ops.SCRATCH_BLOCK): empty
page-table entries point at it and frozen slots' writes land there.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from ..observability import metrics as _metrics
from ..ops.paged_ops import SCRATCH_BLOCK

_POOL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}


@dataclasses.dataclass
class CacheConfig:
    num_layers: int
    num_heads: int
    head_dim: int
    block_size: int
    num_blocks: int            # pool blocks INCLUDING the scratch block
    max_blocks_per_slot: int   # page-table width; max_len = this * block_size
    dtype: str = "float32"

    @property
    def max_len(self) -> int:
        return self.max_blocks_per_slot * self.block_size

    def pool_shape(self):
        return (self.num_layers, self.num_blocks, self.num_heads,
                self.block_size, self.head_dim)


class BlockAllocator:
    """Free-list allocator over pool block ids (scratch block excluded).
    All-or-nothing alloc: a request either gets its whole budget or
    nothing (it stays queued). Freeing a block that is not live
    (double-free, out-of-range id, scratch) raises — a block on the free
    list twice would be handed to two slots. (The reference refcounts
    blocks for its prefix cache; the port adds that with the cache.)"""

    # every live allocator, so the process-level gauges aggregate across
    # engines instead of last-writer-wins
    _live: "weakref.WeakSet" = weakref.WeakSet()

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is scratch)")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, SCRATCH_BLOCK, -1))
        self._live_blocks: Set[int] = set()
        BlockAllocator._live.add(self)
        self._gauge()

    @classmethod
    def _gauge(cls):
        allocs = list(cls._live)
        _metrics.set_gauge("serving.kv_blocks_total",
                           sum(a.num_blocks - 1 for a in allocs))
        _metrics.set_gauge(
            "serving.kv_blocks_used",
            sum((a.num_blocks - 1) - len(a._free) for a in allocs))

    def close(self):
        """Retire this allocator from the process gauges (engine.stop())."""
        BlockAllocator._live.discard(self)
        self._gauge()

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        self._live_blocks.update(got)
        self._gauge()
        return got

    def free(self, blocks: List[int]):
        """Return live blocks to the free list. Raises on double-free /
        unknown ids / the scratch block."""
        for b in blocks:
            if b == SCRATCH_BLOCK:
                raise ValueError("freeing the scratch block")
            if b not in self._live_blocks:
                raise ValueError(f"double-free or unknown block id {b}")
        self._live_blocks.difference_update(blocks)
        self._free.extend(blocks)
        self._gauge()


class PagedKVCache:
    """Device pools + host page table + per-slot block ownership.

    The pools are written in place by the engine (ops/paged_ops). `assign`
    on a slot that already holds blocks raises, and `release` on a slot
    that holds none raises: a silent no-op would mask a double-release or
    a retire/admit race."""

    def __init__(self, config: CacheConfig, device: torch.device):
        if config.dtype not in _POOL_DTYPES:
            raise ValueError(f"pool dtype {config.dtype!r} not in "
                             f"{sorted(_POOL_DTYPES)}")
        self.config = config
        self.allocator = BlockAllocator(config.num_blocks)
        dt = _POOL_DTYPES[config.dtype]
        self.k_pool = torch.zeros(config.pool_shape(), dtype=dt,
                                  device=device)
        self.v_pool = torch.zeros(config.pool_shape(), dtype=dt,
                                  device=device)
        self._slot_blocks: Dict[int, List[int]] = {}

    def page_table_rows(self, max_slots: int) -> np.ndarray:
        """[max_slots, max_blocks_per_slot] int32; unassigned entries point
        at the scratch block."""
        pt = np.full((max_slots, self.config.max_blocks_per_slot),
                     SCRATCH_BLOCK, np.int32)
        for slot, blocks in self._slot_blocks.items():
            pt[slot, :len(blocks)] = blocks
        return pt

    def assign(self, slot: int, n_blocks: int) -> Optional[List[int]]:
        """Reserve n_blocks for `slot` (its full request budget). None if
        the pool cannot fund it — the caller keeps the request queued."""
        if slot in self._slot_blocks:
            raise ValueError(f"slot {slot} already holds blocks")
        if n_blocks > self.config.max_blocks_per_slot:
            raise ValueError(
                f"request needs {n_blocks} blocks > max_blocks_per_slot "
                f"{self.config.max_blocks_per_slot}")
        blocks = self.allocator.alloc(n_blocks)
        if blocks is None:
            return None
        self._slot_blocks[slot] = blocks
        return blocks

    def blocks_of(self, slot: int) -> List[int]:
        return list(self._slot_blocks.get(slot, ()))

    def release(self, slot: int):
        """Free every block in `slot`'s row and clear the row. Raises
        KeyError if the slot holds no blocks."""
        if slot not in self._slot_blocks:
            raise KeyError(f"release of slot {slot} which holds no blocks")
        self.allocator.free(self._slot_blocks.pop(slot))

    def close(self):
        self.allocator.close()
