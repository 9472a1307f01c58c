"""Paged KV cache: block pools on the device, page tables, the refcounted
host-side allocator and the radix prefix cache (counterpart of
paddle_tpu/serving/cache.py).

The cache is ONE preallocated pool per k/v on the device,
[L, num_blocks, nh, block_size, hd], and a sequence owns an ordered list of
blocks recorded in its slot's page-table row. Allocation is host-side and
happens only between decode windows (admission/retirement). Admission
reserves a request's WHOLE budget (prompt bucket + max_new_tokens) up
front, so there is no mid-flight allocation and no mid-flight OOM: a
request that cannot be fully funded stays queued.

Block 0 is the SCRATCH block (ops/paged_ops.SCRATCH_BLOCK): empty
page-table entries point at it and frozen slots' writes land there.

Blocks are REFCOUNTED so slots sharing a prompt prefix share its KV blocks
(SGLang's RadixAttention over the vLLM block pool): `share` takes a
reference, `free` drops one, and a block returns to the free list only at
zero. Shared blocks are never written: the partially filled last block of
a cached prefix is copied into the slot's private block by the suffix
prefill (serving/engine.py). `RadixPrefixCache` maps token prefixes to
immutable block chains at block_size granularity, with LRU eviction of
chains only the cache holds.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

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
    """Refcounted free-list allocator over pool block ids (scratch block
    excluded). All-or-nothing alloc: a request either gets its whole
    budget or nothing (it stays queued).

    `alloc` hands out blocks at refcount 1, `share` takes an extra
    reference on live blocks (a slot mapping a cached prefix, the radix
    cache pinning a published chain), and `free` drops one reference,
    returning the block to the free list only at zero. Freeing a block
    that is not live (double-free, out-of-range id, scratch) raises: a
    block on the free list twice would be handed to two slots."""

    # every live allocator, so the process-level gauges aggregate across
    # engines instead of last-writer-wins
    _live: "weakref.WeakSet" = weakref.WeakSet()

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is scratch)")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, SCRATCH_BLOCK, -1))
        self._refs: Dict[int, int] = {}
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
        _metrics.set_gauge("serving.prefix_cache.shared_blocks",
                           sum(a.shared_blocks for a in allocs))

    def close(self):
        """Retire this allocator from the process gauges (engine.stop())."""
        BlockAllocator._live.discard(self)
        self._gauge()

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def shared_blocks(self) -> int:
        """Live blocks with more than one owner (refcount >= 2)."""
        return sum(1 for r in self._refs.values() if r >= 2)

    def refcount(self, block: int) -> int:
        """Current reference count of `block` (0 if not live)."""
        return self._refs.get(block, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        for b in got:
            self._refs[b] = 1
        self._gauge()
        return got

    def share(self, blocks: List[int]):
        """Take an extra reference on live blocks. Sharing a block nobody
        owns raises: its owner must pin it for the whole handoff, or an
        eviction could recycle it."""
        for b in blocks:
            if b not in self._refs:
                raise ValueError(f"sharing block {b} that is not live")
        for b in blocks:
            self._refs[b] += 1
        self._gauge()

    def free(self, blocks: List[int]):
        """Drop one reference per block; a block returns to the free list
        only at refcount zero. Raises on double-free / unknown ids / the
        scratch block."""
        for b in blocks:
            if b == SCRATCH_BLOCK:
                raise ValueError("freeing the scratch block")
            if b not in self._refs:
                raise ValueError(
                    f"double-free or unknown block id {b} (live blocks "
                    f"hold refcount >= 1; this one holds none)")
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)
        self._gauge()


class _RadixNode:
    """One cached block: `chunk` is the token-id tuple the block holds
    (block_size tokens for an interior node, fewer for a partial tail,
    which is always a leaf), `block` the pool block id."""

    __slots__ = ("chunk", "block", "parent", "children", "last_used")

    def __init__(self, chunk: Tuple[int, ...], block: int,
                 parent: Optional["_RadixNode"]):
        self.chunk = chunk
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_RadixNode"] = {}
        self.last_used = 0


class RadixPrefixCache:
    """Token-id prefix -> immutable refcounted block chain, at block_size
    granularity.

    Edges are token chunks: interior nodes hold exactly block_size tokens
    and one full KV block; a node with fewer tokens is a PARTIAL tail (the
    last, partly filled block of some published prompt) and always a
    leaf. The cache owns one allocator reference per stored block (taken
    at insert, dropped at evict), so a chain outlives its publisher; a
    slot mapping a chain takes its own references
    (PagedKVCache.assign_with_prefix).

    Eviction is LRU over leaves whose block has refcount 1 (only the
    cache holds it), cascading upward as interior nodes lose their last
    child."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._root = _RadixNode((), SCRATCH_BLOCK, None)
        self._clock = 0
        self._nodes = 0

    def __len__(self) -> int:
        return self._nodes

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def lookup(self, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached prefix of `prompt`: (blocks, matched), the chain
        (full blocks, possibly ending in one partial tail) and the tokens
        it covers. At most len(prompt) - 1 tokens match: at least one
        suffix token is always prefilled, so the first sampled token has a
        query row. The caller pins the chain (allocator.share) before the
        next eviction can run."""
        bs = self.block_size
        plen = len(prompt)
        toks = tuple(int(t) for t in prompt)
        now = self._tick()
        node = self._root
        blocks: List[int] = []
        matched = 0
        max_full = (plen - 1) // bs    # full chunks usable, >= 1 suffix token
        while matched // bs < max_full:
            child = node.children.get(toks[matched:matched + bs])
            if child is None or len(child.chunk) < bs:
                break
            node = child
            node.last_used = now
            blocks.append(node.block)
            matched += bs
        # the longest partial tail that is a prefix of the remainder
        best = None
        for chunk, child in node.children.items():
            if len(chunk) >= bs or matched + len(chunk) > plen - 1:
                continue
            if chunk == toks[matched:matched + len(chunk)]:
                if best is None or len(chunk) > len(best.chunk):
                    best = child
        if best is not None:
            best.last_used = now
            blocks.append(best.block)
            matched += len(best.chunk)
        return blocks, matched

    def insert(self, prompt: Sequence[int], blocks: Sequence[int],
               allocator: BlockAllocator):
        """Publish a retired request's prompt chain: `blocks` is the slot's
        block list covering `prompt` in order. Full blocks become interior
        nodes, a remainder a partial tail leaf. Chunks already cached keep
        their blocks (first publisher wins: the bits are the same by the
        determinism contract); each newly stored block gets a cache-owned
        reference."""
        bs = self.block_size
        toks = tuple(int(t) for t in prompt)
        plen = len(toks)
        now = self._tick()
        node = self._root
        spans = [(i * bs, (i + 1) * bs) for i in range(plen // bs)]
        if plen % bs:
            spans.append((plen - plen % bs, plen))
        for i, (lo, hi) in enumerate(spans):
            chunk = toks[lo:hi]
            child = node.children.get(chunk)
            if child is None:
                child = _RadixNode(chunk, int(blocks[i]), node)
                allocator.share([child.block])
                node.children[chunk] = child
                self._nodes += 1
            child.last_used = now
            node = child

    def evict(self, allocator: BlockAllocator, need: int) -> int:
        """Free least-recently-used refcount-1 leaves until `need` blocks
        have returned to the free list (or nothing more is evictable).
        Returns the number of blocks freed."""
        freed = 0
        while freed < need:
            victim = None
            stack = [self._root]
            while stack:
                n = stack.pop()
                for c in n.children.values():
                    if c.children:
                        stack.append(c)
                    elif allocator.refcount(c.block) == 1:
                        if victim is None or c.last_used < victim.last_used:
                            victim = c
            if victim is None:
                break
            del victim.parent.children[victim.chunk]
            self._nodes -= 1
            allocator.free([victim.block])
            freed += 1
            _metrics.inc("serving.prefix_cache.evictions")
        return freed

    def clear(self, allocator: BlockAllocator):
        """Drop every cached chain (engine stop)."""
        stack = list(self._root.children.values())
        self._root.children = {}
        while stack:
            n = stack.pop()
            allocator.free([n.block])
            stack.extend(n.children.values())
        self._nodes = 0


class PagedKVCache:
    """Device pools + host page table + per-slot block ownership.

    The pools are written in place by the engine (ops/paged_ops), at fixed
    addresses, so a captured window can hold their pointers. `assign` /
    `assign_with_prefix` on a slot that already holds blocks raises, and
    `release` on a slot that holds none raises: a silent no-op would mask
    a double-release or a retire/admit race.

    Speculative decoding adds a MAPPED / RESERVED split on the same
    all-or-nothing funding: a spec engine still funds a request's whole
    budget at admission, but only the blocks covering committed positions
    sit in the slot's page-table row; the rest wait in an ordered per-slot
    reserve. `extend_mapped` maps reserve blocks to cover a speculative
    span, and a rejection `truncate_mapped`s the row back, returning the
    blocks to the FRONT of the reserve, so the position -> block mapping
    is stable across rollbacks. Plain engines never touch the split."""

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
        self._slot_reserve: Dict[int, List[int]] = {}

    def page_table_rows(self, max_slots: int) -> np.ndarray:
        """[max_slots, max_blocks_per_slot] int32; unassigned entries point
        at the scratch block."""
        pt = np.full((max_slots, self.config.max_blocks_per_slot),
                     SCRATCH_BLOCK, np.int32)
        for slot, blocks in self._slot_blocks.items():
            pt[slot, :len(blocks)] = blocks
        return pt

    def _check_width(self, slot: int, n_blocks: int):
        if slot in self._slot_blocks:
            raise ValueError(f"slot {slot} already holds blocks")
        if n_blocks > self.config.max_blocks_per_slot:
            raise ValueError(
                f"request needs {n_blocks} blocks > max_blocks_per_slot "
                f"{self.config.max_blocks_per_slot}")

    def assign(self, slot: int, n_blocks: int) -> Optional[List[int]]:
        """Reserve n_blocks for `slot` (its full request budget). None if
        the pool cannot fund it — the caller keeps the request queued."""
        self._check_width(slot, n_blocks)
        blocks = self.allocator.alloc(n_blocks)
        if blocks is None:
            return None
        self._slot_blocks[slot] = blocks
        return list(blocks)

    def assign_with_prefix(self, slot: int, shared: List[int],
                           n_private: int) -> Optional[List[int]]:
        """Map `shared` (a cached prefix chain) read-only into `slot`'s row
        and fund n_private fresh blocks after it. The shared blocks get a
        slot-owned reference first, so an eviction can never recycle the
        matched chain, then the private tail is funded all-or-nothing.
        Returns the private blocks, or None (the share undone) if the pool
        cannot fund them."""
        self._check_width(slot, len(shared) + n_private)
        self.allocator.share(shared)
        private = self.allocator.alloc(n_private)
        if private is None:
            self.allocator.free(shared)
            return None
        self._slot_blocks[slot] = list(shared) + private
        return private

    def blocks_of(self, slot: int) -> List[int]:
        return list(self._slot_blocks.get(slot, ()))

    def reserved_of(self, slot: int) -> List[int]:
        return list(self._slot_reserve.get(slot, ()))

    def reserve_tail(self, slot: int, keep: int):
        """Move every mapped block past the first `keep` into the slot's
        reserve (spec admission: fund everything, map only what covers
        committed positions). Refcounts do not move."""
        row = self._slot_blocks[slot]
        if keep < 1:
            raise ValueError(f"reserve_tail keep={keep} must map >= 1 block")
        if len(row) > keep:
            self._slot_reserve[slot] = (
                row[keep:] + self._slot_reserve.get(slot, []))
            del row[keep:]

    def extend_mapped(self, slot: int, n_needed: int) -> int:
        """Map reserve blocks, in order, into `slot`'s row until it holds at
        least `n_needed` blocks (before a window or a verify round). Raises
        if the reserve cannot cover it: admission funded the whole budget,
        so a shortfall is a bookkeeping bug. Returns the blocks moved."""
        row = self._slot_blocks[slot]
        resv = self._slot_reserve.get(slot, [])
        moved = 0
        while len(row) < n_needed:
            if not resv:
                raise ValueError(
                    f"slot {slot} needs {n_needed} mapped blocks but only "
                    f"{len(row)} mapped + {moved} extended are funded")
            row.append(resv.pop(0))
            moved += 1
        return moved

    def truncate_mapped(self, slot: int, keep: int) -> List[int]:
        """Roll back speculation: unmap every row block past the first
        `keep`, returning them to the FRONT of the reserve so a later
        extend restores the same position -> block mapping. Returns the
        truncated ids; the allocator is untouched."""
        if keep < 1:
            raise ValueError(f"truncate_mapped keep={keep} must keep >= 1")
        row = self._slot_blocks[slot]
        cut = row[keep:]
        if cut:
            del row[keep:]
            self._slot_reserve[slot] = cut + self._slot_reserve.get(slot, [])
        return cut

    def release(self, slot: int):
        """Drop one reference on every block of `slot`, mapped and
        reserved (shared prefix blocks live on in the radix cache or other
        slots) and clear the row. Raises KeyError if the slot holds no
        blocks."""
        if slot not in self._slot_blocks:
            raise KeyError(f"release of slot {slot} which holds no blocks")
        blocks = self._slot_blocks.pop(slot)
        blocks += self._slot_reserve.pop(slot, [])
        self.allocator.free(blocks)

    def reset(self):
        """Zero both pools in place (a captured graph holds their
        addresses) and start a fresh allocator: every slot's blocks and
        reserve are dropped. The engine's resurrection."""
        self.k_pool.zero_()
        self.v_pool.zero_()
        self.allocator.close()
        self.allocator = BlockAllocator(self.config.num_blocks)
        self._slot_blocks.clear()
        self._slot_reserve.clear()

    def close(self):
        self.allocator.close()
