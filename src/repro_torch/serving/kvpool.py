"""Paged KV-cache memory subsystem: block pool allocator + prefix cache.

The serving engine's KV memory is a device-resident *block pool* — per layer,
``[n_blocks, block_size, ...]`` — instead of one contiguous ``max_len`` slab
per slot.  This module is the **host-side brain** of that pool: it owns the
free list, per-slot block tables, reference counts, the token-keyed prefix
cache and the LRU eviction policy.  It never touches device memory — the
engine applies the returned :class:`AdmitPlan` (gathers, scatters, block
copies) so the device step keeps its one-dispatch-per-step property.

Layout & invariants
-------------------
* Block ids are shared across layers: one allocation covers every layer's
  slice of the pool (``k[:, bid]`` is block ``bid`` in all L layers).
* Block id 0 is the reserved **null block**: never allocated, the write sink
  for inactive slots and the gather source for unallocated table entries
  (masked out by ``kpos == -1``).
* A block is in exactly one of three states: **free** (on the free list),
  **in use** (``ref > 0``; held by one or more running slots), or **cached**
  (``ref == 0`` but registered in the prefix cache; LRU-evictable).
* Decode only ever writes a slot's *tail* block, and tails are never shared:
  prefix sharing covers full prompt blocks (read-only while shared), and a
  partially-filled cached block is reused via **copy-on-write** — the sharer
  gets its own device copy before any write can land.

Prefix cache
------------
Full prompt blocks register under their exact token chain
(``tuple(prompt[:(i+1)*bs])`` — value-keyed, so no hash collisions and no
dangling references when parents are evicted).  Admission walks the chain and
reuses every matching full block (incref, zero prefill cost); if the chain
covers all full blocks and some cached sibling block *starts with* the prompt
remainder, that block is reused copy-on-write and the whole prompt is served
from cache.  Only the unmatched tail pays prefill.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

__all__ = ["KVPool", "AdmitPlan", "POOL_STAT_KEYS", "empty_stats"]

# the full stats() key set — contiguous (pool-less) engines report the same
# keys zeroed, so dashboards and CI assertions never branch on engine kind
POOL_STAT_KEYS = ("n_blocks", "block_size", "free_blocks", "cached_blocks",
                  "in_use_blocks", "peak_in_use_blocks", "prefix_queries",
                  "prefix_hit_blocks", "prefix_hit_tokens", "prefix_hit_rate",
                  "cow_copies", "evictions")


def empty_stats() -> dict:
    """Zeroed :meth:`KVPool.stats` shape for engines without a block pool."""
    return {k: 0.0 if k == "prefix_hit_rate" else 0 for k in POOL_STAT_KEYS}


@dataclass
class AdmitPlan:
    """Host-side admission decision, applied to device memory by the engine."""
    table: np.ndarray  # [view_blocks] int32 block ids (0 = unallocated/null)
    cached_tokens: int  # leading tokens already resident (skip their prefill)
    shared: list[int] = field(default_factory=list)  # reused read-only blocks
    new: list[int] = field(default_factory=list)  # freshly allocated blocks
    cow: tuple[int, int] | None = None  # (src, dst): device-copy src -> dst


class KVPool:
    """Free-list block allocator + prefix cache over a paged KV pool.

    ``n_blocks`` counts usable blocks (ids ``1..n_blocks``; id 0 is the null
    block and is not the pool's to give out).  ``view_blocks`` is the block-
    table width — ``ceil(view_tokens / block_size)`` logical blocks per slot.
    """

    def __init__(self, *, n_slots: int, n_blocks: int, block_size: int,
                 view_blocks: int, prefix_cache: bool = True,
                 windowed: bool = False):
        self.n_slots = n_slots
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.view_blocks = view_blocks
        self.windowed = windowed
        # a ring cache rewrites its prefix as it wraps: cached blocks would go
        # stale the moment the window slides, so sharing is disabled
        self.prefix_cache = prefix_cache and not windowed
        self._free: list[int] = list(range(n_blocks, 0, -1))  # pop() -> low ids
        self._ref = np.zeros(n_blocks + 1, np.int32)
        self._slot_blocks: list[list[int]] = [[] for _ in range(n_slots)]
        # prefix cache: token-chain -> block id, plus reverse index for evict
        self._children: dict[tuple, dict[tuple, int]] = {}
        self._block_key: dict[int, tuple[tuple, tuple]] = {}  # bid -> (parent, toks)
        self._lru: OrderedDict[int, None] = OrderedDict()  # cached, ref == 0
        # telemetry
        self.prefix_queries = 0
        self.prefix_hit_blocks = 0
        self.prefix_hit_tokens = 0
        self.cow_copies = 0
        self.evictions = 0
        self.peak_in_use = 0

    # ------------------------------------------------------------- accounting
    @property
    def capacity_tokens(self) -> int:
        return self.n_blocks * self.block_size

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        return len(self._lru)

    @property
    def in_use_blocks(self) -> int:
        return self.n_blocks - self.free_blocks - self.cached_blocks

    @property
    def available_blocks(self) -> int:
        """Blocks an admission could obtain: free + LRU-evictable."""
        return self.free_blocks + self.cached_blocks

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def stats(self) -> dict:
        return {
            "n_blocks": self.n_blocks, "block_size": self.block_size,
            "free_blocks": self.free_blocks, "cached_blocks": self.cached_blocks,
            "in_use_blocks": self.in_use_blocks,
            "peak_in_use_blocks": self.peak_in_use,
            "prefix_queries": self.prefix_queries,
            "prefix_hit_blocks": self.prefix_hit_blocks,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_hit_rate": (self.prefix_hit_blocks
                                / max(1, self.prefix_queries)),
            "cow_copies": self.cow_copies, "evictions": self.evictions,
        }

    # ------------------------------------------------------------- allocation
    def _evict_one(self) -> int | None:
        """Drop the least-recently-used cached block from the prefix cache."""
        if not self._lru:
            return None
        bid, _ = self._lru.popitem(last=False)
        parent, toks = self._block_key.pop(bid)
        kids = self._children.get(parent)
        if kids is not None and kids.get(toks) == bid:
            del kids[toks]
            if not kids:
                del self._children[parent]
        self.evictions += 1
        return bid

    def _alloc(self) -> int | None:
        if self._free:
            return self._free.pop()
        return self._evict_one()

    def _hold(self, bid: int) -> None:
        """Take a reference; a cached block leaves the LRU (no longer evictable)."""
        if self._ref[bid] == 0:
            self._lru.pop(bid, None)
        self._ref[bid] += 1

    def _drop(self, bid: int) -> None:
        self._ref[bid] -= 1
        assert self._ref[bid] >= 0, f"block {bid} over-released"
        if self._ref[bid] == 0:
            if bid in self._block_key:
                self._lru[bid] = None  # stays resident, evictable
            else:
                self._free.append(bid)

    # -------------------------------------------------------------- admission
    def _match_prefix(self, prompt: list[int]):
        """Walk the cache chain: (matched full-block ids, cow source or None).

        The COW source is a cached block whose first ``len(prompt) % bs``
        tokens equal the prompt remainder — reusable only through a private
        copy, since the new request will write into it."""
        bs = self.block_size
        f, r = len(prompt) // bs, len(prompt) % bs
        matched: list[int] = []
        key: tuple = ()
        for i in range(f):
            toks = tuple(prompt[i * bs:(i + 1) * bs])
            bid = self._children.get(key, {}).get(toks)
            if bid is None:
                return matched, None
            matched.append(bid)
            key = key + toks
        cow_src = None
        if r:
            tail = tuple(prompt[f * bs:])
            for toks, bid in self._children.get(key, {}).items():
                if toks[:r] == tail:
                    cow_src = bid
                    break
        return matched, cow_src

    def admit_cost(self, prompt: list[int]) -> int:
        """Blocks an admission would allocate (after prefix sharing).  The
        count includes one reserve block of decode headroom — ``admit``
        really allocates it, so concurrent requests cannot starve each
        other's first growth block.  Pure query — no refcounts move."""
        plen = len(prompt)
        if self.windowed:
            return self.view_blocks
        if not self.prefix_cache:
            return self.blocks_for(plen) + 1
        matched, cow_src = self._match_prefix(prompt)
        cached = plen if (cow_src is not None
                          and len(matched) == plen // self.block_size) \
            else len(matched) * self.block_size
        fresh = min(self.blocks_for(plen - cached) + 1,  # +1 decode reserve,
                    self.view_blocks - len(matched)      # capped by the table
                    - (cow_src is not None))
        return fresh + (cow_src is not None)

    def can_admit(self, prompt: list[int]) -> bool:
        return self.admit_cost(prompt) <= self.available_blocks

    def admit(self, slot: int, prompt: list[int]) -> AdmitPlan | None:
        """Reserve blocks for a prompt: reuse cached prefix blocks, allocate
        the rest.  Returns None (state unchanged) when the pool cannot supply
        enough blocks even after eviction."""
        assert not self._slot_blocks[slot], f"slot {slot} still holds blocks"
        bs, plen = self.block_size, len(prompt)
        matched: list[int] = []
        cow_src = None
        if self.prefix_cache and not self.windowed:
            self.prefix_queries += 1
            matched, cow_src = self._match_prefix(prompt)
        for bid in matched:  # pin before allocating: eviction must skip these
            self._hold(bid)
        if cow_src is not None:
            self._hold(cow_src)
        cached = len(matched) * bs
        cow = None
        new: list[int] = []
        # +1: the decode-headroom reserve block, capped so the table never
        # overflows (rings never grow — their whole view is allocated here)
        if self.windowed:
            want = self.view_blocks
        else:
            cow_n = cow_src is not None
            want = min(self.blocks_for(plen - cached) - cow_n + 1,
                       self.view_blocks - len(matched) - cow_n)
        ok = True
        if cow_src is not None:
            dst = self._alloc()
            if dst is None:
                ok = False
            else:
                cow = (cow_src, dst)
                cached = plen  # the copy carries the whole prompt remainder
        if ok:
            for _ in range(max(0, want)):
                bid = self._alloc()
                if bid is None:
                    ok = False
                    break
                new.append(bid)
        if cow_src is not None:
            self._drop(cow_src)  # pin released; stays cached either way
        if not ok:  # rollback — admission is all-or-nothing
            for bid in new + ([cow[1]] if cow else []):
                self._free.append(bid)
            for bid in matched:
                self._drop(bid)
            return None
        owned = matched + ([cow[1]] if cow else []) + new
        for bid in owned[len(matched):]:
            self._ref[bid] = 1
        table = np.zeros(self.view_blocks, np.int32)
        table[:len(owned)] = owned
        self._slot_blocks[slot] = owned
        self.prefix_hit_blocks += len(matched) + (cow is not None)
        self.prefix_hit_tokens += cached
        self.cow_copies += cow is not None
        self.peak_in_use = max(self.peak_in_use, self.in_use_blocks)
        return AdmitPlan(table=table, cached_tokens=min(cached, plen),
                         shared=matched, new=new, cow=cow)

    def append_block(self, slot: int) -> int | None:
        """Grow a slot by one decode block; None when the pool is exhausted."""
        if len(self._slot_blocks[slot]) >= self.view_blocks:
            return None
        bid = self._alloc()
        if bid is None:
            return None
        self._ref[bid] = 1
        self._slot_blocks[slot].append(bid)
        self.peak_in_use = max(self.peak_in_use, self.in_use_blocks)
        return bid

    # ----------------------------------------------------- cache registration
    def register_prefix(self, slot: int, prompt: list[int]) -> None:
        """Publish a slot's full prompt blocks into the prefix cache (called
        once the blocks hold real K/V, i.e. right after prefill).  Blocks
        whose chain position is already cached keep the existing entry."""
        if not self.prefix_cache:
            return
        bs = self.block_size
        key: tuple = ()
        for i in range(len(prompt) // bs):
            toks = tuple(prompt[i * bs:(i + 1) * bs])
            bid = self._slot_blocks[slot][i]
            kids = self._children.setdefault(key, {})
            if toks not in kids and bid not in self._block_key:
                kids[toks] = bid
                self._block_key[bid] = (key, toks)
            key = key + toks

    def release(self, slot: int) -> None:
        """Retire a slot: every held block drops one reference.  Registered
        blocks at ref 0 stay cached (LRU-evictable); the rest go back to the
        free list."""
        for bid in self._slot_blocks[slot]:
            self._drop(bid)
        self._slot_blocks[slot] = []
