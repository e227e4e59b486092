"""Block allocator for the paged KV cache.

vLLM-style paging, TPU-shaped: the cache is [L, num_blocks, block_size,
Hkv, D]; a slot's logical sequence maps to physical blocks through a
per-slot block table.  Block 0 is a reserved NULL block — padding table
entries of inactive/short slots point at it, stray masked writes land in
it, and it is never handed out — so scatter/gather with padded tables
needs no bounds branching on device.

Allocation happens entirely at admission time for the request's worst
case (prompt + max_new_tokens), so decode can never fail mid-stream;
elasticity comes from short requests reserving only what they can ever
touch instead of a dense max_len row.

No reference equivalent (the reference proxies serving to SGLang); this
is the memory-management half of the TPU-native engine.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable, List, Optional


class BlockAllocator:
    """Free-list allocator over block ids 1..num_blocks-1 (0 is NULL)."""

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def available_blocks(self) -> int:
        """Blocks obtainable by the next alloc (free + evictable)."""
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n blocks, or None (all-or-nothing) if not enough are free."""
        if n > len(self._free):
            return None
        taken = self._free[-n:] if n else []
        del self._free[len(self._free) - n:]
        return list(reversed(taken))

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if not 0 < b < self.num_blocks:
                raise ValueError(f"bad block id {b}")
            if b in self._free:
                raise ValueError(f"double free of block {b}")
        self._free.extend(blocks)

    # release() is the engine-facing name; the prefix-aware subclass gives
    # it refcount semantics, here it is plain free.
    release = free


class PrefixBlockAllocator(BlockAllocator):
    """Refcounted allocator with a content-addressed block cache.

    vLLM "automatic prefix caching", TPU-paged: a FULL prompt block's KV is
    registered under a chained content key (parent key + the block's token
    ids — structural equality, no hash collisions).  A later prompt whose
    leading blocks match reuses the cached blocks (refcount++) and only
    computes KV for its suffix.  Released blocks with a registered key
    aren't returned to the free list — they park in an LRU of evictable
    blocks and are evicted only when a fresh alloc runs short; unregistered
    blocks free as usual.
    """

    def __init__(self, num_blocks: int) -> None:
        super().__init__(num_blocks)
        self._refs: dict[int, int] = {}
        self._by_key: dict[Hashable, int] = {}
        self._key_of: dict[int, Hashable] = {}
        #: unreferenced-but-cached blocks, oldest first (eviction order)
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.stats = {"lookups": 0, "hit_blocks": 0, "evictions": 0}

    @property
    def available_blocks(self) -> int:
        return len(self._free) + len(self._lru)

    @staticmethod
    def block_keys(tokens: List[int], block_size: int) -> List[Hashable]:
        """Chained content keys for each FULL block of ``tokens``."""
        keys: List[Hashable] = []
        parent: Any = None
        for i in range(len(tokens) // block_size):
            parent = (parent,
                      tuple(tokens[i * block_size:(i + 1) * block_size]))
            keys.append(parent)
        return keys

    def lookup(self, keys: List[Hashable]) -> List[int]:
        """Longest cached prefix of ``keys``; matched blocks are ref'd and
        must be released like allocated ones."""
        self.stats["lookups"] += 1
        matched: List[int] = []
        for key in keys:
            block = self._by_key.get(key)
            if block is None:
                break
            matched.append(block)
        for b in matched:
            self._lru.pop(b, None)
            self._refs[b] = self._refs.get(b, 0) + 1
        self.stats["hit_blocks"] += len(matched)
        return matched

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free) + len(self._lru):
            return None
        while n > len(self._free):
            block, _ = self._lru.popitem(last=False)  # evict oldest
            del self._by_key[self._key_of.pop(block)]
            self._free.append(block)
            self.stats["evictions"] += 1
        blocks = super().alloc(n)
        assert blocks is not None
        for b in blocks:
            self._refs[b] = 1
        return blocks

    def register(self, key: Hashable, block: int) -> None:
        """Publish a full block's KV under its content key (post-prefill).
        No-op if the key is already cached (a concurrent request computed
        the same block first — its copy wins, ours stays private)."""
        if key in self._by_key or block in self._key_of:
            return
        self._by_key[key] = block
        self._key_of[block] = key

    def release(self, blocks: List[int]) -> None:
        # Reversed: a table's blocks are a prefix CHAIN (parent first), and
        # lookup stops at the first missing key — so the chain head must be
        # the LAST evicted.  Parking leaves first makes them LRU-older and
        # evicts them before their ancestors.
        for b in reversed(blocks):
            refs = self._refs.get(b, 0) - 1
            if refs > 0:
                self._refs[b] = refs
                continue
            self._refs.pop(b, None)
            if b in self._key_of:
                self._lru[b] = None  # cached: evictable, not free
            else:
                self.free([b])

    def clear_cache(self) -> None:
        """Drop every cached association (device KV was reallocated — the
        contents backing the keys are gone)."""
        for block in list(self._lru):
            self.free([block])
        self._lru.clear()
        self._by_key.clear()
        self._key_of.clear()
