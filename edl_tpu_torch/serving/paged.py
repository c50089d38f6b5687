"""Host-side bookkeeping for the paged KV cache — the block allocator
and the shared-prefix cache behind ``ContinuousBatchingEngine``'s
paged mode (``block_size > 0``).

The PyTorch port's copy of ``edl_tpu/serving/paged.py``, unchanged in
behaviour (torch-free, like the reference).

The DEVICE side is ``llama.decode_*_paged`` / ``llama.prefill_paged``:
K/V live in a pool of fixed-size blocks and every dispatch addresses
them through a per-slot block table snapshot. Everything else — which
physical block backs which logical position, who still references a
block, which block chains are reusable prompt prefixes — is plain
host Python here, so allocation, sharing, copy-on-write, and frees
never touch the device.

Invariants:

* **block 0 is SCRATCH** — never allocated, never referenced by a live
  table entry; inactive/frozen device lanes and bucket padding write
  there and nothing ever reads it back.
* **a freed block id must leave every table that referenced it** in the
  same bookkeeping step — a stale table entry over a reallocated block
  is the paged twin of a stale donated buffer.
* **refcounts gate frees** — a shared prefix block is freed only when
  the last referencing slot AND the prefix cache drop it; writes are
  only ever issued against blocks with refcount 1 (the engine
  copy-on-writes first otherwise).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

SCRATCH = 0  # reserved physical block: pad/inactive writes, never read


class BlockAllocator:
    """Free-list allocator with refcounts over ``n_blocks`` physical
    KV blocks of ``block_size`` tokens each. Block 0 (``SCRATCH``) is
    reserved and never handed out."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError(f"need >= 2 blocks (scratch + 1), got {n_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        # ascending allocation order (pop from the end of a reversed
        # list) keeps tests/debug dumps readable; ids 1..n_blocks-1
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._ref: List[int] = [0] * n_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def allocated_blocks(self) -> int:
        return (self.n_blocks - 1) - len(self._free)

    def alloc(self) -> Optional[int]:
        """One fresh block at refcount 1, or None when the pool is
        exhausted (the engine then evicts cache entries / preempts)."""
        if not self._free:
            return None
        bid = self._free.pop()
        self._ref[bid] = 1
        return bid

    def incref(self, bid: int) -> None:
        if bid == SCRATCH or self._ref[bid] <= 0:
            raise ValueError(f"incref on unallocated block {bid}")
        self._ref[bid] += 1

    def refcount(self, bid: int) -> int:
        return self._ref[bid]

    def free(self, bid: int) -> bool:
        """Drop one reference; returns True when the block actually
        returned to the free list (refcount hit zero)."""
        if bid == SCRATCH:
            return False  # scratch is never owned, never freed
        if self._ref[bid] <= 0:
            raise ValueError(f"double free of block {bid}")
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)
            return True
        return False


def chain_keys(
    tokens: Sequence[int], block_size: int
) -> List[Tuple[int, ...]]:
    """Prefix-chain keys for every FULL block of ``tokens``: key j is
    the tuple of all tokens through block j's end, so a hit implies the
    entire prefix matched (hash-chain semantics without hashing —
    prompts are short host lists and tuple keys cannot collide)."""
    bs = block_size
    return [
        tuple(tokens[: (j + 1) * bs])
        for j in range(len(tokens) // bs)
    ]


class PrefixCache:
    """LRU map from prompt-prefix block chains to physical blocks.

    Each cached block carries ONE reference held by the cache itself,
    so a block can outlive every slot that used it and back future
    prefix hits. ``match`` returns the longest cached chain for a
    prompt; ``insert`` publishes a slot's freshly prefilled full
    prompt blocks; ``evict_one`` reclaims the least-recently-used
    entry whose block no live slot references — the allocator calls
    through it under pool pressure."""

    def __init__(self, alloc: BlockAllocator):
        self._alloc = alloc
        self._map: "OrderedDict[Tuple[int, ...], int]" = OrderedDict()
        self.hits = 0  # block-granular hit count (telemetry)
        self.misses = 0

    def __len__(self) -> int:
        return len(self._map)

    def match(self, prompt: Sequence[int]) -> List[int]:
        """Physical blocks backing the longest cached prefix chain of
        ``prompt`` (block-granular; stops at the first divergent
        block). Does NOT take references or bump ``hits``/``misses`` —
        the engine probes admissibility with this too, and only the
        table-commit path counts (exactly once per admission)."""
        out: List[int] = []
        for key in chain_keys(prompt, self._alloc.block_size):
            bid = self._map.get(key)
            if bid is None:
                break
            self._map.move_to_end(key)
            out.append(bid)
        return out

    def insert(self, key: Tuple[int, ...], bid: int) -> None:
        """Publish one full prompt block under its chain key, taking
        the cache's own reference. Re-inserting an existing key is a
        no-op touch (the first publisher's block stays canonical, so
        concurrent identical prompts converge on one copy)."""
        if key in self._map:
            self._map.move_to_end(key)
            return
        self._alloc.incref(bid)
        self._map[key] = bid

    def evict_one(self) -> bool:
        """Reclaim the LRU entry whose block only the cache still
        references (refcount 1 — live slots win over cache retention).
        Returns True if a block was actually freed to the pool."""
        for key, bid in self._map.items():
            if self._alloc.refcount(bid) == 1:
                del self._map[key]
                self._alloc.free(bid)
                return True
        return False

    def evictable(self) -> int:
        """Entries reclaimable right now (refcount 1) — what admission
        adds to the free-block count when sizing 'enough free blocks'."""
        return sum(
            1 for bid in self._map.values() if self._alloc.refcount(bid) == 1
        )

    def drop_block(self, bid: int) -> None:
        """Remove any entry mapping to ``bid`` WITHOUT freeing it —
        the copy-on-write path transfers ownership to the writer."""
        for key, b in list(self._map.items()):
            if b == bid:
                del self._map[key]
                self._alloc.free(bid)


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to cover ``n_tokens`` logical positions."""
    return -(-n_tokens // block_size) if n_tokens > 0 else 0
